"""RefineNet training: ``python -m smap_tpu_torch.train_refinenet``.

Trains on the pairs of a ``test_smap -t generate_train`` result and saves
the model after every epoch as ``<output-dir>/epoch_<N>.pth`` (``{"model":
state_dict}``, the layout ``test_smap -rp`` and ``serve -rp`` load).

Usage:
  python -m smap_tpu_torch.train_refinenet --pairs-json pairs.json \\
      [--epochs N] [--output-dir DIR]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Runs the CLI; returns the snapshot directory."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.train_refinenet",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs-json", required=True)
    parser.add_argument("--epochs", type=int, default=0,
                        help="default: RefineNetConfig.num_epochs")
    parser.add_argument("--output-dir", default="model_logs/refinenet_root2")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from smap_tpu_torch.config import RefineNetConfig
    from smap_tpu_torch.data.datasets import P2PDataset
    from smap_tpu_torch.train.refine import train_refinenet

    snapshots = train_refinenet(P2PDataset(args.pairs_json),
                                RefineNetConfig(),
                                num_epochs=args.epochs or None,
                                seed=args.seed, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    for epoch, model in snapshots.items():
        torch.save({"model": model.state_dict()},
                   os.path.join(args.output_dir, f"epoch_{epoch}.pth"))
    print(f"saved {len(snapshots)} epoch snapshots to {args.output_dir}")
    return args.output_dir


if __name__ == "__main__":
    main()
