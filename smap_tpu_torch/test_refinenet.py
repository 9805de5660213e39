"""RefineNet model selection: ``python -m smap_tpu_torch.test_refinenet``.

Evaluates every ``epoch_<N>.pth`` of a ``train_refinenet`` output
directory on a pair set and prints each epoch's per-joint and mean
root-relative L2 error (cm), then the best epoch.

Usage:
  python -m smap_tpu_torch.test_refinenet --pairs-json pairs.json \\
      --snapshot-dir model_logs/refinenet_root2
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Optional, Sequence, Tuple


def main(argv: Optional[Sequence[str]] = None) -> Tuple[int, float]:
    """Runs the CLI; returns (best epoch, its mean error)."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.test_refinenet",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs-json", required=True)
    parser.add_argument("--snapshot-dir", required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from smap_tpu_torch.config import RefineNetConfig
    from smap_tpu_torch.data.datasets import P2PDataset
    from smap_tpu_torch.models.convert import load_torch_checkpoint
    from smap_tpu_torch.models.refinenet import RefineNet
    from smap_tpu_torch.runtime import get_device
    from smap_tpu_torch.train.refine import evaluate_refinenet

    device = get_device(args.device)
    dataset = P2PDataset(args.pairs_json)
    paths = glob.glob(os.path.join(args.snapshot_dir, "epoch_*.pth"))
    if not paths:
        raise SystemExit(f"no epoch_*.pth under {args.snapshot_dir}")
    best = (-1, float("inf"))
    for path in sorted(paths, key=lambda p: int(
            re.search(r"epoch_(\d+)\.pth$", p).group(1))):
        epoch = int(re.search(r"epoch_(\d+)\.pth$", path).group(1))
        model = RefineNet(RefineNetConfig())
        model.load_state_dict(load_torch_checkpoint(path), strict=True)
        per_joint, mean_err = evaluate_refinenet(model.to(device), dataset)
        print(f"epoch {epoch}: mean {mean_err:.4f} cm, per-joint "
              + " ".join(f"{e:.3f}" for e in per_joint))
        if mean_err < best[1]:
            best = (epoch, mean_err)
    print(f"best epoch: {best[0]} ({best[1]:.4f} cm)")
    return best


if __name__ == "__main__":
    main()
