"""Checkpoints between the reference ``.pth`` and the port's training
checkpoints, both ways: ``python -m smap_tpu_torch.convert_checkpoint``
(counterpart of ``scripts/convert_checkpoint.py``).

* Import: ``--smap-path X.pth --output-dir D`` writes
  ``D/checkpoints/0.pt``, the training state ``Trainer`` restores
  (``train_smap --resume --output-dir D``): the reference weights, a fresh
  Adam and schedule, step 0.
* Export: ``--ckpt-dir D --to-torch Y.pth`` writes the model of D's latest
  checkpoint as the reference's ``{"model": state_dict}``, loadable by
  the reference ``model/smap.py``, the JAX package and ``test_smap -p``.

Runs on the host; no card is needed.

Usage:
  python -m smap_tpu_torch.convert_checkpoint --smap-path SMAP.pth \\
      --output-dir model_logs/stage3_root2
  python -m smap_tpu_torch.convert_checkpoint \\
      --ckpt-dir model_logs/stage3_root2 --to-torch SMAP_port.pth
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from smap_tpu_torch.config import Config


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Runs the CLI; returns the path written."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.convert_checkpoint",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--smap-path", default="",
                        help="reference .pth to import")
    parser.add_argument("--output-dir", default="",
                        help="the port's checkpoint dir (import target / "
                        "export source with --ckpt-dir)")
    parser.add_argument("--ckpt-dir", default="",
                        help="the port's checkpoint dir to export from")
    parser.add_argument("--to-torch", default="",
                        help="write a reference-format .pth to this path")
    args = parser.parse_args(argv)

    from smap_tpu_torch.models.convert import (load_torch_checkpoint,
                                               save_torch_checkpoint)
    from smap_tpu_torch.train.engine import (CheckpointManager, Trainer,
                                             TrainerConfig)

    if args.to_torch:
        src = args.ckpt_dir or args.output_dir
        directory = os.path.join(src, "checkpoints")
        ckpt = CheckpointManager(directory) if os.path.isdir(directory) \
            else None
        if ckpt is None or ckpt.latest_step() is None:
            raise SystemExit(f"no checkpoint found under {src}: refusing "
                             f"to export uninitialized weights")
        save_torch_checkpoint(ckpt.model_state_dict(), args.to_torch)
        print(f"reference-format checkpoint written to {args.to_torch}")
        return args.to_torch

    if not (args.smap_path and args.output_dir):
        parser.error("need --smap-path + --output-dir (import) or "
                     "--ckpt-dir + --to-torch (export)")
    trainer = Trainer(Config(), TrainerConfig(output_dir=args.output_dir),
                      device="cpu")
    try:
        state = trainer.init_state()
        state.model.load_state_dict(load_torch_checkpoint(args.smap_path))
        trainer.ckpt.save(0, state)
    finally:
        trainer.close()
    path = os.path.join(args.output_dir, "checkpoints", "0.pt")
    print(f"converted checkpoint written to {path}")
    return path


if __name__ == "__main__":
    main()
