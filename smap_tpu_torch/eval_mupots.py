"""MuPoTS-3D evaluation of a ``generate_result`` JSON:
``python -m smap_tpu_torch.eval_mupots`` (counterpart of
``scripts/eval_mupots.py``; numpy and scipy, no card).

Prints PCK@150mm and AUC per joint group, MPJPE, the undetected rate, the
per-joint PCK15 and, with ``--absolute``, the ordinal depth accuracy.

Usage:
  python -m smap_tpu_torch.eval_mupots --result-json result.json \\
      --mupots-dir /path/MultiPersonTestSet [--absolute] [--no-skel] \\
      [--eval-mode 0|1]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """Runs the CLI; returns the ``MupotsMetrics`` it printed."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.eval_mupots",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--result-json", required=True)
    parser.add_argument("--mupots-dir", required=True)
    parser.add_argument("--absolute", action="store_true",
                        help="PCK_abs (no root centering) + ordinal accuracy")
    parser.add_argument("--no-skel", action="store_true",
                        help="disable GT bone-length rescaling")
    parser.add_argument("--eval-mode", type=int, default=0, choices=[0, 1],
                        help="0: score all annotated people; 1: matched only")
    args = parser.parse_args(argv)

    if not os.path.exists(args.result_json):
        raise SystemExit(f"result JSON not found: {args.result_json}")
    if not os.path.isdir(args.mupots_dir):
        raise SystemExit(f"MuPoTS directory not found: {args.mupots_dir}")

    from smap_tpu_torch.evaluation.mupots_data import evaluate_results

    metrics = evaluate_results(
        args.result_json, args.mupots_dir,
        is_relative=not args.absolute, use_skel=not args.no_skel,
        eval_mode=args.eval_mode)

    mode = "PCK_abs" if args.absolute else "PCK_rel"
    print(f"== MuPoTS-3D ({mode}, use_skel={not args.no_skel}, "
          f"eval_mode={args.eval_mode}) ==")
    for group, val in metrics.pck.items():
        print(f"  PCK@150mm {group:>6}: {val:6.2f}   "
              f"AUC {metrics.auc[group]:6.2f}")
    print(f"  MPJPE: {metrics.mpjpe:.1f} mm")
    if args.absolute:
        print(f"  ordinal depth accuracy: {metrics.ordinal_accuracy:.4f}")
    print(f"  undetected people rate: {metrics.undetected_rate:.4f}")
    print("  PCK15 per joint:",
          " ".join(f"{v:.3f}" for v in metrics.pck15_per_joint))
    return metrics


if __name__ == "__main__":
    main()
