"""Panoptic-style evaluation of a ``generate_result`` JSON (PCK15, MPJPE,
ordinal-reversal accounting): ``python -m smap_tpu_torch.eval_panoptic``
(counterpart of ``scripts/eval_panoptic.py``; numpy, no card).

Usage:
  python -m smap_tpu_torch.eval_panoptic --result-json result.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


def evaluate_result_json(result: dict) -> Dict[str, float]:
    """Accumulates every ``3d_pairs`` item (ground-truth-registered rows,
    as ``generate_result`` writes them) and returns the metric summary."""
    from smap_tpu_torch.evaluation.panoptic import PanopticAccumulator

    acc = PanopticAccumulator()
    for pair in result["3d_pairs"]:
        gt2, gt3 = np.asarray(pair["gt_2d"]), np.asarray(pair["gt_3d"])
        if gt2.size == 0:
            continue
        gt = np.concatenate([gt2, gt3], axis=-1)    # [P, J, >=7] rows
        pred = np.asarray(pair["pred_3d"], float)
        if pred.size == 0:
            pred = np.zeros((0, gt.shape[1], 4))
        if len(pred) < len(gt):                     # undetected tail rows
            pred = np.concatenate(
                [pred, np.zeros((len(gt) - len(pred), *pred.shape[1:]))])
        acc.update(pred[:len(gt)], gt)
    return acc.summary()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Runs the CLI; returns the summary it printed."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.eval_panoptic",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--result-json", required=True)
    args = parser.parse_args(argv)
    if not os.path.exists(args.result_json):
        raise SystemExit(f"No such result file {args.result_json}")
    with open(args.result_json) as f:
        summary = evaluate_result_json(json.load(f))
    for k, v in summary.items():
        print(f"  {k}: {v:.4f}")
    return summary


if __name__ == "__main__":
    main()
