"""Panoptic-style python-side evaluation accounting (counterpart of
``smap_tpu/evaluation/panoptic.py``; numpy only).

Working port of the superset eval logic in the reference's stale module
(``lib/eval/test_util_panoptic.py:273-307`` in zju3dv/SMAP — dead code
there: its imports are broken, but it is the only in-tree python metric
implementation): per matched person, absolute and root-relative per-joint
L2 error in cm, PCK@15cm per joint, root PCK@15cm, detected-people counts,
and adjacent-pair depth-order reversals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from smap_tpu_torch.config import NUM_JOINTS, ROOT_IDX

PCK_CM = 15.0


@dataclasses.dataclass
class PanopticAccumulator:
    total_people_gt: int = 0
    count_people: int = 0
    root_within_15: int = 0
    total_pairs: int = 0
    reversed_pairs: int = 0
    count_point: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_JOINTS))
    abs_error: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_JOINTS))
    abs_pck: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_JOINTS))
    rel_error: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_JOINTS))
    rel_pck: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_JOINTS))

    def update(self, pred_bodys_3d: np.ndarray, gt_bodys: np.ndarray,
               root_n: int = ROOT_IDX) -> None:
        """Accumulate one image (GT-registered rows; reference eval_3d).

        Args:
          pred_bodys_3d: [P, J, 4] (X, Y, Z, score) cm.
          gt_bodys: [P, J, >=7] unified rows; cols 4:7 are GT XYZ (cm).
        """
        pred_bodys_3d = np.asarray(pred_bodys_3d, float)
        gt_bodys = np.asarray(gt_bodys, float)
        for i, pred in enumerate(pred_bodys_3d):
            if gt_bodys[i][root_n][3] < 2:
                continue
            self.total_people_gt += 1
            if pred[root_n][3] == 0:
                continue
            gt = gt_bodys[i, :, 4:7]
            detected = pred[:, 3] != 0
            err = np.linalg.norm(pred[:, :3] - gt, axis=1)
            err[~detected] = 0
            rel_pred = pred[:, :3] - pred[root_n, :3]
            rel_gt = gt - gt[root_n]
            rerr = np.linalg.norm(rel_gt - rel_pred, axis=1)
            rerr[~detected] = 0

            if err[root_n] < PCK_CM:
                self.root_within_15 += 1
            # adjacent-pair depth ordering (reference :297-300).
            if (i + 1 < len(pred_bodys_3d) and i + 1 < len(gt_bodys)
                    and pred_bodys_3d[i + 1][root_n][3] != 0
                    and gt_bodys[i + 1][root_n][3] >= 2):
                self.total_pairs += 1
                if ((gt[root_n][2] - gt_bodys[i + 1][root_n][6])
                        * (pred[root_n][2]
                           - pred_bodys_3d[i + 1][root_n][2])) < 0:
                    self.reversed_pairs += 1

            self.count_point += detected
            self.abs_error += err
            self.abs_pck += (err < PCK_CM) & detected
            self.rel_error += rerr
            self.rel_pck += (rerr < PCK_CM) & detected
            self.count_people += 1

    def summary(self) -> Dict[str, float]:
        cp = np.maximum(self.count_point, 1)
        return {
            "detection_rate": self.count_people / max(self.total_people_gt, 1),
            "root_pck15": self.root_within_15 / max(self.count_people, 1),
            "mpjpe_abs_cm": float((self.abs_error / cp).mean()),
            "mpjpe_rel_cm": float((self.rel_error / cp).mean()),
            "pck15_abs": float((self.abs_pck / cp).mean()),
            "pck15_rel": float((self.rel_pck / cp).mean()),
            "pair_reversal_rate": (self.reversed_pairs
                                   / max(self.total_pairs, 1)),
        }
