"""Prediction-to-GT registration for result generation (counterpart of
``smap_tpu/evaluation/register.py``; numpy only).

Greedily match predicted root joints to GT roots by 2D distance (< 30 px),
then re-order the predictions into GT order (unmatched GT rows become
zeros), so that each result row of ``generate_result`` /
``generate_train`` aligns with its GT person.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from smap_tpu_torch.config import ROOT_IDX


def register_pred(pred_2d: np.ndarray, pred_3d: np.ndarray,
                  root_depth: np.ndarray, gt_bodys: np.ndarray, *,
                  root_idx: int = ROOT_IDX, threshold: float = 30.0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match preds to GT and emit GT-ordered tables.

    Args:
      pred_2d / pred_3d: [P, 15, 4]; root_depth: [P]; gt_bodys: [G, 15, C].

    Returns:
      (new_2d [G,15,4], new_3d [G,15,4], new_depth [G]).
    """
    G = len(gt_bodys)
    new_2d = np.zeros((G, pred_2d.shape[1], 4), pred_2d.dtype)
    new_3d = np.zeros((G, pred_3d.shape[1], 4), pred_3d.dtype)
    new_d = np.zeros((G,), np.float64)
    if len(pred_2d) == 0 or G == 0:
        return new_2d, new_3d, new_d

    root_gt = np.asarray(gt_bodys)[:, root_idx, :2].astype(float)
    root_pd = pred_2d[:, root_idx, :2].astype(float)
    dist = np.linalg.norm(root_gt[:, None, :] - root_pd[None, :, :], axis=2)
    corres = np.full(G, -1, np.int64)
    occupied = np.zeros(len(pred_2d), bool)
    # Repeatedly take the global minimum under the threshold and overwrite
    # it with 50 to mark it visited; ties are taken in row-major order.
    work = dist.copy()
    while work.min(initial=np.inf) < threshold:
        ij = np.argwhere(work == work.min())
        for gi, pj in ij:
            work[gi, pj] = 50.0
            if corres[gi] >= 0 or occupied[pj]:
                continue
            corres[gi] = pj
            occupied[pj] = True
    for gi in range(G):
        if corres[gi] >= 0:
            new_2d[gi] = pred_2d[corres[gi]]
            new_3d[gi] = pred_3d[corres[gi]]
            new_d[gi] = root_depth[corres[gi]]
    return new_2d, new_3d, new_d
