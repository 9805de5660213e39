"""RefineNet's training pairs (counterpart of ``P2PDataset`` in
``smap_tpu/data/datasets.py``; json and numpy only)."""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from smap_tpu_torch.config import NUM_JOINTS, ROOT_IDX


class P2PDataset:
    """``3d_pairs`` of a result JSON: each pair's predicted 2D and 3D pose
    and its ground-truth 3D pose."""

    def __init__(self, json_path: str, root_idx: int = ROOT_IDX):
        with open(json_path) as f:
            data = json.load(f)
        self.pairs = data["3d_pairs"]
        self.root_idx = root_idx

    def __len__(self) -> int:
        return len(self.pairs)

    def get_sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input [75], target [45]) root-relative encodings: the root's
        2D position and 3D position, then each other joint with a predicted
        depth relative to the root (zeros where it has none)."""
        pair = self.pairs[index]
        pred_3d = np.asarray(pair["pred_3d"], np.float32)
        pred_2d = np.asarray(pair["pred_2d"], np.float32)
        gt_3d = np.asarray(pair["gt_3d"], np.float32)
        r = self.root_idx
        inp = np.zeros((NUM_JOINTS, 5), np.float32)
        inp[r, :2] = pred_2d[r, :2]
        inp[r, 2:] = pred_3d[r, :3]
        for j in range(NUM_JOINTS):
            if j != r and pred_3d[j, 3] > 0:
                inp[j, :2] = pred_2d[j, :2] - pred_2d[r, :2]
                inp[j, 2:] = pred_3d[j, :3] - pred_3d[r, :3]
        gt = gt_3d[:, :3] - gt_3d[r:r + 1, :3]
        return inp.reshape(-1), gt.reshape(-1)
