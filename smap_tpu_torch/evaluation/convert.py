"""Result-JSON -> evaluation-ready predictions, replacing
lib/eval/convert.py (counterpart of ``smap_tpu/evaluation/convert.py``;
numpy only).

Mirrors the reference's MATLAB-prep script (``lib/eval/convert.py`` in
zju3dv/SMAP): per MuPoTS image, undo the 832x512 letterboxing on the 2D
joints for the sequence's native resolution, re-project 3D as
``Z * K^-1 [u, v, 1]`` using the (possibly RefineNet-refined) depths, and
convert cm -> mm; then reorder into the MPI test joint order.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

from smap_tpu_torch.evaluation.mupots import FramePrediction, reorder_to_test

NET_W, NET_H = 832, 512


def sequence_resolution(ts: int) -> Tuple[int, int]:
    """TS1-5 are 2048x2048, TS6-20 1920x1080 (convert.py:19-24)."""
    if ts < 6:
        return 2048, 2048
    if ts <= 20:
        return 1920, 1080
    raise NotImplementedError(ts)


def parse_ts(image_path: str) -> Tuple[int, str]:
    """Extract sequence id + canonical 'TS<d>/img_xxxx.jpg' name."""
    m = re.search(r"TS(\d+)[/\\](.+)$", image_path)
    if not m:
        raise ValueError(f"not a MuPoTS path: {image_path}")
    return int(m.group(1)), f"TS{m.group(1)}/{m.group(2)}"


def unletterbox_2d(pred_2d: np.ndarray, width: int, height: int) -> np.ndarray:
    """Undo net-input letterboxing (convert.py:41-58)."""
    scale = min(NET_W / float(width), NET_H / float(height))
    adj = np.zeros(2)
    if height * scale < NET_H:
        adj = np.array([0.0, (NET_H - height * scale) // 2])
    if width * scale < NET_W:
        adj = np.array([(NET_W - width * scale) // 2, 0.0])
    out = pred_2d.copy()
    out[..., :2] = (out[..., :2] - adj) / scale
    return out


def pair_to_prediction(pair: Dict, K: np.ndarray) -> FramePrediction:
    """One result-JSON item -> eval-ready FramePrediction (mm, test order).

    Reprojection (convert.py:61-76): for joints with nonzero score,
    XYZ = Z * K^-1 [u, v, 1]; zero-score joints keep the original values.
    Units x10 cm->mm (convert.py:78).
    """
    pred_3d = np.asarray(pair["pred_3d"], float)       # [P, 15, 4]
    pred_2d = np.asarray(pair["pred_2d"], float)       # [P, 15, 4]
    if pred_3d.size == 0:
        z = np.zeros((0, 15, 2))
        return FramePrediction(pose_2d=z, pose_3d=np.zeros((0, 15, 3)),
                               visibility=np.zeros((0, 15)))
    ts, _ = parse_ts(pair["image_path"])
    width, height = sequence_resolution(ts)
    pred_2d = unletterbox_2d(pred_2d, width, height)

    iK = np.linalg.inv(K)
    new_3d = pred_3d[..., :3].copy()
    uv1 = np.concatenate([pred_2d[..., :2],
                          np.ones((*pred_2d.shape[:2], 1))], axis=-1)
    reproj = pred_3d[..., 2:3] * np.einsum("ij,pkj->pki", iK, uv1)
    score = pred_2d[..., 3]
    new_3d = np.where((score > 0)[..., None], reproj, new_3d)

    pose_3d_mm = new_3d * 10.0                          # cm -> mm
    vis = pred_3d[..., 3]
    return FramePrediction(
        pose_2d=reorder_to_test(pred_2d[..., :2]),
        pose_3d=reorder_to_test(pose_3d_mm),
        visibility=reorder_to_test(vis[..., None])[..., 0])


def intrinsics_from_gt(gt_3d: np.ndarray) -> np.ndarray:
    """K from the GT row layout [X, Y, Z, fx, fy, cx, cy]
    (convert.py:33-36 uses columns 3:7 of the 7-wide gt rows; the
    reference builds K with fx for both focal entries)."""
    intri = np.asarray(gt_3d, float)[0, 0, 3:7]
    return np.array([[intri[1], 0, intri[2]],
                     [0, intri[1], intri[3]],
                     [0, 0, 1]])


def results_to_predictions(result: Dict) -> Dict[str, FramePrediction]:
    """Full result dict -> {canonical image name: FramePrediction}."""
    out = {}
    for pair in result["3d_pairs"]:
        gt_3d = np.asarray(pair.get("gt_3d", []), float)
        if gt_3d.size:
            K = intrinsics_from_gt(gt_3d)
        else:
            ts, _ = parse_ts(pair["image_path"])
            w, h = sequence_resolution(ts)
            K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], float)
        _, name = parse_ts(pair["image_path"])
        out[name] = pair_to_prediction(pair, K)
    return out
