"""MuPoTS-3D ground-truth loading, annot.mat / occlusion.mat (counterpart
of ``smap_tpu/evaluation/mupots_data.py``; numpy and scipy only).

Replaces the MATLAB-side data access of the reference harness
(``lib/eval/mupots_smap.m:48-62`` in zju3dv/SMAP): per test sequence TS1-20,
``annot.mat`` holds a [num_frames, num_subjects] cell array of structs with
``annot2`` [2, J], ``univ_annot3`` [3, J] and ``isValidFrame``;
``occlusion.mat`` holds per-joint occlusion labels. Joints are truncated to
the first 15 (MPI test order).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from smap_tpu_torch.evaluation.mupots import FrameAnnotation


def _struct_record(cell):
    """Normalize one MATLAB cell entry to a numpy struct record.

    scipy.io.loadmat's shape for a cell-of-structs depends on how the file
    was written and loaded: the canonical MuPoTS layout is an object cell
    whose entries are 1x1 struct arrays (``cell[0, 0]`` is the record),
    but squeeze_me=True round-trips, savemat-written fixtures and
    cell-of-cell nesting all squeeze or wrap differently. Unwrap object
    nesting and leading singleton dims until the record itself surfaces.
    """
    rec = np.asarray(cell)
    while rec.dtype == object:
        if rec.size < 1:
            raise ValueError("empty MATLAB cell where a struct was expected")
        rec = np.asarray(rec.reshape(-1)[0])
    if rec.dtype.names is None:
        raise ValueError(
            f"MATLAB cell entry is not a struct (dtype {rec.dtype})")
    if rec.ndim:
        rec = rec.reshape(-1)[0]
    return rec


def _dense(value) -> np.ndarray:
    """Unwrap object-array nesting around a numeric MATLAB field."""
    a = np.asarray(value)
    while a.dtype == object:
        if a.size < 1:
            return np.zeros((0,))
        a = np.asarray(a.reshape(-1)[0])
    return a


def load_sequence(seq_dir: str) -> List[FrameAnnotation]:
    """Load one TS directory into per-frame annotations (valid persons only)."""
    import scipy.io as sio

    annot = sio.loadmat(os.path.join(seq_dir, "annot.mat"))["annotations"]
    occl = sio.loadmat(os.path.join(seq_dir, "occlusion.mat"))[
        "occlusion_labels"]
    annot = np.atleast_2d(np.asarray(annot))
    occl = np.atleast_2d(np.asarray(occl))
    num_frames, num_subjects = annot.shape
    frames = []
    for i in range(num_frames):
        a2, a3, oc = [], [], []
        for k in range(num_subjects):
            rec = _struct_record(annot[i, k])
            valid = int(np.squeeze(_dense(rec["isValidFrame"])))
            if not valid:
                continue
            a2.append(np.asarray(_dense(rec["annot2"]), float)[:, :15])
            a3.append(np.asarray(_dense(rec["univ_annot3"]), float)[:, :15])
            oc.append(np.asarray(_dense(occl[i, k]),
                                 float).reshape(-1)[:15])
        frames.append(FrameAnnotation(annot2=a2, univ_annot3=a3,
                                      occlusion=oc))
    return frames


def load_mupots(base_dir: str, sequences=None
                ) -> Dict[int, List[FrameAnnotation]]:
    """Load TS sequences from a MultiPersonTestSet root (all present by
    default)."""
    if sequences is None:
        sequences = [ts for ts in range(1, 21)
                     if os.path.isdir(os.path.join(base_dir, f"TS{ts}"))]
    return {ts: load_sequence(os.path.join(base_dir, f"TS{ts}"))
            for ts in sequences}


def evaluate_results(result_json_path: str, mupots_dir: str, *,
                     is_relative: bool = True, use_skel: bool = True,
                     eval_mode: int = 0):
    """Full pipeline: result JSON -> MuPoTS metrics (as mupots_smap.m runs it).

    Returns smap_tpu_torch.evaluation.mupots.MupotsMetrics.
    """
    import json

    from smap_tpu_torch.evaluation.convert import results_to_predictions
    from smap_tpu_torch.evaluation.mupots import (FramePrediction, aggregate,
                                            evaluate_sequence)

    with open(result_json_path) as f:
        result = json.load(f)
    preds = results_to_predictions(result)
    gt = load_mupots(mupots_dir)

    results = []
    for ts, frames in gt.items():
        frame_preds = []
        for i in range(len(frames)):
            name = f"TS{ts}/img_{i:06d}.jpg"
            if name in preds:
                frame_preds.append(preds[name])
            else:
                frame_preds.append(FramePrediction(
                    pose_2d=np.zeros((0, 15, 2)),
                    pose_3d=np.zeros((0, 15, 3)),
                    visibility=np.zeros((0, 15))))
        results.append(evaluate_sequence(frames, frame_preds,
                                         is_relative=is_relative,
                                         use_skel=use_skel,
                                         eval_mode=eval_mode))
    return aggregate(results)
