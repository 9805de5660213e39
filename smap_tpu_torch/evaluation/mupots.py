"""MuPoTS-3D evaluation protocol in Python, replacing the MATLAB harness
(counterpart of ``smap_tpu/evaluation/mupots.py``; numpy only).

Port of the reference's evaluation stack (``lib/eval/mupots_smap.m`` and
``lib/eval/util_smap/*.m`` in zju3dv/SMAP) so accuracy parity is
CI-checkable without MATLAB:

* joint reorder mpi15 -> MPI test order (mupots_smap.m:122-123);
* greedy GT->pred identity matching: per-coordinate 40px threshold over
  joints 2..14, max joint-count score
  (mpii_multiperson_get_identity_matching.m);
* optional skeleton rescaling of predictions to GT bone lengths along a
  safe traversal order (mpii_map_to_gt_bone_lengths.m, mupots_smap.m:29);
* PCK@150mm / AUC(0:5:150) over 8 joint groups, per-sequence MPJPE
  (mpii_compute_3d_pck.m, mpii_evaluate_multiperson_errors.m);
* pairwise root-depth ordinal accuracy @300mm (cal_ordinal.m,
  mupots_smap.m:210-221);
* PCK15 per-joint summary (mupots_smap.m:245-256).

All distances in millimeters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

# mpi15 (ours) -> MPI test order (mupots_smap.m:122, zero-based):
# [head, neck, rsho, relb, rwri, lsho, lelb, lwri, rhip, rknee, rankle,
#  lhip, lknee, lankle, pelvis]
MPI_TEST_ORDER = (1, 0, 9, 10, 11, 3, 4, 5, 12, 13, 14, 6, 7, 8, 2)

# Parent of each MPI-test joint (mpii_get_joints.m 'relevant' o1 restricted
# to 15 joints with o1[1]=pelvis, mupots_smap.m:16-17), zero-based.
MPI_TEST_PARENTS = (1, 14, 1, 2, 3, 1, 5, 6, 14, 8, 9, 14, 11, 12, 14)

# Order to rescale bones in (mupots_smap.m:29, minus the root), zero-based.
SAFE_TRAVERSAL_ORDER = (1, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)

JOINT_GROUPS = (  # mpii_get_pck_auc_joint_groups.m (zero-based test order)
    ("Head", (0,)),
    ("Neck", (1,)),
    ("Shou", (2, 5)),
    ("Elbow", (3, 6)),
    ("Wrist", (4, 7)),
    ("Hip", (8, 11)),
    ("Knee", (9, 12)),
    ("Ankle", (10, 13)),
)

MATCH_JOINTS = tuple(range(1, 14))    # matching_joints = 2:14 (1-based)
EVAL_JOINTS = tuple(range(14))        # eval_joints = 1:14 (pelvis excluded)
PCK_THRESHOLD_MM = 150.0
AUC_THRESHOLDS = tuple(np.arange(0, 151, 5, dtype=float))
ORDINAL_TOLERANCE_MM = 300.0
MATCH_PIXEL_THRESHOLD = 40.0
UNDETECTED_ERROR = 100000.0


def reorder_to_test(pose: np.ndarray) -> np.ndarray:
    """[P, 15, C] mpi15 order -> MPI test order."""
    return pose[:, list(MPI_TEST_ORDER)]


def match_people(gt_2d: Sequence[np.ndarray], gt_vis: Sequence[np.ndarray],
                 pred_2d: Sequence[np.ndarray],
                 pred_vis: Sequence[np.ndarray],
                 threshold: float = MATCH_PIXEL_THRESHOLD) -> np.ndarray:
    """Greedy GT-order matching (mpii_multiperson_get_identity_matching.m).

    Args:
      gt_2d / pred_2d: per-person [2, J] 2D joints (matching subset).
      gt_vis / pred_vis: per-person [J] visibility.

    Returns:
      matching: [num_gt] index into preds, or -1 if unmatched.
    """
    matching = np.full(len(gt_2d), -1, np.int64)
    matched = np.zeros(len(pred_2d), bool)
    for i in range(len(gt_2d)):
        scores = np.zeros(len(pred_2d))
        for j in range(len(pred_2d)):
            if matched[j]:
                continue
            diff = np.abs(gt_2d[i] - pred_2d[j])
            ok = (diff[0] < threshold) & (diff[1] < threshold)
            both = (gt_vis[i] != 0) & (pred_vis[j] != 0)
            scores[j] = np.sum(ok & both)
        if len(scores) and scores.max() > 0:
            j = int(np.argmax(scores))
            matching[i] = j
            matched[j] = True
    return matching


def map_to_gt_bone_lengths(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Rescale predicted bones to GT lengths (mpii_map_to_gt_bone_lengths.m).

    Args:
      pred / gt: [3, 15] in MPI test order.
    """
    mapped = pred.copy()
    for idx in SAFE_TRAVERSAL_ORDER:
        parent = MPI_TEST_PARENTS[idx]
        gt_len = np.linalg.norm(gt[:, idx] - gt[:, parent])
        vec = pred[:, idx] - pred[:, parent]
        norm = np.linalg.norm(vec)
        with np.errstate(invalid="ignore", divide="ignore"):
            vec = vec * gt_len / norm
        mapped[:, idx] = mapped[:, parent] + vec
    return mapped


def cal_ordinal(pd1: float, pd2: float, gt1: float, gt2: float,
                thres: float = ORDINAL_TOLERANCE_MM) -> int:
    """Pairwise depth-order agreement (cal_ordinal.m, active branch)."""
    if (gt1 - gt2) * (pd1 - pd2) > 0:
        return 1
    if abs(gt1 - gt2) < thres and abs(pd1 - pd2) < thres:
        return 0
    return -1


@dataclasses.dataclass
class FrameAnnotation:
    """One frame's GT: lists over valid annotated persons.

    annot2: [2, 15] pixel 2D (MPI test order).
    univ_annot3: [3, 15] universal 3D mm (MPI test order).
    occlusion: [15] binary occlusion labels.
    """

    annot2: List[np.ndarray]
    univ_annot3: List[np.ndarray]
    occlusion: List[np.ndarray]


@dataclasses.dataclass
class FramePrediction:
    """One frame's predictions in MPI test order.

    pose_2d: [P, 15, 2] pixels; pose_3d: [P, 15, 3] mm;
    visibility: [P, 15] (score>0).
    """

    pose_2d: np.ndarray
    pose_3d: np.ndarray
    visibility: np.ndarray


@dataclasses.dataclass
class SequenceResult:
    per_joint_error: np.ndarray        # [15, N] mm
    visibility_mask: np.ndarray        # [15, N]
    occlusion_mask: np.ndarray         # [15, N]
    undetected: int
    annotated: int
    correct_ordinal: int
    total_ordinal: int


def evaluate_sequence(frames_gt: Sequence[FrameAnnotation],
                      frames_pred: Sequence[FramePrediction], *,
                      is_relative: bool = True, use_skel: bool = True,
                      eval_mode: int = 0) -> SequenceResult:
    """Evaluate one test sequence (mupots_smap.m:77-223)."""
    errors, vis_masks, occ_masks = [], [], []
    undetected = annotated = correct_ordinal = total_ordinal = 0
    for gt, pred in zip(frames_gt, frames_pred):
        n_gt = len(gt.annot2)
        annotated += n_gt
        if n_gt == 0:
            continue
        gt2 = [a[:, list(MATCH_JOINTS)] for a in gt.annot2]
        gtv = [np.ones(len(MATCH_JOINTS)) for _ in gt.annot2]
        p2 = [pred.pose_2d[k].T[:, list(MATCH_JOINTS)]
              for k in range(len(pred.pose_2d))]
        pv = [~((p[0] == 0) & (p[1] == 0)) for p in p2]
        p3 = []
        for k in range(len(pred.pose_3d)):
            pose = pred.pose_3d[k].T.astype(float)          # [3, 15]
            if is_relative:
                pose = pose - pose[:, 14:15]
            p3.append(pose)

        matching = match_people(gt2, gtv, p2, pv)
        undetected += int(np.sum(matching < 0))

        pred_rt_z, gt_rt_z = [], []
        for k in range(n_gt):
            P = gt.univ_annot3[k].astype(float)
            if is_relative:
                P = P - P[:, 14:15]
            considered = False
            if matching[k] >= 0:
                pred_p = p3[matching[k]]
                if use_skel:
                    pred_p = map_to_gt_bone_lengths(pred_p, P)
                considered = True
            else:
                pred_p = np.full_like(P, UNDETECTED_ERROR)
                considered = eval_mode == 0
            if considered:
                if not is_relative:
                    pred_rt_z.append(pred_p[2, 14])
                    gt_rt_z.append(P[2, 14])
                err = np.sqrt(np.sum((pred_p - P) ** 2, axis=0))
                errors.append(err)
                occ_masks.append(np.asarray(gt.occlusion[k], float))
                vis_masks.append(1 - np.asarray(gt.occlusion[k], float))
        for a in range(len(pred_rt_z) - 1):
            for b in range(a + 1, len(pred_rt_z)):
                ordi = cal_ordinal(pred_rt_z[b], pred_rt_z[a],
                                   gt_rt_z[b], gt_rt_z[a])
                if ordi >= 0:
                    correct_ordinal += 1
                total_ordinal += 1
    stack = (np.stack(errors, -1) if errors else np.zeros((15, 0)))
    vstack = (np.stack(vis_masks, -1) if vis_masks else np.zeros((15, 0)))
    ostack = (np.stack(occ_masks, -1) if occ_masks else np.zeros((15, 0)))
    return SequenceResult(stack, vstack, ostack, undetected, annotated,
                          correct_ordinal, total_ordinal)


def compute_pck_auc(errors: np.ndarray) -> Dict[str, Dict[str, float]]:
    """PCK@150 / AUC per joint group + totals (mpii_compute_3d_pck.m).

    Args:
      errors: [14, N] per-joint errors over all considered persons
        (eval joints only).
    """
    n = errors.shape[1]
    out = {"pck": {}, "auc": {}}
    total_pck = total_curve = 0.0
    joint_count = 0
    for name, joints in JOINT_GROUPS:
        idx = [j for j in joints]
        sub = errors[idx]
        curve = np.array([np.mean(sub < t) if n else 0.0
                          for t in AUC_THRESHOLDS])
        pck = 100.0 * (np.mean(sub < PCK_THRESHOLD_MM) if n else 0.0)
        out["pck"][name] = pck
        out["auc"][name] = 100.0 * curve.mean()
        total_pck += pck * len(idx)
        total_curve += curve * len(idx)
        joint_count += len(idx)
    out["pck"]["Total"] = total_pck / joint_count
    out["auc"]["Total"] = 100.0 * float((total_curve / joint_count).mean())
    return out


@dataclasses.dataclass
class MupotsMetrics:
    pck: Dict[str, float]
    auc: Dict[str, float]
    mpjpe_per_sequence: List[float]
    mpjpe: float
    ordinal_accuracy: float
    pck15_per_joint: np.ndarray
    undetected_rate: float


def compute_masked_pck_auc(results: Sequence["SequenceResult"],
                           use_occluded: bool = False
                           ) -> Dict[str, Dict[str, float]]:
    """PCK/AUC restricted to visible (or occluded) joints
    (mpii_evaluate_multiperson_errors_visibility_mask.m). Masked-out
    entries are treated as errors above every threshold."""
    errs, masks = [], []
    for r in results:
        errs.append(r.per_joint_error)
        masks.append(r.occlusion_mask if use_occluded else r.visibility_mask)
    all_err = np.concatenate(errs, axis=1)[list(EVAL_JOINTS)]
    all_mask = np.concatenate(masks, axis=1)[list(EVAL_JOINTS)]
    masked = np.where(all_mask > 0, all_err, np.inf)
    return compute_pck_auc(masked)


def aggregate(results: Sequence[SequenceResult]) -> MupotsMetrics:
    """Aggregate sequence results into headline metrics
    (mupots_smap.m:232-256 + mpii_evaluate_multiperson_errors.m)."""
    all_err = np.concatenate([r.per_joint_error for r in results], axis=1)
    eval_err = all_err[list(EVAL_JOINTS)]
    tables = compute_pck_auc(eval_err)

    mpjpe_seq = []
    for r in results:
        e = r.per_joint_error[list(EVAL_JOINTS)]
        mpjpe_seq.append(float(e.mean()) if e.size else float("nan"))
    mpjpe = float(np.nanmean(mpjpe_seq))

    rates = [r.correct_ordinal / r.total_ordinal for r in results
             if r.total_ordinal > 0]
    ordinal = float(np.mean(rates)) if rates else float("nan")

    count = all_err.shape[1]
    pck15 = (np.sum(all_err <= PCK_THRESHOLD_MM, axis=1) / count
             if count else np.zeros(15))

    undetected = sum(r.undetected for r in results)
    annotated = sum(r.annotated for r in results)
    return MupotsMetrics(
        pck=tables["pck"], auc=tables["auc"], mpjpe_per_sequence=mpjpe_seq,
        mpjpe=mpjpe, ordinal_accuracy=ordinal, pck15_per_joint=pck15,
        undetected_rate=undetected / max(annotated, 1))
