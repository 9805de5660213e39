"""Depth-aware greedy skeleton association (counterpart of
``smap_tpu/ops/association.py``), over a batch of images.

1. Every root (pelvis) peak seeds a person; persons are ordered by the
   root-depth map read at the truncated peak coordinates, nearest first.
2. Limbs run in the order [1, 0, 2, 3, ...]; with the pelvis as root,
   limb 1 (neck -> pelvis) runs flipped.
3. Per limb, persons pick greedily, nearest first, the unused dst peak
   that maximizes paf_score + min(1.2 * bone_len / root_depth / limb_dist
   / 4 - 1, 0); a pick needs a score strictly > 0.

The per-limb score adjustment is plain PyTorch; the greedy itself is
``associate_limb_kernel`` (``smap_tpu_torch/csrc/associate_limb.cu``) on a
CUDA tensor and :func:`associate_limb_plain` on a CPU tensor, so a batch
takes 14 launches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from smap_tpu_torch.config import BONE_LENGTHS, NUM_LIMBS, PAF_VECTOR
from smap_tpu_torch.ops import kernels
from smap_tpu_torch.ops.nms import Peaks
from smap_tpu_torch.runtime import device_constant


class Bodies(NamedTuple):
    """Assembled 2D skeletons at output-map resolution.

    joints: [B, P, J, 4] = (x, y, 0, score); score 0 marks a missing joint.
    count: [B] number of persons (root peaks).
    root_depth: [B, P] normalized root depth per person, ascending.
    """

    joints: torch.Tensor
    count: torch.Tensor
    root_depth: torch.Tensor


def _limb_order(num_limbs: int) -> Tuple[int, ...]:
    order = list(range(num_limbs))
    order[0], order[1] = 1, 0
    return tuple(order)


def associate_limb_plain(scores_all: torch.Tensor,
                         dst_slot_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch greedy: a loop over person rows, batched over images.

    scores_all [B, K, K] f32, dst_slot_valid [B, K] bool -> [B, K] int32
    chosen dst peak per person, -1 = none. ``argmax`` takes the first
    maximum (and NaN as the maximum), as the kernel does.
    """
    B, K = scores_all.shape[0], scores_all.shape[1]
    dev = scores_all.device
    rows = torch.arange(B, device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)
    used = torch.zeros((B, K), dtype=torch.bool, device=dev)
    assign = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    blocked_base = ~dst_slot_valid
    for k1 in range(K):
        s = torch.where(used | blocked_base, neg_inf, scores_all[:, k1])
        best_idx = torch.argmax(s, dim=1)
        take = s[rows, best_idx] > 0.0
        assign[:, k1] = torch.where(take, best_idx.to(torch.int32),
                                    assign[:, k1])
        used[rows, best_idx] |= take
    return assign


def associate_limb(scores_all: torch.Tensor, dst_slot_valid: torch.Tensor,
                   *, plain: bool = False) -> torch.Tensor:
    """Per-limb greedy: the kernel on CUDA, the plain loop on the CPU (or
    anywhere with ``plain=True``)."""
    if plain or scores_all.device.type == "cpu":
        return associate_limb_plain(scores_all, dst_slot_valid)
    return kernels.associate_limb(scores_all, dst_slot_valid)


def associate(peaks: Peaks, paf_score_table: torch.Tensor,
              root_depth_map: torch.Tensor, *, root_idx: int = 2,
              ds_scale: float = 4.0,
              bone_factor: float = 1.2, plain: bool = False) -> Bodies:
    """Greedy depth-aware association for a batch.

    Args:
      peaks: xy [B, J, K, 2], score [B, J, K], count [B, J].
      paf_score_table: [B, L, K, K] from ``paf_scores``.
      root_depth_map: [B, H, W] normalized root-depth map.
      plain: run the greedy's plain version whatever the device.

    Returns:
      Bodies with capacity K; rows >= count are all zero.
    """
    B, num_joints, K = peaks.xy.shape[0], peaks.xy.shape[1], peaks.xy.shape[2]
    dev = peaks.xy.device
    h, w = root_depth_map.shape[-2], root_depth_map.shape[-1]
    bone_lengths = device_constant(BONE_LENGTHS, torch.float32, dev)
    rows = torch.arange(B, device=dev)[:, None]
    slots = torch.arange(K, device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)

    person_num = peaks.count[:, root_idx]                      # [B]
    person_valid = slots[None, :] < person_num[:, None]        # [B, K]

    # Root depth per root peak, read at the truncated coordinates.
    root_xy = peaks.xy[:, root_idx]                            # [B, K, 2]
    rx = torch.clamp(root_xy[..., 0].to(torch.int32), 0, w - 1).long()
    ry = torch.clamp(root_xy[..., 1].to(torch.int32), 0, h - 1).long()
    root_depth = root_depth_map[rows, ry, rx]                  # [B, K]

    sort_key = torch.where(person_valid, root_depth,
                           torch.full((), float("inf"), device=dev))
    sorted_depth, sort_index = torch.sort(sort_key, dim=1, stable=True)

    # remap[b, j, p] = peak index of joint j for person p.
    remap = slots.to(torch.int64).repeat(B, num_joints, 1)
    remap[:, root_idx] = sort_index

    bodies = torch.zeros((B, K, num_joints, 4), dtype=torch.float32,
                         device=dev)
    sorted_root_xy = root_xy[rows, sort_index]                 # [B, K, 2]
    sorted_root_sc = peaks.score[:, root_idx][rows, sort_index]
    bodies[:, :, root_idx, 0] = torch.where(person_valid,
                                            sorted_root_xy[..., 0], zero)
    bodies[:, :, root_idx, 1] = torch.where(person_valid,
                                            sorted_root_xy[..., 1], zero)
    bodies[:, :, root_idx, 3] = torch.where(person_valid, sorted_root_sc,
                                            zero)

    for limb in _limb_order(NUM_LIMBS):
        flip = root_idx == 2 and limb == 1
        src_joint, dst_joint = PAF_VECTOR[limb][::-1] if flip else (
            PAF_VECTOR[limb])

        dst_size = peaks.count[:, dst_joint]                   # [B]
        dst_xy = peaks.xy[:, dst_joint]                        # [B, K, 2]
        dst_score = peaks.score[:, dst_joint]                  # [B, K]
        table = paf_score_table[:, limb]
        if flip:
            table = table.transpose(1, 2)                      # [src, dst]
        dst_slot_valid = slots[None, :] < dst_size[:, None]    # [B, K]

        src = bodies[:, :, src_joint]                          # [B, K, 4]
        src_ok = (src[..., 3] >= 1e-5) & person_valid
        # Person rows: table[remap_src[p]].
        scores_all = table[rows, remap[:, src_joint]]          # [B, K, K]
        dx = src[..., 0:1] - dst_xy[:, None, :, 0]
        dy = src[..., 1:2] - dst_xy[:, None, :, 1]
        limb_dist = torch.sqrt(dx * dx + dy * dy)              # [B, K, K]
        bone_dist = (bone_factor * bone_lengths[limb]
                     / sorted_depth)[..., None]                # [B, K, 1]
        penalty = torch.clamp(bone_dist / limb_dist / ds_scale - 1.0,
                              max=0.0)
        scores_all = torch.where(scores_all > 0, scores_all + penalty,
                                 scores_all)
        scores_all = torch.where(dst_slot_valid[:, None, :], scores_all,
                                 neg_inf)
        # Persons whose src joint is missing never take.
        scores_all = torch.where(src_ok[..., None], scores_all,
                                 neg_inf).contiguous()

        assign = associate_limb(scores_all, dst_slot_valid, plain=plain)
        take = (assign >= 0) & (dst_size > 0)[:, None]         # [B, K]
        max_idx = torch.clamp(assign, 0, K - 1).long()

        picked_xy = dst_xy[rows, max_idx]                      # [B, K, 2]
        picked_sc = dst_score[rows, max_idx]
        new_joints = torch.stack([picked_xy[..., 0], picked_xy[..., 1],
                                  torch.zeros_like(picked_sc), picked_sc],
                                 dim=-1)
        bodies[:, :, dst_joint] = torch.where(take[..., None], new_joints,
                                              bodies[:, :, dst_joint])
        remap[:, dst_joint] = torch.where(take, max_idx,
                                          remap[:, dst_joint])

    return Bodies(joints=bodies, count=person_num,
                  root_depth=torch.where(person_valid, sorted_depth, zero))
