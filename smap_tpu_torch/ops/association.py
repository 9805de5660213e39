"""Depth-aware greedy skeleton association (counterpart of
``smap_tpu/ops/association.py``), over a batch of images.

1. Every root (pelvis) peak seeds a person; persons are ordered by the
   root-depth map read at the truncated peak coordinates, nearest first.
2. Limbs run in the order [1, 0, 2, 3, ...]; with the pelvis as root,
   limb 1 (neck -> pelvis) runs flipped.
3. Per limb, persons pick greedily, nearest first, the unused dst peak
   that maximizes paf_score + min(1.2 * bone_len / root_depth / limb_dist
   / 4 - 1, 0); a pick needs a score strictly > 0.

On a CUDA tensor the whole of it is one launch of ``associate_kernel``
(``smap_tpu_torch/csrc/associate.cu``), which runs the limbs by waves
(:func:`limb_waves`); on a CPU tensor, and with ``plain=True`` on any
device, it is :func:`associate_plain`, a loop over the limbs around the
greedy :func:`associate_limb_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
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


def _limb_edges(root_idx: int) -> Tuple[Tuple[int, int, int, bool], ...]:
    """(limb, src joint, dst joint, flip) in the greedy's limb order."""
    edges = []
    for limb in _limb_order(NUM_LIMBS):
        flip = root_idx == 2 and limb == 1
        src, dst = PAF_VECTOR[limb][::-1] if flip else PAF_VECTOR[limb]
        edges.append((limb, src, dst, flip))
    return tuple(edges)


def limb_waves(root_idx: int = 2) -> Tuple[Tuple[int, ...], ...]:
    """The limbs in waves whose greedies do not depend on each other.

    Limb l reads only its src joint's column of the bodies / remap state
    and writes only its dst joint's. When every dst is unique and not the
    root, and every src is the root or the dst of an earlier limb in the
    order, the limbs form a tree: a limb's wave is one more than that of
    the limb that writes its src (the root's is 0). Running the waves in
    order, the limbs of each wave in any order, gives the sequential
    result bit for bit. Raises ValueError for a root whose limbs do not
    form such a tree.
    """
    wave_of = {root_idx: 0}
    waves = []
    for limb, src, dst, _ in _limb_edges(root_idx):
        if dst in wave_of:
            raise ValueError(f"root {root_idx}: limb {limb} writes joint "
                             f"{dst}, which is the root or written before")
        if src not in wave_of:
            raise ValueError(f"root {root_idx}: limb {limb} reads joint "
                             f"{src} before any limb writes it")
        wave_of[dst] = wave_of[src] + 1
        if wave_of[dst] > len(waves):
            waves.append([])
        waves[wave_of[dst] - 1].append(limb)
    return tuple(tuple(w) for w in waves)


class KernelPlan(NamedTuple):
    """What ``associate_kernel`` gets from the host besides the data.

    steps: [L, 4] int32 (limb, src joint, dst joint, flip), wave by wave.
    wave_starts: [n_waves + 1] int32, the first row of each wave in steps.
    max_wave: the most limbs in one wave.
    bone: [L] float32, ``bone_factor * bone_length`` per limb, rounded to
      float32 as the plain version's product is.
    inv_ds_scale: float32 ``1 / ds_scale``; PyTorch divides a CUDA tensor
      by a Python scalar as a product with its reciprocal.
    """

    steps: torch.Tensor
    wave_starts: torch.Tensor
    max_wave: int
    bone: torch.Tensor
    inv_ds_scale: float


@functools.lru_cache(maxsize=None)
def kernel_plan(root_idx: int, bone_factor: float, ds_scale: float,
                device: torch.device) -> KernelPlan:
    """The kernel's plan for this root on ``device`` (made once)."""
    edges = {e[0]: e for e in _limb_edges(root_idx)}
    waves = limb_waves(root_idx)
    steps = tuple(tuple(int(v) for v in edges[limb])
                  for wave in waves for limb in wave)
    starts = tuple(int(v) for v in np.cumsum([0] + [len(w) for w in waves]))
    bone = np.float32(bone_factor) * np.asarray(BONE_LENGTHS, np.float32)
    return KernelPlan(
        steps=device_constant(steps, torch.int32, device),
        wave_starts=device_constant(starts, torch.int32, device),
        max_wave=max(len(w) for w in waves),
        bone=device_constant(tuple(bone.tolist()), torch.float32, device),
        inv_ds_scale=float(np.float32(1.0) / np.float32(ds_scale)))


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


def associate(peaks: Peaks, paf_score_table: torch.Tensor,
              root_depth_map: torch.Tensor, *, root_idx: int = 2,
              ds_scale: float = 4.0,
              bone_factor: float = 1.2, plain: bool = False) -> Bodies:
    """Greedy depth-aware association for a batch.

    Args:
      peaks: xy [B, J, K, 2], score [B, J, K], count [B, J].
      paf_score_table: [B, L, K, K] from ``paf_scores``.
      root_depth_map: [B, H, W] normalized root-depth map.
      plain: run the plain version whatever the device.

    Returns:
      Bodies with capacity K; rows >= count are all zero.
    """
    if plain or peaks.xy.device.type == "cpu":
        return associate_plain(peaks, paf_score_table, root_depth_map,
                               root_idx=root_idx, ds_scale=ds_scale,
                               bone_factor=bone_factor)
    plan = kernel_plan(root_idx, bone_factor, ds_scale, peaks.xy.device)
    joints, root_depth = kernels.associate(
        peaks.xy, peaks.score, peaks.count, paf_score_table,
        root_depth_map.contiguous(), plan.steps, plan.wave_starts, plan.bone,
        root_idx=root_idx, max_wave=plan.max_wave,
        inv_ds_scale=plan.inv_ds_scale)
    return Bodies(joints=joints, count=peaks.count[:, root_idx],
                  root_depth=root_depth)


def associate_plain(peaks: Peaks, paf_score_table: torch.Tensor,
                    root_depth_map: torch.Tensor, *, root_idx: int = 2,
                    ds_scale: float = 4.0,
                    bone_factor: float = 1.2) -> Bodies:
    """Plain PyTorch association: :func:`associate`'s arguments and result,
    the limbs one after the other in the order [1, 0, 2, ...]."""
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

    for limb, src_joint, dst_joint, flip in _limb_edges(root_idx):
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

        assign = associate_limb_plain(scores_all, dst_slot_valid)
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
