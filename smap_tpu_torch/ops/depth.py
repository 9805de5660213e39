"""Relative-depth readout along limbs, depth chaining and back-projection
to absolute 3D (counterpart of ``smap_tpu/ops/depth.py``), over a batch.

The maps are read by direct indexing at ``coord // stride``: that equals
reading the nearest-neighbour upsampled map without building it.
"""

from __future__ import annotations

import torch

from smap_tpu_torch.camera import back_project
from smap_tpu_torch.config import NUM_LIMBS, PAF_VECTOR
from smap_tpu_torch.runtime import device_constant


def _read_maps(maps: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               stride: int) -> torch.Tensor:
    """``maps[..., y // stride, x // stride]`` for ``maps`` [B, C, H, W]
    and coords [B, C, N] (or ``maps`` [B, H, W] and coords [B, N])."""
    h, w = maps.shape[-2], maps.shape[-1]
    xi = torch.clamp(x.to(torch.int32) // stride, 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32) // stride, 0, h - 1).long()
    flat = maps.reshape(*maps.shape[:-2], h * w)
    return torch.gather(flat, -1, yi * w + xi)


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: float32 ``i * (1 / (n - 1))``
    with the end point exact. (``torch.linspace`` rounds differently for
    some ``n``, e.g. 7.)"""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    t = torch.arange(n, dtype=torch.float32) * step
    t[-1] = 1.0
    return t.to(device)


def read_limb_depths(bodies_2d: torch.Tensor, paf_z: torch.Tensor, *,
                     stride: int = 4, num_samples: int = 10,
                     root_idx: int = 2) -> torch.Tensor:
    """Per-limb delta-Z: the mean of ``num_samples`` readings along the
    limb, clipped to their linear [10th, 90th] percentiles.

    Args:
      bodies_2d: [B, P, J, 4] skeletons at input resolution.
      paf_z: [B, L, Ho, Wo] delta-Z maps at output resolution.

    Returns:
      [B, P, L] (0 where the limb or the person is missing).
    """
    src_j = [a for a, _ in PAF_VECTOR]
    dst_j = [b for _, b in PAF_VECTOR]
    src = bodies_2d[:, :, src_j]                  # [B, P, L, 4]
    dst = bodies_2d[:, :, dst_j]
    limb_ok = (src[..., 3] > 0) & (dst[..., 3] > 0)
    person_ok = bodies_2d[:, :, root_idx, 3] > 0  # [B, P]

    # np.round(np.linspace(a, b, n)): round half to even, at the sample
    # positions of jnp.linspace(0, 1, n) (iota * float32(1 / (n - 1))).
    t = _linspace01(num_samples, bodies_2d.device)
    xs = torch.round(src[..., 0:1] * (1 - t) + dst[..., 0:1] * t)
    ys = torch.round(src[..., 1:2] * (1 - t) + dst[..., 1:2] * t)

    B, P, L, S = xs.shape

    def per_limb(c):   # [B, P, L, S] -> [B, L, P*S]: limb l reads map l
        return c.permute(0, 2, 1, 3).reshape(B, L, P * S)

    vals = _read_maps(paf_z, per_limb(xs), per_limb(ys), stride)
    vals = vals.reshape(B, L, P, S).permute(0, 2, 1, 3)        # [B, P, L, S]

    q = device_constant((0.1, 0.9), torch.float32, vals.device)
    lo, hi = torch.quantile(vals, q, dim=-1, keepdim=True)
    mean = torch.clamp(vals, lo, hi).mean(-1)
    return torch.where(limb_ok & person_ok[..., None], mean,
                       torch.zeros((), device=vals.device))


def chain_depths(depth_v: torch.Tensor, *, root_idx: int = 2,
                 num_joints: int = 15) -> torch.Tensor:
    """Chain per-limb delta-Z ``[..., L]`` into root-relative joint depth
    ``[..., J]`` (root joint 0); ``root_idx`` 2 (pelvis) or 0 (neck)."""
    cols = [torch.zeros_like(depth_v[..., 0])] * num_joints
    if root_idx == 2:
        cols[0] = -depth_v[..., 1]
        cols[1] = cols[0] + depth_v[..., 0]
        start = 2
    else:
        cols[1] = depth_v[..., 0]
        start = 1
    for k in range(start, NUM_LIMBS):
        s, d = PAF_VECTOR[k]
        cols[d] = cols[s] + depth_v[..., k]
    return torch.stack(cols, dim=-1)


def root_depths(bodies_2d: torch.Tensor, root_d_map: torch.Tensor, *,
                scale: torch.Tensor, f_x: torch.Tensor, stride: int = 4,
                root_idx: int = 2) -> torch.Tensor:
    """Absolute root depth ``[B, P]``: the root-depth map ``[B, Ho, Wo]``
    at the root pixel x focal x resize scale (``scale``, ``f_x``: [B])."""
    x = bodies_2d[:, :, root_idx, 0]
    y = bodies_2d[:, :, root_idx, 1]
    vals = _read_maps(root_d_map, x, y, stride)
    ok = bodies_2d[:, :, root_idx, 3] > 0
    return torch.where(ok, vals * scale[:, None] * f_x[:, None],
                       torch.zeros((), device=vals.device))


def back_project_bodies(bodies_2d: torch.Tensor, rel_z: torch.Tensor,
                        root_depth: torch.Tensor, K: torch.Tensor, *,
                        scale: torch.Tensor, net_w: float, net_h: float,
                        img_w: torch.Tensor, img_h: torch.Tensor,
                        root_idx: int = 2) -> torch.Tensor:
    """Un-letterbox and back-project ``[B, P, J, 4]`` skeletons with
    per-image intrinsics ``K`` [B, 3, 3] and metadata [B].

    Returns [B, P, J, 4] = (X, Y, Z, score); missing joints are zero.
    """
    s = scale[:, None, None]
    x = bodies_2d[..., 0] / s - (net_w / s - img_w[:, None, None]) / 2.0
    y = bodies_2d[..., 1] / s - (net_h / s - img_h[:, None, None]) / 2.0
    depth = rel_z + root_depth[..., None]
    pts = back_project(torch.stack([x, y], dim=-1), depth,
                       K[:, None, None])                       # [B,P,J,3]
    score = bodies_2d[..., 3]
    person_ok = score[..., root_idx:root_idx + 1] > 0
    joint_ok = (score > 0) & person_ok
    zero = torch.zeros((), device=pts.device)
    pts = torch.where(joint_ok[..., None], pts, zero)
    return torch.cat([pts, torch.where(joint_ok, score, zero)[..., None]],
                     dim=-1)
