"""Label synthesis on the device: Gaussian heatmap pyramids, 3-channel
PAF (delta-Z) fields and sparse root-depth targets (counterpart of
``smap_tpu/data/labels.py``).

Every function takes one sample's tables or a batch of them (any leading
axes) and renders on the tables' device, vectorised over samples, persons,
limbs and pixels. The numerics are those of the JAX package:

* heatmaps: a delta at ``(int(y / s), int(x / s))`` for each joint with
  ``v >= 1`` (indices truncated towards zero; as in JAX, an index in
  ``[-size, 0)`` wraps to the far edge and anything else off the map is
  dropped), a separable Gaussian blur with REFLECT_101 borders, the peak
  normalised to 255;
* PAFs: per limb, the band of pixels within ``thre`` of the segment,
  inside its banker's-rounded bounding box, carries ``[ux * 127,
  uy * 127, delta-Z]``, averaged where persons overlap;
* root depth: rows ``(y / s, x / s, Z / (f * scale))`` sorted by depth,
  descending and stable, to ``max_people`` rows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from smap_tpu_torch.config import NUM_LIMBS, PAF_VECTOR, ROOT_IDX

# cv2.getGaussianKernel(k, 0) uses fixed binomial kernels for small sizes
# (OpenCV's small_gaussian_tab); larger sizes use the sigma-from-size rule.
_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([4, 14, 28, 36, 28, 14, 4], np.float32) / 128.0,
    9: np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], np.float32) / 256.0,
}


def _gaussian_kernel_1d(ksize: int) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, 0)`` as float32."""
    if ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, r: int, device: torch.device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` positions of a REFLECT_101
    padding (``jnp.pad(mode="reflect")``, any ``r``)."""
    i = np.abs(np.arange(-r, n + r))
    if n > 1:
        period = 2 * (n - 1)
        i = i % period
        i = np.where(i >= n, period - i, i)
    else:
        i = np.zeros_like(i)
    return torch.from_numpy(i).to(device)


def _blur_reflect(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of ``x [..., H, W]`` with REFLECT_101 borders, the
    taps summed in order as the JAX package sums them."""
    r = kernel.shape[0] // 2
    taps = [float(v) for v in kernel]
    h, w = x.shape[-2:]
    xp = x.index_select(-2, _reflect_index(h, r, x.device))
    x = sum(k * xp[..., i:i + h, :] for i, k in enumerate(taps))
    xp = x.index_select(-1, _reflect_index(w, r, x.device))
    return sum(k * xp[..., i:i + w] for i, k in enumerate(taps))


def synthesize_heatmaps(joints: torch.Tensor, vis: torch.Tensor,
                        out_shape: Tuple[int, int], stride: int,
                        kernels: Sequence[int]) -> torch.Tensor:
    """Heatmap pyramid.

    Args:
      joints: ``[..., P, J, 2]`` (x, y) at input resolution, float32.
      vis: ``[..., P, J]`` visibility (>= 1 marks labeled).
      kernels: one odd Gaussian size per pyramid level.

    Returns:
      ``[..., num_levels, H, W, J]`` float32, peak-normalized to 255.
    """
    h, w = out_shape
    lead = joints.shape[:-3]
    p, j = joints.shape[-3:-1]
    joints = joints.reshape(-1, p, j, 2)
    n = joints.shape[0]
    dev = joints.device
    xi = (joints[..., 0] / stride).to(torch.int64)     # trunc toward zero
    yi = (joints[..., 1] / stride).to(torch.int64)
    xi = torch.where(xi < 0, xi + w, xi)
    yi = torch.where(yi < 0, yi + h, yi)
    keep = ((vis.reshape(-1, p, j) >= 1) & (xi >= 0) & (xi < w)
            & (yi >= 0) & (yi < h))
    plane = (torch.arange(n, device=dev)[:, None, None] * j
             + torch.arange(j, device=dev)[None, None, :])
    flat = (plane * h + yi) * w + xi
    delta = torch.zeros(n * j * h * w, dtype=torch.float32, device=dev)
    delta[flat[keep]] = 1.0
    delta = delta.view(n, j, h, w)
    levels = []
    for ksize in kernels:
        hm = _blur_reflect(delta, _gaussian_kernel_1d(ksize))
        peak = hm.amax(dim=(-2, -1), keepdim=True)
        hm = torch.where(peak > 1e-8, hm * 255.0 / peak, hm)
        levels.append(hm.permute(0, 2, 3, 1))            # [N, H, W, J]
    return torch.stack(levels, 1).reshape(*lead, len(kernels), h, w, j)


_PAIRS = np.asarray(PAF_VECTOR)


def synthesize_pafs(joints_xyz: torch.Tensor, vis: torch.Tensor,
                    out_shape: Tuple[int, int], stride: int,
                    thre: float, min_vis: int) -> torch.Tensor:
    """3-channel-per-limb PAF field of one pyramid level.

    Args:
      joints_xyz: ``[..., P, J, 3]`` integer-valued (x, y, Z) at input
        resolution.
      vis: ``[..., P, J]`` visibility.
      thre: band half-width at output resolution.
      min_vis: 1, or 2 for wide bands on MDS-labeled data.

    Returns:
      ``[..., H, W, 3 * L]``; x / y channels scaled by 127.
    """
    h, w = out_shape
    lead = joints_xyz.shape[:-3]
    p, j = joints_xyz.shape[-3:-1]
    joints_xyz = joints_xyz.reshape(-1, p, j, 3)
    vis = vis.reshape(-1, p, j)
    dev = joints_xyz.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    src = torch.from_numpy(_PAIRS[:, 0]).to(dev)
    dst = torch.from_numpy(_PAIRS[:, 1]).to(dev)
    a = joints_xyz[:, :, src]                              # [N, P, L, 3]
    b = joints_xyz[:, :, dst]
    vis_ok = (vis[:, :, src] >= min_vis) & (vis[:, :, dst] >= min_vis)

    ax, ay = a[..., 0] / stride, a[..., 1] / stride        # [N, P, L]
    bx, by = b[..., 0] / stride, b[..., 1] / stride
    dz = b[..., 2] - a[..., 2]
    vx, vy = bx - ax, by - ay
    norm = torch.sqrt(vx * vx + vy * vy)
    limb_ok = vis_ok & (norm >= 1.0)
    inv = norm.clamp(min=1e-9)
    ux = torch.where(limb_ok, vx / inv, 0.0)
    uy = torch.where(limb_ok, vy / inv, 0.0)

    # Bounding box; torch.round rounds half to even, as jnp.round does.
    min_x = torch.round(torch.minimum(ax, bx) - thre).clamp(min=0)
    max_x = torch.round(torch.maximum(ax, bx) + thre).clamp(max=w)
    min_y = torch.round(torch.minimum(ay, by) - thre).clamp(min=0)
    max_y = torch.round(torch.maximum(ay, by) + thre).clamp(max=h)

    def e(t):   # [N, P, L] -> [N, P, L, 1, 1]
        return t[..., None, None]

    width = torch.abs((xs - e(ax)) * e(uy) - (ys - e(ay)) * e(ux))
    band = ((width < thre) & (xs >= e(min_x)) & (xs < e(max_x))
            & (ys >= e(min_y)) & (ys < e(max_y)) & e(limb_ok))
    bandf = band.to(torch.float32)                         # [N, P, L, H, W]
    denom = bandf.sum(1).clamp(min=1.0)                    # [N, L, H, W]
    per_limb = torch.stack([(bandf * e(t)).sum(1) / denom
                            for t in (ux, uy, dz)], 2)     # [N, L, 3, H, W]
    per_limb[:, :, :2] *= 127.0
    out = per_limb.reshape(-1, 3 * NUM_LIMBS, h, w).permute(0, 2, 3, 1)
    return out.reshape(*lead, h, w, 3 * NUM_LIMBS)


def synthesize_rdepth(bodys: torch.Tensor, scale: torch.Tensor, stride: int,
                      max_people: int) -> torch.Tensor:
    """Sparse root-depth targets.

    Args:
      bodys: ``[..., P, J, >=8]`` unified rows ``[x, y, Z, v, X, Y, Z, fx,
        ...]``.
      scale: ``[...]`` resize scale of each sample.

    Returns:
      ``[..., max_people, 3]`` rows ``(y / stride, x / stride,
      Z / (f * scale))`` sorted by descending depth (stable); padding rows
      are zero.
    """
    lead = bodys.shape[:-3]
    p = bodys.shape[-3]
    root = bodys.reshape(-1, p, *bodys.shape[-2:])[:, :, ROOT_IDX]
    scale = torch.as_tensor(scale, dtype=root.dtype,
                            device=root.device).reshape(-1, 1)
    ok = root[..., 3] >= 1
    rows = torch.stack([
        torch.where(ok, root[..., 1] / stride, 0.0),
        torch.where(ok, root[..., 0] / stride, 0.0),
        torch.where(ok, root[..., 2] / root[..., 7] / scale, 0.0),
    ], dim=-1)                                             # [N, P, 3]
    if p < max_people:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, max_people - p))
    else:
        rows = rows[:, :max_people]
    order = torch.argsort(-rows[..., 2], dim=1, stable=True)
    rows = torch.take_along_dim(rows, order[..., None], dim=1)
    return rows.reshape(*lead, max_people, 3)


def synthesize_labels(bodys: torch.Tensor, scale: torch.Tensor,
                      out_shape: Tuple[int, int], stride: int,
                      kernels: Sequence[int], paf_thre: float,
                      with_mds: bool, max_people: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full label stack.

    Args:
      bodys: ``[..., P, J, 11]`` float32 unified annotation rows
        (post-augmentation; invalid joints carry v = 0).
      scale: ``[...]`` resize scales.
      paf_thre: base line width (``TrainConfig.paf_line_width``).

    Returns:
      labels ``[..., num_levels, H, W, 57]`` and rdepth
      ``[..., max_people, 3]``.
    """
    joints = bodys[..., :2]
    vis = bodys[..., 3]
    heatmaps = synthesize_heatmaps(joints, vis, out_shape, stride, kernels)
    joints_int = torch.trunc(bodys[..., :3])
    pafs = []
    for i in range(len(kernels)):
        # Band width per level: max(1, 3 - i) * thre.
        thre_i = max(1, 3 - i) * paf_thre
        min_vis = 2 if (thre_i > 1 and with_mds) else 1
        pafs.append(synthesize_pafs(joints_int, vis, out_shape, stride,
                                    float(thre_i), min_vis))
    labels = torch.cat([heatmaps, torch.stack(pafs, -4)], dim=-1)
    rdepth = synthesize_rdepth(bodys, scale, stride, max_people)
    return labels, rdepth

