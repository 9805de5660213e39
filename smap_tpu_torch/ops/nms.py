"""Peak extraction: strict 3x3 local-max NMS, the first ``max_peaks`` peaks
in raster order, and the 7x7 score-weighted sub-pixel refinement
(counterpart of ``smap_tpu/ops/nms.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Peaks(NamedTuple):
    """Fixed-capacity peak tables.

    xy: [..., K, 2] refined (x, y); score: [..., K] heatmap value at the
    peak pixel; count: [...] int32 number of valid peaks. Slots beyond
    ``count`` hold zeros.
    """

    xy: torch.Tensor
    score: torch.Tensor
    count: torch.Tensor


def _local_max_mask(hm: torch.Tensor, threshold: float) -> torch.Tensor:
    """Strict 3x3 local max above ``threshold`` on ``[..., H, W]``; border
    rows and columns excluded."""
    h, w = hm.shape[-2], hm.shape[-1]
    padded = F.pad(hm, (1, 1, 1, 1), value=float("-inf"))
    mask = hm > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                mask &= hm > padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    border = torch.zeros((h, w), dtype=torch.bool, device=hm.device)
    border[1:-1, 1:-1] = True
    return mask & border


def _box_sum_7x7(x: torch.Tensor) -> torch.Tensor:
    """7x7 window sums of ``[..., H, W]`` with zero padding (separable,
    sums of shifted slices)."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, 3, 3))
    y = xp[..., 0:h, :]
    for d in range(1, 7):
        y = y + xp[..., d:d + h, :]
    yp = F.pad(y, (3, 3))
    out = yp[..., 0:w]
    for d in range(1, 7):
        out = out + yp[..., d:d + w]
    return out


def extract_peaks(heatmaps: torch.Tensor, *, max_peaks: int = 127,
                  threshold: float = 0.2, offset: float = 0.5) -> Peaks:
    """Up to ``max_peaks`` refined peaks per channel of ``[..., H, W]``
    heatmaps (any leading axes, e.g. ``[B, J, H, W]``)."""
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    hm = heatmaps.float().reshape(-1, h, w)
    mask = _local_max_mask(hm, threshold)

    s_pos = torch.where(hm > 0, hm, torch.zeros((), device=hm.device))
    xs = torch.arange(w, dtype=torch.float32, device=hm.device)
    ys = torch.arange(h, dtype=torch.float32, device=hm.device)[:, None]
    sum_s = _box_sum_7x7(s_pos)
    refined_x = _box_sum_7x7(s_pos * xs) / sum_s + offset
    refined_y = _box_sum_7x7(s_pos * ys) / sum_s + offset

    # The K largest keys HW - raster are the first K masked pixels in
    # raster order; unmasked pixels key 0.
    n = hm.shape[0]
    flat_mask = mask.reshape(n, h * w)
    raster = torch.arange(h * w, dtype=torch.int32, device=hm.device)
    key = torch.where(flat_mask, h * w - raster, 0)
    peak_idx = torch.topk(key, max_peaks, dim=-1).indices
    count = torch.clamp(flat_mask.sum(-1), max=max_peaks).to(torch.int32)
    valid = (torch.arange(max_peaks, device=hm.device)[None, :]
             < count[:, None])

    def take(vals):
        got = torch.gather(vals.reshape(n, h * w), 1, peak_idx)
        return torch.where(valid, got, torch.zeros((), device=hm.device))

    xy = torch.stack([take(refined_x), take(refined_y)], dim=-1)
    return Peaks(xy=xy.reshape(*lead, max_peaks, 2),
                 score=take(hm).reshape(*lead, max_peaks),
                 count=count.reshape(lead))
