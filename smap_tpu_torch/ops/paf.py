"""PAF line-integral scoring: the ``[B, L, K, K]`` pair-score table
(counterpart of ``smap_tpu/ops/paf.py:paf_scores``).

For every (image, limb, src peak, dst peak) the segment between the two
peaks is sampled at ``n_pts = clip(floor(sqrt(5 * max(|dx|, |dy|)) + 0.5),
5, num_samples)`` integer points; each sample's PAF vector is dotted with
the segment's unit vector. The score is the mean of the samples above
``inter_threshold`` when more than ``inter_min_above`` of them pass; else
``default_threshold + 1e-6`` when the peaks are closer than
``sqrt(H * W) / 150``; else -1. Coincident peaks and invalid slots score -1.

On a CUDA tensor the whole table is one launch of the hand-written kernel
``paf_score_kernel`` (``smap_tpu_torch/csrc/paf_score.cu``); on a CPU
tensor, and with ``plain=True`` on any device, it is
:func:`paf_scores_plain`, which gathers the samples directly.
"""

from __future__ import annotations

import torch

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.ops.nms import Peaks


def paf_scores_plain(pafs: torch.Tensor, peaks: Peaks,
                     limb_pairs: torch.Tensor, *,
                     inter_threshold: float = 0.05,
                     inter_min_above: float = 0.95,
                     default_threshold: float = 0.1,
                     num_samples: int = 25) -> torch.Tensor:
    """Plain PyTorch score table, in the JAX gather path's order of
    operations. Memory is ``O(B L K^2 num_samples)``."""
    B, _, h, w = pafs.shape
    L = limb_pairs.shape[0]
    K = peaks.xy.shape[-2]
    dev = pafs.device
    close_threshold = (float(h) * float(w)) ** 0.5 / 150.0
    src, dst = limb_pairs[:, 0].long(), limb_pairs[:, 1].long()

    a = peaks.xy[:, src][:, :, :, None, :]          # [B, L, K, 1, 2]
    b = peaks.xy[:, dst][:, :, None, :, :]          # [B, L, 1, K, 2]
    vec = b - a                                     # [B, L, K, K, 2]
    norm = torch.sqrt(torch.sum(vec * vec, dim=-1))
    vmax = torch.maximum(vec[..., 0].abs(), vec[..., 1].abs())
    n_pts = torch.clamp(torch.floor(torch.sqrt(5.0 * vmax) + 0.5), 5,
                        num_samples)
    unit = vec / torch.clamp(norm, min=1e-12)[..., None]

    lm = torch.arange(num_samples, dtype=torch.float32, device=dev)
    step = vec[..., None, :] / n_pts[..., None, None]   # [B,L,K,K,1,2]
    pos = a[..., None, :] + lm[:, None] * step          # [B,L,K,K,S,2]
    px = torch.clamp(torch.clamp(torch.floor(pos[..., 0] + 0.5), max=w - 1)
                     .to(torch.int32), min=0)
    py = torch.clamp(torch.clamp(torch.floor(pos[..., 1] + 0.5), max=h - 1)
                     .to(torch.int32), min=0)

    # Direct gather from each limb's x and y maps.
    flat = (py * w + px).long().reshape(B, L, -1)
    maps = pafs.float().reshape(B, L, 2, h * w)
    mx = torch.gather(maps[:, :, 0], 2, flat).reshape(px.shape)
    my = torch.gather(maps[:, :, 1], 2, flat).reshape(px.shape)

    sample_score = unit[..., 0:1] * mx + unit[..., 1:2] * my
    active = lm < n_pts[..., None]
    passing = (sample_score > inter_threshold) & active
    cnt = passing.sum(-1).float()
    zero = torch.zeros((), device=dev)
    ssum = torch.where(passing, sample_score, zero).sum(-1)

    mean_score = ssum / torch.clamp(cnt, min=1.0)
    enough = cnt / n_pts > inter_min_above
    close = norm < close_threshold
    minus_one = torch.full((), -1.0, device=dev)
    score = torch.where(enough, mean_score,
                        torch.where(close, torch.full(
                            (), default_threshold + 1e-6, device=dev),
                            minus_one))
    score = torch.where(norm > 1e-6, score, minus_one)

    ia = torch.arange(K, device=dev)
    n_src = peaks.count[:, src][:, :, None, None]
    n_dst = peaks.count[:, dst][:, :, None, None]
    valid = (ia[:, None] < n_src) & (ia[None, :] < n_dst)
    return torch.where(valid, score, minus_one)


def paf_scores(pafs: torch.Tensor, peaks: Peaks, limb_pairs: torch.Tensor, *,
               inter_threshold: float = 0.05, inter_min_above: float = 0.95,
               default_threshold: float = 0.1, num_samples: int = 25,
               plain: bool = False) -> torch.Tensor:
    """Pair-score table.

    Args:
      pafs: [B, 2L, H, W] float32 PAF field (x then y channel per limb,
        already divided by 127).
      peaks: Peaks with xy [B, J, K, 2], count [B, J].
      limb_pairs: [L, 2] (src joint, dst joint).
      plain: run the plain PyTorch version whatever the device (to hold
        the kernel against it).

    Returns:
      [B, L, K, K] float32; invalid pairs hold -1.
    """
    kw = dict(inter_threshold=inter_threshold,
              inter_min_above=inter_min_above,
              default_threshold=default_threshold, num_samples=num_samples)
    if plain or pafs.device.type == "cpu":
        return paf_scores_plain(pafs, peaks, limb_pairs, **kw)
    return kernels.paf_score(pafs, peaks.xy, peaks.count, limb_pairs, **kw)
