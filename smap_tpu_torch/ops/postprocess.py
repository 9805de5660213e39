"""Post-processing: network maps -> 3D skeletons, over a batch
(counterpart of ``smap_tpu/ops/postprocess.py``).

  normalize maps -> peak NMS -> PAF score table (kernel A on CUDA)
  -> depth-aware association (kernel B on CUDA, 14 launches)
  -> limb delta-Z readout -> depth chaining -> absolute root depth
  -> un-letterbox -> back-projection.

Results are fixed-capacity ``[B, K, 15, 4]`` tables with a per-image
person count. Nothing in it waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smap_tpu_torch.config import (NUM_JOINTS, PAF_VECTOR, ROOT_IDX, STRIDE,
                                   PostProcessConfig)
from smap_tpu_torch.ops.association import associate
from smap_tpu_torch.ops.depth import (back_project_bodies, chain_depths,
                                      read_limb_depths, root_depths)
from smap_tpu_torch.ops.nms import Peaks, extract_peaks
from smap_tpu_torch.ops.paf import paf_scores
from smap_tpu_torch.runtime import device_constant


class PoseResults(NamedTuple):
    """Per-image results, batch axis first.

    bodies_2d: [B, K, J, 4] (x, y, chained rel-Z, score), input resolution.
    bodies_3d: [B, K, J, 4] (X, Y, Z, score), camera space.
    root_depth: [B, K] absolute root depth per person.
    count: [B] number of valid persons.
    overflow: [B] bool: some joint had more peaks than ``assoc_peaks``.
    """

    bodies_2d: torch.Tensor
    bodies_3d: torch.Tensor
    root_depth: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


class ScaleInfo(NamedTuple):
    """Per-image letterbox / camera metadata, float32 [B] each."""

    scale: torch.Tensor
    img_w: torch.Tensor
    img_h: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def postprocess_batch(outputs_2d: torch.Tensor, outputs_3d: torch.Tensor,
                      outputs_rd: torch.Tensor, scale: ScaleInfo,
                      cfg: PostProcessConfig = PostProcessConfig(), *,
                      net_w: float = 832.0, net_h: float = 512.0,
                      stride: int = STRIDE, plain: bool = False
                      ) -> PoseResults:
    """Decode a batch of NHWC network maps.

    Args:
      outputs_2d: [B, Ho, Wo, 43] summed finest 2D maps (raw net scale).
      outputs_3d: [B, Ho, Wo, 14] delta-Z maps.
      outputs_rd: [B, Ho, Wo, 1] root-depth map.
      scale: letterbox / camera metadata on the maps' device.
      plain: decode with the kernels' plain versions whatever the device.
    """
    dev = outputs_2d.device
    maps = outputs_2d.float().permute(0, 3, 1, 2)              # [B, 43, H, W]
    # Label encoding: heatmaps peak at 255, PAF unit vectors scaled by 127.
    kpt = maps[:, :NUM_JOINTS] / 255.0
    paf = (maps[:, NUM_JOINTS:] / 127.0).contiguous()
    rd_map = outputs_rd[..., 0].float()                        # [B, H, W]
    paf_z = outputs_3d.float().permute(0, 3, 1, 2)             # [B, 14, H, W]

    peaks = extract_peaks(kpt, max_peaks=cfg.max_peaks,
                          threshold=cfg.nms_threshold, offset=cfg.nms_offset)
    # Only the first assoc_peaks candidates enter the K^2 stages; the
    # results are those of full capacity while the counts fit, and
    # ``overflow`` flags the images where they did not.
    kassoc = min(cfg.assoc_peaks, cfg.max_peaks)
    overflow = torch.any(peaks.count > kassoc, dim=-1)
    if kassoc < cfg.max_peaks:
        peaks = Peaks(xy=peaks.xy[:, :, :kassoc].contiguous(),
                      score=peaks.score[:, :, :kassoc],
                      count=torch.clamp(peaks.count, max=kassoc))
    limb_pairs = device_constant(PAF_VECTOR, torch.int32, dev)
    table = paf_scores(paf, peaks, limb_pairs,
                       inter_threshold=cfg.inter_threshold,
                       inter_min_above=cfg.inter_min_above_threshold,
                       default_threshold=cfg.default_nms_threshold,
                       num_samples=cfg.num_line_samples, plain=plain)
    bodies = associate(peaks, table, rd_map, root_idx=ROOT_IDX,
                       ds_scale=cfg.ds_scale, bone_factor=cfg.bone_factor,
                       plain=plain)

    # To input resolution.
    bodies_2d = bodies.joints.clone()
    bodies_2d[..., :2] *= float(stride)

    depth_v = read_limb_depths(bodies_2d, paf_z, stride=stride,
                               num_samples=cfg.num_depth_samples,
                               root_idx=ROOT_IDX)
    rel_z = chain_depths(depth_v, root_idx=ROOT_IDX, num_joints=NUM_JOINTS)
    person_ok = bodies_2d[:, :, ROOT_IDX, 3] > 0
    rel_z = torch.where(person_ok[..., None], rel_z,
                        torch.zeros((), device=dev))
    abs_root = root_depths(bodies_2d, rd_map, scale=scale.scale,
                           f_x=scale.fx, stride=stride, root_idx=ROOT_IDX)

    zeros, ones = torch.zeros_like(scale.fx), torch.ones_like(scale.fx)
    K = torch.stack([
        torch.stack([scale.fx, zeros, scale.cx], dim=-1),
        torch.stack([zeros, scale.fy, scale.cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)                                                 # [B, 3, 3]
    bodies_3d = back_project_bodies(
        bodies_2d, rel_z, abs_root, K, scale=scale.scale, net_w=net_w,
        net_h=net_h, img_w=scale.img_w, img_h=scale.img_h, root_idx=ROOT_IDX)

    # The chained rel-Z goes into the 2D table's third column.
    bodies_2d[..., 2] = rel_z
    return PoseResults(bodies_2d=bodies_2d, bodies_3d=bodies_3d,
                       root_depth=abs_root, count=bodies.count,
                       overflow=overflow)


def postprocess_single(outputs_2d: torch.Tensor, outputs_3d: torch.Tensor,
                       outputs_rd: torch.Tensor, scale: ScaleInfo,
                       cfg: PostProcessConfig = PostProcessConfig(),
                       **kw) -> PoseResults:
    """One image: :func:`postprocess_batch` on a batch of one (maps
    [Ho, Wo, C], scalar metadata); results without the batch axis."""
    scale = ScaleInfo(*(torch.as_tensor(s, dtype=torch.float32,
                                        device=outputs_2d.device).reshape(1)
                        for s in scale))
    res = postprocess_batch(outputs_2d[None], outputs_3d[None],
                            outputs_rd[None], scale, cfg, **kw)
    return PoseResults(*(r[0] for r in res))


def flip_tta_merge(outputs_2d: torch.Tensor, outputs_2d_flip: torch.Tensor,
                   flip_order, paf_flip_channel,
                   num_joints: int = NUM_JOINTS) -> torch.Tensor:
    """Merge the prediction on the W-flipped image into the upright one
    (both [B, H, W, C]): re-flip along W, permute channels (keypoints by
    ``flip_order``, PAF channels by ``paf_flip_channel``), negate the
    x-direction PAF channels, add, and halve the PAF channels only."""
    c = outputs_2d.shape[-1]
    perm = list(flip_order) + [num_joints + ch for ch in paf_flip_channel]
    gathered = torch.flip(outputs_2d_flip, dims=[2])[..., perm]
    sign = torch.ones(c, dtype=outputs_2d.dtype, device=outputs_2d.device)
    sign[num_joints::2] = -1.0          # x-direction PAF channels
    half = torch.ones_like(sign)
    half[num_joints:] = 0.5
    return (outputs_2d + gathered * sign) * half
