"""Image preprocessing (counterpart of ``smap_tpu/data/preprocess.py`` and
``smap_tpu/inference.py:prepare_images``).

Host side, numpy: the letterbox (``data.image.resize_linear``, OpenCV's
``INTER_LINEAR`` bit for bit), the I420 packing and ``normalize_image``.
Device side: ``i420_to_bgr``, ``prepare_images`` and
``device_letterbox_normalize`` run on whatever device the frames are on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from smap_tpu_torch.camera import default_scale_dict
from smap_tpu_torch.config import INPUT_SHAPE, PIXEL_MEANS_BGR, PIXEL_STDS_BGR
from smap_tpu_torch.data.image import bgr_to_i420, resize_linear
from smap_tpu_torch.runtime import device_constant

__all__ = ["bgr_to_i420", "device_letterbox_normalize", "i420_to_bgr",
           "letterbox_image", "normalize_image", "prepare_images"]


def letterbox_image(img_bgr: np.ndarray, net_hw: Tuple[int, int] = INPUT_SHAPE
                    ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Aspect-preserving resize into a gray (128) ``net_h x net_w`` canvas.

    Args:
      img_bgr: [H, W, 3] uint8 BGR image.

    Returns:
      (padded uint8 [net_h, net_w, 3], scale dict with default intrinsics).
    """
    net_h, net_w = net_hw
    img_h, img_w = img_bgr.shape[:2]
    scale = min(net_w / img_w, net_h / img_h)
    resized = resize_linear(img_bgr, scale, scale)
    rh, rw = resized.shape[:2]
    out = np.full((net_h, net_w, 3), 128, np.uint8)
    if rw < net_w:
        ml = (net_w - rw) // 2
        out[:rh, ml:ml + rw] = resized[:net_h]
    elif rh < net_h:
        mu = (net_h - rh) // 2
        out[mu:mu + rh, :rw] = resized[:, :net_w]
    else:
        out[:rh, :rw] = resized
    return out, default_scale_dict(img_w, img_h, net_w, net_h)


def normalize_image(img_bgr_u8: np.ndarray) -> np.ndarray:
    """[0, 255] uint8 BGR -> normalized float32, on the host."""
    means = np.asarray(PIXEL_MEANS_BGR, np.float32)
    stds = np.asarray(PIXEL_STDS_BGR, np.float32)
    return (img_bgr_u8.astype(np.float32) / 255.0 - means) / stds


def i420_to_bgr(packed_u8: torch.Tensor) -> torch.Tensor:
    """Packed I420 ``[..., 3H/2, W]`` uint8 -> ``[..., H, W, 3]`` float32 BGR.

    BT.601 studio-swing coefficients with 2x2 replicated chroma, as
    ``cv2.cvtColor(COLOR_YUV2BGR_I420)`` up to its final rounding.
    """
    h3, w = packed_u8.shape[-2], packed_u8.shape[-1]
    h = h3 * 2 // 3
    lead = packed_u8.shape[:-2]
    y = packed_u8[..., :h, :].float()
    u = packed_u8[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v = packed_u8[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2)

    def up2(c):
        c = c.float()
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    ud = up2(u) - 128.0
    vd = up2(v) - 128.0
    yd = 1.164 * (y - 16.0)
    r = yd + 1.596 * vd
    g = yd - 0.391 * ud - 0.813 * vd
    b = yd + 2.018 * ud
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0.0, 255.0)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """Wire format -> normalized float32 BGR ``[B, H, W, 3]``, on the
    images' device.

    Accepts packed planar I420 ``[B, 3H/2, W]`` uint8, letterboxed
    ``[B, H, W, 3]`` uint8, or already-normalized float32 (returned as is).
    """
    if images.ndim == 3:
        images = i420_to_bgr(images)
    elif images.dtype == torch.uint8:
        images = images.float()
    else:
        return images
    means = device_constant(PIXEL_MEANS_BGR, torch.float32, images.device)
    stds = device_constant(PIXEL_STDS_BGR, torch.float32, images.device)
    return (images / 255.0 - means) / stds


def device_letterbox_normalize(img_bgr_u8: torch.Tensor,
                               src_hw: Tuple[int, int],
                               net_hw: Tuple[int, int] = INPUT_SHAPE
                               ) -> torch.Tensor:
    """Letterbox and normalize one ``[H, W, 3]`` uint8 frame on its device:
    half-pixel bilinear without antialiasing (the source clamped at its
    edges), gray (128) bars, then the BGR normalization. Returns
    ``[net_h, net_w, 3]`` float32."""
    net_h, net_w = net_hw
    img_h, img_w = src_hw
    scale = min(net_w / img_w, net_h / img_h)
    rw, rh = round(img_w * scale), round(img_h * scale)
    x = img_bgr_u8.float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                      antialias=False)[0].permute(1, 2, 0)
    canvas = torch.full((net_h, net_w, 3), 128.0, dtype=torch.float32,
                        device=x.device)
    if rw < net_w:
        ml = (net_w - rw) // 2
        canvas[:min(rh, net_h), ml:ml + rw] = x[:net_h]
    elif rh < net_h:
        mu = (net_h - rh) // 2
        canvas[mu:mu + rh, :min(rw, net_w)] = x[:, :net_w]
    else:
        canvas[:rh, :rw] = x[:net_h, :net_w]
    means = device_constant(PIXEL_MEANS_BGR, torch.float32, x.device)
    stds = device_constant(PIXEL_STDS_BGR, torch.float32, x.device)
    return (canvas / 255.0 - means) / stds
