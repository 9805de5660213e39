"""Camera math: back-projection and letterbox coordinate transforms
(counterpart of ``smap_tpu/camera.py``)."""

from __future__ import annotations

from typing import Dict

import torch


def back_project(xy: torch.Tensor, depth: torch.Tensor,
                 K: torch.Tensor) -> torch.Tensor:
    """Back-project pixel coords ``[..., 2]`` at ``depth`` ``[...]`` to
    camera-space points ``[..., 3]``. ``K`` is ``[3, 3]``, or ``[..., 3, 3]``
    broadcastable against ``depth``."""
    X = (xy[..., 0] - K[..., 0, 2]) * depth / K[..., 0, 0]
    Y = (xy[..., 1] - K[..., 1, 2]) * depth / K[..., 1, 1]
    return torch.stack([X, Y, depth], dim=-1)


def unletterbox(xy: torch.Tensor, scale: float, net_w: int, net_h: int,
                img_w: float, img_h: float) -> torch.Tensor:
    """Net-input pixel coords back to original-image coords."""
    x = xy[..., 0] / scale - (net_w / scale - img_w) / 2.0
    y = xy[..., 1] / scale - (net_h / scale - img_h) / 2.0
    return torch.stack([x, y], dim=-1)


def letterbox_scale(img_w: int, img_h: int, net_w: int, net_h: int) -> float:
    """Aspect-preserving fit scale."""
    return min(net_w / float(img_w), net_h / float(img_h))


def intrinsics_from_scale(scale: Dict[str, float],
                          device="cpu") -> torch.Tensor:
    """``K`` from a scale dict."""
    return torch.tensor([
        [scale["f_x"], 0.0, scale["cx"]],
        [0.0, scale["f_y"], scale["cy"]],
        [0.0, 0.0, 1.0],
    ], dtype=torch.float32, device=device)


def default_scale_dict(img_w: int, img_h: int,
                       net_w: int = 832, net_h: int = 512) -> Dict[str, float]:
    """Scale metadata with fake intrinsics fx = fy = W."""
    return {
        "scale": letterbox_scale(img_w, img_h, net_w, net_h),
        "img_width": float(img_w),
        "img_height": float(img_h),
        "net_width": float(net_w),
        "net_height": float(net_h),
        "f_x": float(img_w),
        "f_y": float(img_w),
        "cx": img_w / 2.0,
        "cy": img_h / 2.0,
    }
