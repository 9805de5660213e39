"""Shared model building blocks (counterpart of ``smap_tpu/models/layers.py``).

NCHW modules. Submodule names follow the reference state_dict layout
(``conv`` / ``bn`` inside each conv block, ``conv_bn_relu1..3`` and
``downsample`` inside a bottleneck) so a reference checkpoint loads with
``load_state_dict`` as it is.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvBnRelu(nn.Module):
    """Conv2d (with bias) + eval-mode BatchNorm (eps 1e-5) + optional ReLU.

    ``padding=None`` is SAME for odd kernels (``k // 2``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding=None, has_relu: bool = True):
        super().__init__()
        if padding is None:
            padding = kernel_size // 2
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=True)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
        self.has_relu = has_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.has_relu else x


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck block (1x1 -> 3x3/stride -> 1x1, expansion 4)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv_bn_relu1 = ConvBnRelu(in_planes, planes, 1)
        self.conv_bn_relu2 = ConvBnRelu(planes, planes, 3, stride=stride,
                                        padding=1)
        self.conv_bn_relu3 = ConvBnRelu(planes, out, 1, has_relu=False)
        self.downsample = (ConvBnRelu(in_planes, out, 1, stride=stride,
                                      padding=0, has_relu=False)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_bn_relu3(self.conv_bn_relu2(self.conv_bn_relu1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``[B, C, H, W]`` with ``align_corners=True``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max-pool with pad 1; the padding never wins (-inf)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
