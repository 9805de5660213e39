"""The BN-folded stride-1 ResNet bottleneck in one pass (counterpart of
``smap_tpu/ops/fused_block.py``):
``relu(conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3 + residual)``,
the residual being ``x`` or a 1x1 projection ``x·wd + bd``.

On a CUDA tensor :func:`fused_bottleneck` launches
``fused_bottleneck_kernel`` (``smap_tpu_torch/csrc/fused_bottleneck.cu``),
which keeps both 64-channel intermediates in shared memory; on a CPU tensor
it runs :func:`fused_bottleneck_plain`, the op chain of the JAX package's
``bottleneck_reference``: bf16 operands, float32 sums, the intermediates
``y`` and ``z`` rounded to bf16 after bias and ReLU, the residual and the
output summed in float32 and rounded once.

Weights come in the kernel's layout: w1 ``[Cin, Cm]``, w2 ``[3, 3, Cm, Cm]``
(HWIO), w3 ``[Cm, Cout]``, wd ``[Cin, Cout]``; biases float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.runtime import no_tf32


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fused_bottleneck_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor,
                           w3: torch.Tensor, b3: torch.Tensor,
                           wd: Optional[torch.Tensor] = None,
                           bd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch bottleneck: x [B, H, W, Cin] NHWC (any float dtype;
    rounded to bf16) -> [B, H, W, Cout] bf16 NHWC."""
    bf16 = torch.bfloat16
    xf = _bf16_f32(x).permute(0, 3, 1, 2)

    def conv1x1(a, w):            # w [in, out]
        return F.conv2d(a, _bf16_f32(w).t()[:, :, None, None])

    with no_tf32():
        y = torch.relu(conv1x1(xf, w1) + b1.float()[:, None, None])
        y = y.to(bf16).float()
        z = F.conv2d(y, _bf16_f32(w2).permute(3, 2, 0, 1), padding=1)
        z = torch.relu(z + b2.float()[:, None, None]).to(bf16).float()
        o = conv1x1(z, w3) + b3.float()[:, None, None]
        res = xf if wd is None else (conv1x1(xf, wd)
                                     + bd.float()[:, None, None])
    return torch.relu(o + res).to(bf16).permute(0, 2, 3, 1)


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     w3: torch.Tensor, b3: torch.Tensor,
                     wd: Optional[torch.Tensor] = None,
                     bd: Optional[torch.Tensor] = None,
                     plain: bool = False) -> torch.Tensor:
    """A BN-folded bottleneck (see :func:`fused_bottleneck_plain`). A CUDA
    ``x`` must be contiguous NHWC bf16 and the weights contiguous bf16 with
    float32 biases (the kernel raises otherwise); ``plain`` runs the plain
    version whatever the device."""
    if wd is None and w1.shape[0] != w3.shape[1]:
        raise ValueError("an identity residual needs Cin == Cout")
    if plain or x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    return kernels.fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd, bd)
