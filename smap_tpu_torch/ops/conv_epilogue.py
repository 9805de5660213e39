"""A convolution's epilogue in one pass: its bias, eval-mode BatchNorm, a
residual add and a ReLU (kernel F). The JAX package leaves this work to
XLA, which fuses it into each convolution's output on the TPU.

:func:`conv_epilogue_plain` is the port's chain of separate ops: the bias
added to the conv's result in its dtype, the BatchNorm module (by the
running statistics in eval mode, by the batch in train mode), the
residual added, the ReLU. The model's blocks (``models.layers``) run it on
the CPU, in train mode and while autograd records; on the card, in eval
mode under ``no_grad`` (:func:`use_kernel`), they launch
``conv_epilogue_kernel`` (``ops.kernels.conv_epilogue``,
``csrc/conv_epilogue.cu``) on the channels-last output in place, with the
per-channel values of :func:`epilogue_params`. It rounds where the chain
does; its BatchNorm is Flax's arithmetic, ``(y - mean) * (rsqrt(var + eps)
* scale) + shift``, which PyTorch's BatchNorm kernels order otherwise (one
bf16 ulp apart on a few elements).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def use_kernel(module: nn.Module, y: torch.Tensor) -> bool:
    """Whether ``module``'s epilogue on ``y`` goes through the kernel: y on
    the card, the module in eval mode, no gradient being recorded."""
    return y.is_cuda and not module.training and not torch.is_grad_enabled()


def epilogue_params(bias: torch.Tensor, mean: Optional[torch.Tensor] = None,
                    var: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """The kernel's per-channel values, ``[4, C]`` float32 on ``bias``'s
    device: the conv bias, then (with the BatchNorm's statistics and
    parameters) the running mean, Flax's factor ``rsqrt(var + eps) *
    scale`` and the shift; zeros where there is no BatchNorm. The factor is
    computed on the host, so that it is the same number whatever the
    device: ``var + eps`` in float32, its rsqrt rounded once to float32
    (within 1 ulp of any float32 rsqrt, XLA's and PyTorch's included), the
    product with the scale in float32."""
    out = torch.zeros((4, bias.shape[0]), dtype=torch.float32)
    out[0] = bias.detach().float().cpu()
    if mean is not None:
        v = var.detach().float().cpu() + eps
        out[1] = mean.detach().float().cpu()
        out[2] = (torch.rsqrt(v.double()).float()
                  * scale.detach().float().cpu())
        out[3] = shift.detach().float().cpu()
    return out.to(bias.device)


def conv_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        bn: Optional[nn.Module] = None,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """``relu(bn(y + bias) + residual)``, each step optional: the bias
    ([C], in y's dtype) added to ``y`` in place, ``bn`` a BatchNorm module,
    the residual added to a new tensor."""
    if bias is not None:
        y = y.add_(bias[:, None, None])
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y
