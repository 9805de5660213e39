"""int8 convolution of the int8 serving forward (counterpart of the int8
branch of ``Conv2D`` in ``smap_tpu/models/layers.py``).

Activations are quantized per tensor, symmetric, to int8 with a scale
``s_x`` (taken from the input, or frozen by calibration); weights are int8
per output channel with scale ``w_scale``; the product is summed in int32
and dequantized in the JAX package's order, each step rounded on its own:
``acc.float() * (s_x * w_scale) + bias``, cast to the output dtype, then
the ReLU if asked.

On CUDA tensors :func:`int8_conv2d` launches ``int8_conv_kernel``
(``smap_tpu_torch/csrc/int8_conv.cu``), an implicit GEMM on the int8 tensor
cores with the dequantization, bias, cast and ReLU in its epilogue; on CPU
tensors it runs :func:`int8_conv2d_plain`. Scales stay 0-dim tensors on
the activations' device: nothing here waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from smap_tpu_torch.ops import kernels

# float32(1 / 127): the dynamic scale is a multiply by it, as in the JAX
# package, so that a calibration on the host reproduces it bit for bit.
INV_127 = float(np.float32(1.0 / 127.0))
# Smallest activation abs-max a scale is taken from.
MIN_ABSMAX = 1e-6
# Kernel E's weight rows are padded to a multiple of this many int8 values
# (one mma.m16n8k32 step), and its input channels to a multiple of 4.
K_ALIGN, CIN_ALIGN = 32, 4


def act_absmax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` as a 0-dim float32 tensor on ``x``'s device (one pass:
    the larger of ``max x`` and ``-min x``, both exact). A channels-last
    tensor is reduced as the flat NHWC view of its memory: reduced as
    it stands, it would first be copied."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        x = x.permute(0, 2, 3, 1)
    lo, hi = torch.aminmax(x.reshape(-1))
    return torch.maximum(hi, -lo).float()


def scale_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-6) * float32(1 / 127)`` (a multiply, not a
    divide)."""
    return torch.clamp(absmax, min=MIN_ABSMAX) * INV_127


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale of ``x``, a 0-dim float32 tensor on
    its device."""
    return scale_from_absmax(act_absmax(x))


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x / s_x), -127, 127)`` as int8 (round half to even, as
    ``jnp.round``). ``s_x`` is a 0-dim tensor on ``x``'s device, so the
    division is a true division (a CUDA division by a CPU scalar multiplies
    by its reciprocal). Keeps ``x``'s memory format."""
    if s_x.device != x.device:
        raise ValueError(f"s_x lies on {s_x.device}, x on {x.device}")
    return torch.round(x.float() / s_x).clamp_(-127, 127).to(torch.int8)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor,
                      w_scale: torch.Tensor, s_x: torch.Tensor,
                      bias: torch.Tensor, stride=1, padding=0,
                      relu: bool = False,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch int8 convolution.

    xq [B, Cin, H, W] int8; wq [Cout, Cin, kh, kw] int8; w_scale and bias
    [Cout] float32; s_x a 0-dim float32 tensor. The integer product is a
    float64 convolution of the int8 values, exact (every partial sum is an
    integer below 2^53), cast to int32. Returns [B, Cout, Ho, Wo] in
    ``out_dtype``.
    """
    acc = F.conv2d(xq.double(), wq.double(), None, _pair(stride),
                   _pair(padding)).round_().to(torch.int32)
    scale = (s_x * w_scale)[:, None, None]
    y = (acc.float() * scale + bias[:, None, None]).to(out_dtype)
    return F.relu(y) if relu else y


def pack_int8_weights(wq: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, kh, kw]`` int8 -> kernel E's ``[Cout, K]`` rows:
    element ``(dh * kw + dw) * Cin_pad + ci`` is ``wq[:, ci, dh, dw]``,
    with Cin padded to a multiple of 4 and K to a multiple of 32 with
    zeros."""
    cout, cin, kh, kw = wq.shape
    cin_pad = -(-cin // CIN_ALIGN) * CIN_ALIGN
    k = kh * kw * cin_pad
    out = torch.zeros((cout, -(-k // K_ALIGN) * K_ALIGN), dtype=torch.int8,
                      device=wq.device)
    taps = torch.zeros((cout, kh, kw, cin_pad), dtype=torch.int8,
                       device=wq.device)
    taps[..., :cin] = wq.permute(0, 2, 3, 1)
    out[:, :k] = taps.reshape(cout, k)
    return out


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                s_x: torch.Tensor, bias: torch.Tensor, stride=1, padding=0,
                relu: bool = False, out_dtype: torch.dtype = torch.float32,
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 convolution (arguments as :func:`int8_conv2d_plain`). On a
    CPU ``xq`` it is the plain version; on a CUDA ``xq`` it launches kernel
    E on ``packed`` (:func:`pack_int8_weights` of ``wq``, packed here when
    not given). The output is channels-last in memory on the card."""
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, w_scale, s_x, bias, stride, padding,
                                 relu, out_dtype)
    if packed is None:
        packed = pack_int8_weights(wq)
    cin = xq.shape[1]
    x = xq.permute(0, 2, 3, 1)          # channels_last NCHW is NHWC
    if cin % CIN_ALIGN:
        x = F.pad(x, (0, CIN_ALIGN - cin % CIN_ALIGN))
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if sh != sw or ph != pw:
        raise ValueError(f"int8_conv_kernel takes square strides and "
                         f"paddings, got {stride}, {padding}")
    y = kernels.int8_conv(x.contiguous(), packed, w_scale, s_x, bias,
                          kh=wq.shape[2], kw=wq.shape[3], stride=sh,
                          padding=ph, relu=relu, out_dtype=out_dtype)
    return y.permute(0, 3, 1, 2)
