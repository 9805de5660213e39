"""The BN-folded stem in one pass: ``maxpool3x3/2(relu(conv7x7/2(x) + b))``
(counterpart of ``smap_tpu/ops/fused_stem.py``).

On a CUDA tensor :func:`fused_stem` launches ``fused_stem_kernel``
(``smap_tpu_torch/csrc/fused_stem.cu``), an implicit GEMM on the tensor
cores that reads the NHWC image directly, with its weights as
:func:`pack_stem_for_kernel` lays them out; on a CPU tensor it runs
:func:`fused_stem_plain`, the op chain of
the JAX package's ``stem_reference``: bf16-rounded operands, the conv summed
in float32, ``+ bias`` in float32, ReLU, a 3x3/2 max-pool whose padding
never wins, one rounding to bf16 at the end.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.runtime import no_tf32

# Kernel C's weight rows: K = 7 kernel rows x (8 taps x 4 channels), the
# 8th tap and the 4th channel zero, and 8 more zeros that keep ldmatrix's
# row reads free of bank conflicts.
STEM_K, STEM_ROW = 7 * 32, 7 * 32 + 8


def fused_stem_plain(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch stem.

    x [B, H, W, Cin] NHWC (any float dtype; rounded to bf16); kernel
    [Cout, Cin, 7, 7] OIHW (rounded to bf16); bias [Cout] (float32).
    Returns [B, Hp, Wp, Cout] bf16 NHWC, Hp = ceil(ceil(H / 2) / 2).
    """
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    kf = kernel.to(torch.bfloat16).float()
    with no_tf32():
        # Products of bf16 values are exact in float32; the sums are f32.
        y = F.conv2d(xf, kf, stride=2, padding=3)
    y = torch.relu(y + bias.float()[:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1)


def pack_stem_for_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, 7, 7]`` (Cin 3 or 4) -> kernel C's ``[Cout, 232]``
    bf16 rows: element ``kh * 32 + kw * 4 + ci`` is ``kernel[:, ci, kh,
    kw]``, zero for kw = 7, ci >= Cin and past 224."""
    cout, cin = kernel.shape[:2]
    if cin > 4 or tuple(kernel.shape[2:]) != (7, 7):
        raise ValueError(f"kernel C takes [Cout, Cin <= 4, 7, 7], got "
                         f"{tuple(kernel.shape)}")
    k = torch.zeros((cout, 7, 8, 4), dtype=torch.bfloat16,
                    device=kernel.device)
    k[:, :, :7, :cin] = kernel.to(torch.bfloat16).permute(0, 2, 3, 1)
    out = torch.zeros((cout, STEM_ROW), dtype=torch.bfloat16,
                      device=kernel.device)
    out[:, :STEM_K] = k.reshape(cout, STEM_K)
    return out


def unpack_stem_for_kernel(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """The inverse of :func:`pack_stem_for_kernel`: ``[Cout, cin, 7, 7]``."""
    k = packed[:, :STEM_K].reshape(-1, 7, 8, 4)
    return k[:, :, :7, :cin].permute(0, 3, 1, 2).contiguous()


def fused_stem(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               plain: bool = False,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stem of a BN-folded SMAP (see :func:`fused_stem_plain` for the
    arguments). A CUDA ``x`` must be contiguous NHWC bf16 and ``bias``
    float32 (the kernel raises otherwise); the kernel takes ``packed``
    (:func:`pack_stem_for_kernel` of ``kernel``) or packs it here.
    ``plain`` runs the plain version whatever the device."""
    if plain or x.device.type == "cpu":
        return fused_stem_plain(x, kernel, bias)
    if packed is None:
        packed = pack_stem_for_kernel(kernel)
    return kernels.fused_stem(x, packed, bias)
