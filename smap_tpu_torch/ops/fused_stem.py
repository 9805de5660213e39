"""The BN-folded stem in one pass: ``maxpool3x3/2(relu(conv7x7/2(x) + b))``
(counterpart of ``smap_tpu/ops/fused_stem.py``).

On a CUDA tensor :func:`fused_stem` launches ``fused_stem_kernel``
(``smap_tpu_torch/csrc/fused_stem.cu``), which reads the NHWC image
directly; on a CPU tensor it runs :func:`fused_stem_plain`, the op chain of
the JAX package's ``stem_reference``: bf16-rounded operands, the conv summed
in float32, ``+ bias`` in float32, ReLU, a 3x3/2 max-pool whose padding
never wins, one rounding to bf16 at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.runtime import no_tf32


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


def fused_stem(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
    """The stem of a BN-folded SMAP (see :func:`fused_stem_plain` for the
    arguments). A CUDA ``x`` must be contiguous NHWC bf16, ``kernel``
    contiguous bf16 and ``bias`` float32 (the kernel raises otherwise);
    ``plain`` runs the plain version whatever the device."""
    if plain or x.device.type == "cpu":
        return fused_stem_plain(x, kernel, bias)
    return kernels.fused_stem(x, kernel, bias)
