"""The BN-folded stride-1 ResNet bottleneck in one pass (counterpart of
``smap_tpu/ops/fused_block.py``):
``relu(conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3 + residual)``,
the residual being ``x`` or a 1x1 projection ``x·wd + bd``.

On a CUDA tensor :func:`fused_bottleneck` launches
``fused_bottleneck_kernel`` (``smap_tpu_torch/csrc/fused_bottleneck.cu``),
which keeps both 64-channel intermediates and all the weights in shared
memory; on a CPU tensor it runs :func:`fused_bottleneck_plain`, the op chain
of the JAX package's ``bottleneck_reference``: bf16 operands, float32 sums,
the intermediates ``y`` and ``z`` rounded to bf16 after bias and ReLU, the
residual and the output summed in float32 and rounded once.

Weights come in the plain layout: w1 ``[Cin, Cm]``, w2 ``[3, 3, Cm, Cm]``
(HWIO), w3 ``[Cm, Cout]``, wd ``[Cin, Cout]``; biases float32. The kernel
takes them as :func:`pack_bottleneck_for_kernel` lays them out: the image
of its shared memory, built once per weight state (``Bottleneck`` caches
it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.runtime import no_tf32

# The kernel's output tile (rows x cols of one image) and its fixed widths:
# Cm is padded to 64, Cout to 256, Cin to a multiple of 64 (one TMA chunk).
TILE_H, TILE_W = 8, 16
KERNEL_CM, KERNEL_COUT, KERNEL_CHUNK = 64, 256, 64


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


# -- the kernel's weight image ----------------------------------------------

class PackedBottleneck(NamedTuple):
    """Kernel D's weights: ``weights`` bf16, the shared-memory image (see
    :func:`pack_bottleneck_for_kernel`); ``bias`` f32 ``[64 + 64 + 256 +
    256]`` (b1, b2, b3, bd, zero-padded; bd 0 without a projection)."""
    weights: torch.Tensor
    bias: torch.Tensor
    cin: int
    cm: int
    cout: int
    proj: bool


def _swizzle128(m: torch.Tensor) -> torch.Tensor:
    """A ``[R, 64]`` bf16 matrix (rows of 128 bytes) in the 128-byte swizzle
    that ``wgmma`` and TMA share: 16-byte chunk ``c`` of row ``r`` goes to
    chunk ``c ^ (r % 8)``. Its own inverse."""
    r = m.shape[0]
    idx = (torch.arange(8)[None, :] ^ (torch.arange(r) % 8)[:, None])
    return m.reshape(r, 8, 8)[torch.arange(r)[:, None], idx].reshape(r, 64)


def conv3_column_order(n: int = KERNEL_COUT) -> torch.Tensor:
    """Output channel held in each accumulator column of conv3: column
    ``32G + 8t + 2q + e`` holds channel ``32G + 8q + 2t + e``, so that the
    8 values a thread holds per group of 32 columns are 8 consecutive
    channels (one 16-byte store). An involution."""
    c = torch.arange(n)
    g, r = c // 32, c % 32
    return g * 32 + (r % 8 // 2) * 8 + (r // 8) * 2 + r % 2


def _pad(t: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def pack_bottleneck_for_kernel(w1: torch.Tensor, b1: torch.Tensor,
                               w2: torch.Tensor, b2: torch.Tensor,
                               w3: torch.Tensor, b3: torch.Tensor,
                               wd: Optional[torch.Tensor] = None,
                               bd: Optional[torch.Tensor] = None
                               ) -> PackedBottleneck:
    """Plain-layout weights -> kernel D's shared-memory image, on their
    device. Every operand is B of a K-major product in 128-byte swizzled
    ``[N][64]`` blocks (8 KB per 64 x 64): w1 as Cin/64 blocks of
    ``w1[64k:64k+64, :]ᵀ``, w2 as 9 blocks (tap dy*3+dx), w3 and wd as
    ``[256][64]`` with their rows in :func:`conv3_column_order`. Cm pads to
    64, Cout to 256, Cin to a multiple of 64, with zeros: a zero weight and
    bias give a zero channel, so the padding adds nothing."""
    cin, cm = w1.shape
    cout = w3.shape[1]
    if cm > KERNEL_CM or cout > KERNEL_COUT:
        raise ValueError(f"kernel D takes Cm <= {KERNEL_CM} and Cout <= "
                         f"{KERNEL_COUT}, got {cm}, {cout}")
    nk = -(-cin // KERNEL_CHUNK)
    bf = torch.bfloat16
    w1p = _pad(w1.to(bf), (nk * KERNEL_CHUNK, KERNEL_CM))
    w2p = _pad(w2.to(bf), (3, 3, KERNEL_CM, KERNEL_CM))
    order = conv3_column_order().to(w3.device)
    blocks = [_swizzle128(w1p[64 * k:64 * k + 64].t()) for k in range(nk)]
    blocks += [_swizzle128(w2p[dy, dx].t()) for dy in range(3)
               for dx in range(3)]
    blocks.append(_swizzle128(
        _pad(w3.to(bf), (KERNEL_CM, KERNEL_COUT)).t()[order]))
    if wd is not None:
        if nk != 1:
            raise ValueError(f"kernel D takes a projection only with Cin <= "
                             f"{KERNEL_CHUNK}, got {cin}")
        blocks.append(_swizzle128(
            _pad(wd.to(bf), (KERNEL_CHUNK, KERNEL_COUT)).t()[order]))
    zero = torch.zeros((KERNEL_COUT,), dtype=torch.float32, device=b3.device)
    bias = torch.cat([_pad(b1.float(), (KERNEL_CM,)),
                      _pad(b2.float(), (KERNEL_CM,)),
                      _pad(b3.float(), (KERNEL_COUT,)),
                      zero if bd is None else _pad(bd.float(), (KERNEL_COUT,))])
    return PackedBottleneck(torch.cat([b.reshape(-1) for b in blocks]),
                            bias.contiguous(), cin, cm, cout, wd is not None)


def unpack_bottleneck(packed: PackedBottleneck):
    """The inverse of :func:`pack_bottleneck_for_kernel`: (w1, b1, w2, b2,
    w3, b3, wd, bd) in the plain layout, bf16 weights and f32 biases (wd
    and bd None without a projection)."""
    cin, cm, cout = packed.cin, packed.cm, packed.cout
    nk = -(-cin // KERNEL_CHUNK)
    blocks = packed.weights.reshape(-1, 64)
    w1 = torch.cat([_swizzle128(blocks[64 * k:64 * k + 64]).t()
                    for k in range(nk)])[:cin, :cm]
    w2 = torch.stack([_swizzle128(blocks[64 * (nk + t):64 * (nk + t + 1)]).t()
                      for t in range(9)]).reshape(3, 3, 64, 64)[:, :, :cm, :cm]
    order = conv3_column_order().to(blocks.device)
    base = 64 * (nk + 9)
    w3 = _swizzle128(blocks[base:base + 256])[order].t()[:cm, :cout]
    b = packed.bias
    b1, b2, b3, bd = b[:cm], b[64:64 + cm], b[128:128 + cout], b[384:384 + cout]
    if not packed.proj:
        return w1, b1, w2, b2, w3, b3, None, None
    wd = _swizzle128(blocks[base + 256:base + 512])[order].t()[:cin, :cout]
    return w1, b1, w2, b2, w3, b3, wd, bd


def tile_origins(tiles: torch.Tensor, B: int, H: int,
                 W: int) -> Tuple[torch.Tensor, ...]:
    """Kernel D's tile walk: tile index -> (image, first row, first col) of
    its 8 x 16 output tile, column tiles fastest, then row tiles, then
    images (a raster order, so neighbouring CTAs share halo rows in L2). A
    persistent CTA ``c`` of a grid ``g`` takes tiles ``c, c + g, ...``."""
    ntx, nty = -(-W // TILE_W), -(-H // TILE_H)
    return (tiles // (ntx * nty), (tiles // ntx) % nty * TILE_H,
            tiles % ntx * TILE_W)


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     w3: torch.Tensor, b3: torch.Tensor,
                     wd: Optional[torch.Tensor] = None,
                     bd: Optional[torch.Tensor] = None,
                     plain: bool = False,
                     packed: Optional[PackedBottleneck] = None
                     ) -> torch.Tensor:
    """A BN-folded bottleneck (see :func:`fused_bottleneck_plain`). A CUDA
    ``x`` must be contiguous NHWC bf16 (the kernel raises otherwise); the
    kernel takes ``packed`` (:func:`pack_bottleneck_for_kernel` of these
    weights) or packs them here. ``plain`` runs the plain version whatever
    the device."""
    if wd is None and w1.shape[0] != w3.shape[1]:
        raise ValueError("an identity residual needs Cin == Cout")
    if plain or x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if packed is None:
        packed = pack_bottleneck_for_kernel(w1, b1, w2, b2, w3, b3, wd, bd)
    return kernels.fused_bottleneck(x, packed)
