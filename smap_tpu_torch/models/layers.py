"""Shared model building blocks (counterpart of ``smap_tpu/models/layers.py``).

NCHW modules. Submodule names follow the reference state_dict layout
(``conv`` / ``bn`` inside each conv block, ``conv_bn_relu1..3`` and
``downsample`` inside a bottleneck) so a reference checkpoint loads with
``load_state_dict`` as it is. ``quant`` is ``ModelConfig.quantized``: a
BN-folded model (``"folded"``, ``models.quantize.fold_bn_state_dict``) has
no ``bn`` submodules; an int8 model (True or ``"static"``,
``models.quantize.quantize_state_dict``) has none either, and each ``conv``
is an :class:`Int8Conv`.

Training (``module.train()``) follows Flax as the JAX package trains:
float32 parameters, each conv casting its kernel and bias to the input's
dtype per call (so gradients reach the float32 weights), and BatchNorm
normalising in float32 by the batch's biased variance, with that same
variance in its running statistics.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smap_tpu_torch.ops import kernels
from smap_tpu_torch.ops.conv_epilogue import (conv_epilogue_plain,
                                              epilogue_params, use_kernel)
from smap_tpu_torch.ops.fused_block import (fused_bottleneck,
                                           pack_bottleneck_for_kernel)
from smap_tpu_torch.ops.int8_conv import (act_absmax, int8_conv2d,
                                          pack_int8_weights,
                                          scale_from_absmax)
from smap_tpu_torch.parallel.distributed import all_reduce_sum, process_count

# A bottleneck fuses only when its height is a multiple of this: the JAX
# package's condition (its kernel's row band), kept so that the same blocks
# take the kernel in both packages.
FUSE_ROWS = 8


class _FlaxBatchNorm:
    """Train mode of Flax's ``nn.BatchNorm(momentum=0.9)``, for a subclass
    of a PyTorch BatchNorm (whose eval mode and state_dict keys it keeps).

    PyTorch moves ``running_var`` towards the batch's unbiased variance;
    Flax, and so the JAX package, towards the biased one it normalises by
    (at 192 pixels a channel that is a factor 192/191 on every update).
    The batch statistics come from ``torch.native_batch_norm``, which
    normalises in float32 whatever the input's dtype; the variance is taken
    back from its inverse standard deviation in float64. ``frozen`` (set by
    :func:`frozen_batch_stats`) leaves the running statistics alone.

    In a process group of more than one rank the statistics are those of
    the global batch, as the JAX package's under SPMD: per-channel sums of
    x and x^2 and the count, all-reduced, give mean(x^2) - mean(x)^2
    (Flax's ``use_fast_variance``, clipped at 0), and the backward carries
    the statistics' gradient to every rank through the all-reduce."""

    frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if process_count() > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        if not self.frozen:
            with torch.no_grad():
                if var is None:
                    var = invstd.double().pow(-2).sub_(self.eps).clamp_(min=0)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var.float(), alpha=m)
                self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor):
        """(normalized x in its dtype, mean, variance) by the global
        batch's statistics, in float32 (float64 for a float64 x), with
        Flax's arithmetic: ``(x - mean) * (rsqrt(var + eps) * scale) +
        bias``."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [d for d in range(x.dim()) if d != 1]
        count = torch.full((1,), x.numel() // x.shape[1], dtype=xf.dtype,
                           device=x.device)
        sums = all_reduce_sum(torch.cat(
            [xf.sum(dims), (xf * xf).sum(dims), count]))
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0)
        shape = [1, c] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = ((xf - mean.view(shape)) * mul.view(shape)
             + self.bias.to(xf.dtype).view(shape))
        return y.to(x.dtype), mean.detach(), var.detach()


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is Flax's (:class:`_FlaxBatchNorm`)."""


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train mode is Flax's (:class:`_FlaxBatchNorm`)."""


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Inside the block, the train-mode BatchNorms of ``module`` normalise
    by the batch but do not update their running statistics: a stage
    recomputed in the backward pass (``ModelConfig.remat``) updated them
    once already, in its forward, as Flax's ``nn.remat`` does."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


class PackedWeights:
    """Weights repacked for a kernel, built once per weight state.

    The owning module clears it on ``load_state_dict`` and on every move
    or cast (``_apply``); the key (each source tensor's storage and
    version counter) also catches an in-place update of a weight."""

    def __init__(self, pack: Callable[..., tuple]):
        self._pack = pack
        self.clear()

    def clear(self) -> None:
        self._key = None
        self._value: tuple = ()

    def get(self, sources: Sequence[torch.Tensor]) -> tuple:
        key = tuple((t.data_ptr(), t._version) for t in sources)
        if key != self._key:
            with torch.no_grad():
                self._value = self._pack(*sources)
            self._key = key
        return self._value


class PackedModule(nn.Module):
    """A module with a :class:`PackedWeights` ``self._packed``, cleared
    whenever its weights are loaded, moved or cast."""

    _packed: PackedWeights

    def _apply(self, fn, *args, **kwargs):
        self._packed.clear()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed.clear()
        super()._load_from_state_dict(*args, **kwargs)


class Int8Conv(PackedModule):
    """The int8 convolution of the JAX package's ``Conv2D(quant=...)``:
    int8 ``kernel_q`` [out, in, k, k] (OIHW), float32 ``kernel_scale``
    [out] and ``bias`` [out] (BatchNorm folded in), and under ``static`` a
    frozen float32 ``act_scale`` (a 0-dim tensor). Otherwise each input's
    scale is taken on the device (``ops.int8_conv.dynamic_scale``).

    The input is quantized per tensor, convolved, dequantized, cast to
    ``out_dtype`` (float32 until ``to_compute_dtype`` sets it) and passed
    through the ReLU when ``relu``, all by
    :func:`~smap_tpu_torch.ops.int8_conv.int8_conv2d`: on the card one
    launch of kernel E on the bf16 (or float32) input, its weights packed
    once per weight state.

    ``act_scale`` is kept only when it is loaded: as in the JAX package, a
    conv that the deployment readout never runs has none after
    calibration, and a strict ``load_state_dict`` takes state_dicts with or
    without it; running such a conv raises. ``record``, when a list, gets
    the abs-max of every input (a 0-dim device tensor) for calibration.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, relu: bool = False,
                 static: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.relu, self.static = relu, static
        self.out_dtype = torch.float32
        self.record: Optional[List[torch.Tensor]] = None
        self.register_buffer("kernel_q", torch.zeros(
            (out_ch, in_ch, kernel_size, kernel_size), dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(out_ch))
        self.register_buffer("bias", torch.zeros(out_ch))
        self.register_buffer("act_scale", None)
        self._packed = PackedWeights(lambda wq: (pack_int8_weights(wq),))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.static and f"{prefix}act_scale" in state_dict:
            self.act_scale = torch.zeros((), device=self.bias.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.static:
            if self.act_scale is None:
                raise RuntimeError(
                    "static int8 conv without an act_scale: run "
                    "models.quantize.calibrate_activation_scales on the "
                    "weights (the deployment readout never runs this conv)")
            s_x = self.act_scale
        else:
            absmax = act_absmax(x)
            if self.record is not None:
                self.record.append(absmax)
            s_x = scale_from_absmax(absmax)
        packed = (self._packed.get([self.kernel_q])[0] if x.is_cuda
                  else None)
        return int8_conv2d(x, self.kernel_q, self.kernel_scale, s_x,
                           self.bias, self.stride, self.padding, self.relu,
                           self.out_dtype, packed=packed)


class ConvBnRelu(PackedModule):
    """Conv2d (with bias) + BatchNorm (eps 1e-5; by the running statistics
    in eval mode, by the batch in train mode) + optional ReLU;
    ``quant="folded"``: the conv alone, BatchNorm being folded into it;
    int8 ``quant``: an :class:`Int8Conv` with the ReLU in its epilogue.

    ``padding=None`` is SAME for odd kernels (``k // 2``).

    The conv's epilogue (bias, BatchNorm, a ``residual`` given to
    :meth:`forward`, the ReLU) is one launch of kernel F
    (``ops.conv_epilogue``) on the card in eval mode under ``no_grad``, its
    per-channel values computed once per weight state; otherwise the plain
    chain of ops."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding=None, has_relu: bool = True,
                 quant: Any = False):
        super().__init__()
        if padding is None:
            padding = kernel_size // 2
        if quant and quant != "folded":
            self.conv = Int8Conv(in_ch, out_ch, kernel_size, stride, padding,
                                 relu=has_relu, static=quant == "static")
        else:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                                  padding=padding, bias=True)
        self.bn = None if quant else BatchNorm2d(out_ch, eps=1e-5,
                                                 momentum=0.1)
        self.has_relu = has_relu
        self._packed = PackedWeights(
            lambda *t: (epilogue_params(*t, eps=1e-5),))

    @property
    def dtype(self) -> torch.dtype:
        """The dtype this block computes and returns."""
        c = self.conv
        return c.out_dtype if isinstance(c, Int8Conv) else c.weight.dtype

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                relu: Optional[bool] = None) -> torch.Tensor:
        """The block on ``x``; a ``residual`` (for a block without a ReLU
        of its own: a bottleneck's shortcut, an upsample unit's skip) is
        added after BatchNorm, and then ``relu`` (default ``has_relu``)
        applies."""
        relu = self.has_relu if relu is None else relu
        c = self.conv
        if isinstance(c, Int8Conv):
            y = c(x)   # with has_relu's ReLU, in kernel E
            if residual is None and relu == self.has_relu:
                return y
            if use_kernel(self, y):
                return kernels.conv_epilogue(y, None, residual, bias=False,
                                             bn=False, relu=relu)
            return conv_epilogue_plain(y, residual=residual, relu=relu)
        w, b = c.weight, c.bias
        if w.dtype != x.dtype:   # float32 parameters, a bf16 forward
            w, b = w.to(x.dtype), b.to(x.dtype)
        # The bias is added to the conv's result rounded to its dtype, as
        # the JAX package's Conv2D does (and PyTorch's cuDNN path does on
        # the card; on the CPU a fused bias would round once, not twice).
        y = F.conv2d(x, w, None, c.stride, c.padding)
        if use_kernel(self, y):
            bn = self.bn
            sources = [c.bias] if bn is None else [
                c.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias]
            return kernels.conv_epilogue(y, self._packed.get(sources)[0],
                                         residual, bias=True,
                                         bn=bn is not None, relu=relu)
        return conv_epilogue_plain(y, b, self.bn, residual, relu)


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.detach().float().contiguous()


def _matrix(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv's OIHW weight -> ``[in, out]`` bf16."""
    return w.detach()[:, :, 0, 0].t().to(torch.bfloat16).contiguous()


def _pack_bottleneck(w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """(the plain layout's weights, kernel D's image of them)."""
    plain = (_matrix(w1), _bias(b1),
             w2.detach().permute(2, 3, 1, 0).to(torch.bfloat16).contiguous(),
             _bias(b2), _matrix(w3), _bias(b3))
    if wd is not None:
        plain += (_matrix(wd), _bias(bd))
    return plain, pack_bottleneck_for_kernel(*plain)


class Bottleneck(PackedModule):
    """ResNet-50 bottleneck block (1x1 -> 3x3/stride -> 1x1, expansion 4).

    ``fuse`` (with ``quant="folded"``): a stride-1 block with ``planes <=
    64`` and a height that is a multiple of ``FUSE_ROWS`` runs as one
    :func:`~smap_tpu_torch.ops.fused_block.fused_bottleneck` call, in bf16
    whatever the model's dtype (as the JAX package does), with the same
    state_dict keys."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, quant: Any = False,
                 fuse: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.planes, self.stride = planes, stride
        self.quant, self.fuse = quant, fuse
        self.conv_bn_relu1 = ConvBnRelu(in_planes, planes, 1, quant=quant)
        self.conv_bn_relu2 = ConvBnRelu(planes, planes, 3, stride=stride,
                                        padding=1, quant=quant)
        self.conv_bn_relu3 = ConvBnRelu(planes, out, 1, has_relu=False,
                                        quant=quant)
        self.downsample = (ConvBnRelu(in_planes, out, 1, stride=stride,
                                      padding=0, has_relu=False,
                                      quant=quant)
                           if has_downsample else None)
        self._packed = PackedWeights(_pack_bottleneck)

    def _fuse_eligible(self, x: torch.Tensor) -> bool:
        return (self.fuse and self.quant == "folded" and self.stride == 1
                and self.planes <= 64 and x.shape[2] % FUSE_ROWS == 0)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        convs = [self.conv_bn_relu1, self.conv_bn_relu2, self.conv_bn_relu3]
        if self.downsample is not None:
            convs.append(self.downsample)
        sources = [t for c in convs for t in (c.conv.weight, c.conv.bias)]
        plain, packed = self._packed.get(sources)
        # NCHW in channels_last memory is NHWC: the permutes move no data.
        y = fused_bottleneck(
            x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(), *plain,
            packed=packed)
        return y.permute(0, 3, 1, 2).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fuse_eligible(x):
            return self._fused(x)
        out = self.conv_bn_relu2(self.conv_bn_relu1(x))
        if self.downsample is None:
            return self.conv_bn_relu3(out, residual=x, relu=True)
        # conv3 before the projection, as the chain ran them: its input is
        # freed before the projection's output is made.
        out = self.conv_bn_relu3(out)
        return self.downsample(x, residual=out, relu=True)


def to_compute_dtype(module: nn.Module, device: torch.device,
                     dtype: torch.dtype) -> nn.Module:
    """Move ``module`` to ``device`` in channels_last memory, with its
    convolutions in ``dtype`` and every BatchNorm's parameters and
    statistics in float32, as Flax keeps them: a bf16 forward then
    normalises in float32 and rounds once, as the JAX package's does.
    (The BatchNorm values are never cast: a round trip through bf16 would
    keep its rounding.) An :class:`Int8Conv` keeps its int8 and float32
    values and returns ``dtype``."""
    module.to(device=device, memory_format=torch.channels_last)
    for m in module.modules():
        if isinstance(m, Int8Conv):
            m.out_dtype = dtype
        elif not isinstance(m, nn.BatchNorm2d) and not any(m.children()):
            m.to(dtype)
    return module


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``[B, C, H, W]`` with ``align_corners=True``."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max-pool with pad 1; the padding never wins (-inf)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
