"""SMAP backbone: the 3-stage stacked-hourglass network (counterpart of
``smap_tpu/models/smap.py``).

Images come in and maps go out in NHWC, as in the JAX package; inside, the
network is NCHW, in channels_last memory when the input is (an NHWC tensor
permuted to NCHW already is). Submodule names give the reference
state_dict keys, e.g. ``stage0.downsample.layer1.0.conv_bn_relu1.conv.weight``
(``smap_tpu.models.torch_convert.export_smap_state_dict``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smap_tpu_torch.config import ModelConfig
from smap_tpu_torch.models.layers import (Bottleneck, ConvBnRelu,
                                          PackedModule, PackedWeights,
                                          max_pool_3x3_s2, resize_bilinear)
from smap_tpu_torch.ops.fused_stem import fused_stem

RESNET50_LAYERS = (3, 4, 6, 3)

Heads = Tuple[bool, bool, bool]
ALL_HEADS: Tuple[Heads, ...] = ((True, True, True),) * 4


def _pack_stem(kernel: torch.Tensor, bias: torch.Tensor):
    return (kernel.detach().to(torch.bfloat16).contiguous(),
            bias.detach().float().contiguous())


class ResNetTop(PackedModule):
    """Stem: 7x7/2 conv + BN + ReLU, then 3x3/2 max-pool.

    ``fuse`` (with ``folded``): at width 64, on an image whose height is a
    multiple of 32 and width a multiple of 4 (the JAX package's condition),
    the stem runs as one :func:`~smap_tpu_torch.ops.fused_stem.fused_stem`
    call, in bf16 whatever the model's dtype, from the same
    ``conv.conv.{weight,bias}``."""

    def __init__(self, width: int = 64, folded: bool = False,
                 fuse: bool = False):
        super().__init__()
        self.width, self.folded, self.fuse = width, folded, fuse
        self.conv = ConvBnRelu(3, width, 7, stride=2, padding=3,
                               folded=folded)
        self._packed = PackedWeights(_pack_stem)

    def _fuse_eligible(self, x: torch.Tensor) -> bool:
        return (self.fuse and self.folded and self.width == 64
                and x.shape[2] % 32 == 0 and x.shape[3] % 4 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fuse_eligible(x):
            kernel, bias = self._packed.get([self.conv.conv.weight,
                                             self.conv.conv.bias])
            # NCHW in channels_last memory is NHWC: the permutes move no
            # data.
            y = fused_stem(x.permute(0, 2, 3, 1).to(torch.bfloat16)
                           .contiguous(), kernel, bias)
            return y.permute(0, 3, 1, 2).to(x.dtype)
        return max_pool_3x3_s2(self.conv(x))


class DownsampleModule(nn.Module):
    """ResNet-50 trunk emitting 4 scales, coarsest first."""

    def __init__(self, has_skip: bool = False, width: int = 64,
                 folded: bool = False, fuse: bool = False):
        super().__init__()
        self.has_skip = has_skip
        in_planes = width
        for li, blocks in enumerate(RESNET50_LAYERS):
            planes = width << li
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                has_ds = bi == 0 and (s != 1 or in_planes != planes * 4)
                layer.append(Bottleneck(in_planes, planes, s, has_ds,
                                        folded, fuse))
                in_planes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x, skip1: Optional[List[torch.Tensor]],
                skip2: Optional[List[torch.Tensor]]):
        feats = []
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
            if self.has_skip:
                x = x + skip1[li] + skip2[li]
            feats.append(x)
        x1, x2, x3, x4 = feats
        return x4, x3, x2, x1


class UpsampleUnit(nn.Module):
    """One decoder step with three heads: 2D heatmaps + PAFs, part-relative
    depth, root depth. ``heads`` in :meth:`forward` skips the heads the
    caller does not read (they come back as None)."""

    def __init__(self, ind: int, in_planes: int, up_size: Tuple[int, int],
                 output_shape: Tuple[int, int], kpt_paf_channels: int,
                 depth_channels: int, chl_num: int = 256,
                 gen_skip: bool = False, gen_cross_conv: bool = False,
                 cross_channels: int = 64, folded: bool = False):
        super().__init__()
        self.ind = ind
        self.up_size = tuple(up_size)
        self.output_shape = tuple(output_shape)

        def block(cin, cout, k, has_relu=True):
            return ConvBnRelu(cin, cout, k, has_relu=has_relu, folded=folded)

        self.u_skip = block(in_planes, chl_num, 1, has_relu=False)
        if ind > 0:
            self.up_conv = block(chl_num, chl_num, 1, has_relu=False)
        for prefix, channels in (("res", kpt_paf_channels),
                                 ("res_d", depth_channels), ("res_rd", 1)):
            setattr(self, f"{prefix}_conv1", block(chl_num, chl_num, 1))
            setattr(self, f"{prefix}_conv2",
                    block(chl_num, channels, 3, has_relu=False))
        self.gen_skip = gen_skip
        if gen_skip:
            self.skip1 = block(in_planes, in_planes, 1)
            self.skip2 = block(chl_num, in_planes, 1)
        self.gen_cross_conv = ind == 3 and gen_cross_conv
        if self.gen_cross_conv:
            self.cross_conv = block(chl_num, cross_channels, 1)

    def _head(self, prefix: str, out: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"{prefix}_conv1")(out)
        h = getattr(self, f"{prefix}_conv2")(h)
        return resize_bilinear(h, self.output_shape)

    def forward(self, x, up_x, heads: Heads = (True, True, True)):
        out = self.u_skip(x)
        if self.ind > 0:
            out = out + self.up_conv(resize_bilinear(up_x, self.up_size))
        out = F.relu(out)
        res, res_d, res_rd = (self._head(p, out) if on else None
                              for p, on in zip(("res", "res_d", "res_rd"),
                                               heads))
        skip1 = skip2 = cross_conv = None
        if self.gen_skip:
            skip1 = self.skip1(x)
            skip2 = self.skip2(out)
        if self.gen_cross_conv:
            cross_conv = self.cross_conv(out)
        return out, res, res_d, res_rd, skip1, skip2, cross_conv


class UpsampleModule(nn.Module):
    """4-scale decoder, coarsest unit first."""

    def __init__(self, output_shape: Tuple[int, int], kpt_paf_channels: int,
                 depth_channels: int, chl_num: int = 256,
                 gen_skip: bool = False, gen_cross_conv: bool = False,
                 width: int = 64, folded: bool = False):
        super().__init__()
        h, w = output_shape
        up_sizes = [(h // 8, w // 8), (h // 4, w // 4), (h // 2, w // 2),
                    (h, w)]
        in_planes = [width * 32, width * 16, width * 8, width * 4]
        for i in range(4):
            setattr(self, f"up{i + 1}", UpsampleUnit(
                i, in_planes[i], up_sizes[i], output_shape, kpt_paf_channels,
                depth_channels, chl_num, gen_skip, gen_cross_conv, width,
                folded))

    def forward(self, x4, x3, x2, x1,
                head_spec: Sequence[Heads] = ALL_HEADS):
        res, res_d, res_rd, skip1, skip2 = [], [], [], [], []
        out = cross_conv = None
        for i, x in enumerate((x4, x3, x2, x1)):
            out, r, rd, rrd, s1, s2, cc = getattr(self, f"up{i + 1}")(
                x, out, head_spec[i])
            res.append(r)
            res_d.append(rd)
            res_rd.append(rrd)
            skip1.append(s1)
            skip2.append(s2)
            if cc is not None:
                cross_conv = cc
        # The next stage's trunk consumes the skips finest first.
        return res, res_d, res_rd, skip1[::-1], skip2[::-1], cross_conv


class Stage(nn.Module):
    """Downsample + upsample hourglass."""

    def __init__(self, cfg: ModelConfig, has_skip: bool, gen_skip: bool,
                 gen_cross_conv: bool, fuse_bottleneck: bool = False):
        super().__init__()
        folded = cfg.quantized == "folded"
        self.downsample = DownsampleModule(has_skip, cfg.trunk_width, folded,
                                           fuse_bottleneck)
        self.upsample = UpsampleModule(
            cfg.output_shape, cfg.kpt_paf_channels, cfg.num_limbs,
            cfg.upsample_channels, gen_skip, gen_cross_conv, cfg.trunk_width,
            folded)

    def forward(self, x, skip1, skip2, head_spec: Sequence[Heads] = ALL_HEADS):
        x4, x3, x2, x1 = self.downsample(x, skip1, skip2)
        return self.upsample(x4, x3, x2, x1, head_spec)


def _nhwc_f32(r: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if r is None else r.float().permute(0, 2, 3, 1)


class SMAP(nn.Module):
    """Full SMAP network.

    :meth:`forward` takes NHWC images and returns a dict of per-stage lists
    (coarse to fine) of NHWC float32 maps: ``heatmap_2d`` ``[B, H, W, 43]``,
    ``det_d`` ``[B, H, W, 14]``, ``root_d`` ``[B, H, W, 1]``. The network
    computes in the dtype of its convolutions' parameters.

    ``cfg.quantized == "folded"`` builds the BN-folded serving model
    (``models.quantize.fold_bn_state_dict`` gives its weights). On it,
    ``fuse_stem`` and ``fuse_bottleneck`` route the stem and the eligible
    bottlenecks through the fused kernels; they are the counterparts of the
    JAX package's ``SMAP_TPU_FUSE_STEM`` and ``SMAP_TPU_FUSE_BOTTLENECK``,
    off by default as there, and change no state_dict key.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 fuse_stem: bool = False, fuse_bottleneck: bool = False):
        super().__init__()
        self.cfg = cfg
        self.top = ResNetTop(cfg.trunk_width, cfg.quantized == "folded",
                             fuse_stem)
        for i in range(cfg.stage_num):
            last = i == cfg.stage_num - 1
            setattr(self, f"stage{i}", Stage(cfg, has_skip=i > 0,
                                             gen_skip=not last,
                                             gen_cross_conv=not last,
                                             fuse_bottleneck=fuse_bottleneck))

    def forward(self, imgs: torch.Tensor,
                head_specs: Optional[Sequence[Sequence[Heads]]] = None
                ) -> Dict[str, List[List[Optional[torch.Tensor]]]]:
        dtype = self.top.conv.conv.weight.dtype
        x = self.top(imgs.permute(0, 3, 1, 2).to(dtype))
        outputs = {"heatmap_2d": [], "det_d": [], "root_d": []}
        skip1 = skip2 = None
        for i in range(self.cfg.stage_num):
            spec = ALL_HEADS if head_specs is None else head_specs[i]
            res, res_d, res_rd, skip1, skip2, x = getattr(
                self, f"stage{i}")(x, skip1, skip2, spec)
            outputs["heatmap_2d"].append([_nhwc_f32(r) for r in res])
            outputs["det_d"].append([_nhwc_f32(r) for r in res_d])
            outputs["root_d"].append([_nhwc_f32(r) for r in res_rd])
        return outputs

    def infer(self, imgs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The deployment readout: the sum of the last stage's three finest
        2D maps, and its finest rel-depth and root-depth maps (NHWC f32).
        Every head nothing reads is skipped."""
        off = (False, False, False)
        last_stage = (off, (True, False, False), (True, False, False),
                      (True, True, True))
        head_specs = ((off,) * 4,) * (self.cfg.stage_num - 1) + (last_stage,)
        outputs = self.forward(imgs, head_specs)
        hm = outputs["heatmap_2d"][-1]
        outputs_2d = hm[-1] + hm[-2] + hm[-3]
        return outputs_2d, outputs["det_d"][-1][-1], outputs["root_d"][-1][-1]


def init_smap(cfg: ModelConfig = ModelConfig(), seed: int = 0) -> SMAP:
    """A SMAP with seeded random weights drawn as the JAX package draws
    them: kaiming-normal conv kernels (fan in, gain sqrt(2), normal
    truncated at two standard deviations, as ``jax.nn.initializers``
    does), zero conv biases, identity BatchNorm (scale 1, bias 0, mean 0,
    var 1). The numbers differ from a Flax init of the same seed."""
    model = SMAP(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                # Std of the untruncated normal whose [-2, 2] truncation
                # has variance 2 / fan_in.
                std = (2.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.bias.zero_()
    return model.eval()
