"""Kernel F, the conv epilogue (``ops/conv_epilogue.py``,
``csrc/conv_epilogue.cu``): bias, eval-mode BatchNorm, residual and ReLU
in one pass over a channels-last conv output.

On the CPU: the plain version is the model's chain of ops from before the
kernel, bit for bit, in every form; the kernel's BatchNorm factor is
Flax's; models give the same maps as with the forwards from before the
kernel; with the routing forced and the kernel's arithmetic emulated
(:func:`emulate`), every conv block's epilogue reaches the wrapper, once;
the wrapper refuses CPU tensors and other layouts.

Marked ``cuda`` (they skip without a card, the kernel having no CPU
mode): the kernel against its emulation (bit for bit) and its plain
version at every channel count of the model. This file imports no JAX at
its top, so on the card:

    python -m pytest tests/test_torch_conv_epilogue.py -q -m cuda \
        -p no:randomly --noconftest
"""

import copy
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smap_tpu_torch.config import ModelConfig
from smap_tpu_torch.models import layers
from smap_tpu_torch.models import smap as smap_mod
from smap_tpu_torch.models.quantize import (fold_bn_state_dict,
                                            quantize_state_dict)
from smap_tpu_torch.models.smap import SMAP, init_smap
from smap_tpu_torch.ops import kernels
from smap_tpu_torch.ops.conv_epilogue import (conv_epilogue_plain,
                                              epilogue_params, use_kernel)

TINY = dict(stage_num=3, trunk_width=8, upsample_channels=16,
            output_shape=(16, 24), compute_dtype="float32")
INPUT_HW = (64, 96)
# Epilogues of a 3-stage deployment readout (``SMAP.infer``): one for
# each of its 206 convs unfolded or folded, but those of the bottlenecks
# kernel D takes; an int8 model's conv epilogues run in kernel E, leaving
# the 48 bottlenecks' and 9 upsample units' residual adds and the 3 first
# units' ReLU.
CONVS, INT8_EPILOGUES = 206, 60
# The kernel against the plain chain with BatchNorm. The kernel runs
# Flax's arithmetic, PyTorch's BatchNorm its own: in float32 on an H100
# PyTorch's lies up to ~250 x 2^-24 of its terms (|(y - mean) * factor| +
# |shift|) from the exact value, the kernel's (three roundings) within
# 2.9 x 2^-24 (F32_TERMS_ULPS bounds it). In bf16 the results are then one
# ulp of the output apart where the float32 value lies near a rounding
# point (1e-6 to 5e-5 of the elements), one more of the BatchNorm's value
# after a residual add, and where the terms cancel PyTorch's float32 error
# (BF16_TERMS, twice its measured bound) can exceed an ulp of the small
# output; at most BN_SHARE of the elements apart in all.
BN_SHARE = 1e-3
BF16_TERMS = 2.0 ** -15
F32_TERMS_ULPS = 4.0

FORMS = [dict(bias=b, bn=n, res=r, relu=u)
         for b, n, r, u in itertools.product((True, False), repeat=4)
         if (b or not n) and (b or n or r or u)]


def _form_id(f):
    return "+".join(k for k, v in f.items() if v)


def _perturbed_bn(bn: torch.nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        c = bn.num_features
        bn.weight.copy_(torch.rand(c, generator=gen) * 0.6 + 0.7)
        bn.bias.copy_(torch.randn(c, generator=gen) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)


def _state_dict(seed: int = 0):
    """TINY's weights with seeded BatchNorm statistics and conv biases."""
    sd = init_smap(ModelConfig(**TINY), seed=seed).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for key, v in sd.items():
        if key.endswith("bn.weight"):
            sd[key] = torch.rand(v.shape, generator=gen) * 0.6 + 0.7
        elif key.endswith(("bn.bias", "bn.running_mean")):
            sd[key] = torch.randn(v.shape, generator=gen) * 0.1
        elif key.endswith("bn.running_var"):
            sd[key] = torch.rand(v.shape, generator=gen) * 1.5 + 0.5
        elif key.endswith("conv.bias"):
            sd[key] = torch.randn(v.shape, generator=gen) * 0.05
    return sd


def _model(mode: str, dtype: torch.dtype) -> SMAP:
    sd = _state_dict()
    quant = {"unfolded": False, "folded": "folded", "folded-fused": "folded",
             "int8": True}[mode]
    if quant == "folded":
        sd = fold_bn_state_dict(sd)
    elif quant:
        sd = quantize_state_dict(sd)
    fuse = mode == "folded-fused"
    model = SMAP(ModelConfig(**dict(TINY, quantized=quant)), fuse_stem=fuse,
                 fuse_bottleneck=fuse)
    model.load_state_dict(sd, strict=True)
    return layers.to_compute_dtype(model, torch.device("cpu"), dtype).eval()


def _images(seed: int = 0, batch: int = 2) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randn(batch, *INPUT_HW, 3).astype(np.float32))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x|, in float64."""
    e = torch.floor(torch.log2(x.double().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def emulate(y, params=None, residual=None, *, bias, bn, relu):
    """The kernel's arithmetic in PyTorch ops, each rounded as the kernel
    rounds it (the kernel's spec), in place on ``y``."""
    p = None if params is None else params.float()[:, :, None, None]
    v = y.float()
    if bias:
        v = (v + p[0].to(y.dtype).float()).to(y.dtype).float()
    if bn:
        v = ((v - p[1]) * p[2] + p[3]).to(y.dtype).float()
    if residual is not None:
        v = (v + residual.float()).to(y.dtype).float()
    if relu:
        v = torch.where(v < 0, torch.zeros_like(v), v)
    return y.copy_(v)


# The forwards from before the kernel, for the model tests.
def _old_conv_bn_relu(self, x):
    c = self.conv
    if isinstance(c, layers.Int8Conv):
        return c(x)
    w, b = c.weight, c.bias
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    x = F.conv2d(x, w, None, c.stride, c.padding).add_(b[:, None, None])
    if self.bn is not None:
        x = self.bn(x)
    return F.relu(x) if self.has_relu else x


def _old_bottleneck(self, x):
    if self._fuse_eligible(x):
        return self._fused(x)
    out = self.conv_bn_relu3(self.conv_bn_relu2(self.conv_bn_relu1(x)))
    if self.downsample is not None:
        x = self.downsample(x)
    return F.relu(out + x)


def _old_upsample_unit(self, x, up_x, heads=(True, True, True)):
    out = self.u_skip(x)
    if self.ind > 0:
        out = out + self.up_conv(layers.resize_bilinear(up_x, self.up_size))
    out = F.relu(out)
    res, res_d, res_rd = (self._head(p, out) if on else None
                          for p, on in zip(("res", "res_d", "res_rd"), heads))
    skip1 = skip2 = cross_conv = None
    if self.gen_skip:
        skip1 = self.skip1(x)
        skip2 = self.skip2(out)
    if self.gen_cross_conv:
        cross_conv = self.cross_conv(out)
    return out, res, res_d, res_rd, skip1, skip2, cross_conv


def _old_forwards(monkeypatch):
    monkeypatch.setattr(layers.ConvBnRelu, "forward", _old_conv_bn_relu)
    monkeypatch.setattr(layers.Bottleneck, "forward", _old_bottleneck)
    monkeypatch.setattr(smap_mod.UpsampleUnit, "forward", _old_upsample_unit)


def _block(form, dtype, c=24, seed=0):
    """A ConvBnRelu (BatchNorm with seeded statistics when the form has
    it), its input and, with a residual, a residual of its output's
    shape."""
    gen = torch.Generator().manual_seed(seed)
    block = layers.ConvBnRelu(16, c, 3,
                              has_relu=form["relu"] and not form["res"],
                              quant=False if form["bn"] else "folded")
    with torch.no_grad():
        block.conv.weight.normal_(0, 0.2, generator=gen)
        block.conv.bias.normal_(0, 0.3, generator=gen)
    if form["bn"]:
        _perturbed_bn(block.bn, gen)
    block = block.to(dtype=dtype, memory_format=torch.channels_last).eval()
    if form["bn"]:
        block.bn.float()
    x = torch.randn((2, 16, 9, 13), generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn((2, c, 9, 13), generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) if form["res"] else None
    return block, x, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", [f for f in FORMS if f["bias"]],
                         ids=_form_id)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_plain_is_the_chain_before_the_kernel(form, dtype, train):
    """The block's plain path (the CPU's, train mode's) equals the ops the
    model ran before the kernel, bit for bit: the conv, the bias ``add_``
    in the block's dtype, the BatchNorm module, ``+ residual``,
    ``F.relu``."""
    block, x, r = _block(form, dtype)
    block.train(train)
    twin = copy.deepcopy(block)
    with torch.no_grad():
        got = block(x, residual=r, relu=form["relu"])
        want = _old_conv_bn_relu(twin, x)
        if r is not None:
            want = want + r
            want = F.relu(want) if form["relu"] else want
    assert got.dtype == dtype
    assert torch.equal(got, want)
    if form["bn"] and train:   # the batch statistics moved alike
        assert torch.equal(block.bn.running_var, twin.bn.running_var)


def test_plain_residual_relu_forms_of_int8():
    """An int8 block's residual form after kernel E: ``relu(E(x) + r)``,
    and the ReLU alone after an E without one."""
    gen = torch.Generator().manual_seed(3)
    block = layers.ConvBnRelu(16, 8, 1, has_relu=False, quant=True).eval()
    with torch.no_grad():
        block.conv.kernel_q.copy_(torch.randint(-127, 128, (8, 16, 1, 1),
                                                generator=gen))
        block.conv.kernel_scale.fill_(0.01)
        block.conv.bias.normal_(0, 0.3, generator=gen)
    x = torch.randn((2, 16, 5, 7), generator=gen)
    r = torch.randn((2, 8, 5, 7), generator=gen)
    with torch.no_grad():
        y = block.conv(x)
        assert torch.equal(block(x, residual=r, relu=True), F.relu(y + r))
        assert torch.equal(block(x, relu=True), F.relu(y))
        assert torch.equal(block(x), y)


def test_bn_factor_is_flax():
    """``epilogue_params``' factor against Flax's ``rsqrt(var + eps) *
    scale`` in float32 (JAX on the CPU): XLA's rsqrt and the correctly
    rounded one here differ by at most 1 ulp, so the factors by at most 2
    float32 ulps; the other rows are the statistics and parameters as
    they are."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    c = 2048
    var = (rng.rand(c) * 3).astype(np.float32)
    var[:200] = rng.rand(200).astype(np.float32) * 1e-4   # near eps
    scale = (rng.rand(c) * 2 - 0.5).astype(np.float32)
    mean, shift, bias = (rng.randn(c).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda v, s: jax.lax.rsqrt(v + 1e-5) * s)(
        jnp.asarray(var), jnp.asarray(scale)))
    got = epilogue_params(*(torch.from_numpy(a) for a in
                            (bias, mean, var, scale, shift)), eps=1e-5)
    assert got.dtype == torch.float32 and got.shape == (4, c)
    np.testing.assert_array_equal(got[0].numpy(), bias)
    np.testing.assert_array_equal(got[1].numpy(), mean)
    np.testing.assert_array_equal(got[3].numpy(), shift)
    ulps = np.abs(got[2].numpy().view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    exact = 1.0 / np.sqrt(var.astype(np.float64)
                          + np.float64(np.float32(1e-5))) * scale
    np.testing.assert_allclose(got[2].numpy(), exact, rtol=2 ** -22)
    # Without BatchNorm: the bias, zeros.
    only = epilogue_params(torch.from_numpy(bias))
    assert torch.equal(only[0], torch.from_numpy(bias))
    assert not only[1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["unfolded", "folded", "folded-fused",
                                  "int8"])
def test_models_unchanged_by_the_routing(monkeypatch, mode, dtype):
    """A small unfolded, folded, folded-fused and int8 model give the same
    maps, every head of every stage and the deployment readout, as with
    the forwards from before the kernel, bit for bit (the CPU runs the
    plain chain)."""
    model = _model(mode, dtype)
    imgs = _images()
    with torch.no_grad():
        got = model(imgs), model.infer(imgs)
        with monkeypatch.context() as m:
            _old_forwards(m)
            want = model(imgs), model.infer(imgs)
    for key in got[0]:
        for g_stage, w_stage in zip(got[0][key], want[0][key]):
            for g, w in zip(g_stage, w_stage):
                assert torch.equal(g, w), key
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


def test_training_forward_and_gradients_unchanged(monkeypatch):
    """Train mode with autograd (the plain chain): the same losses'
    gradients and BatchNorm statistics as the forwards from before."""
    runs = []
    for old in (False, True):
        torch.manual_seed(0)
        model = SMAP(ModelConfig(**TINY))
        model.load_state_dict(_state_dict())
        model = model.to(memory_format=torch.channels_last).train()
        with monkeypatch.context() as m:
            if old:
                _old_forwards(m)
            out = model(_images(batch=2))
            loss = sum(t.square().mean() for maps in out.values()
                       for stage in maps for t in stage)
            loss.backward()
        runs.append((loss.detach(),
                     [p.grad for p in model.parameters()],
                     [b.clone() for b in model.buffers()]))
    (l0, g0, b0), (l1, g1, b1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_use_kernel_needs_the_card_eval_and_no_grad():
    class Card:     # stands for a CUDA tensor
        is_cuda = True

    block = layers.ConvBnRelu(4, 4, 1).eval()
    with torch.no_grad():
        assert use_kernel(block, Card())
        assert not use_kernel(block, torch.zeros(1))
        block.train()
        assert not use_kernel(block, Card())
    block.eval()
    assert not use_kernel(block, Card())


@pytest.mark.parametrize("mode", ["unfolded", "folded-fused", "int8"])
def test_routed_forward_reaches_the_kernel_once_a_block(monkeypatch, mode):
    """With the routing forced on the CPU and the kernel's arithmetic
    emulated, the deployment readout makes its epilogues through the
    wrapper, each on a channels-last tensor: one a conv block run (those
    of kernel D's bottlenecks aside; int8: INT8_EPILOGUES). Its maps are
    the plain chain's bit for bit without BatchNorm (the same roundings),
    within a few bf16 ulps with it (Flax's BatchNorm order, rounded per
    layer)."""
    model = _model(mode, torch.bfloat16)
    imgs = _images()
    blocks = []
    for m in model.modules():
        if isinstance(m, layers.ConvBnRelu):
            m.register_forward_hook(lambda *a: blocks.append(1))
    with torch.no_grad():
        want = model.infer(imgs)
    calls = []

    def kernel(y, params=None, residual=None, *, bias, bn, relu):
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert residual is None or residual.is_contiguous(
            memory_format=torch.channels_last)
        calls.append((tuple(y.shape), bias, bn, residual is not None, relu))
        return emulate(y, params, residual, bias=bias, bn=bn, relu=relu)

    monkeypatch.setattr(
        layers, "use_kernel",
        lambda m, y: not m.training and not torch.is_grad_enabled())
    monkeypatch.setattr(kernels, "conv_epilogue", kernel)
    blocks.clear()
    with torch.no_grad():
        got = model.infer(imgs)
    assert len(calls) == {"unfolded": CONVS, "folded-fused": len(blocks),
                          "int8": INT8_EPILOGUES}[mode]
    assert len(blocks) == (CONVS if mode == "unfolded" else len(blocks))
    assert any(c[1] for c in calls) == (mode != "int8")
    assert any(c[2] for c in calls) == (mode == "unfolded")
    for g, w in zip(got, want):
        if mode == "unfolded":
            rel = float((g - w).norm() / w.norm())
            assert rel < 2.0 ** -6, rel
        else:
            assert torch.equal(g, w)


def test_wrapper_refuses_cpu_and_other_layouts():
    y = torch.zeros((2, 16, 5, 7)).contiguous(
        memory_format=torch.channels_last)
    params = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv_epilogue(y, params, bias=True, bn=False, relu=True)
    with pytest.raises(ValueError, match="channels-last"):
        kernels.conv_epilogue(y.contiguous(), params, bias=True, bn=False,
                              relu=True)
    with pytest.raises(ValueError, match="residual: expected a channels-last"):
        kernels.conv_epilogue(y, params, torch.zeros((2, 16, 5, 7)),
                              bias=True, bn=False, relu=True)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kernels.conv_epilogue(y.half(), params, bias=True, bn=False,
                              relu=True)
    with pytest.raises(ValueError, match="C <= 2048"):
        kernels.conv_epilogue(torch.zeros((1, 2056, 1, 1)).contiguous(
            memory_format=torch.channels_last), None, bias=False, bn=False,
            relu=True)


def test_emulation_of_the_kernel_rounds_each_step():
    """The emulation (the card tests' bit-for-bit reference) rounds the
    bias to the type first, keeps NaN through the ReLU, and in float32 is
    the chain's arithmetic without BatchNorm."""
    y = torch.tensor([1.0, -3.0, float("nan"), 0.5],
                     dtype=torch.bfloat16).reshape(1, 4, 1, 1)
    params = torch.zeros((4, 4))
    params[0] = torch.tensor([2.0 ** -9, 0.0, 1.0, -1.0])
    got = emulate(y.clone(), params, bias=True, bn=False, relu=True)
    # 1 + 2^-9 rounds back to 1 in bf16 (the bias rounds to itself first).
    assert got.flatten()[0] == 1.0 and got.flatten()[1] == 0.0
    assert torch.isnan(got.flatten()[2]) and got.flatten()[3] == 0.0


# ---- on the card ----------------------------------------------------------

# Every channel count the model's epilogues see: the heads' 1, 14 and 43,
# the trunk's and decoder's 64-2048.
CHANNELS = (1, 14, 43, 64, 128, 256, 512, 1024, 2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(dev, c, form, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    shape = (2, c, 11, 37)
    y = (torch.randn(shape, generator=gen) * 2).to(dtype).to(dev).contiguous(
        memory_format=torch.channels_last)
    r = (torch.randn(shape, generator=gen).to(dtype).to(dev).contiguous(
        memory_format=torch.channels_last) if form["res"] else None)
    bias = torch.randn(c, generator=gen) * 0.3
    bn = None
    if form["bn"]:
        bn = layers.BatchNorm2d(c, eps=1e-5)
        _perturbed_bn(bn, gen)
        bn = bn.to(dev).eval()
    params = (epilogue_params(
        bias, *((bn.running_mean, bn.running_var, bn.weight, bn.bias)
                if bn is not None else ())).to(dev)
        if form["bias"] else None)
    return y, r, bias.to(dev), bn, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("form", FORMS, ids=_form_id)
@pytest.mark.parametrize("c", CHANNELS)
def test_kernel_matches_emulation_and_plain(dev, c, form, dtype):
    """Bit for bit the emulation, in every form; the plain chain bit for
    bit without BatchNorm; with it, in bf16 one ulp of the output apart
    (one more of the BatchNorm's value before a residual, BF16_TERMS of
    the terms where they cancel) on at most BN_SHARE of the elements; in
    float32 the kernel within F32_TERMS_ULPS of the exact value (see
    BN_SHARE)."""
    y, r, bias, bn, params = _card_case(dev, c, form, dtype, seed=c)
    kw = dict(bias=form["bias"], bn=form["bn"], relu=form["relu"])
    before = kernels.EPILOGUE_LAUNCHES
    with torch.no_grad():
        got = kernels.conv_epilogue(y.clone(), params, r, **kw)
        spec = emulate(y.clone(), params, r, **kw)
        plain = conv_epilogue_plain(
            y.clone(), bias.to(dtype) if form["bias"] else None, bn, r,
            form["relu"])
    torch.cuda.synchronize()
    assert kernels.EPILOGUE_LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, spec)
    if not form["bn"]:
        assert torch.equal(got, plain)
        return
    diff = (got.double() - plain.double()).abs()
    share = float((diff > 0).double().mean())
    p = params.double()[:, :, None, None]
    if dtype == torch.bfloat16:
        with torch.no_grad():
            yb = emulate(y.clone(), params, bias=True, bn=False,
                         relu=False).double()
            value = emulate(y.clone(), params, bias=True, bn=True,
                            relu=False)
        terms = ((yb - p[1]) * p[2]).abs() + p[3].abs()
        bound = (_bf16_ulp(torch.maximum(got.abs(), plain.abs()))
                 + BF16_TERMS * terms)
        if r is not None:
            bound = bound + _bf16_ulp(value)
        print(f"C {c} {_form_id(form)} bf16: {share:.2e} of the elements "
              f"apart from the plain chain, at most "
              f"{float((diff / bound).max()):.2f} of the bound")
        assert bool((diff <= bound).all())
        assert share <= BN_SHARE
        return
    yb = (y + bias[:, None, None]).double()         # rounded as the kernel
    terms = ((yb - p[1]) * p[2]).abs() + p[3].abs()
    exact = (yb - p[1]) * p[2] + p[3]
    if r is not None:
        exact = exact + r.double()
        terms = terms + r.double().abs()
    if form["relu"]:
        exact = exact.clamp(min=0)
    tol = F32_TERMS_ULPS * 2.0 ** -24 * (terms + exact.abs())
    err = (got.double() - exact).abs()
    plain_err = (plain.double() - exact).abs()
    print(f"C {c} {_form_id(form)} f32: kernel within "
          f"{float((err / (2.0 ** -24 * terms)).max()):.2f} x 2^-24 of its "
          f"terms from the exact value, the plain chain "
          f"{float((plain_err / (2.0 ** -24 * terms)).max()):.2f}")
    assert bool((err <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_scalar_path_on_unaligned_operands(dev, dtype):
    """An operand off 16-byte alignment takes the kernel's element path:
    the same results as the emulation."""
    form = dict(bias=True, bn=True, res=True, relu=True)
    y, r, _, _, params = _card_case(dev, 64, form, dtype, seed=5)
    n = y.numel()
    flat = torch.empty(n + 1, dtype=dtype, device=dev)
    flat[1:] = y.permute(0, 2, 3, 1).reshape(-1)
    odd = flat[1:].view(2, 11, 37, 64).permute(0, 3, 1, 2)
    assert odd.is_contiguous(memory_format=torch.channels_last)
    kw = dict(bias=True, bn=True, relu=True)
    with torch.no_grad():
        got = kernels.conv_epilogue(odd, params, r, **kw)
        spec = emulate(y.clone(), params, r, **kw)
    assert torch.equal(got, spec)


@pytest.mark.cuda
def test_wrapper_refuses_on_the_card(dev):
    y = torch.zeros((2, 16, 5, 7), device=dev).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="params"):
        kernels.conv_epilogue(y, None, bias=True, bn=False, relu=False)
    with pytest.raises(ValueError, match="must not be y"):
        kernels.conv_epilogue(y, None, y, bias=False, bn=False, relu=False)
    with pytest.raises(ValueError, match="residual: expected a tensor on"):
        kernels.conv_epilogue(y, None, y.cpu(), bias=False, bn=False,
                              relu=False)
