"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``cuda``: they need a card and nvcc, and skip without a card (the
kernels have no CPU mode). On the card, where there is no JAX for
tests/conftest.py to import:

    python -m pytest tests/test_torch_kernels.py -q -m cuda -p no:randomly \
        --noconftest
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# As chip_smoke.py: kernel A sums the passing samples in another order than
# torch.sum (a few ulps of a mean of <= 25 samples); everything else in
# both kernels must be equal, kernel B's output to the bit.
PAF_SCORE_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _peaks(gen, B, J, K, h, w, dev):
    from smap_tpu_torch.ops.nms import Peaks

    count = torch.randint(0, K + 1, (B, J), generator=gen, dtype=torch.int32)
    xy = torch.rand((B, J, K, 2), generator=gen) * torch.tensor([w, h])
    valid = torch.arange(K)[None, None, :] < count[..., None]
    xy = torch.where(valid[..., None], xy, 0.0)
    score = torch.where(valid, torch.rand((B, J, K), generator=gen), 0.0)
    return Peaks(xy.to(dev), score.to(dev), count.to(dev))


@pytest.mark.parametrize("layout", ["dense", "decode_slice"])
@pytest.mark.parametrize("B,K,h,w", [(1, 5, 16, 24), (4, 40, 128, 208),
                                     (2, 127, 64, 96)])
def test_paf_score_kernel_matches_plain(dev, B, K, h, w, layout):
    """Channels-last maps: a dense [B, 28, H, W] tensor in that memory
    format, and the decode's own, a slice of the NHWC output divided by
    127 (channels-last, 28 channels apart)."""
    from smap_tpu_torch.config import PAF_VECTOR
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.paf import paf_scores

    gen = torch.Generator().manual_seed(K)
    if layout == "dense":
        pafs = (torch.rand((B, 28, h, w), generator=gen) * 2 - 1).to(
            dev).contiguous(memory_format=torch.channels_last)
    else:
        nhwc = (torch.rand((B, h, w, 43), generator=gen) * 254 - 127).to(dev)
        pafs = nhwc.permute(0, 3, 1, 2)[:, 15:] / 127.0
        assert pafs.stride() == (28 * h * w, 1, 28 * w, 28)
    peaks = _peaks(gen, B, 15, K, h, w, dev)
    pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    got = paf_scores(pafs, peaks, pairs)
    assert kernels.LAUNCHES["paf_score"] == 1
    want = paf_scores(pafs, peaks, pairs, plain=True)
    torch.cuda.synchronize()
    default = np.float32(0.1 + 1e-6).item()
    assert torch.equal(got == -1.0, want == -1.0)
    assert torch.equal(got == default, want == default)
    assert float((got - want).abs().max()) <= PAF_SCORE_ATOL


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("K", [1, 8, 40, 127, 128])
def test_associate_kernel_matches_plain(dev, K):
    """The fused association, one launch, bit-equal to the plain loop."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import associate

    from chip_smoke import association_inputs

    gen = torch.Generator().manual_seed(K)
    peaks, table, rdm = association_inputs(gen, 16, K, dev, 32, 48)
    kernels.reset_launch_counts()
    got = associate(peaks, table, rdm)
    assert kernels.LAUNCHES["associate"] == 1
    want = associate(peaks, table, rdm, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.joints), _bits(want.joints))
    assert torch.equal(_bits(got.root_depth), _bits(want.root_depth))
    assert torch.equal(got.count, want.count)


def test_kernels_reject_what_they_do_not_take(dev):
    from chip_smoke import association_inputs

    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import kernel_plan

    gen = torch.Generator().manual_seed(0)
    plan = kernel_plan(2, 1.2, 4.0, dev)
    for K, where in ((129, dev), (8, torch.device("cpu"))):
        peaks, table, rdm = association_inputs(gen, 5, K, where, 32, 48)
        p = plan if where == dev else kernel_plan(2, 1.2, 4.0, where)
        with pytest.raises(ValueError):
            kernels.associate(*peaks, table, rdm, p.steps, p.wave_starts,
                              p.bone, root_idx=2, max_wave=p.max_wave,
                              inv_ds_scale=p.inv_ds_scale)
    pafs = torch.zeros((1, 28, 16, 24), device=dev)   # NCHW: not taken
    peaks = _peaks(gen, 1, 15, 5, 16, 24, dev)
    with pytest.raises(ValueError):
        kernels.paf_score(pafs, peaks.xy, peaks.count, torch.zeros(
            (14, 2), dtype=torch.int32, device=dev), inter_threshold=0.05,
            inter_min_above=0.95, default_threshold=0.1, num_samples=25)


# Kernel C vs its plain version: the conv sums 147 exact products in
# another order; a conv output near a bf16 rounding point can round the
# other way, one bf16 ulp (tests/test_fused_stem.py's own bound).
STEM_ATOL, STEM_RTOL = 2e-2, 1e-2
# Kernel D vs its plain version: the sums run in another order, which can
# flip the bf16 rounding of an intermediate y or z and so move an output
# by up to two bf16 ulps.
BLOCK_ATOL, BLOCK_RTOL = 1e-2, 1.6e-2


def _stem_inputs(gen, B, H, W, cin, bias_value=None):
    x = torch.randn((B, H, W, cin), generator=gen).to(torch.bfloat16)
    k = (torch.randn((64, cin, 7, 7), generator=gen)
         * (2.0 / (49 * cin)) ** 0.5).to(torch.bfloat16)
    b = (torch.randn((64,), generator=gen) * 0.1 if bias_value is None
         else torch.full((64,), bias_value))
    return x, k, b.float()


@pytest.mark.parametrize("B,H,W,cin", [(2, 64, 96, 3), (1, 32, 48, 3),
                                       (2, 64, 64, 4), (1, 128, 96, 3),
                                       (3, 30, 50, 3), (1, 5, 7, 3),
                                       (2, 30, 50, 3), (1, 512, 832, 3)])
def test_fused_stem_kernel_matches_plain(dev, B, H, W, cin):
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.fused_stem import fused_stem

    gen = torch.Generator().manual_seed(H * W + cin)
    x, k, b = (t.to(dev) for t in _stem_inputs(gen, B, H, W, cin))
    kernels.reset_launch_counts()
    got = fused_stem(x, k, b)
    assert kernels.LAUNCHES["fused_stem"] == 1
    want = fused_stem(x, k, b, plain=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, (H + 3) // 4, (W + 3) // 4, 64)
    torch.testing.assert_close(got.float(), want.float(), atol=STEM_ATOL,
                               rtol=STEM_RTOL)


def test_fused_stem_kernel_negative_bias_pools_to_zero(dev):
    """Every conv output relus to 0: the pool padding must not win."""
    from smap_tpu_torch.ops.fused_stem import fused_stem

    gen = torch.Generator().manual_seed(1)
    x, k, b = (t.to(dev) for t in _stem_inputs(gen, 2, 32, 48, 3, -10.0))
    got = fused_stem(x, k, b)
    want = fused_stem(x, k, b, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got.float().abs().max()) == 0.0


def _block_inputs(gen, B, H, W, cin, cm, cout, proj):
    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen)
                * (2.0 / fan_in) ** 0.5).to(torch.bfloat16)

    def bias(n):
        return torch.randn((n,), generator=gen) * 0.1

    x = torch.randn((B, H, W, cin), generator=gen).to(torch.bfloat16)
    args = [x, w(cin, cm, fan_in=cin), bias(cm),
            w(3, 3, cm, cm, fan_in=9 * cm), bias(cm),
            w(cm, cout, fan_in=cm), bias(cout)]
    if proj:
        args += [w(cin, cout, fan_in=cin), bias(cout)]
    return args


@pytest.mark.parametrize("B,H,W,cin,cm,cout,proj", [
    (2, 16, 24, 32, 16, 32, False),       # identity, two row tiles
    (2, 16, 24, 32, 16, 32, True),
    (1, 32, 13, 16, 16, 16, False),       # ragged width
    (2, 24, 24, 32, 16, 48, True),        # Cout != Cin, projection
    (1, 20, 40, 64, 64, 256, True),       # H not a multiple of the tile
    (2, 128, 208, 64, 64, 256, True),     # layer1_0 at the serving shape
    (2, 128, 208, 256, 64, 256, False),   # layer1_1 / layer1_2
    (1, 8, 100, 256, 64, 256, False),     # batch 1, one tile row, W = 100
    (3, 40, 13, 64, 64, 256, True),       # W = 13: one ragged tile column
    (5, 64, 100, 256, 64, 256, False),    # 280 tiles: not a multiple of 132
    (1, 128, 208, 64, 64, 256, True),     # batch 1 at the serving width
])
def test_fused_bottleneck_kernel_matches_plain(dev, B, H, W, cin, cm, cout,
                                               proj):
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.fused_block import fused_bottleneck

    gen = torch.Generator().manual_seed(H * W + cin + proj)
    args = [t.to(dev) for t in _block_inputs(gen, B, H, W, cin, cm, cout,
                                             proj)]
    kernels.reset_launch_counts()
    got = fused_bottleneck(*args)
    assert kernels.LAUNCHES["fused_bottleneck"] == 1
    want = fused_bottleneck(*args, plain=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, H, W, cout)
    torch.testing.assert_close(got.float(), want.float(), atol=BLOCK_ATOL,
                               rtol=BLOCK_RTOL)


def test_fused_kernels_reject_what_they_do_not_take(dev):
    from smap_tpu_torch.ops import kernels

    from smap_tpu_torch.ops.fused_block import pack_bottleneck_for_kernel
    from smap_tpu_torch.ops.fused_stem import pack_stem_for_kernel

    gen = torch.Generator().manual_seed(0)
    x, k, b = (t.to(dev) for t in _stem_inputs(gen, 1, 32, 48, 3))
    packed = pack_stem_for_kernel(k)
    with pytest.raises(ValueError):        # not contiguous NHWC
        kernels.fused_stem(x.permute(0, 2, 1, 3), packed, b)
    with pytest.raises(ValueError):        # f32 image
        kernels.fused_stem(x.float(), packed, b)
    with pytest.raises(ValueError):        # weights not packed
        kernels.fused_stem(x, k, b)
    args = [t.to(dev) for t in _block_inputs(gen, 1, 8, 16, 32, 16, 32,
                                             False)]
    packed = pack_bottleneck_for_kernel(*args[1:])
    with pytest.raises(ValueError):        # channels not multiples of 16
        kernels.fused_bottleneck(args[0][..., :24].contiguous(), packed)
    with pytest.raises(ValueError):        # bf16 bias
        kernels.fused_bottleneck(args[0], packed._replace(
            bias=packed.bias.bfloat16()))
    with pytest.raises(ValueError):        # a projection needs Cin <= 64
        pack_bottleneck_for_kernel(*_block_inputs(gen, 1, 8, 16, 128, 16, 128,
                                                  True)[1:])


def test_engine_serves_frames_already_on_the_card(dev):
    """device="cuda" (no index) with a uint8 frame tensor on the card: the
    engine takes it as it is (no pinning of a CUDA tensor)."""
    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap

    mcfg = ModelConfig(stage_num=1, trunk_width=8, upsample_channels=16,
                       output_shape=(16, 24))
    cfg = Config(model=mcfg, post=PostProcessConfig(max_peaks=31,
                                                    assoc_peaks=8),
                 input_shape=(64, 96), output_shape=(16, 24))
    engine = SMAPInference(init_smap(mcfg).state_dict(), cfg, device="cuda")
    assert engine.device == torch.device("cuda", torch.cuda.current_device())
    frames = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                           device="cuda")
    scales = [{"scale": 0.05, "img_width": 1920.0, "img_height": 1080.0,
               "f_x": 1500.0, "f_y": 1500.0, "cx": 960.0, "cy": 540.0}] * 2
    res = engine.run_batch(frames, scales)
    torch.cuda.synchronize()
    assert tuple(res.count.shape) == (2,)


def test_folded_engine_runs_both_fused_kernels(dev):
    """SMAPInference(quantized="folded") with both fused paths on the card
    (one stage, full width, 64x96): 1 stem and 3 bottleneck launches per
    forward, and maps as close to a float32 forward as the unfolded bf16
    engine's, within 2x + 1e-4."""
    import dataclasses

    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.runtime import no_tf32

    mcfg = ModelConfig(stage_num=1, output_shape=(16, 24))
    cfg = Config(model=mcfg, post=PostProcessConfig(max_peaks=31,
                                                    assoc_peaks=8),
                 input_shape=(64, 96), output_shape=(16, 24))
    sd = init_smap(mcfg, seed=3).state_dict()
    gen = torch.Generator().manual_seed(4)
    for key, v in sd.items():    # non-identity BatchNorm: the fold matters
        if key.endswith(("bn.bias", "bn.running_mean", "conv.bias")):
            sd[key] = torch.randn(v.shape, generator=gen) * 0.1
        elif key.endswith(("bn.weight", "bn.running_var")):
            sd[key] = torch.rand(v.shape, generator=gen) + 0.5
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        mcfg, compute_dtype="float32"))
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 64, 96, 3), np.uint8)).to(dev)
    fused = SMAPInference(sd, cfg, device=dev, quantized="folded",
                          fuse_stem=True, fuse_bottleneck=True)
    with no_tf32():
        truth = SMAPInference(sd, f32, device=dev).forward(frames)
    base = SMAPInference(sd, cfg, device=dev).forward(frames)
    kernels.reset_launch_counts()
    got = fused.forward(frames)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["fused_stem"],
            kernels.LAUNCHES["fused_bottleneck"]) == (1, 3)

    def rel(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

    for g, b, t in zip(got, base, truth):
        assert bool(torch.isfinite(g).all())
        assert rel(g, t) <= 2.0 * rel(b, t) + 1e-4


def _int8_conv_inputs(gen, B, H, W, cin, cout, k, dev):
    """Seeded int8 activations and weights, scales and a bias such that
    about half of the outputs are negative."""
    xq = torch.randint(-127, 128, (B, cin, H, W), generator=gen,
                       dtype=torch.int8).to(dev).contiguous(
        memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                       dtype=torch.int8).to(dev)
    w_scale = (torch.rand(cout, generator=gen) * 1e-3 + 1e-4).to(dev)
    s_x = torch.tensor(0.0371, device=dev)
    bias = (torch.randn(cout, generator=gen) * 0.5).to(dev)
    return xq, wq, w_scale, s_x, bias


# (B, H, W, Cin, Cout, k, stride, pad, relu, out dtype): the stem, a 1x1, a
# 3x3/2, a Cout-1 head, and ragged ones (odd sizes, Cin 8 and 3, Cout 43).
INT8_SHAPES = [
    (2, 64, 96, 3, 64, 7, 2, 3, True, torch.bfloat16),      # stem
    (2, 32, 52, 256, 64, 1, 1, 0, True, torch.bfloat16),    # 1x1
    (2, 32, 52, 128, 128, 3, 2, 1, True, torch.bfloat16),   # 3x3/2
    (2, 32, 52, 256, 1, 3, 1, 1, False, torch.bfloat16),    # root-depth head
    (1, 13, 17, 8, 43, 3, 1, 1, False, torch.float32),      # ragged, f32
    (3, 15, 11, 3, 14, 7, 2, 3, True, torch.float32),
    (1, 9, 7, 64, 1, 1, 2, 0, False, torch.float32),
    (2, 16, 26, 2048, 256, 1, 1, 0, False, torch.bfloat16),  # deep K
]


@pytest.mark.parametrize("B,H,W,cin,cout,k,stride,pad,relu,dtype",
                         INT8_SHAPES)
def test_int8_conv_kernel_matches_plain(dev, B, H, W, cin, cout, k, stride,
                                        pad, relu, dtype):
    """Kernel E bit-equal to int8_conv2d_plain on the card."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.int8_conv import int8_conv2d, int8_conv2d_plain

    gen = torch.Generator().manual_seed(H * W + cin + cout)
    args = _int8_conv_inputs(gen, B, H, W, cin, cout, k, dev)
    kernels.reset_launch_counts()
    got = int8_conv2d(*args, stride, pad, relu, dtype)
    assert kernels.LAUNCHES["int8_conv"] == 1
    want = int8_conv2d_plain(*args, stride, pad, relu, dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.contiguous().view(view),
                       want.contiguous().view(view))


def test_int8_conv_kernel_rejects_what_it_does_not_take(dev):
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.int8_conv import pack_int8_weights

    gen = torch.Generator().manual_seed(0)
    xq, wq, w_scale, s_x, bias = _int8_conv_inputs(gen, 1, 8, 8, 16, 8, 3,
                                                   dev)
    x = xq.permute(0, 2, 3, 1)
    packed = pack_int8_weights(wq)
    kw = dict(kh=3, kw=3, stride=1, padding=1, relu=False,
              out_dtype=torch.bfloat16)
    kernels.int8_conv(x, packed, w_scale, s_x, bias, **kw)   # takes these
    for bad in ((x[..., :6].contiguous(), packed, w_scale, s_x, bias),
                (x, wq.reshape(8, -1), w_scale, s_x, bias),
                (x, packed, w_scale, s_x.cpu(), bias),
                (x, packed, w_scale.bfloat16(), s_x, bias),
                (x.float(), packed, w_scale, s_x, bias)):
        with pytest.raises(ValueError):
            kernels.int8_conv(*bad, **kw)
    with pytest.raises(ValueError):
        kernels.int8_conv(x, packed, w_scale, s_x, bias,
                          **dict(kw, out_dtype=torch.float16))


def test_int8_static_engine_serves_a_batch(dev):
    """SMAPInference(quantized="static") at full width, one stage, 64x96,
    calibrated on its batch: one kernel E launch per conv the readout runs,
    1 A and 1 B per decode, maps equal to the dynamic engine's on the
    calibration batch and close to a float32 forward."""
    import dataclasses

    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.runtime import no_tf32

    mcfg = ModelConfig(stage_num=1, output_shape=(16, 24))
    cfg = Config(model=mcfg, post=PostProcessConfig(max_peaks=31,
                                                    assoc_peaks=8),
                 input_shape=(64, 96), output_shape=(16, 24))
    sd = init_smap(mcfg, seed=3).state_dict()
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 64, 96, 3), np.uint8))
    static = SMAPInference(sd, cfg, device=dev, quantized="static",
                           calibration_batches=frames)
    dynamic = SMAPInference(sd, cfg, device=dev, quantized=True)
    n_convs = sum(k.endswith("act_scale")
                  for k in static.model.state_dict())
    scales = [{"scale": 0.05, "img_width": 1920.0, "img_height": 1080.0,
               "f_x": 1500.0, "f_y": 1500.0, "cx": 960.0, "cy": 540.0}] * 2
    kernels.reset_launch_counts()
    res = static.run_batch(frames, scales)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_conv"] == n_convs > 0
    assert kernels.LAUNCHES["paf_score"] == kernels.LAUNCHES["associate"] == 1
    assert tuple(res.count.shape) == (2,)
    got = static.forward(static.to_device(frames))
    for a, b in zip(got, dynamic.forward(dynamic.to_device(frames))):
        assert torch.equal(a, b)
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        mcfg, compute_dtype="float32"))
    with no_tf32():
        truth = SMAPInference(sd, f32, device=dev).forward(
            frames.to(dev))
    for g, t in zip(got, truth):
        assert bool(torch.isfinite(g).all())
        corr = float(torch.corrcoef(torch.stack([g.flatten(),
                                                 t.flatten()]))[0, 1])
        assert corr > 0.98
