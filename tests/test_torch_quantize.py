"""int8 serving weights and forward (smap_tpu_torch/models/quantize.py, the
int8 model) against the JAX package's quantize_variables,
calibrate_activation_scales, check_static_scales and int8 SMAP.infer, on
the same seeded weights (tests/torch_parity.py) and inputs, in float32.

The port's transforms round as the JAX functions do when run op by op.
Under ``jax.jit`` XLA rewrites ``a / sqrt(b)`` as ``a * rsqrt(b)`` with an
approximate rsqrt and a division by 127 as a multiply, which moves last
bits of the folded weights; the tests hold the port to the op-by-op result
bit for bit and to the jitted one within the bounds below."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_parity import INPUT_HW, TINY_MODEL, jax_smap, rel_err

torch.set_num_threads(1)

# Against jax.jit(quantize_variables): the fold's approximate rsqrt moves
# a per-channel scale or bias by a few ulps (measured: 2.0e-7 of the
# tensor's largest value) and, rarely, a weight across an int8 rounding
# boundary (measured: 3 steps of 1 in 1,424,664 weights).
JIT_SCALE_RTOL = 1e-6
JIT_MOVED_SHARE = 1e-4
# int8 model maps against JAX's, tiny model, float32; gates at about 2x the
# measurement. Dynamic, measured: rms_rel 3.15e-3 / 4.52e-3 / 9.13e-4 and
# 1 - corr 5.0e-6 / 1.1e-5 / 2.1e-4 (2D / rel-depth / root-depth). XLA's
# fused multiply-add moves a conv output by an ulp now and then; an ulp in
# an input's abs-max moves its dynamic scale, and with it int8 rounding
# boundaries, and whole quantization steps add up over the 3 stages.
# Static, on JAX's calibration, measured: rms_rel 7.3e-8 / 3.4e-8 /
# 2.1e-8, 1 - corr below 1.2e-13: with frozen scales an ulp seldom reaches
# a rounding boundary.
MAP_GATES = {True: ((7e-3, 1e-2, 2e-3), (1e-5, 2.2e-5, 4.2e-4)),
             "static": ((1.5e-7, 7e-8, 5e-8), (1e-12, 1e-12, 1e-12))}
# act_scale against JAX's calibration (the dynamic forward's abs-maxes).
# Stages 0 and 1 see the same inputs up to those ulps (measured: at most
# 1.3e-7 relative); in stage 2 the moved boundaries reach an input's
# abs-max (measured: at most 5.2e-3).
ACT_RTOL_EARLY, ACT_RTOL_ALL = 1e-6, 1e-2


@functools.lru_cache(maxsize=None)
def _jax_int8():
    """(eager quantize_variables tree, jitted one, the JAX-calibrated eager
    tree, the calibration image), numpy."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig as JModelConfig
    from smap_tpu.models.quantize import (calibrate_activation_scales,
                                          quantize_variables)

    _, variables = jax_smap()
    img = np.random.RandomState(4).randn(2, *INPUT_HW, 3).astype(np.float32)
    eager = jax.tree.map(np.asarray, quantize_variables(variables))
    jitted = jax.tree.map(np.asarray, jax.jit(quantize_variables)(variables))
    calibrated = jax.tree.map(np.asarray, calibrate_activation_scales(
        eager, JModelConfig(**TINY_MODEL), jnp.asarray(img)))
    return eager, jitted, calibrated, img


def _port_quantized():
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import quantize_state_dict

    return quantize_state_dict(smap_state_dict(jax_smap()[1]))


def _cfg(mode):
    from smap_tpu_torch.config import ModelConfig

    return ModelConfig(**dict(TINY_MODEL, quantized=mode))


def test_quantize_state_dict_matches_quantize_variables():
    from smap_tpu_torch.models.convert import smap_state_dict

    got = _port_quantized()
    eager, jitted, _, _ = _jax_int8()
    want = smap_state_dict(eager)
    assert set(got) == set(want)
    assert not any(".bn." in f".{k}" or k.endswith("weight") for k in got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    n_q = n_moved = 0
    for k, v in smap_state_dict(jitted).items():
        if k.endswith("kernel_q"):
            step = (got[k].int() - v.int()).abs()
            assert int(step.max()) <= 1, k
            n_q += v.numel()
            n_moved += int(step.sum())
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       rtol=JIT_SCALE_RTOL,
                                       atol=JIT_SCALE_RTOL
                                       * float(v.abs().max()), err_msg=k)
    assert n_moved <= JIT_MOVED_SHARE * n_q


@pytest.mark.parametrize("case", ["missing", "zero", "nan", "negative"])
def test_check_static_scales_rejects_uncalibrated(case):
    from smap_tpu_torch.models.quantize import check_static_scales

    good = {"blk.conv.kernel_q": torch.zeros((4, 4, 3, 3), dtype=torch.int8),
            "blk.conv.kernel_scale": torch.ones(4),
            "blk.conv.bias": torch.zeros(4),
            "blk.conv.act_scale": torch.tensor(0.5),
            "other.conv.act_scale": torch.tensor(0.25)}
    check_static_scales(good)   # does not raise
    if case == "missing":
        bad = {k: v for k, v in good.items() if not k.endswith("act_scale")}
        match = "no act_scale"
    else:
        value = {"zero": 0.0, "nan": float("nan"), "negative": -1.0}[case]
        bad = dict(good, **{"blk.conv.act_scale": torch.tensor(value)})
        match = "uncalibrated"
    with pytest.raises(ValueError, match=match):
        check_static_scales(bad)


def test_int8_trees_convert_and_load_strict():
    """quantize_variables' tree and its calibrated tree carry across: the
    dynamic tree has exactly the port's quantized keys; the calibrated one
    has act_scale for exactly the convs the readout runs, and loads
    strictly into the static model."""
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import check_static_scales
    from smap_tpu_torch.models.smap import SMAP

    eager, _, calibrated, _ = _jax_int8()
    dyn = smap_state_dict(eager)
    assert dyn["top.conv.conv.kernel_q"].dtype == torch.int8
    assert dyn["top.conv.conv.kernel_q"].shape == (8, 3, 7, 7)
    assert set(SMAP(_cfg(True)).state_dict()) == set(dyn)
    SMAP(_cfg(True)).load_state_dict(dyn, strict=True)

    static = smap_state_dict(calibrated)
    check_static_scales(static)
    scaled = {k for k in static if k.endswith("act_scale")}
    assert "stage0.upsample.up1.res_conv1.conv.act_scale" not in scaled
    assert "stage2.upsample.up4.res_rd_conv2.conv.act_scale" in scaled
    model = SMAP(_cfg("static"))
    model.load_state_dict(static, strict=True)
    assert set(model.state_dict()) == set(static)


def test_act_scales_match_jax():
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import calibrate_activation_scales

    _, _, calibrated, img = _jax_int8()
    want = {k: float(v) for k, v in smap_state_dict(calibrated).items()
            if k.endswith("act_scale")}
    got = calibrate_activation_scales(_port_quantized(), _cfg(False),
                                      torch.from_numpy(img))
    assert {k for k in got if k.endswith("act_scale")} == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == ()
        rel = abs(float(got[k]) - w) / w
        assert rel <= (ACT_RTOL_ALL if k.startswith("stage2.")
                       else ACT_RTOL_EARLY), (k, rel)


@pytest.mark.parametrize("mode", [True, "static"])
def test_int8_model_matches_jax(mode):
    """The port's int8 SMAP.infer on the carried-across tree against JAX's
    on the same tree (static: JAX's calibration)."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig as JModelConfig
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.smap import SMAP

    eager, _, calibrated, img = _jax_int8()
    tree = eager if mode is True else calibrated
    jmodel = JSMAP(JModelConfig(**dict(TINY_MODEL, quantized=mode)))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method=JSMAP.infer))(
        tree, jnp.asarray(img))
    model = SMAP(_cfg(mode)).eval()
    model.load_state_dict(smap_state_dict(tree), strict=True)
    with torch.no_grad():
        got = model.infer(torch.from_numpy(img))
    for g, w, rel_gate, corr_gate in zip(got, want, *MAP_GATES[mode]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert rel_err(g, w) < rel_gate
        assert 1.0 - np.corrcoef(g.ravel(), w.ravel())[0, 1] < corr_gate


def test_static_equals_dynamic_on_the_calibration_batch():
    """As tests/test_quantize.py's model test: calibrated on one batch, the
    static forward is the dynamic forward on that batch, bit for bit."""
    from smap_tpu_torch.models.quantize import calibrate_activation_scales
    from smap_tpu_torch.models.smap import SMAP

    img = torch.from_numpy(np.random.RandomState(7).randn(
        1, *INPUT_HW, 3).astype(np.float32))
    sd = _port_quantized()
    dyn = SMAP(_cfg(True)).eval()
    dyn.load_state_dict(sd, strict=True)
    static = SMAP(_cfg("static")).eval()
    static.load_state_dict(calibrate_activation_scales(
        sd, _cfg(True), [img]), strict=True)
    with torch.no_grad():
        for a, b in zip(dyn.infer(img), static.infer(img)):
            assert torch.equal(a, b)
        # A second batch: the frozen scales are no longer its own.
        img2 = img * 0.7
        assert not torch.equal(dyn.infer(img2)[0], static.infer(img2)[0])


def test_quantized_modes_build_their_models():
    from smap_tpu_torch.models.layers import Int8Conv
    from smap_tpu_torch.models.smap import SMAP

    for mode in (True, "static"):
        model = SMAP(dataclasses.replace(_cfg(mode), stage_num=1))
        convs = [m for m in model.modules() if isinstance(m, Int8Conv)]
        assert convs and all(m.static == (mode == "static") for m in convs)
        assert not any(isinstance(m, (torch.nn.BatchNorm2d, torch.nn.Conv2d))
                       for m in model.modules())
