"""BatchNorm folding (smap_tpu_torch/models/quantize.py) and the folded
serving model against the JAX package's ``fold_bn_variables`` and
``ModelConfig(quantized="folded")``, in float32."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import INPUT_HW, TINY_MODEL, jax_smap

torch.set_num_threads(1)

# The fold is a divide, a sqrt and two multiply-adds per channel in
# float32 on both sides; XLA may rewrite a / sqrt(b) as a * rsqrt(b) or
# contract a multiply-add, a few ulps. A bias that cancels to near 0 keeps
# the absolute error of its terms, so the bound is relative to the
# tensor's largest value too.
FOLD_RTOL = 1e-6
# As tests/test_torch_model.py: float32 convolutions summed in another
# order.
MODEL_RTOL = MODEL_ATOL = 1e-4


def _jax_folded():
    import jax

    from smap_tpu.models.quantize import fold_bn_variables

    _, variables = jax_smap()
    return jax.tree.map(np.asarray, jax.jit(fold_bn_variables)(variables))


def _folded_cfg(**kw):
    from smap_tpu_torch.config import ModelConfig

    return ModelConfig(**dict(TINY_MODEL, quantized="folded", **kw))


def test_fold_matches_jax():
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import fold_bn_state_dict

    _, variables = jax_smap()
    got = fold_bn_state_dict(smap_state_dict(variables))
    want = smap_state_dict(_jax_folded())
    assert set(got) == set(want)
    assert not any(".bn." in f".{k}" for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(
            got[k].numpy(), v.numpy(), rtol=FOLD_RTOL,
            atol=FOLD_RTOL * float(v.abs().max()), err_msg=k)


def test_folded_tree_converts_and_loads_strict():
    """fold_bn_variables' output ("params" only) converts; its keys are
    exactly the folded model's."""
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.smap import SMAP

    sd = smap_state_dict(_jax_folded())
    model = SMAP(_folded_cfg())
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("fuse", [False, True])
def test_folded_keys_equal_the_folded_model_keys(fuse):
    """As JAX's test_fused_param_tree_matches_folded_tree: the fused paths
    declare exactly the folded tree's keys, so folded weights drop in."""
    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.quantize import fold_bn_state_dict
    from smap_tpu_torch.models.smap import SMAP

    cfg = ModelConfig(stage_num=2, output_shape=(16, 24))
    folded = fold_bn_state_dict(SMAP(cfg).state_dict())
    model = SMAP(dataclasses.replace(cfg, quantized="folded"),
                 fuse_stem=fuse, fuse_bottleneck=fuse)
    assert set(model.state_dict()) == set(folded)
    model.load_state_dict(folded, strict=True)


def test_folded_model_matches_jax():
    """float32, fused paths off: the port's folded model on the port's
    fold against JAX's folded model on JAX's fold."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig as JModelConfig
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import fold_bn_state_dict
    from smap_tpu_torch.models.smap import SMAP

    _, variables = jax_smap()
    img = np.random.RandomState(4).randn(2, *INPUT_HW, 3).astype(np.float32)
    jmodel = JSMAP(JModelConfig(**dict(TINY_MODEL, quantized="folded")))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method=JSMAP.infer))(
        _jax_folded(), jnp.asarray(img))
    model = SMAP(_folded_cfg()).eval()
    model.load_state_dict(fold_bn_state_dict(smap_state_dict(variables)))
    with torch.no_grad():
        got = model.infer(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)


def test_quantized_config_takes_folded_only():
    """ModelConfig.quantized takes the JAX package's four modes (False,
    "folded", and the int8 True and "static" since they are ported) and
    nothing else."""
    from smap_tpu_torch.config import Config, ModelConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import SMAP

    assert ModelConfig().quantized is False
    for mode in ("folded", True, "static"):
        assert ModelConfig(quantized=mode).quantized == mode
    for mode in ("int4", "dynamic", 2):
        with pytest.raises(ValueError, match="quantized"):
            ModelConfig(quantized=mode)
        with pytest.raises(ValueError, match="quantized"):
            SMAPInference(SMAP(ModelConfig()).state_dict(), Config(),
                          device="cpu", quantized=mode)


def test_engine_folds_once_or_takes_folded_weights():
    """SMAPInference(quantized="folded") folds the weights it is given;
    with cfg.model.quantized == "folded" it takes them as folded. Both
    serve the same model."""
    from smap_tpu_torch.config import Config, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.quantize import fold_bn_state_dict

    _, variables = jax_smap()
    sd = smap_state_dict(variables)
    cfg = Config(model=dataclasses.replace(_folded_cfg(), quantized=False),
                 post=PostProcessConfig(max_peaks=31, assoc_peaks=8),
                 input_shape=INPUT_HW, output_shape=TINY_MODEL["output_shape"])
    folds = SMAPInference(sd, cfg, device="cpu", quantized="folded")
    assert folds.cfg.model.quantized == "folded"
    assert all(".bn." not in k for k in folds.model.state_dict())
    pre = SMAPInference(fold_bn_state_dict(sd), dataclasses.replace(
        cfg, model=_folded_cfg()), device="cpu")
    frames = np.random.RandomState(5).randint(0, 256, (2, *INPUT_HW, 3),
                                              np.uint8)
    a = folds.forward(torch.from_numpy(frames))
    b = pre.forward(torch.from_numpy(frames))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_packed_weights_follow_load_state_dict():
    """The fused paths repack their weights after load_state_dict: a
    loaded model computes what a model built with those weights does."""
    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.quantize import fold_bn_state_dict
    from smap_tpu_torch.models.smap import SMAP, init_smap

    cfg = ModelConfig(stage_num=1, output_shape=(16, 24))
    fcfg = dataclasses.replace(cfg, quantized="folded")
    img = torch.from_numpy(np.random.RandomState(6).randn(
        1, *INPUT_HW, 3).astype(np.float32))
    sds = [fold_bn_state_dict(init_smap(cfg, seed=s).state_dict())
           for s in (0, 1)]

    def fused():
        return SMAP(fcfg, fuse_stem=True, fuse_bottleneck=True).eval()

    model = fused()
    with torch.no_grad():
        model.load_state_dict(sds[0])
        first = model.infer(img)
        model.load_state_dict(sds[1])
        second = model.infer(img)
        fresh = fused()
        fresh.load_state_dict(sds[1])
        want = fresh.infer(img)
    for f, s, w in zip(first, second, want):
        assert not torch.equal(f, s)
        assert torch.equal(s, w)
