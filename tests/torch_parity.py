"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

The same weights and inputs go through the JAX package and the PyTorch
port. JAX SMAP variables are the tree of a Flax init (its shapes through
``jax.eval_shape``, which compiles nothing) filled from a seeded numpy
generator: kaiming-scale kernels and non-identity BatchNorm statistics,
so a wrong layout or a swapped statistic changes the output, and
activations stay O(1) through three stages, so float32 tolerances are
meaningful.
"""

import functools

import numpy as np

# A narrow model: every stage, block and head of the real topology.
TINY_MODEL = dict(stage_num=3, trunk_width=8, upsample_channels=16,
                  output_shape=(16, 24), compute_dtype="float32")
INPUT_HW = (64, 96)
# Decode capacities of the engine tests.
TINY_POST = dict(max_peaks=31, assoc_peaks=8)


def _fill(rng, path, leaf):
    name = "/".join(str(getattr(p, "key", p)) for p in path)
    shape = leaf.shape
    if name.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if name.endswith("scale"):
        return rng.uniform(0.2, 0.6, shape).astype(np.float32)
    if name.endswith("var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (rng.randn(*shape) * 0.1).astype(np.float32)


def random_variables(module, example, seed=0):
    """Seeded numpy values in the tree ``module.init`` would return."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), example)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: _fill(rng, p, leaf), shapes)


@functools.lru_cache(maxsize=None)
def jax_smap():
    """(JAX SMAP module, its numpy variables) for TINY_MODEL."""
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig
    from smap_tpu.models.smap import SMAP

    model = SMAP(ModelConfig(**TINY_MODEL))
    return model, random_variables(
        model, jnp.zeros((1, *INPUT_HW, 3), jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_refinenet():
    """(JAX RefineNet module, numpy variables) with random BN stats."""
    import jax.numpy as jnp

    from smap_tpu.config import RefineNetConfig
    from smap_tpu.models.refinenet import RefineNet

    model = RefineNet(RefineNetConfig())
    return model, random_variables(model, jnp.zeros((1, 75), jnp.float32),
                                   seed=1)


def port_configs():
    """(JAX Config, port Config) of the engine tests, field for field."""
    from smap_tpu.config import Config as JConfig
    from smap_tpu.config import ModelConfig as JModel
    from smap_tpu.config import PostProcessConfig as JPost

    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig

    out_hw = TINY_MODEL["output_shape"]
    jcfg = JConfig(model=JModel(**TINY_MODEL), post=JPost(**TINY_POST),
                   input_shape=INPUT_HW, output_shape=out_hw)
    cfg = Config(model=ModelConfig(**TINY_MODEL),
                 post=PostProcessConfig(**TINY_POST), input_shape=INPUT_HW,
                 output_shape=out_hw)
    return jcfg, cfg


def jax_peaks_to_torch(peaks):
    """A JAX Peaks of one image -> the port's batched Peaks (B = 1)."""
    import torch

    from smap_tpu_torch.ops.nms import Peaks

    return Peaks(xy=torch.from_numpy(np.array(peaks.xy))[None],
                 score=torch.from_numpy(np.array(peaks.score))[None],
                 count=torch.from_numpy(
                     np.array(peaks.count, np.int32))[None])


# The folded serving tests' model: JAX's tests/test_fused_block.py
# _tiny_model_and_vars (one stage at full width, 64x96 in), bf16.
FUSED_MODEL = dict(stage_num=1, output_shape=(16, 24),
                   compute_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def jax_fused_smap():
    """(JAX SMAP module, numpy variables, image [2, 64, 96, 3]) for
    FUSED_MODEL, unfolded."""
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig
    from smap_tpu.models.smap import SMAP

    model = SMAP(ModelConfig(**FUSED_MODEL))
    variables = random_variables(
        model, jnp.zeros((1, *INPUT_HW, 3), jnp.float32), seed=2)
    img = np.random.RandomState(3).randn(2, *INPUT_HW, 3).astype(np.float32)
    return model, variables, img


def rel_err(a, b):
    """RMS of a - b over the RMS of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(b ** 2)) + 1e-9))


def folded_fused_errors(monkeypatch, fuse_stem, fuse_bottleneck):
    """Distances to the float32 unfolded truth of FUSED_MODEL's infer maps:
    JAX's bf16 unfolded graph (the noise floor), JAX's folded bf16 graph
    and the port's, each with the given fused paths on. Returns
    {map: (noise, jax_err, port_err)}."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    import smap_tpu.models.layers as jlayers
    import smap_tpu.models.smap as jsmap
    from smap_tpu.models.quantize import fold_bn_variables
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.layers import to_compute_dtype
    from smap_tpu_torch.models.smap import SMAP

    jmodel, variables, img = jax_fused_smap()
    cfg = jmodel.cfg

    def infer(c, v):
        m = JSMAP(c)
        return jax.jit(lambda v, x: m.apply(v, x, method=JSMAP.infer))(
            v, jnp.asarray(img))

    truth = infer(dataclasses.replace(cfg, compute_dtype="float32"),
                  variables)
    base = infer(cfg, variables)
    folded = jax.tree.map(np.asarray, jax.jit(fold_bn_variables)(variables))
    monkeypatch.setattr(jsmap, "FUSE_STEM", fuse_stem)
    monkeypatch.setattr(jlayers, "FUSE_BOTTLENECK", fuse_bottleneck)
    jax_fused = infer(dataclasses.replace(cfg, quantized="folded"), folded)

    port = SMAP(ModelConfig(**FUSED_MODEL, quantized="folded"),
                fuse_stem=fuse_stem, fuse_bottleneck=fuse_bottleneck).eval()
    port.load_state_dict(smap_state_dict(folded), strict=True)
    to_compute_dtype(port, torch.device("cpu"), torch.bfloat16)
    with torch.no_grad():
        port_fused = port.infer(torch.from_numpy(img))
    return {name: (rel_err(b, t), rel_err(j, t), rel_err(p.numpy(), t))
            for name, t, b, j, p in zip(("2d", "3d", "rd"), truth, base,
                                        jax_fused, port_fused)}
