"""The port decodes the golden corpus (tests/golden/decode_corpus.json):
the base scenes, the rung8, flip_tta and refine serving variants, and the
BN-folded engine's decode (int8_folded_ref), at tests/test_golden.py's
tolerances (rtol 1e-3, atol 2e-3, counts exact)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PORT_VARIANTS = {"scenes", "rung8", "flip_tta", "refine"}
# Decoded end to end by the engine (test_engine_decodes_folded_ref).
ENGINE_VARIANTS = {"int8_folded_ref"}
# int8 serving is not ported yet.
NOT_PORTED = {"int8_static"}


def test_renderer_copy_matches_tests_scenes():
    """smap_tpu_torch.golden renders with a copy of tests/scenes.py (the
    card has no tests/ import path to the JAX package): identical maps."""
    from make_golden import _scene_inputs

    from smap_tpu_torch import golden

    for (seed, n, _, out2d, paf_z, rd), (s2, n2, _, o2, z2, r2) in zip(
            golden.scene_inputs(), _scene_inputs()):
        assert (seed, n) == (s2, n2)
        np.testing.assert_array_equal(out2d, o2)
        np.testing.assert_array_equal(paf_z, z2)
        np.testing.assert_array_equal(rd, r2)


@pytest.fixture(scope="module")
def decoded():
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import RefineNetConfig as JRefineNetConfig
    from smap_tpu.models.refinenet import RefineNet as JRefineNet

    from smap_tpu_torch import golden
    from smap_tpu_torch.models.convert import refinenet_state_dict
    from smap_tpu_torch.models.refinenet import RefineNet

    # The RefineNet weights of tests/make_golden.py: a Flax init at
    # PRNGKey(0), carried across.
    variables = JRefineNet(JRefineNetConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 75), jnp.float32))
    refine = RefineNet().eval()
    refine.load_state_dict(refinenet_state_dict(
        jax.tree.map(np.asarray, variables)))
    return golden.decode_golden("cpu", refine_model=refine)


def test_variant_set_is_exact(decoded):
    from smap_tpu_torch import golden

    assert set(decoded) == PORT_VARIANTS
    assert set(golden.load_corpus()) == (PORT_VARIANTS | ENGINE_VARIANTS
                                         | NOT_PORTED)


@pytest.mark.parametrize("variant", sorted(PORT_VARIANTS))
def test_decode_matches_golden_corpus(decoded, variant):
    from smap_tpu_torch import golden

    want = golden.load_corpus()[variant]
    golden.compare(decoded[variant], want, label=variant)
    assert [r["count"] for r in decoded[variant]] == [1, 2, 3, 4, 3]


def test_engine_decodes_folded_ref():
    """int8_folded_ref: tests/make_golden.py's seeded full-width 3-stage
    model (a Flax init at PRNGKey(0), float32, 64x96 in, max_peaks 31,
    assoc_peaks 8) served with BatchNorm folded, one uint8 frame, through
    the port's SMAPInference(quantized="folded") on the CPU."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig as JModelConfig
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch import golden
    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import smap_state_dict

    input_shape, out = (64, 96), (16, 24)
    model = dict(stage_num=3, output_shape=out, compute_dtype="float32")
    variables = jax.jit(JSMAP(JModelConfig(**model)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *input_shape, 3), jnp.float32))
    cfg = Config(model=ModelConfig(**model),
                 post=PostProcessConfig(max_peaks=31, assoc_peaks=8),
                 input_shape=input_shape, output_shape=out)
    engine = SMAPInference(smap_state_dict(jax.tree.map(np.asarray,
                                                        variables)),
                           cfg, quantized="folded")
    img = np.random.RandomState(5).randint(0, 256, (1, *input_shape, 3),
                                           np.uint8)
    scale = min(input_shape[1] / 640.0, input_shape[0] / 360.0)
    scales = [{"scale": scale, "img_width": 640.0, "img_height": 360.0,
               "f_x": 500.0, "f_y": 500.0, "cx": 320.0, "cy": 180.0}]
    got = [golden._record(5, 0, engine.run_batch(img, scales))]
    golden.compare(got, golden.load_corpus()["int8_folded_ref"],
                   label="int8_folded_ref")


def test_postprocess_single_is_the_batch_of_one():
    from smap_tpu_torch import golden
    from smap_tpu_torch.config import PostProcessConfig
    from smap_tpu_torch.ops.postprocess import (postprocess_batch,
                                                postprocess_single)

    _, _, K, out2d, paf_z, rd = next(golden.scene_inputs())
    maps = [torch.from_numpy(m) for m in (out2d, paf_z, rd)]
    info = golden._scale_info(K, "cpu")
    cfg = PostProcessConfig(assoc_peaks=8)
    one = postprocess_single(*maps, tuple(float(s) for s in info), cfg)
    batch = postprocess_batch(*(m[None] for m in maps), info, cfg)
    assert int(one.count) == 1
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])
