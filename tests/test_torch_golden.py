"""The port decodes the golden corpus (tests/golden/decode_corpus.json):
the base scenes and the rung8, flip_tta and refine serving variants, at
tests/test_golden.py's tolerances (rtol 1e-3, atol 2e-3, counts exact)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PORT_VARIANTS = {"scenes", "rung8", "flip_tta", "refine"}
# The quantized serving variants belong to models/quantize.py, which is
# not ported yet.
NOT_PORTED = {"int8_static", "int8_folded_ref"}


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
    assert set(golden.load_corpus()) == PORT_VARIANTS | NOT_PORTED


@pytest.mark.parametrize("variant", sorted(PORT_VARIANTS))
def test_decode_matches_golden_corpus(decoded, variant):
    from smap_tpu_torch import golden

    want = golden.load_corpus()[variant]
    golden.compare(decoded[variant], want, label=variant)
    assert [r["count"] for r in decoded[variant]] == [1, 2, 3, 4, 3]


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
