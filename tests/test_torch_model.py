"""The port's SMAP and RefineNet against the JAX package's, on the same
weights and inputs, in float32."""

import numpy as np
import pytest
import torch

from torch_parity import INPUT_HW, TINY_MODEL, jax_refinenet, jax_smap

torch.set_num_threads(1)

# float32 on both sides; the convolutions sum in another order (XLA's vs
# oneDNN's), which moves outputs of magnitude <= ~1 by ~1e-7 here.
RTOL = ATOL = 1e-4


def _port_smap():
    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.smap import SMAP

    _, variables = jax_smap()
    model = SMAP(ModelConfig(**TINY_MODEL)).eval()
    model.load_state_dict(smap_state_dict(variables))
    return model


def _image(seed=0, batch=2):
    return np.random.RandomState(seed).randn(batch, *INPUT_HW, 3).astype(
        np.float32)


def test_infer_matches_jax():
    import jax
    import jax.numpy as jnp

    from smap_tpu.models.smap import SMAP as JSMAP

    jmodel, variables = jax_smap()
    img = _image()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method=JSMAP.infer))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = _port_smap().infer(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_forward_pyramid_matches_jax():
    """Every stage and scale of every head, as the loss reads them."""
    import jax
    import jax.numpy as jnp

    jmodel, variables = jax_smap()
    img = _image(seed=1, batch=1)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = _port_smap()(torch.from_numpy(img))
    assert set(got) == set(want) == {"heatmap_2d", "det_d", "root_d"}
    for key in want:
        assert len(got[key]) == len(want[key]) == TINY_MODEL["stage_num"]
        for gs, ws in zip(got[key], want[key]):
            assert len(gs) == len(ws) == 4
            for g, w in zip(gs, ws):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("batch", [1, 7])
def test_refinenet_matches_jax(batch):
    from smap_tpu_torch.models.convert import refinenet_state_dict
    from smap_tpu_torch.models.refinenet import RefineNet

    jmodel, variables = jax_refinenet()
    x = np.random.RandomState(batch).randn(batch, 75).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x))
    model = RefineNet().eval()
    model.load_state_dict(refinenet_state_dict(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # Five float32 dense layers; only the sum order differs.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layers_match_jax():
    """resize_bilinear (align_corners) and the -inf-padded max-pool."""
    import jax.numpy as jnp

    from smap_tpu.models.layers import max_pool_3x3_s2 as jpool
    from smap_tpu.models.layers import resize_bilinear as jresize

    from smap_tpu_torch.models.layers import max_pool_3x3_s2, resize_bilinear

    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32) - 3.0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for hw in ((10, 14), (9, 13), (5, 7), (3, 4)):
        got = resize_bilinear(xt, hw).permute(0, 2, 3, 1).numpy()
        # The JAX version is two f32 matmuls with weights computed in
        # float64; F.interpolate computes its weights in float32.
        np.testing.assert_allclose(got, np.asarray(jresize(jnp.asarray(x),
                                                           hw)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        max_pool_3x3_s2(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jpool(jnp.asarray(x))))
