"""The port's label synthesis (smap_tpu_torch/data/labels.py) against the
JAX package's (smap_tpu/data/labels.py), on the same seeded joint tables.

Tolerances: heatmaps are peak-normalised to 255 and blurred with the same
taps summed in the same order, so they agree to float32 rounding of that
scale (atol 1e-4); PAF channels are means of at most P unit vectors x 127
and depth deltas, summed over persons in another order (atol 1e-4); root
rows are one division each and sorted the same way (exact up to 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smap_tpu.data import labels as jl
from smap_tpu_torch.data import labels as tl

ATOL = 1e-4
KERNELS = [15, 11, 9, 7, 5]


def _bodys(rng, P=4, h=64, w=96, off_map=False, with_depth=True):
    """Unified rows [x, y, Z, v, X, Y, Z, fx, ...] with a third of the
    joints unlabeled (v = 0) and some at v = 2 (the MDS-labeled bands)."""
    bodys = np.zeros((P, 15, 11), np.float32)
    bodys[..., 0] = rng.uniform(0, w - 1, (P, 15))
    bodys[..., 1] = rng.uniform(0, h - 1, (P, 15))
    bodys[..., 2] = rng.uniform(50, 500, (P, 15)) if with_depth else 0
    bodys[..., 3] = rng.randint(0, 3, (P, 15))
    bodys[..., 7] = 1200.0
    if off_map:
        # Labeled joints off the map on every side: x / 4 truncates to 0
        # (-3), wraps to the far edge (-5, -w * 4 + 1) or is dropped
        # (w * 4 + 3, -5 * w), and the same for y.
        bodys[0, :5, 0] = [-3.0, -5.0, 4 * w + 3, -5.0 * w, -4.0 * w + 1]
        bodys[1, :5, 1] = [-3.0, -5.0, 4 * h + 3, -5.0 * h, -4.0 * h + 1]
        bodys[:2, :5, 3] = 1
    return bodys


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 15, 25])
def test_gaussian_kernel(ksize):
    np.testing.assert_array_equal(tl._gaussian_kernel_1d(ksize),
                                  jl._gaussian_kernel_1d(ksize))


@pytest.mark.parametrize("out_shape", [(16, 24), (4, 6), (1, 3)])
def test_blur_reflect(out_shape, rng):
    """REFLECT_101 borders, also where the padding is wider than the map
    (jnp.pad reflects again)."""
    x = rng.rand(3, *out_shape).astype(np.float32)
    for k in (15, 5):
        kernel = jl._gaussian_kernel_1d(k)
        want = np.asarray(jl._blur_reflect(jnp.asarray(x), kernel))
        got = tl._blur_reflect(torch.from_numpy(x), kernel).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("off_map,out_shape", [(False, (16, 24)),
                                               (True, (16, 24)),
                                               (True, (8, 12))])
def test_heatmaps(rng, off_map, out_shape):
    h, w = out_shape
    bodys = _bodys(rng, h=4 * h, w=4 * w, off_map=off_map)
    want = np.asarray(jl.synthesize_heatmaps(
        jnp.asarray(bodys[..., :2]), jnp.asarray(bodys[..., 3]), out_shape,
        4, KERNELS))
    got = tl.synthesize_heatmaps(torch.from_numpy(bodys[..., :2]),
                                 torch.from_numpy(bodys[..., 3]), out_shape,
                                 4, KERNELS).numpy()
    assert got.shape == want.shape == (5, h, w, 15)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if off_map:   # the wrapped joints did land on the far edge
        assert want[-1, :, w - 1, 1].max() > 0


@pytest.mark.parametrize("thre,min_vis", [(1.0, 1), (2.0, 2), (3.0, 2),
                                          (3.0, 1)])
def test_pafs(rng, thre, min_vis):
    bodys = _bodys(rng, off_map=True)
    joints = np.trunc(bodys[..., :3])
    want = np.asarray(jl.synthesize_pafs(
        jnp.asarray(joints), jnp.asarray(bodys[..., 3]), (16, 24), 4, thre,
        min_vis))
    got = tl.synthesize_pafs(torch.from_numpy(joints),
                             torch.from_numpy(bodys[..., 3]), (16, 24), 4,
                             thre, min_vis).numpy()
    assert got.shape == want.shape == (16, 24, 42)
    assert np.abs(want).max() > 1
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("P,max_people", [(4, 4), (6, 4), (3, 20)])
def test_rdepth(rng, P, max_people):
    """Fewer, as many and more persons than rows; an unlabeled root; two
    roots at the same depth (the stable sort keeps their order)."""
    bodys = _bodys(rng, P=P)
    bodys[:, 2, 3] = 1
    bodys[0, 2, 3] = 0
    bodys[1, 2, 2] = bodys[2, 2, 2]
    bodys[1, 2, :2] = [10.0, 20.0]
    want = np.asarray(jl.synthesize_rdepth(jnp.asarray(bodys),
                                           jnp.float32(0.5), 4, max_people))
    got = tl.synthesize_rdepth(torch.from_numpy(bodys), torch.tensor(0.5),
                               4, max_people).numpy()
    assert got.shape == want.shape == (max_people, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("with_mds", [True, False])
def test_labels_batched(rng, with_mds):
    """synthesize_labels on a batch of 3 against JAX's vmap of it (as
    train.step.render_labels vmaps), P = 6 > max_people = 4."""
    import jax

    bodys = np.stack([_bodys(rng, P=6, off_map=i == 0) for i in range(3)])
    scales = np.array([0.5, 1.0, 0.75], np.float32)
    args = ((16, 24), 4, KERNELS, 1.0, with_mds, 4)
    want = jax.vmap(lambda b, s: jl.synthesize_labels(b, s, *args))(
        jnp.asarray(bodys), jnp.asarray(scales))
    got = tl.synthesize_labels(torch.from_numpy(bodys),
                               torch.from_numpy(scales), *args)
    assert got[0].shape == (3, 5, 16, 24, 57)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
