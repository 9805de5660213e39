"""The port's depth readout, chaining, back-projection, refinement folding,
camera math and preprocessing against the JAX package's."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# float32 arithmetic in the same order on both sides, except the linear
# percentile interpolation (jnp.percentile's weighted sum vs
# torch.quantile's lerp), which moves results by a few ulps.
ATOL = 1e-5


def _bodies(rng, P=6, J=15, w=96.0, h=64.0, drop=0.2):
    b = np.zeros((P, J, 4), np.float32)
    b[..., 0] = rng.uniform(0, w, (P, J))
    b[..., 1] = rng.uniform(0, h, (P, J))
    b[..., 3] = rng.uniform(0.3, 1.0, (P, J)) * (rng.rand(P, J) > drop)
    b[-1] = 0.0                                       # an empty row
    return b


def test_linspace_matches_jax_bit_for_bit():
    """read_limb_depths rounds points on the linspace half to even, so the
    sample positions must be the same floats as jnp.linspace's. For the
    decode's 10 samples torch.linspace gives them too; for other counts it
    does not (e.g. 7), so the port builds them as jnp.linspace does."""
    import jax.numpy as jnp

    from smap_tpu_torch.ops.depth import _linspace01

    for n in range(1, 33):
        np.testing.assert_array_equal(_linspace01(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)),
                                      err_msg=str(n))
    np.testing.assert_array_equal(
        torch.linspace(0.0, 1.0, 10, dtype=torch.float32).numpy(),
        np.asarray(jnp.linspace(0.0, 1.0, 10)))


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_ops_match_jax(seed):
    import jax.numpy as jnp

    from smap_tpu.ops import depth as jdepth

    from smap_tpu_torch.ops import depth

    rng = np.random.RandomState(seed)
    b2d = _bodies(rng)
    paf_z = rng.randn(14, 16, 24).astype(np.float32)
    rd = rng.rand(16, 24).astype(np.float32) * 3
    t2d, tz, trd = (torch.from_numpy(a)[None] for a in (b2d, paf_z, rd))

    want_v = np.asarray(jdepth.read_limb_depths(jnp.asarray(b2d),
                                                jnp.asarray(paf_z)))
    got_v = depth.read_limb_depths(t2d, tz)[0].numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=ATOL)
    assert (want_v != 0).sum() > 20

    for root_idx in (2, 0):
        want = jdepth.chain_depths(jnp.asarray(want_v), None,
                                   root_idx=root_idx)
        got = depth.chain_depths(torch.tensor(want_v)[None],
                                 root_idx=root_idx)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    scale, fx = np.float32(0.43), np.float32(1500.0)
    want_r = np.asarray(jdepth.root_depths(jnp.asarray(b2d), jnp.asarray(rd),
                                           scale=scale, f_x=fx))
    got_r = depth.root_depths(t2d, trd, scale=torch.tensor([scale]),
                              f_x=torch.tensor([fx]))[0].numpy()
    np.testing.assert_array_equal(got_r, want_r)

    K = np.array([[1500.0, 0, 960.0], [0, 1490.0, 540.0], [0, 0, 1]],
                 np.float32)
    rel_z = rng.randn(6, 15).astype(np.float32) * 20
    kw = dict(net_w=96.0, net_h=64.0)
    want_3d = np.asarray(jdepth.back_project_bodies(
        jnp.asarray(b2d), jnp.asarray(rel_z), jnp.asarray(want_r),
        jnp.asarray(K), scale=scale, img_w=np.float32(1920.0),
        img_h=np.float32(1080.0), **kw))
    got_3d = depth.back_project_bodies(
        t2d, torch.from_numpy(rel_z)[None], torch.from_numpy(want_r)[None],
        torch.from_numpy(K)[None], scale=torch.tensor([scale]),
        img_w=torch.tensor([1920.0]), img_h=torch.tensor([1080.0]),
        **kw)[0].numpy()
    np.testing.assert_allclose(got_3d, want_3d, rtol=1e-6, atol=1e-4)


def test_refine_folding_matches_jax():
    import jax.numpy as jnp

    from smap_tpu.ops import refine as jrefine

    from smap_tpu_torch.ops import refine

    rng = np.random.RandomState(3)
    b2d = _bodies(rng)
    b3d = _bodies(rng) * 10
    b3d[2, 2, 3] = 0.0                                # a person without root
    want_in = np.asarray(jrefine.build_refine_input(jnp.asarray(b2d),
                                                    jnp.asarray(b3d)))
    got_in = refine.build_refine_input(torch.from_numpy(b2d)[None],
                                       torch.from_numpy(b3d)[None])[0]
    np.testing.assert_array_equal(got_in.numpy(), want_in)

    pred = rng.randn(6, 45).astype(np.float32)
    want = np.asarray(jrefine.apply_refinement(jnp.asarray(pred),
                                               jnp.asarray(b3d)))
    got = refine.apply_refinement(torch.from_numpy(pred)[None],
                                  torch.from_numpy(b3d)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_camera_matches_jax():
    import jax.numpy as jnp

    from smap_tpu import camera as jcamera

    from smap_tpu_torch import camera

    assert camera.default_scale_dict(1920, 1080) == (
        jcamera.default_scale_dict(1920, 1080))
    sd = camera.default_scale_dict(640, 480, 96, 64)
    np.testing.assert_array_equal(camera.intrinsics_from_scale(sd).numpy(),
                                  np.asarray(jcamera.intrinsics_from_scale(sd)))
    xy = np.random.RandomState(0).rand(4, 15, 2).astype(np.float32) * 90
    z = np.random.RandomState(1).rand(4, 15).astype(np.float32) * 500
    K = np.asarray(jcamera.intrinsics_from_scale(sd))
    np.testing.assert_allclose(
        camera.back_project(torch.from_numpy(xy), torch.from_numpy(z),
                            torch.from_numpy(K)).numpy(),
        np.asarray(jcamera.back_project(xy, z, K)), rtol=1e-6)
    np.testing.assert_allclose(
        camera.unletterbox(torch.from_numpy(xy), 0.15, 96, 64, 640.0,
                           480.0).numpy(),
        np.asarray(jcamera.unletterbox(xy, 0.15, 96, 64, 640.0, 480.0)),
        rtol=1e-6)


def test_prepare_images_matches_jax():
    """uint8, I420 and float32 wire formats; the I420 planes are made with
    numpy, so no OpenCV is needed."""
    import jax.numpy as jnp

    from smap_tpu.inference import prepare_images as jprepare

    from smap_tpu_torch.data.preprocess import prepare_images

    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    i420 = rng.randint(0, 256, (2, 24, 24)).astype(np.uint8)
    f32 = rng.randn(2, 16, 24, 3).astype(np.float32)
    for x in (u8, i420, f32):
        got = prepare_images(torch.from_numpy(x)).numpy()
        want = np.asarray(jprepare(jnp.asarray(x)))
        assert got.shape == want.shape == (2, 16, 24, 3)
        # Same float32 formula; |values| <= ~3.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
