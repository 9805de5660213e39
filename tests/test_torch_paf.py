"""The port's PAF scoring (the module that holds kernel A) against the
JAX package's gather path, which tests/test_pallas_kernels.py holds equal
to the Pallas kernel's path."""

import numpy as np
import pytest
import torch

from torch_parity import jax_peaks_to_torch

torch.set_num_threads(1)

# Sample points, pass counts and the -1 / default decisions must be equal.
# Mean scores are float32 sums of <= 25 samples taken in another order.
SCORE_ATOL = 1e-6


def _compare_tables(got, want, default_score):
    for pick in (lambda t: t == -1.0, lambda t: t == default_score):
        np.testing.assert_array_equal(pick(got), pick(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("seed,max_peaks", [(0, 31), (1, 15)])
def test_paf_scores_plain_matches_jax_gather(seed, max_peaks):
    import jax.numpy as jnp

    from smap_tpu.config import PAF_VECTOR
    from smap_tpu.ops.nms import extract_peaks
    from smap_tpu.ops.paf import paf_scores as jpaf_scores

    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.paf import paf_scores

    rng = np.random.RandomState(seed)
    hm = rng.rand(15, 32, 48).astype(np.float32)
    pafs = (rng.rand(28, 32, 48).astype(np.float32) - 0.5) * 2
    jpeaks = extract_peaks(jnp.asarray(hm), max_peaks=max_peaks)
    pairs = np.asarray(PAF_VECTOR, np.int32)
    want = np.asarray(jpaf_scores(jnp.asarray(pafs), jpeaks,
                                  jnp.asarray(pairs), impl="gather"))

    kernels.reset_launch_counts()
    got = paf_scores(torch.from_numpy(pafs)[None], jax_peaks_to_torch(jpeaks),
                     torch.from_numpy(pairs))
    assert set(kernels.LAUNCHES.values()) == {0}, (
        "a CPU tensor must take the plain version")
    assert got.shape == (1, 14, max_peaks, max_peaks)
    default = np.float32(0.1 + 1e-6)
    _compare_tables(got[0].numpy(), want, default)
    # Every class of entry occurs, so each rule is exercised.
    assert (want == -1).any() and (want > 0.1 + 1e-6).any()


def test_paf_scores_on_scene_matches_jax_gather():
    """Rendered people: long limbs, all-passing samples, real scores."""
    import jax.numpy as jnp

    from scenes import make_scene, render_outputs
    from smap_tpu.config import PAF_VECTOR
    from smap_tpu.ops.nms import extract_peaks
    from smap_tpu.ops.paf import paf_scores as jpaf_scores

    from smap_tpu_torch.ops.paf import paf_scores

    rng = np.random.RandomState(3)
    K, people = make_scene(rng, num_people=4)
    scale = min(832 / 1920, 512 / 1080)
    out2d, _, _ = render_outputs(people, K, 1920, 1080, 128, 208, 4, scale,
                                 0.0, (512 - 1080 * scale) // 2)
    maps = np.ascontiguousarray(np.moveaxis(out2d, -1, 0))
    jpeaks = extract_peaks(jnp.asarray(maps[:15] / 255.0), max_peaks=40)
    pafs = (maps[15:] / 127.0).astype(np.float32)
    pairs = np.asarray(PAF_VECTOR, np.int32)
    want = np.asarray(jpaf_scores(jnp.asarray(pafs), jpeaks,
                                  jnp.asarray(pairs), impl="gather"))
    got = paf_scores(torch.from_numpy(pafs)[None], jax_peaks_to_torch(jpeaks),
                     torch.from_numpy(pairs))[0].numpy()
    _compare_tables(got, want, np.float32(0.1 + 1e-6))
    assert (want > 0.5).sum() >= 14 * 4


def test_paf_scores_batch_rows_are_independent():
    """Image b of a batch scores as the same image alone."""
    from smap_tpu_torch.config import PAF_VECTOR
    from smap_tpu_torch.ops.nms import extract_peaks
    from smap_tpu_torch.ops.paf import paf_scores

    rng = np.random.RandomState(5)
    hm = torch.from_numpy(rng.rand(3, 15, 16, 24).astype(np.float32))
    pafs = torch.from_numpy(
        (rng.rand(3, 28, 16, 24).astype(np.float32) - 0.5) * 2)
    peaks = extract_peaks(hm, max_peaks=12)
    pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32)
    both = paf_scores(pafs, peaks, pairs)
    for b in range(3):
        one = paf_scores(pafs[b:b + 1], type(peaks)(*(p[b:b + 1]
                                                      for p in peaks)), pairs)
        assert torch.equal(both[b], one[0])


@pytest.mark.parametrize("B", [1, 3])
def test_paf_scores_plain_channels_last_equals_contiguous(B):
    """The decode hands kernel A channels-last maps; the plain version
    gives the same bits on them as on NCHW-contiguous maps."""
    from smap_tpu_torch.config import PAF_VECTOR
    from smap_tpu_torch.ops.nms import extract_peaks
    from smap_tpu_torch.ops.paf import paf_scores_plain

    rng = np.random.RandomState(7 + B)
    hm = torch.from_numpy(rng.rand(B, 15, 16, 24).astype(np.float32))
    nhwc = torch.from_numpy(
        (rng.rand(B, 16, 24, 28).astype(np.float32) - 0.5) * 254)
    cl = nhwc.permute(0, 3, 1, 2) / 127.0
    assert cl.is_contiguous(memory_format=torch.channels_last)
    assert not cl.is_contiguous()
    peaks = extract_peaks(hm, max_peaks=12)
    pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32)
    got = paf_scores_plain(cl, peaks, pairs)
    want = paf_scores_plain(cl.contiguous(), peaks, pairs)
    assert torch.equal(got, want)
    assert (want > 0.1).any() and (want == -1).any()


def test_decode_passes_channels_last_pafs(monkeypatch):
    """postprocess_batch divides the NHWC maps' PAF channels by 127 with no
    copy to NCHW: the tensor kernel A gets has strides (28HW, 1, 28W, 28)."""
    from smap_tpu_torch.camera import default_scale_dict
    from smap_tpu_torch.ops import paf as paf_module
    from smap_tpu_torch.ops import postprocess

    seen = []

    def spy(pafs, *args, **kw):
        seen.append(pafs)
        return paf_module.paf_scores(pafs, *args, **kw)

    monkeypatch.setattr(postprocess, "paf_scores", spy)
    rng = np.random.RandomState(0)
    B, H, W = 2, 16, 24
    out2d = torch.from_numpy(rng.rand(B, H, W, 43).astype(np.float32) * 255)
    out3d = torch.zeros((B, H, W, 14))
    rd = torch.ones((B, H, W, 1))
    sd = default_scale_dict(1920, 1080, 96, 64)
    scale = postprocess.ScaleInfo(*(torch.full((B,), float(v)) for v in (
        sd["scale"], sd["img_width"], sd["img_height"], sd["f_x"],
        sd["f_y"], sd["cx"], sd["cy"])))
    postprocess.postprocess_batch(out2d, out3d, rd, scale, net_w=96.0,
                                  net_h=64.0)
    (pafs,) = seen
    assert tuple(pafs.shape) == (B, 28, H, W)
    assert pafs.stride() == (28 * H * W, 1, 28 * W, 28)
    assert torch.equal(pafs, out2d[..., 15:].permute(0, 3, 1, 2) / 127.0)
