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
    assert kernels.LAUNCHES == {"paf_score": 0, "associate_limb": 0}, (
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
