"""The port's peak extraction against the JAX package's."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# Counts and peak scores are selections: exact. The refined xy divide two
# 7x7 window sums. The port adds seven shifted slices, and is held to a
# float64 oracle within rtol 1e-6 (8 float32 ulps: a 49-term float32 sum
# and a division, at coordinates up to ~200). JAX takes the sums as differences of cumulative
# sums along whole rows and columns, whose float32 rounding grows with the
# running sum (x * score summed over a row, ~4e3 on the dense random maps):
# up to ~5e-5 in a coordinate. So against JAX the bound is 1e-4.
ORACLE_RTOL = 1e-6
JAX_ATOL = 1e-4


def _oracle_xy(hm, peak_rc, offset=0.5):
    """float64 score-weighted 7x7 centroid at integer peak positions."""
    s = np.where(hm > 0, hm, 0.0).astype(np.float64)
    h, w = s.shape[-2:]
    out = np.zeros(peak_rc.shape[:-1] + (2,))
    for idx in np.ndindex(*peak_rc.shape[:-1]):
        c, (r, q) = idx[0], peak_rc[idx]
        ys = np.arange(max(r - 3, 0), min(r + 4, h))
        xs = np.arange(max(q - 3, 0), min(q + 4, w))
        win = s[c][np.ix_(ys, xs)]
        out[idx] = ((win * xs[None, :]).sum() / win.sum() + offset,
                    (win * ys[:, None]).sum() / win.sum() + offset)
    return out


def _compare(hm, max_peaks):
    import jax.numpy as jnp

    from smap_tpu.ops.nms import extract_peaks as jextract

    from smap_tpu_torch.ops.nms import extract_peaks

    want = jextract(jnp.asarray(hm), max_peaks=max_peaks)
    got = extract_peaks(torch.from_numpy(hm)[None], max_peaks=max_peaks)
    assert got.count.dtype == torch.int32
    np.testing.assert_array_equal(got.count[0].numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.score[0].numpy(), np.asarray(want.score))
    np.testing.assert_allclose(got.xy[0].numpy(), np.asarray(want.xy),
                               rtol=0, atol=JAX_ATOL)
    # The peak pixels are the first ``count`` local maxima in
    # raster order.
    from smap_tpu_torch.ops.nms import _local_max_mask

    mask = _local_max_mask(torch.from_numpy(hm), 0.2).numpy()
    for c in range(hm.shape[0]):
        n = int(got.count[0, c])
        rc = np.argwhere(mask[c])[:n]
        np.testing.assert_allclose(got.xy[0, c, :n].numpy(),
                                   _oracle_xy(hm[c:c + 1], rc[None])[0],
                                   rtol=ORACLE_RTOL, atol=0)
    return got


@pytest.mark.parametrize("seed,num_people", [(0, 1), (3, 4), (4, 3)])
def test_extract_peaks_matches_jax_on_scenes(seed, num_people):
    from scenes import make_scene, render_outputs

    rng = np.random.RandomState(seed)
    K, people = make_scene(rng, num_people=num_people)
    scale = min(832 / 1920, 512 / 1080)
    out2d, _, _ = render_outputs(people, K, 1920, 1080, 128, 208, 4, scale,
                                 0.0, (512 - 1080 * scale) // 2)
    hm = np.ascontiguousarray(np.moveaxis(out2d[..., :15], -1, 0) / 255.0)
    got = _compare(hm.astype(np.float32), 127)
    assert int(got.count.sum()) >= 15 * num_people - 2


@pytest.mark.parametrize("seed,max_peaks", [(0, 31), (1, 127)])
def test_extract_peaks_matches_jax_on_random_maps(seed, max_peaks):
    """Dense random maps: many peaks, truncation at max_peaks."""
    hm = np.random.RandomState(seed).rand(15, 32, 48).astype(np.float32)
    got = _compare(hm, max_peaks)
    assert int(got.count.max()) > 10


def test_extract_peaks_batched_equals_per_image():
    from smap_tpu_torch.ops.nms import extract_peaks

    hm = torch.from_numpy(
        np.random.RandomState(2).rand(3, 15, 16, 24).astype(np.float32))
    both = extract_peaks(hm, max_peaks=31)
    for b in range(3):
        one = extract_peaks(hm[b], max_peaks=31)
        for g, w in zip(both, one):
            assert torch.equal(g[b], w)
