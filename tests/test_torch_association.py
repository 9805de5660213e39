"""The port's association (the module that holds kernel B) against the
numpy greedy oracle and the JAX package: the Pallas kernel in interpret
mode, and ``associate(impl="scan")``."""

import numpy as np
import pytest
import torch

from test_pallas_kernels import _greedy_oracle
from torch_parity import jax_peaks_to_torch

torch.set_num_threads(1)


def _tables(rng, B, K, ties=False):
    scores = rng.rand(B, K, K).astype(np.float32) * 2 - 1
    if ties:
        scores = np.round(scores * 4) / 4
    for b in range(B):
        scores[b, rng.rand(K) < 0.3] = -np.inf
    scores[0] = -np.inf                 # an image where nothing is valid
    valid = np.stack([np.arange(K) < rng.randint(0, K + 1)
                      for _ in range(B)])
    return scores, valid


@pytest.mark.parametrize("seed,K,ties", [(0, 40, False), (1, 31, True),
                                         (2, 8, True)])
def test_plain_greedy_matches_oracle_and_pallas(seed, K, ties):
    import jax
    import jax.numpy as jnp

    from smap_tpu.ops.pallas_kernels import associate_limb as jassociate_limb

    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import associate_limb

    rng = np.random.RandomState(seed)
    B = 4
    scores, valid = _tables(rng, B, K, ties)
    kernels.reset_launch_counts()
    got = associate_limb(torch.from_numpy(scores),
                         torch.from_numpy(valid)).numpy()
    assert kernels.LAUNCHES["associate_limb"] == 0
    assert got.dtype == np.int32
    oracle = np.stack([_greedy_oracle(scores[b], valid[b]) for b in range(B)])
    np.testing.assert_array_equal(got, oracle)
    # The Pallas kernel, per image and through its batched vmap rule.
    for b in range(B):
        one = jassociate_limb(jnp.asarray(scores[b]), jnp.asarray(valid[b]),
                              interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(one))
    batched = jax.vmap(lambda s, v: jassociate_limb(s, v, interpret=True))(
        jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(batched))


def test_plain_greedy_nan_counts_as_max():
    """torch.argmax / jnp.argmax take NaN as the maximum; NaN is never > 0,
    so such a row takes nothing (the kernel follows the same rule)."""
    from smap_tpu_torch.ops.association import associate_limb

    scores = torch.tensor([[[0.5, float("nan"), 0.9],
                            [0.2, 0.1, 0.3],
                            [0.4, 0.8, 0.1]]])
    got = associate_limb(scores, torch.ones((1, 3), dtype=torch.bool))
    assert got.tolist() == [[-1, 2, 1]]


@pytest.mark.parametrize("seed", [0, 1])
def test_associate_matches_jax_scan(seed):
    import jax.numpy as jnp

    from smap_tpu.config import PAF_VECTOR
    from smap_tpu.ops.association import associate as jassociate
    from smap_tpu.ops.nms import extract_peaks
    from smap_tpu.ops.paf import paf_scores

    from smap_tpu_torch.ops.association import associate

    rng = np.random.RandomState(seed)
    hm = rng.rand(15, 32, 48).astype(np.float32)
    pafs = (rng.rand(28, 32, 48).astype(np.float32) - 0.5) * 2
    rdm = (rng.rand(32, 48) * 5).astype(np.float32)
    jpeaks = extract_peaks(jnp.asarray(hm), max_peaks=31)
    table = paf_scores(jnp.asarray(pafs), jpeaks,
                       jnp.asarray(PAF_VECTOR, jnp.int32), impl="gather")
    want = jassociate(jpeaks, table, jnp.asarray(rdm), impl="scan")

    got = associate(jax_peaks_to_torch(jpeaks),
                    torch.from_numpy(np.array(table))[None],
                    torch.from_numpy(rdm)[None])
    assert int(got.count[0]) == int(want.count) > 0
    # Same table in, same selections out: exact.
    np.testing.assert_array_equal(got.joints[0].numpy(),
                                  np.asarray(want.joints))
    np.testing.assert_array_equal(got.root_depth[0].numpy(),
                                  np.asarray(want.root_depth))
    # Limbs beyond the root were assigned.
    assert (got.joints[0, :, :, 3] > 0).sum() > int(got.count[0])
