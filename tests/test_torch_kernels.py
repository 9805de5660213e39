"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``cuda``: they need a card and nvcc, and skip without a card (the
kernels have no CPU mode). On the card, where there is no JAX for
tests/conftest.py to import:

    python -m pytest tests/test_torch_kernels.py -q -m cuda -p no:randomly \
        --noconftest
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# As chip_smoke.py: kernel A sums the passing samples in another order than
# torch.sum (a few ulps of a mean of <= 25 samples); everything else in
# both kernels must be equal.
PAF_SCORE_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _peaks(gen, B, J, K, h, w, dev):
    from smap_tpu_torch.ops.nms import Peaks

    count = torch.randint(0, K + 1, (B, J), generator=gen, dtype=torch.int32)
    xy = torch.rand((B, J, K, 2), generator=gen) * torch.tensor([w, h])
    valid = torch.arange(K)[None, None, :] < count[..., None]
    xy = torch.where(valid[..., None], xy, 0.0)
    score = torch.where(valid, torch.rand((B, J, K), generator=gen), 0.0)
    return Peaks(xy.to(dev), score.to(dev), count.to(dev))


@pytest.mark.parametrize("B,K,h,w", [(1, 5, 16, 24), (4, 40, 128, 208),
                                     (2, 127, 64, 96)])
def test_paf_score_kernel_matches_plain(dev, B, K, h, w):
    from smap_tpu_torch.config import PAF_VECTOR
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.paf import paf_scores

    gen = torch.Generator().manual_seed(K)
    pafs = (torch.rand((B, 28, h, w), generator=gen) * 2 - 1).to(dev)
    peaks = _peaks(gen, B, 15, K, h, w, dev)
    pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    got = paf_scores(pafs, peaks, pairs)
    assert kernels.LAUNCHES["paf_score"] == 1
    want = paf_scores(pafs, peaks, pairs, plain=True)
    torch.cuda.synchronize()
    default = np.float32(0.1 + 1e-6).item()
    assert torch.equal(got == -1.0, want == -1.0)
    assert torch.equal(got == default, want == default)
    assert float((got - want).abs().max()) <= PAF_SCORE_ATOL


@pytest.mark.parametrize("K", [1, 8, 40, 127, 128])
def test_associate_limb_kernel_matches_plain(dev, K):
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import (associate_limb,
                                                associate_limb_plain)

    gen = torch.Generator().manual_seed(K)
    B = 16
    scores = torch.round((torch.rand((B, K, K), generator=gen) * 2 - 1)
                         * 8) / 8
    scores[torch.rand((B, K), generator=gen) < 0.3] = float("-inf")
    scores[0] = float("-inf")
    scores[1] = 0.25
    scores[2, 0, K // 2] = float("nan")
    valid = (torch.arange(K)[None, :]
             < torch.randint(0, K + 1, (B, 1), generator=gen))
    scores, valid = scores.to(dev), valid.to(dev)
    kernels.reset_launch_counts()
    got = associate_limb(scores, valid)
    assert kernels.LAUNCHES["associate_limb"] == 1
    want = associate_limb_plain(scores, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernels_reject_what_they_do_not_take(dev):
    from smap_tpu_torch.ops import kernels

    with pytest.raises(ValueError):
        kernels.associate_limb(torch.zeros((1, 129, 129), device=dev),
                               torch.ones((1, 129), dtype=torch.bool,
                                          device=dev))
    with pytest.raises(ValueError):
        kernels.associate_limb(torch.zeros((1, 4, 4)),
                               torch.ones((1, 4), dtype=torch.bool))
