"""The port's losses (smap_tpu_torch/losses.py) against the JAX package's
(smap_tpu/losses.py), values and gradients, on the same seeded inputs.

Tolerances: each loss is a float32 mean over a few thousand squares,
reduced in another order (rtol 1e-5); gradients are elementwise
(2 (o - l) w / n, or a sign at the root pixels), equal up to the rounding
of those scales (rtol 1e-5, atol 1e-9).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smap_tpu import losses as jlosses
from smap_tpu.config import TrainConfig as JTrainConfig
from smap_tpu_torch import losses as tlosses
from smap_tpu_torch.config import TrainConfig

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("ohkm,paf_num", [(False, 0), (True, 0), (True, 14)])
def test_joints_l2_loss(rng, ohkm, paf_num):
    B, C, H, W = 3, 43 if paf_num else 14, 16, 24
    out = rng.randn(B, H, W, C).astype(np.float32)
    lbl = rng.randn(B, H, W, C).astype(np.float32)
    valid = (rng.rand(B, C) > 0.3).astype(np.float32)
    kw = dict(ohkm=ohkm, topk=8, paf_num=paf_num)

    want, want_g = jax.value_and_grad(
        lambda o: jlosses.joints_l2_loss(o, jnp.asarray(valid),
                                         jnp.asarray(lbl), **kw))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_()
    got = tlosses.joints_l2_loss(o, torch.from_numpy(valid),
                                 torch.from_numpy(lbl), **kw)
    got.backward()
    _close(got.item(), float(want))
    _close(o.grad, want_g)


def _rdepth(rng, B, P, H, W):
    rdepth = np.zeros((B, P, 3), np.float32)
    for b in range(B):
        n = rng.randint(1, 6)
        rdepth[b, :n, 0] = rng.uniform(-2, H + 2, n)   # clipped to the map
        rdepth[b, :n, 1] = rng.uniform(-2, W + 2, n)
        rdepth[b, :n, 2] = rng.rand(n) * 3
    return rdepth


def test_depth_loss(rng):
    B, H, W, P = 2, 16, 24, 20
    out = rng.randn(B, H, W, 1).astype(np.float32)
    rdepth = _rdepth(rng, B, P, H, W)
    want, want_g = jax.value_and_grad(
        lambda o: jlosses.depth_loss(o, jnp.asarray(rdepth)))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_()
    got = tlosses.depth_loss(o, torch.from_numpy(rdepth))
    got.backward()
    _close(got.item(), float(want))
    _close(o.grad, want_g)
    assert np.count_nonzero(want_g) > 0


def test_depth_loss_no_valid_root(rng):
    """No valid root: loss 0 and a zero gradient, not NaN."""
    out = torch.from_numpy(rng.randn(2, 8, 8, 1).astype(np.float32))
    out.requires_grad_()
    loss = tlosses.depth_loss(out, torch.zeros(2, 20, 3))
    loss.backward()
    assert loss.item() == 0.0
    assert torch.equal(out.grad, torch.zeros_like(out))
    assert float(jlosses.depth_loss(jnp.asarray(out.detach().numpy()),
                                    jnp.zeros((2, 20, 3)))) == 0.0


@pytest.mark.parametrize("stage_num,coarse_to_fine,ohkm",
                         [(3, True, True), (2, False, True),
                          (1, True, False)])
def test_smap_loss_and_gradient(rng, stage_num, coarse_to_fine, ohkm):
    """smap_loss and its gradient w.r.t. every output map, against
    jax.value_and_grad; the last stage's shifted labels, the coarse
    scales' /4, OHKM and the paf / z channel split all show in them."""
    import dataclasses

    B, H, W = 2, 16, 26
    channels = {"heatmap_2d": 43, "det_d": 14, "root_d": 1}
    outputs = {k: [[rng.randn(B, H, W, c).astype(np.float32)
                    for _ in range(4)] for _ in range(stage_num)]
               for k, c in channels.items()}
    labels = (rng.randn(B, 5, H, W, 57) * 50).astype(np.float32)
    valids = (rng.rand(B, 57) > 0.2).astype(np.float32)
    rdepth = _rdepth(rng, B, 20, H, W)
    kw = dict(coarse_to_fine=coarse_to_fine, ohkm=ohkm)
    jcfg = dataclasses.replace(JTrainConfig(), **kw)
    cfg = dataclasses.replace(TrainConfig(), **kw)

    def jloss(outs):
        return jlosses.smap_loss(outs, jnp.asarray(valids),
                                 jnp.asarray(labels), jnp.asarray(rdepth),
                                 jcfg)

    want = jloss(jax.tree.map(jnp.asarray, outputs))
    want_g = jax.grad(lambda o: jloss(o)["total_loss"])(
        jax.tree.map(jnp.asarray, outputs))
    touts = {k: [[torch.from_numpy(a).requires_grad_() for a in s]
                 for s in v] for k, v in outputs.items()}
    got = tlosses.smap_loss(touts, torch.from_numpy(valids),
                            torch.from_numpy(labels),
                            torch.from_numpy(rdepth), cfg)
    got["total_loss"].backward()
    for key in ("total_loss", "loss_2d", "loss_bone", "loss_root"):
        _close(got[key].item(), float(want[key]))
    for k in channels:
        for i in range(stage_num):
            for j in range(4):
                _close(touts[k][i][j].grad, want_g[k][i][j])
