"""The port's RefineNet training (smap_tpu_torch/train/refine.py, and
P2PDataset in smap_tpu_torch/data/datasets.py) against the JAX package's
(smap_tpu/train/refine.py, smap_tpu/data/datasets.py), on the same
weights and seeded pairs.

Tolerances: the pair encoding is exact; one step's loss, gradients and
BatchNorm1d statistics (biased variance, as Flax's) agree to float32
rounding (rtol 1e-5, atol 1e-6 on gradients of up to ~1); the learning
rate each step runs at to rtol 1e-4 (optax takes Adam's bias corrections
1 - beta^t in float32, which moves its step off the rate by ~1e-5). Over
epochs of Adam, the BatchNorms' input biases have a zero gradient up to
rounding, which Adam's normalised step turns into +-lr moves of their own
in either package: they and the running means they shift are not
compared. At the reference rate (0.08) those moves make the two float32
trajectories part by ~1e-2 within 12 steps, so the epoch loop is compared
at base_lr 1e-3, where every other leaf of each epoch's snapshot (linear
kernels, BatchNorm scales and shifts, the last bias, running variances)
agrees to 1e-4 (relative, in norm), and so do the models' errors
(evaluate_refinenet); evaluate_refinenet on the same weights agrees to
rtol 1e-5.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smap_tpu.config import RefineNetConfig as JRefineCfg
from smap_tpu.data.datasets import P2PDataset as JP2P
from smap_tpu.train import refine as jrefine
from smap_tpu_torch.config import RefineNetConfig
from smap_tpu_torch.data.datasets import P2PDataset
from smap_tpu_torch.models.convert import refinenet_state_dict
from smap_tpu_torch.models.refinenet import RefineNet
from smap_tpu_torch.train import refine as trefine

SMALL = dict(batch_size=16, lr_step=1, num_epochs=3, base_lr=1e-3)


def _pairs_json(path, n=64, seed=0):
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        pred_3d = np.concatenate([rng.randn(15, 3) * 30 + [0, 0, 400],
                                  rng.randint(0, 2, (15, 1))], 1)
        pairs.append({"pred_3d": pred_3d.tolist(),
                      "pred_2d": (rng.rand(15, 3) * 300).tolist(),
                      "gt_3d": (pred_3d[:, :3] + rng.randn(15, 3)).tolist()})
    with open(path, "w") as f:
        json.dump({"3d_pairs": pairs}, f)
    return str(path)


def _model(variables):
    model = RefineNet(RefineNetConfig())
    model.load_state_dict(refinenet_state_dict(jax.device_get(variables)))
    return model


def test_p2p_dataset_matches(tmp_path):
    path = _pairs_json(tmp_path / "pairs.json", n=8)
    ours, theirs = P2PDataset(path), JP2P(path)
    assert len(ours) == len(theirs) == 8
    for i in range(8):
        for a, b in zip(ours.get_sample(i), theirs.get_sample(i)):
            np.testing.assert_array_equal(a, b)


def test_refine_train_step_matches_jax(rng):
    """One step on 64 pairs: the loss, each parameter's gradient and the
    BatchNorm1d statistics (64 samples: an unbiased update would move
    each running variance by 1/63 of its step)."""
    from torch_parity import jax_refinenet

    jmodel, variables = jax_refinenet()
    cfg, jcfg = RefineNetConfig(), JRefineCfg()
    inputs = rng.randn(64, 75).astype(np.float32)
    targets = rng.randn(64, 45).astype(np.float32)

    # Applies nothing and keeps the gradient as its state.
    expose = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    state = jrefine.RefineState(step=jnp.zeros((), jnp.int32),
                                params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=expose.init(variables["params"]))
    new, loss = jax.jit(functools.partial(jrefine.refine_train_step,
                                          cfg=jcfg, tx=expose))(
        state, jnp.asarray(inputs), jnp.asarray(targets))
    new = jax.device_get(new)
    grads = refinenet_state_dict({"params": new.opt_state,
                                  "batch_stats": new.batch_stats})
    want = refinenet_state_dict({"params": variables["params"],
                                 "batch_stats": new.batch_stats})

    model = _model(variables)
    st = trefine.create_refine_state(cfg, 1, model)
    st, got_loss = trefine.refine_train_step(st, torch.from_numpy(inputs),
                                             torch.from_numpy(targets))
    assert st.step == 1
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    sd = model.state_dict()
    for n in want:
        if "running" in n:
            np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)


def test_refine_schedule_halves_by_epoch():
    """The rate each step runs at, against the JAX optimizer's: with a
    constant gradient of 1, Adam's step is the learning rate itself
    (lr_step 2 epochs of 3 steps, 14 steps)."""
    cfg = RefineNetConfig(lr_step=2)
    opt, sched = trefine.make_refine_optimizer(
        [torch.zeros(1, requires_grad=True)], cfg, 3)
    tx = jrefine.make_refine_optimizer(JRefineCfg(lr_step=2), 3)
    params = {"w": jnp.zeros(1)}
    s = tx.init(params)
    for step in range(14):
        updates, s = tx.update({"w": jnp.ones(1)}, s, params)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   -float(updates["w"][0]), rtol=1e-4,
                                   err_msg=str(step))
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == cfg.base_lr / 4   # epoch 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX's train_refinenet and the port's on the same 64 pairs, from the
    same initial weights, 3 epochs of 4 steps."""
    path = _pairs_json(tmp_path_factory.mktemp("p2p") / "pairs.json")
    jcfg, cfg = JRefineCfg(**SMALL), RefineNetConfig(**SMALL)
    jsnaps = jrefine.train_refinenet(JP2P(path), jcfg, seed=0,
                                     log_fn=lambda s: None)
    init = jrefine.create_refine_state(
        jcfg, jrefine.make_refine_optimizer(jcfg, 4), 0)
    logs = []
    snaps = trefine.train_refinenet(
        P2PDataset(path), cfg, seed=0, log_fn=logs.append, device="cpu",
        model=_model({"params": init.params,
                      "batch_stats": init.batch_stats}))
    return path, jcfg, jsnaps, snaps, logs


def _rel(a, b):
    a, b = a.numpy().astype(np.float64), b.numpy().astype(np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def test_train_refinenet_snapshots_match_jax(trained):
    path, jcfg, jsnaps, snaps, logs = trained
    assert sorted(snaps) == sorted(jsnaps) == [0, 1, 2]
    assert len(logs) == 3 and logs[0].startswith("refine epoch 0: mse ")
    for epoch, model in snaps.items():
        want = refinenet_state_dict(jax.device_get(
            {"params": jsnaps[epoch].params,
             "batch_stats": jsnaps[epoch].batch_stats}))
        sd = model.state_dict()
        for n in want:
            pre_bn_bias = n.endswith(".0.bias")
            if pre_bn_bias or "running_mean" in n or "num_batches" in n:
                continue
            assert _rel(sd[n], want[n]) < 1e-4, (epoch, n)
        _, err = trefine.evaluate_refinenet(model, P2PDataset(path))
        _, jerr = jrefine.evaluate_refinenet(jsnaps[epoch], JP2P(path),
                                             jcfg)
        np.testing.assert_allclose(err, jerr, rtol=1e-4)


def test_evaluate_and_select_match_jax(trained):
    """On the JAX snapshots' own weights: evaluate_refinenet to rtol 1e-5,
    and select_best_epoch picks JAX's epoch."""
    path, jcfg, jsnaps, snaps, _ = trained
    models = {e: _model({"params": s.params,
                         "batch_stats": s.batch_stats}).eval()
              for e, s in jsnaps.items()}
    for e, m in models.items():
        per_joint, err = trefine.evaluate_refinenet(m, P2PDataset(path))
        jper, jerr = jrefine.evaluate_refinenet(jsnaps[e], JP2P(path), jcfg)
        np.testing.assert_allclose(per_joint, jper, rtol=1e-5)
        np.testing.assert_allclose(err, jerr, rtol=1e-5)
    best, err = trefine.select_best_epoch(models, P2PDataset(path))
    jbest, jerr = jrefine.select_best_epoch(jsnaps, JP2P(path), jcfg)
    assert best == jbest
    np.testing.assert_allclose(err, jerr, rtol=1e-5)
    assert trefine.select_best_epoch(snaps, P2PDataset(path))[0] in snaps


def test_train_refinenet_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = _pairs_json(tmp_path / "pairs.json", n=4)
    with pytest.raises(RuntimeError, match="cuda"):
        trefine.train_refinenet(P2PDataset(path), RefineNetConfig(**SMALL))
