"""The training path on the card against the same computation on the CPU.

Marked ``cuda``: they need a card and skip without one. On the card, where
there is no JAX for tests/conftest.py to import:

    python -m pytest tests/test_torch_train_cuda.py -q -m cuda \
        -p no:randomly --noconftest

Tolerances as chip_smoke.py phase 8 states them: labels within 1e-5 (the
same terms in the same order, PAF means over persons reduced in another
order); a float32 train step (TF32 off) is held, with the CPU's, to a
float64 CPU step, no farther than 4 times the CPU float32 step's distance
(BatchNorm by the batch amplifies float32 rounding at these shapes);
remat equals no remat on the card under PyTorch's deterministic
algorithms (losses rtol 1e-5, statistics and gradients 1e-6; without them
some backward sums change order from run to run); one RefineNet step to
rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LABEL_ATOL = 1e-5
NOISE = 4.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from smap_tpu_torch.runtime import get_device, no_tf32

    with no_tf32():
        yield get_device("cuda")


def _cfg(**model):
    from smap_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(**dict(dict(
        stage_num=1, trunk_width=16, upsample_channels=32,
        output_shape=(16, 24), compute_dtype="float32"), **model)),
        train=TrainConfig(max_people=4), input_shape=(64, 96),
        output_shape=(16, 24))


def _batch(cfg, b=2, seed=0):
    from smap_tpu_torch.train.step import TrainBatch

    rng = np.random.RandomState(seed)
    h, w = cfg.input_shape
    bodys = np.zeros((b, cfg.train.max_people, 15, 11), np.float32)
    bodys[..., 0] = rng.uniform(-10, w + 10, bodys.shape[:3])
    bodys[..., 1] = rng.uniform(-10, h + 10, bodys.shape[:3])
    bodys[..., 2] = rng.uniform(100, 400, bodys.shape[:3])
    bodys[..., 3] = rng.randint(0, 3, bodys.shape[:3])
    bodys[..., 7] = 1100.0
    return TrainBatch(torch.from_numpy(rng.randn(b, h, w, 3).astype(
        np.float32)), torch.from_numpy(bodys), torch.ones(b, 57),
        torch.full((b,), 0.5))


def _on(batch, d):
    from smap_tpu_torch.train.step import TrainBatch

    return TrainBatch(*(x.to(d) for x in batch))


def _dist(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / (b.norm() + 1e-30))


def _step(cfg, batch, d, dtype=torch.float32, seed=1):
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.train.step import (create_train_state, train_step,
                                           training_model)

    model = training_model(init_smap(cfg.model, seed=seed), d)
    if dtype == torch.float64:
        model.double().compute_dtype = torch.float64
    st, losses = train_step(create_train_state(model, cfg), _on(batch, d),
                            cfg=cfg)
    grads = torch.cat([p.grad.double().flatten().cpu()
                       for p in model.parameters()])
    stats = torch.cat([v.double().flatten().cpu() for k, v in
                       model.state_dict().items() if "running_" in k])
    return {k: float(v) for k, v in losses.items()}, grads, stats


def test_labels_on_the_card_match_the_cpu(dev):
    from smap_tpu_torch.train.step import render_labels

    cfg = _cfg()
    batch = _batch(cfg, b=3)
    for got, want in zip(render_labels(_on(batch, dev), cfg=cfg),
                         render_labels(batch, cfg=cfg)):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=LABEL_ATOL)


def test_train_step_on_the_card_matches_the_cpu(dev):
    cfg = _cfg()
    batch = _batch(cfg)
    lc, gc, sc = _step(cfg, batch, dev)
    l32, g32, s32 = _step(cfg, batch, torch.device("cpu"))
    _, g64, s64 = _step(cfg, batch, torch.device("cpu"), torch.float64)
    for k in ("total_loss", "loss_2d", "loss_bone"):
        np.testing.assert_allclose(lc[k], l32[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(lc["loss_root"], l32["loss_root"], rtol=1e-2)
    assert _dist(gc, g64) <= NOISE * _dist(g32, g64) + 1e-6
    assert _dist(sc, s64) <= NOISE * _dist(s32, s64) + 1e-6


@pytest.fixture
def deterministic(monkeypatch):
    """PyTorch's deterministic algorithms, and cuDNN's, for one test."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def test_remat_on_the_card(dev, deterministic):
    """remat: the same losses, running statistics and gradients as the
    plain step."""
    cfg = _cfg(stage_num=2)
    batch = _batch(cfg)
    l0, g0, s0 = _step(cfg, batch, dev)
    l1, g1, s1 = _step(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=True)), batch, dev)
    for k in l0:
        np.testing.assert_allclose(l1[k], l0[k], rtol=1e-5, err_msg=k)
    assert _dist(s1, s0) < 1e-6
    assert _dist(g1, g0) <= 1e-6


def test_refine_step_on_the_card_matches_the_cpu(dev):
    from smap_tpu_torch.config import RefineNetConfig
    from smap_tpu_torch.models.refinenet import RefineNet
    from smap_tpu_torch.train.refine import (create_refine_state,
                                             refine_train_step)

    cfg = RefineNetConfig()
    gen = torch.Generator().manual_seed(0)
    x, y = torch.randn(256, 75, generator=gen), torch.randn(256, 45,
                                                            generator=gen)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = RefineNet(cfg)
    got = {}
    for d in (dev, torch.device("cpu")):
        m = RefineNet(cfg)
        m.load_state_dict(model.state_dict())
        st, loss = refine_train_step(create_refine_state(cfg, 1, m.to(d)),
                                     x.to(d), y.to(d))
        got[d.type] = (float(loss), {k: v.cpu() for k, v in
                                     m.state_dict().items()})
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-4)
    for k, v in got["cpu"][1].items():
        if "running_var" in k or "running_mean" in k:
            np.testing.assert_allclose(got["cuda"][1][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
