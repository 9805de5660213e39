"""The port's datasets, batch iterator and GT registration against the JAX
package's (which reads with cv2), on PNG and on JPEG frames: joint tables,
validity, scales and epoch orders
exact; images exact where they are only resized and within
``warp_affine``'s remainder where rotated."""

import json

import cv2
import numpy as np
import pytest

from smap_tpu.config import Config as JConfig
from smap_tpu.config import TrainConfig as JTrainConfig
from smap_tpu.data import datasets as jds
from smap_tpu.data import native as jnative
from smap_tpu.evaluation.register import register_pred as jregister

from smap_tpu_torch.config import PIXEL_STDS_BGR, Config, TrainConfig
from smap_tpu_torch.data import datasets as ds
from smap_tpu_torch.data import native as tnative
from smap_tpu_torch.evaluation.register import register_pred
from test_torch_image import WARP_MAX_DIFF, WARP_MAX_SHARE

INPUT = (64, 96)
# One grey level, normalized: 1 / 255 / the smallest channel deviation.
PIXEL_STEP = 1.0 / 255.0 / min(PIXEL_STDS_BGR) + 1e-6


@pytest.fixture(params=["png", "jpg"])
def annotated(tmp_path, request):
    """Frames of two datasets (MuCo and COCO), PNG or JPEG, train and
    validation records with two or three people each."""
    ext = request.param
    rng = np.random.RandomState(0)
    records = []
    for i in range(7):
        h, w = rng.randint(50, 130), rng.randint(60, 180)
        name = "COCO" if i % 3 == 0 else "MUCO"
        (tmp_path / name).mkdir(exist_ok=True)
        base = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1, 3))
        img = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w].astype(np.uint8)
        cv2.imwrite(str(tmp_path / name / f"f{i}.{ext}"), img)
        people = 2 + i % 2
        bodys = np.zeros((people, 15, 11))
        bodys[..., 0] = rng.uniform(-5, w + 5, (people, 15))
        bodys[..., 1] = rng.uniform(-5, h + 5, (people, 15))
        bodys[..., 2] = rng.uniform(200, 500, (people, 15))
        bodys[..., 3] = rng.choice([0, 1, 2], (people, 15), p=[.1, .2, .7])
        bodys[..., 4:7] = rng.randn(people, 15, 3) * 40
        bodys[..., 7:] = [900.0, 905.0, w / 2, h / 2]
        records.append({"dataset": name, "img_paths": f"f{i}.{ext}",
                        "img_height": h, "img_width": w,
                        "isValidation": int(i >= 5),
                        "bodys": bodys.tolist()})
    path = tmp_path / "annot.json"
    path.write_text(json.dumps({"root": records}))
    roots = {"MUCO": str(tmp_path / "MUCO"), "COCO": str(tmp_path / "COCO")}
    return str(path), roots


def _pair(annotated, stage, with_aug, composed=False):
    path, roots = annotated
    tc = dict(max_people=4, composed_warp=composed)
    jcfg = JConfig(train=JTrainConfig(**tc), input_shape=INPUT)
    cfg = Config(train=TrainConfig(**tc), input_shape=INPUT)
    assert ds.load_annotations(path) == jds.load_annotations(path)
    records = ds.load_annotations(path)
    return (ds.JointDataset(records, roots, cfg, stage, with_aug),
            jds.JointDataset(records, roots, jcfg, stage, with_aug))


def assert_images_close(got, want, exact):
    """Normalized images: equal, or a grey level apart on few pixels."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    diff = np.abs(got - want)
    if exact:
        assert diff.max() == 0
    else:
        assert diff.max() <= WARP_MAX_DIFF * PIXEL_STEP
        assert (diff > 0).mean() <= WARP_MAX_SHARE


@pytest.fixture
def jax_numpy_normalize(monkeypatch):
    """Both packages' train samples normalize through their ctypes library
    when it builds; here both take their numpy fallback, the same
    normalize_image (the libraries are held to each other below)."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    load = tnative.load
    monkeypatch.setattr(tnative, "load", lambda name="preprocess": (
        None if name == "preprocess" else load(name)))


@pytest.mark.parametrize("with_aug,composed", [(False, False), (True, False),
                                               (True, True)])
def test_get_train_sample(annotated, jax_numpy_normalize, with_aug,
                          composed):
    port, jax_ds = _pair(annotated, "train", with_aug, composed)
    assert len(port) == len(jax_ds) == 5
    for i in range(len(port)):
        got = port.get_train_sample(i, np.random.RandomState(i))
        want = jax_ds.get_train_sample(i, np.random.RandomState(i))
        assert_images_close(got[0], want[0], exact=not with_aug)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_train_sample_normalizes_as_the_native_library(annotated):
    """Both train samples through their native libraries, where both
    build: the same source and flags on the same host, so the same bits
    (the port normalized in numpy before, 4.8e-7 apart)."""
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("a native preprocessing library did not build")
    port, jax_ds = _pair(annotated, "train", False)
    for i in range(len(port)):
        got = port.get_train_sample(i, np.random.RandomState(i))[0]
        want = jax_ds.get_train_sample(i, np.random.RandomState(i))[0]
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("stage", ["test", "generation"])
def test_get_eval_sample(annotated, stage):
    port, jax_ds = _pair(annotated, stage, False)
    assert len(port) == len(jax_ds) == (2 if stage == "test" else 5)
    for i in range(len(port)):
        got, want = port.get_eval_sample(i), jax_ds.get_eval_sample(i)
        assert_images_close(got[0], want[0], exact=True)
        assert got[1].dtype == want[1].dtype
        assert np.array_equal(got[1], want[1])
        assert got[2:] == want[2:]


def test_missing_frame_raises(annotated):
    port, _ = _pair(annotated, "train", False)
    port.records[0] = dict(port.records[0], img_paths="gone.png")
    with pytest.raises(FileNotFoundError, match="gone.png"):
        port.get_train_sample(0, np.random.RandomState(0))


@pytest.mark.parametrize("n,shards", [(7, 1), (7, 3), (10, 4), (1, 2)])
def test_epoch_indices(n, shards):
    for epoch in range(3):
        for shard in range(shards):
            for shuffle in (False, True):
                got = ds.epoch_indices(n, epoch, shuffle, shards, shard, 5)
                want = jds.epoch_indices(n, epoch, shuffle, shards, shard, 5)
                assert np.array_equal(got, want)


def _batches(it):
    return [(i, tuple(np.asarray(x) for x in b)) for i, b in it]


def test_train_iterator_matches_jax(annotated):
    """Across an epoch boundary and resumed mid-way; the port's batches at
    0 and 2 worker processes are equal bit for bit, and JAX's within the
    rotation's remainder. Every sample normalizes through the native
    libraries, in the workers too (a patch here would not reach them)."""
    port, jax_ds = _pair(annotated, "train", True)
    want = _batches(jds.train_iterator(jax_ds, 2, 5, start_iter=1, seed=3))
    serial = _batches(ds.train_iterator(port, 2, 5, start_iter=1, seed=3))
    pooled = _batches(ds.train_iterator(port, 2, 5, start_iter=1, seed=3,
                                        num_workers=2))
    assert [i for i, _ in want] == [i for i, _ in serial] == [1, 2, 3, 4]
    for (_, g), (_, p), (_, w) in zip(serial, pooled, want):
        for a, b in zip(g, p):
            assert np.array_equal(a, b)
        assert_images_close(g[0], w[0], exact=False)
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    resumed = _batches(ds.train_iterator(port, 2, 5, start_iter=3, seed=3))
    assert [i for i, _ in resumed] == [3, 4]
    for (_, g), (_, r) in zip(serial[2:], resumed):
        assert all(np.array_equal(a, b) for a, b in zip(g, r))


def test_train_iterator_close_and_errors(annotated):
    """Closing the iterator early stops its thread and pool; an error in
    a sample is raised to the consumer."""
    port, _ = _pair(annotated, "train", False)
    it = ds.train_iterator(port, 2, 100, num_workers=1)
    assert next(it)[0] == 0
    it.close()
    port.records[1] = dict(port.records[1], img_paths="gone.png")
    with pytest.raises(FileNotFoundError, match="gone.png"):
        list(ds.train_iterator(port, 5, 1))


def test_register_pred_matches_jax():
    """Random cases, an exact tie of distances, and empty inputs."""
    rng = np.random.RandomState(0)
    cases = []
    for _ in range(20):
        p, g = rng.randint(0, 5), rng.randint(0, 5)
        pred_2d = rng.uniform(0, 100, (p, 15, 4))
        gt = rng.uniform(0, 100, (g, 15, 11))
        cases.append((pred_2d, rng.randn(p, 15, 4), rng.rand(p), gt))
    # Two predictions at the same distance from one root, and one from two.
    tie_pred = np.zeros((2, 15, 4))
    tie_pred[0, 2, :2] = [10.0, 0.0]
    tie_pred[1, 2, :2] = [-10.0, 0.0]
    tie_gt = np.zeros((2, 15, 11))
    tie_gt[1, 2, :2] = [0.0, 20.0]
    cases.append((tie_pred, rng.randn(2, 15, 4), rng.rand(2), tie_gt))
    for pred_2d, pred_3d, depth, gt in cases:
        got = register_pred(pred_2d, pred_3d, depth, gt)
        want = jregister(pred_2d, pred_3d, depth, gt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
