"""The port's tools against the JAX package's, on the CPU and the same
seeded inputs, exactly: checkpoint conversion both ways
(``convert_checkpoint``, ``models.convert.save_torch_checkpoint``), COCO
conversion, suffix-matched parameter alignment, the ``Timer`` and the
result viewer (the saved figures' pixels)."""

import json
import time

import jax
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from smap_tpu.data.coco_convert import convert_coco as jconvert_coco
from smap_tpu.models.torch_convert import (convert_smap_state_dict,
                                           export_smap_state_dict)
from smap_tpu.models.torch_convert import \
    load_torch_checkpoint as jload_torch_checkpoint
from smap_tpu.models.torch_convert import \
    save_torch_checkpoint as jsave_torch_checkpoint
from smap_tpu.utils.align import align_and_update as jalign
from smap_tpu.utils.timer import Timer as JTimer
from smap_tpu_torch import convert_checkpoint
from smap_tpu_torch.data.coco_convert import (coco_person_to_mpi15,
                                              convert_coco)
from smap_tpu_torch.data.image import imread
from smap_tpu_torch.models.convert import (load_torch_checkpoint,
                                           save_torch_checkpoint,
                                           smap_state_dict)
from smap_tpu_torch.train.engine import Trainer, TrainerConfig
from smap_tpu_torch.utils.align import align_and_update
from smap_tpu_torch.utils.timer import Timer


@pytest.fixture
def small(monkeypatch):
    """JAX variables of a narrow one-stage SMAP, and the port's config of
    the same model patched into the CLI."""
    jcfg, cfg = tp.cfgs(input_shape=(32, 48), trunk_width=8,
                        upsample_channels=16)
    _, variables = tp.jax_variables(jcfg, seed=2)
    monkeypatch.setattr(convert_checkpoint, "Config", lambda: cfg)
    return cfg, jax.device_get(variables)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_convert_checkpoint_both_ways(tmp_path, small):
    """A reference .pth from the JAX package's exporter -> a port training
    checkpoint holding smap_state_dict(variables) bit for bit, with a fresh
    Adam and schedule at step 0, which Trainer restores; its export, read
    back by the JAX package, is the variables bit for bit."""
    cfg, variables = small
    ref = str(tmp_path / "ref.pth")
    jsave_torch_checkpoint(export_smap_state_dict(variables), ref)
    run = str(tmp_path / "run")
    path = convert_checkpoint.main(["--smap-path", ref, "--output-dir", run])
    ckpt = torch.load(path, weights_only=True)
    want = smap_state_dict(variables)
    assert ckpt["step"] == 0 and ckpt["optimizer"]["state"] == {}
    assert ckpt["scheduler"]["last_epoch"] == 0
    assert sorted(ckpt["model"]) == sorted(want)
    for k, v in want.items():
        assert ckpt["model"][k].dtype == v.dtype
        assert torch.equal(ckpt["model"][k], v), k

    trainer = Trainer(cfg, TrainerConfig(output_dir=run), device="cpu")
    state = trainer.ckpt.restore(trainer.init_state(7))
    trainer.close()
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    out = str(tmp_path / "back.pth")
    assert convert_checkpoint.main(["--ckpt-dir", run, "--to-torch", out]
                                   ) == out
    back = convert_smap_state_dict(jload_torch_checkpoint(out))
    got = dict(_leaves(back))
    expect = dict(_leaves(variables))
    assert sorted(got) == sorted(expect)
    for k, v in expect.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert torch.load(out, weights_only=True).keys() == {"model"}


def test_convert_checkpoint_refuses_without_a_checkpoint(tmp_path, small):
    for src in (tmp_path / "none", tmp_path / "empty"):
        (tmp_path / "empty" / "checkpoints").mkdir(parents=True,
                                                   exist_ok=True)
        with pytest.raises(SystemExit, match="no checkpoint found"):
            convert_checkpoint.main(["--ckpt-dir", str(src), "--to-torch",
                                     str(tmp_path / "x.pth")])
    assert not (tmp_path / "x.pth").exists()
    assert not (tmp_path / "none").exists()
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["--smap-path", "only.pth"])


def test_save_torch_checkpoint_matches_jax(tmp_path):
    """numpy and tensor state_dicts -> {"model": tensors}, as the JAX
    package writes them; load_torch_checkpoint reads either back."""
    rng = np.random.RandomState(0)
    sd = {"a.weight": rng.randn(3, 2).astype(np.float32),
          "a.num_batches_tracked": np.asarray(0, np.int64),
          "b.bias": np.asfortranarray(rng.randn(2, 3))}
    jsave_torch_checkpoint(sd, str(tmp_path / "j.pth"))
    save_torch_checkpoint(sd, str(tmp_path / "p.pth"))
    save_torch_checkpoint({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, str(tmp_path / "t.pth"))
    want = torch.load(tmp_path / "j.pth", weights_only=True)["model"]
    for name in ("p.pth", "t.pth"):
        got = torch.load(tmp_path / name, weights_only=True)
        assert got.keys() == {"model"}
        got = got["model"]
        assert list(got) == list(want) == list(sd)
        for k, v in sd.items():
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k].numpy(), v), k
            # 0-d stays 0-d, as in the reference (the JAX writer: [1]).
            assert got[k].shape == v.shape
            assert want[k].shape == (v.shape or (1,))
        assert list(load_torch_checkpoint(str(tmp_path / name))) == list(sd)


def _coco_file(path):
    """Three images, people with every joint, a crowd, one with no
    keypoints, one whose visible joints map to nothing of mpi15, one with
    no hips (no pelvis: the neck is the shoulders' midpoint) and an image
    with nobody."""
    rng = np.random.RandomState(3)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": w,
               "height": h} for i, (w, h) in enumerate(
                   ((640, 480), (500, 375), (427, 640), (300, 200)), 1)]
    anns = []

    def person(image_id, vis=None, **kw):
        k = np.zeros((17, 3))
        k[:, 0] = rng.uniform(0, 400, 17)
        k[:, 1] = rng.uniform(0, 300, 17)
        k[:, 2] = rng.choice([0, 1, 2], 17) if vis is None else vis
        anns.append(dict({"image_id": image_id, "iscrowd": 0,
                          "num_keypoints": int((k[:, 2] > 0).sum()),
                          "keypoints": k.ravel().tolist()}, **kw))

    for image_id in (1, 1, 2, 3, 3, 3):
        person(image_id)
    person(1, vis=np.full(17, 2))
    person(2, iscrowd=1)
    person(2, vis=np.zeros(17))
    face_only = np.zeros(17)
    face_only[:5] = 2
    person(3, vis=face_only)
    no_hips = np.full(17, 2)
    no_hips[11:13] = 0
    person(2, vis=no_hips)
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(path)


def test_convert_coco_matches_jax(tmp_path):
    src = _coco_file(tmp_path / "coco.json")
    n = convert_coco(src, str(tmp_path / "port.json"), "train2017")
    want_n = jconvert_coco(src, str(tmp_path / "jax.json"), "train2017")
    assert n == want_n == 3
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == want
    assert [len(r["bodys"]) for r in got["root"]] == [3, 2, 3]
    from smap_tpu.data.coco_convert import coco_person_to_mpi15 as jperson
    kpts = np.random.RandomState(4).rand(17, 3) * [300, 200, 3]
    assert np.array_equal(coco_person_to_mpi15(kpts, 300, 200),
                          jperson(kpts, 300, 200))


def _nest(flat):
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}} (numpy), in the same order."""
    tree = {}
    for name, value in flat.items():
        node = tree
        *scope, leaf = name.split(".")
        for p in scope:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


ALIGN_CASES = {
    # exact names
    "exact": ({"stage0.conv.weight": (8, 4, 3, 3), "head.bias": (8,)},
              {"stage0.conv.weight": (8, 4, 3, 3), "head.bias": (8,)}),
    # a prefixed checkpoint (backbone weights, DDP's module.)
    "prefixed": ({"stage0.conv.weight": (8, 4, 3, 3), "head.bias": (8,)},
                 {"module.backbone.stage0.conv.weight": (8, 4, 3, 3),
                  "other.bias": (3,)}),
    # a longer target name: the loaded name is its suffix
    "shorter": ({"model.stage0.conv.weight": (8, 4, 3, 3)},
                {"conv.weight": (8, 4, 3, 3)}),
    # two candidates: the longest match wins
    "longest": ({"layer1.conv.weight": (4, 4)},
                {"conv.weight": (4, 4), "x.layer1.conv.weight": (4, 4),
                 "layer1.conv.weight.extra": (4, 4)}),
    # the shape guard: a same-named entry of another shape is no match
    "shape": ({"w": (4, 4), "a.w": (2,)}, {"w": (2, 2), "b.a.w": (3,)}),
    # a name that only ends with the same letters is no match
    "partial": ({"conv.weight": (2,)}, {"xconv.weight": (2,)}),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_align_and_update_matches_jax(case):
    target_shapes, loaded_shapes = ALIGN_CASES[case]
    rng = np.random.RandomState(len(case))
    target = {k: torch.zeros(s) for k, s in target_shapes.items()}
    loaded = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for k, s in loaded_shapes.items()}
    out, missing = align_and_update(target, loaded)
    jout, jmissing = jalign(_nest(target), _nest(loaded))
    assert missing == [m.replace("/", ".") for m in jmissing]
    jflat = {".".join(k): v for k, v in _leaves(jout)}
    assert list(out) == list(target) and sorted(jflat) == sorted(out)
    for k, v in out.items():
        assert np.array_equal(v.numpy(), jflat[k]), k
    assert all(torch.equal(v, torch.zeros(target_shapes[k]))
               for k, v in target.items())


def test_align_and_update_logs_the_unmatched(caplog):
    import logging

    logger = logging.getLogger("align_test")
    with caplog.at_level(logging.WARNING, logger="align_test"):
        _, missing = align_and_update({"a": torch.zeros(2)}, {}, logger)
    assert missing == ["a"] and "kept at init: a" in caplog.text


def test_timer():
    """tests/test_utils.py's checks, and the JAX Timer's summary lines."""
    t = Timer()
    with t.section("a"):
        time.sleep(0.01)
    with t.section("a"):
        pass
    assert t.counts["a"] == 2
    assert t.totals["a"] >= 0.01
    assert "a:" in t.summary()
    j = JTimer()
    for timer in (t, j):
        timer.reset()
        timer.totals.update(a=0.5, b=1.25)
        timer.counts.update(a=2, b=5)
    assert t.summary() == j.summary()
    assert t.summary().splitlines()[0] == "b: total 1250.0 ms, n=5, avg " \
        "250.00 ms"
    t.reset()
    assert t.summary() == "" and not t.counts


def test_visualize_results_matches_jax(tmp_path):
    """A PNG frame and a missing one: the saved figures equal the JAX
    package's pixel for pixel."""
    pytest.importorskip("matplotlib")
    import cv2

    from smap_tpu.utils.visualize import visualize_results as jvisualize
    from smap_tpu_torch.utils.visualize import visualize_results

    rng = np.random.RandomState(0)
    cv2.imwrite(str(tmp_path / "f0.png"),
                rng.randint(0, 256, (60, 90, 3)).astype(np.uint8))
    pairs = []
    for name, people in (("f0.png", 2), ("missing.png", 1)):
        pose = np.zeros((people, 15, 4))
        pose[..., :3] = rng.randn(people, 15, 3) * 30 + [0, 0, 300]
        pose[..., 3] = rng.rand(people, 15) > 0.2
        pairs.append({"image_path": name, "pred_3d": pose.tolist()})
    result = tmp_path / "result.json"
    result.write_text(json.dumps({"3d_pairs": pairs}))
    visualize_results(str(result), str(tmp_path), str(tmp_path / "port"))
    jvisualize(str(result), str(tmp_path), str(tmp_path / "jax"))
    for i in range(2):
        got = imread(str(tmp_path / "port" / f"vis_{i:05d}.png"))
        want = imread(str(tmp_path / "jax" / f"vis_{i:05d}.png"))
        assert got is not None and got.shape == want.shape
        assert np.array_equal(got, want), i
    visualize_results(str(result), str(tmp_path), str(tmp_path / "one"),
                      limit=1)
    assert sorted(p.name for p in (tmp_path / "one").iterdir()) == [
        "vis_00000.png"]
