"""The port's evaluation chain (smap_tpu_torch/evaluation/{mupots,
mupots_data,convert,panoptic}.py and the eval_mupots / eval_panoptic
CLIs) against the JAX package's (smap_tpu/evaluation/, scripts/eval_*.py).

Both are numpy on the host: on the same seeded inputs the results must be
equal, to the bit where the arithmetic is the same code. The CLIs print
the same text on chip_smoke.py's MuPoTS-shaped sequence, and the
perturbed predictions print chip_smoke.MUPOTS_PINNED, the numbers the card
check holds its own run to. Last, the whole chain: the port's test_smap
-t generate_result on MuPoTS-style frames, then its eval_mupots, gives
the JAX package's evaluate_results on the same files."""

import dataclasses
import json
import os
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from torch_dist_workers import frame_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(rng, mod, n_frames=5, max_people=4, miss=0.2):
    """(FrameAnnotation list, FramePrediction list) of ``mod``'s classes:
    ground truth in test order and noisy predictions near it, some people
    missing, some predicted people spurious."""
    gts, preds = [], []
    for _ in range(n_frames):
        n = rng.randint(0, max_people + 1)
        a3 = [rng.randn(3, 15) * 200 + [[0], [0], [3000 + 500 * k]]
              for k in range(n)]
        a2 = [a[:2] / a[2:] * 1500 + [[960], [540]] for a in a3]
        occ = [(rng.rand(15) < 0.2).astype(float) for _ in range(n)]
        gts.append(mod.FrameAnnotation(annot2=a2, univ_annot3=a3,
                                       occlusion=occ))
        keep = [k for k in range(n) if rng.rand() > miss]
        rng.shuffle(keep)
        p2 = [a2[k].T + rng.randn(15, 2) * 8 for k in keep]
        p3 = [a3[k].T + rng.randn(15, 3) * 60 for k in keep]
        if rng.rand() < 0.3:                 # a spurious person
            p2.append(rng.rand(15, 2) * 1000)
            p3.append(rng.randn(15, 3) * 300 + [0, 0, 4000])
        m = len(p2)
        preds.append(mod.FramePrediction(
            pose_2d=np.asarray(p2).reshape(m, 15, 2),
            pose_3d=np.asarray(p3).reshape(m, 15, 3),
            visibility=np.ones((m, 15))))
    return gts, preds


def _same(got, want):
    """Equal dataclass fields (dicts equal, arrays bit-equal, floats equal
    or both NaN)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, dict):
            assert a == b, f.name
            continue
        np.testing.assert_array_equal(np.asarray(a, float),
                                      np.asarray(b, float), err_msg=f.name)


@pytest.mark.parametrize("is_relative,use_skel,eval_mode",
                         [(True, True, 0), (False, False, 0),
                          (True, False, 1), (False, True, 1)])
def test_evaluate_sequence_and_aggregate_match_jax(is_relative, use_skel,
                                                   eval_mode):
    import smap_tpu.evaluation.mupots as jm

    import smap_tpu_torch.evaluation.mupots as pm

    jres, pres = [], []
    for seq in range(3):
        kw = dict(is_relative=is_relative, use_skel=use_skel,
                  eval_mode=eval_mode)
        jres.append(jm.evaluate_sequence(*_frames(
            np.random.RandomState(seq), jm), **kw))
        pres.append(pm.evaluate_sequence(*_frames(
            np.random.RandomState(seq), pm), **kw))
        _same(pres[-1], jres[-1])
    assert sum(r.per_joint_error.shape[1] for r in pres) > 10
    got, want = pm.aggregate(pres), jm.aggregate(jres)
    assert got.pck == want.pck and got.auc == want.auc
    _same(got, want)
    for occluded in (False, True):
        assert (pm.compute_masked_pck_auc(pres, occluded)
                == jm.compute_masked_pck_auc(jres, occluded))


def test_compute_pck_auc_matches_jax():
    import smap_tpu.evaluation.mupots as jm

    import smap_tpu_torch.evaluation.mupots as pm

    rng = np.random.RandomState(3)
    for n in (0, 1, 37):
        errors = np.abs(rng.randn(14, n)) * 120
        assert pm.compute_pck_auc(errors) == jm.compute_pck_auc(errors)


def test_results_to_predictions_matches_jax():
    """Unletterbox, reprojection by the intrinsics of the ground-truth
    rows (or the default camera without them), cm -> mm, test order; a
    frame with no prediction; both resolutions."""
    from smap_tpu.evaluation.convert import results_to_predictions as jconv

    from smap_tpu_torch.evaluation.convert import results_to_predictions

    rng = np.random.RandomState(4)
    pairs = []
    for i, ts in enumerate((2, 7, 7, 15)):
        n = i % 3
        pred2 = rng.rand(n, 15, 4) * [832, 512, 1, 1]
        pred2[..., 3] = rng.rand(n, 15) > 0.2
        pred3 = rng.randn(n, 15, 4) * [30, 30, 50, 1] + [0, 0, 400, 0]
        gt3 = (np.tile([0, 0, 0, 1400.0, 1450.0, 900.0, 500.0], (1, 15, 1))
               if i % 2 else np.zeros((0,)))
        pairs.append({"pred_2d": pred2.tolist(), "pred_3d": pred3.tolist(),
                      "gt_3d": gt3.tolist(),
                      "image_path": f"x/TS{ts}/img_{i:06d}.jpg"})
    got, want = (results_to_predictions({"3d_pairs": pairs}),
                 jconv({"3d_pairs": pairs}))
    assert got.keys() == want.keys() and len(got) == 4
    for k in want:
        _same(got[k], want[k])


def test_panoptic_accumulator_matches_jax():
    from smap_tpu.evaluation.panoptic import PanopticAccumulator as J

    from smap_tpu_torch.evaluation.panoptic import PanopticAccumulator as P

    rng = np.random.RandomState(5)
    jacc, pacc = J(), P()
    for _ in range(6):
        n = rng.randint(1, 4)
        gt = np.zeros((n, 15, 11))
        gt[..., 3] = rng.randint(0, 3, (n, 15))
        gt[..., 4:7] = rng.randn(n, 15, 3) * 30 + [0, 0, 400]
        pred = np.concatenate([gt[..., 4:7] + rng.randn(n, 15, 3) * 10,
                               (rng.rand(n, 15, 1) > 0.3)], -1)
        jacc.update(pred, gt)
        pacc.update(pred, gt)
    assert pacc.summary() == jacc.summary()
    _same(pacc, jacc)


@pytest.fixture(scope="module")
def mupots(tmp_path_factory):
    """chip_smoke.py's MuPoTS sequence and its exact and perturbed result
    JSONs."""
    root = tmp_path_factory.mktemp("mupots")
    poses = chip_smoke.mupots_sequence(
        str(root / f"TS{chip_smoke.MUPOTS_TS}"))
    paths = {}
    for label, perturb in (("exact", False), ("perturbed", True)):
        paths[label] = str(root / f"{label}.json")
        with open(paths[label], "w") as f:
            json.dump(chip_smoke.mupots_result(poses, perturb), f)
    return str(root), paths


def _script_stdout(capsys, script, args):
    """The JAX package's ``scripts/<script>`` run as __main__ here."""
    saved = sys.argv
    sys.argv = [script, *args]
    try:
        capsys.readouterr()
        runpy.run_path(os.path.join(ROOT, "scripts", script),
                       run_name="__main__")
    finally:
        sys.argv = saved
    return capsys.readouterr().out


@pytest.mark.parametrize("label", ["exact", "perturbed"])
def test_eval_clis_print_the_jax_scripts_text(capsys, mupots, label):
    """eval_mupots (relative and --absolute) and eval_panoptic print what
    scripts/eval_mupots.py and eval_panoptic.py print; the exact
    predictions score 100 / 0 / 1, and the perturbed ones the lines
    chip_smoke.py pins."""
    from smap_tpu_torch import eval_mupots, eval_panoptic

    root, paths = mupots
    pinned = (chip_smoke.MUPOTS_PERFECT if label == "exact"
              else chip_smoke.MUPOTS_PINNED)
    runs = {"relative": (eval_mupots, "eval_mupots.py",
                         ["--result-json", paths[label], "--mupots-dir",
                          root]),
            "absolute": (eval_mupots, "eval_mupots.py",
                         ["--result-json", paths[label], "--mupots-dir",
                          root, "--absolute"]),
            "panoptic": (eval_panoptic, "eval_panoptic.py",
                         ["--result-json", paths[label]])}
    for mode, (module, script, args) in runs.items():
        capsys.readouterr()
        module.main(args)
        got = capsys.readouterr().out
        assert got == _script_stdout(capsys, script, args), mode
        lines = got.splitlines()
        assert all(line in lines for line in pinned[mode]), (mode, got)


def test_eval_clis_reject_missing_inputs(tmp_path):
    from smap_tpu_torch import eval_mupots, eval_panoptic

    with pytest.raises(SystemExit, match="result JSON not found"):
        eval_mupots.main(["--result-json", str(tmp_path / "x.json"),
                          "--mupots-dir", str(tmp_path)])
    (tmp_path / "r.json").write_text("{}")
    with pytest.raises(SystemExit, match="MuPoTS directory not found"):
        eval_mupots.main(["--result-json", str(tmp_path / "r.json"),
                          "--mupots-dir", str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="No such result file"):
        eval_panoptic.main(["--result-json", str(tmp_path / "x.json")])


def test_generate_result_then_eval_mupots_matches_jax(tmp_path, capsys,
                                                      monkeypatch):
    """The chain a user runs: the port's test_smap -t generate_result on
    MuPoTS-style frames (TS7/img_*.jpg, the forward fed the ideal maps of
    each frame's people), then the port's eval_mupots on its JSON: the
    metrics of the JAX package's evaluate_results on the same files, and a
    high PCK (the decode finds the people)."""
    from smap_tpu.evaluation.mupots_data import evaluate_results

    from smap_tpu_torch import eval_mupots, golden, test_smap
    from smap_tpu_torch.config import (Config, ModelConfig,
                                       PostProcessConfig)
    from smap_tpu_torch.evaluation.mupots import MPI_TEST_ORDER
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap

    ts, K = chip_smoke.MUPOTS_TS, chip_smoke.MUPOTS_K
    poses = chip_smoke.mupots_sequence(str(tmp_path / f"TS{ts}"))
    inv = np.argsort(np.asarray(MPI_TEST_ORDER))
    net, out = (golden.NET_H, golden.NET_W), (128, 208)
    scale = min(net[1] / 1920, net[0] / 1080)
    pad_y = (net[0] - 1080 * scale) // 2
    rng = np.random.RandomState(9)
    records, maps = [], {}
    for i, frame in enumerate(poses):
        people = [(a3.T / 10.0)[inv] for valid, _, a3 in frame if valid]
        img = rng.randint(0, 256, (1080, 1920, 3)).astype(np.uint8)
        name = f"TS{ts}/img_{i:06d}.jpg"
        cv2.imwrite(str(tmp_path / name), img)
        rows = np.zeros((len(people), 15, 11))
        for p, joints in enumerate(people):
            rows[p, :, :2] = (K @ (joints / joints[:, 2:3]).T).T[:, :2]
            rows[p, :, 2] = joints[:, 2]
            rows[p, :, 3] = 2
            rows[p, :, 4:7] = joints
            rows[p, :, 7:] = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
        records.append({"dataset": "MUPOTS", "img_paths": name,
                        "img_height": 1080, "img_width": 1920,
                        "isValidation": 1, "bodys": rows.tolist()})
        maps[i] = tuple(np.asarray(m, np.float32) for m in golden
                        .render_outputs(people, K, 1920, 1080, *out, 4,
                                        scale, 0.0, pad_y))
    annot = tmp_path / "annot.json"
    annot.write_text(json.dumps({"root": records}))
    cfg = Config(model=ModelConfig(stage_num=1, trunk_width=8,
                                   upsample_channels=16, output_shape=out,
                                   compute_dtype="float32"),
                 post=PostProcessConfig(max_peaks=31, assoc_peaks=8),
                 input_shape=net, output_shape=out)
    monkeypatch.setattr(test_smap, "Config", lambda: cfg)
    # The frames, letterboxed and normalized, in the order test_smap
    # reads them; the forward answers each with its frame's maps.
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations

    dataset = JointDataset(load_annotations(str(annot)),
                           {"MUPOTS": str(tmp_path)}, cfg, "test")
    keys = {frame_key(dataset.get_eval_sample(i)[0]): i
            for i in range(len(dataset))}
    zeros = tuple(np.zeros_like(m) for m in maps[0])

    def forward(self, images):
        per = [maps.get(keys.get(frame_key(x)), zeros)
               for x in images.numpy()]
        return tuple(torch.from_numpy(np.stack(m)) for m in zip(*per))

    monkeypatch.setattr(SMAPInference, "forward", forward)
    pth = tmp_path / "smap.pth"
    torch.save(init_smap(cfg.model, seed=0).state_dict(), pth)
    result = test_smap.main(["-t", "generate_result", "-p", str(pth),
                             "--test-json", str(annot), "--test-root",
                             str(tmp_path), "--batch_size", "2",
                             "--output-dir", str(tmp_path / "res"),
                             "--device", "cpu"])
    capsys.readouterr()
    got = eval_mupots.main(["--result-json", result, "--mupots-dir",
                            str(tmp_path)])
    want = evaluate_results(result, str(tmp_path))
    _same(got, want)
    assert got.undetected_rate == 0 and got.pck["Total"] > 50
