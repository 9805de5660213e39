"""The port's entry points on the CPU (``--device cpu``) at a small
``Config`` patched into each CLI module by the test: the serve loop's frame
sources, the serve CLI and ``test_smap`` against the in-process engine,
``train_smap`` against ``Trainer.fit`` (with a checkpoint and a resume),
and the RefineNet CLIs run as ``python -m`` processes."""

import json
import os
import re
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from smap_tpu_torch.config import (Config, ModelConfig, PostProcessConfig,
                                   TrainConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_HW, OUT_HW = (64, 96), (16, 24)
SMALL = Config(model=ModelConfig(stage_num=1, trunk_width=8,
                                 upsample_channels=16, output_shape=OUT_HW,
                                 compute_dtype="float32"),
               post=PostProcessConfig(max_peaks=31, assoc_peaks=8),
               train=TrainConfig(max_people=4),
               input_shape=NET_HW, output_shape=OUT_HW)
LADDER = "4,8"


def _touch(path):
    cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))


def _backdate(path, seconds=60.0):
    past = time.time() - seconds
    os.utime(path, (past, past))


def test_iter_frames_oneshot(tmp_path):
    from smap_tpu_torch.serve import iter_frames

    for name in ("b.png", "a.jpg", "sub/c.jpeg"):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        _touch(tmp_path / name)
    got = list(iter_frames(str(tmp_path), watch=False))
    assert [os.path.relpath(p, tmp_path) for p in got] == [
        "a.jpg", "b.png", "sub/c.jpeg"]


def test_iter_frames_watch_yields_new_and_idle(tmp_path):
    from smap_tpu_torch.serve import iter_frames

    _touch(tmp_path / "a.png")
    _backdate(tmp_path / "a.png")
    gen = iter_frames(str(tmp_path), watch=True, poll_s=0.01)
    assert os.path.basename(next(gen)) == "a.png"
    assert next(gen) is None           # an idle poll
    _touch(tmp_path / "b.png")
    _backdate(tmp_path / "b.png")
    vals = [next(gen) for _ in range(3)]
    assert [os.path.basename(v) for v in vals if v is not None] == ["b.png"]


def test_iter_frames_watch_settles_and_evicts(tmp_path, monkeypatch):
    import smap_tpu_torch.serve as serve

    monkeypatch.setattr(serve.time, "sleep", lambda s: None)
    gen = serve.iter_frames(str(tmp_path), watch=True, poll_s=5.0)
    _touch(tmp_path / "a.png")
    assert next(gen) is None           # still being written
    _backdate(tmp_path / "a.png")
    assert os.path.basename(next(gen)) == "a.png"
    os.unlink(tmp_path / "a.png")
    assert next(gen) is None           # evicted from the dedup set
    _touch(tmp_path / "a.png")
    _backdate(tmp_path / "a.png")
    assert os.path.basename(next(gen)) == "a.png"


def test_iter_video_frames(tmp_path, monkeypatch):
    """Every stride-th frame, named by its index; a source that does not
    open exits; without OpenCV, an ImportError naming the file."""
    import builtins

    from smap_tpu_torch.serve import iter_video_frames

    vid = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (64, 48))
    assert writer.isOpened()
    rng = np.random.RandomState(3)
    for _ in range(5):
        writer.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    got = list(iter_video_frames(str(vid), stride=2))
    assert [n.split("#")[1] for n, _ in got] == [
        "frame000000", "frame000002", "frame000004"]
    assert all(f.shape == (48, 64, 3) for _, f in got)
    with pytest.raises(SystemExit):
        list(iter_video_frames(str(tmp_path / "missing.avi")))
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="clip.avi.*OpenCV"):
        list(iter_video_frames(str(vid)))


def _two_people():
    """The ideal NHWC maps of two people in a SMALL frame (numpy)."""
    from scenes import make_scene, render_outputs

    K, people = make_scene(np.random.RandomState(0), num_people=2,
                           img_w=NET_HW[1], img_h=NET_HW[0], f=100.0)
    return [m.astype(np.float32) for m in render_outputs(
        people, K, NET_HW[1], NET_HW[0], *OUT_HW, 4, 1.0, 0.0, 0.0,
        sigma=0.8)]


@pytest.fixture
def people_in_every_frame(monkeypatch):
    """The engine's forward plus the ideal maps of two people: random
    weights alone decode nobody."""
    from smap_tpu_torch.inference import SMAPInference

    scene = [torch.from_numpy(m) for m in _two_people()]
    real = SMAPInference.forward

    def forward(self, images):
        return tuple(m + s for m, s in zip(real(self, images), scene))

    monkeypatch.setattr(SMAPInference, "forward", forward)


@pytest.fixture
def small_cli(monkeypatch):
    """Every CLI module builds SMALL; returns SMALL's weights, with the
    BatchNorm scales damped so that the maps stay far below the NMS
    threshold."""
    import smap_tpu_torch.serve as serve
    import smap_tpu_torch.test_smap as test_smap
    import smap_tpu_torch.train_smap as train_smap
    from smap_tpu_torch.models.smap import init_smap

    for mod in (serve, test_smap, train_smap):
        monkeypatch.setattr(mod, "Config", lambda: SMALL)
    return {k: v * 0.3 if k.endswith("bn.weight") else v
            for k, v in init_smap(SMALL.model, seed=0).state_dict().items()}


def _frames_dir(path, n=5, seed=0, ext="png"):
    path.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(40, 90), rng.randint(50, 130)
        cv2.imwrite(str(path / f"f{i}.{ext}"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return str(path)


@pytest.mark.parametrize("mode,ext", [
    ([], "png"), (["--folded", "--fuse-stem", "--fuse-bottleneck"], "png"),
    (["--int8"], "png"), (["--int8-static"], "png"), ([], "jpg")])
def test_serve_cli_matches_run_batch(tmp_path, small_cli,
                                     people_in_every_frame, mode, ext):
    """One JSON line per frame (the tail batch padded), each the item
    run_batch gives for the same I420 frame, in every serving mode, on PNG
    and on JPEG frames."""
    from smap_tpu_torch import serve
    from smap_tpu_torch.data.image import imread
    from smap_tpu_torch.inference import SMAPInference, image_paths

    src = _frames_dir(tmp_path / "frames", ext=ext)
    pth = tmp_path / "smap.pth"
    torch.save({"model": {f"module.{k}": v for k, v in small_cli.items()}},
               pth)
    out = tmp_path / "poses.jsonl"
    summary = serve.main(["--source", src, "-p", str(pth), "--out", str(out),
                          "--batch_size", "2", "--adaptive-capacities",
                          LADDER, "--device", "cpu", *mode])
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert summary["frames"] == len(lines) == 5

    paths = image_paths(src)
    wire = [serve.wire_frame(imread(p), SMALL) for p in paths]
    quantized = {"--folded": "folded", "--int8": True,
                 "--int8-static": "static"}.get(mode[0] if mode else "",
                                                False)
    calib = ([np.stack([w[0] for w in wire[:2]])]
             if quantized == "static" else None)
    engine = SMAPInference(small_cli, SMALL, device="cpu",
                           quantized=quantized, calibration_batches=calib,
                           fuse_stem="--fuse-stem" in mode,
                           fuse_bottleneck="--fuse-bottleneck" in mode)
    want = []
    for start in range(0, 5, 2):
        chunk = wire[start:start + 2]
        res = engine.run_batch(np.stack([c[0] for c in chunk]),
                               [c[1] for c in chunk])
        want += engine.results_to_pairs(res, paths[start:start + 2])
    assert lines == json.loads(json.dumps(want))
    assert all(len(l["pred_3d"]) == 2 for l in lines)


def test_serve_cli_rejects_bad_flags(tmp_path, small_cli):
    from smap_tpu_torch import serve

    for flags in (["--int8", "--folded"], ["--fuse-stem"]):
        with pytest.raises(SystemExit):
            serve.main(["--source", str(tmp_path), "--device", "cpu",
                        *flags])
    with pytest.raises(SystemExit, match="No such checkpoint"):
        serve.main(["--source", str(tmp_path), "-p", "missing.pth",
                    "--device", "cpu"])


def test_test_smap_run_inference(tmp_path, small_cli, people_in_every_frame):
    """-t run_inference writes run_inference's JSON under the reference's
    file name."""
    from smap_tpu_torch import test_smap
    from smap_tpu_torch.inference import run_inference

    src = _frames_dir(tmp_path / "frames", seed=1)
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    out = test_smap.main(["-p", str(pth), "--dataset_path", src,
                          "--batch_size", "2", "--output-dir",
                          str(tmp_path / "res"), "--json_name", "x",
                          "--device", "cpu"])
    assert os.path.basename(out) == "stage3_root2_run_inference_test_x.json"
    want = run_inference(src, small_cli, SMALL, batch_size=2, device="cpu")
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(want))
    assert sum(len(p["pred_3d"]) for p in want["3d_pairs"]) == 10


def _labeled_set(tmp_path, n=3, ext="png"):
    """``n`` PNG (or JPEG) frames and their annotation JSON, two people a
    frame."""
    src = _frames_dir(tmp_path / "frames", n=n, seed=2, ext=ext)
    records = []
    rng = np.random.RandomState(4)
    for i in range(n):
        img = cv2.imread(os.path.join(src, f"f{i}.{ext}"))
        h, w = img.shape[:2]
        bodys = np.zeros((2, 15, 11))
        bodys[..., 0] = rng.uniform(0, w, (2, 15))
        bodys[..., 1] = rng.uniform(0, h, (2, 15))
        bodys[..., 2:4] = [300.0, 2.0]
        bodys[..., 7:] = [100.0, 100.0, w / 2, h / 2]
        records.append({"dataset": "MUPOTS", "img_paths": f"f{i}.{ext}",
                        "img_height": h, "img_width": w, "isValidation": 1,
                        "bodys": bodys.tolist()})
    annot = tmp_path / "annot.json"
    annot.write_text(json.dumps({"root": records}))
    return src, annot


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("mode", ["generate_result", "generate_train"])
def test_test_smap_generate_modes(tmp_path, small_cli, people_in_every_frame,
                                  mode, ext):
    """The generate modes read --test-json / --test-root (PNG or JPEG
    frames) and write run_labeled_inference's JSON."""
    from smap_tpu_torch import test_smap
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import SMAPInference, run_labeled_inference

    src, annot = _labeled_set(tmp_path, ext=ext)
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    out = test_smap.main(["-t", mode, "-d", "generation", "-p", str(pth),
                          "--test-json", str(annot), "--test-root", src,
                          "--batch_size", "2", "--output-dir",
                          str(tmp_path / "res"), "--device", "cpu"])
    assert os.path.basename(out) == f"stage3_root2_{mode}_generation.json"
    stage = "generation" if mode == "generate_train" else "test"
    dataset = JointDataset(load_annotations(str(annot)), {"MUPOTS": src},
                           SMALL, stage)
    engine = SMAPInference(small_cli, SMALL, device="cpu")
    want = run_labeled_inference(dataset, engine, mode=mode, batch_size=2)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(want))


def _train_set(tmp_path):
    """Six PNG frames, MuCo and COCO, as unified annotation JSONs."""
    rng = np.random.RandomState(5)
    paths = {}
    for name in ("MUCO", "COCO"):
        root = tmp_path / name.lower()
        root.mkdir()
        records = []
        for i in range(3):
            h, w = rng.randint(60, 120), rng.randint(80, 160)
            cv2.imwrite(str(root / f"f{i}.png"),
                        rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            bodys = np.zeros((2, 15, 11))
            bodys[..., 0] = rng.uniform(0, w, (2, 15))
            bodys[..., 1] = rng.uniform(0, h, (2, 15))
            bodys[..., 2] = rng.uniform(200, 400, (2, 15))
            bodys[..., 3] = 2
            bodys[..., 4:7] = rng.randn(2, 15, 3) * 30
            bodys[..., 7:] = [500.0, 500.0, w / 2, h / 2]
            records.append({"dataset": name, "img_paths": f"f{i}.png",
                            "img_height": h, "img_width": w,
                            "isValidation": 0, "bodys": bodys.tolist()})
        annot = tmp_path / f"{name.lower()}.json"
        annot.write_text(json.dumps({"root": records}))
        paths[name] = (str(annot), str(root))
    return paths


def _losses(out_dir):
    with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(l).items() if k != "time"}
                for l in f]


def test_train_smap_fits_checkpoints_and_resumes(tmp_path, small_cli):
    """Two steps (with --deterministic, which is undone after), a
    checkpoint, then --resume to step 3 (with a worker process): the
    losses of Trainer.fit on the same iterator, step for step; test_smap
    --ckpt-dir then serves the last checkpoint."""
    from smap_tpu_torch import test_smap, train_smap
    from smap_tpu_torch.data.datasets import (JointDataset, load_annotations,
                                              train_iterator)
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig

    data = _train_set(tmp_path)
    flags = ["--muco-json", data["MUCO"][0], "--muco-root", data["MUCO"][1],
             "--coco-json", data["COCO"][0], "--coco-root", data["COCO"][1],
             "--batch-per-device", "2", "--log-every", "1", "--seed", "1",
             "--output-dir", str(tmp_path / "run"), "--device", "cpu"]
    train_smap.main([*flags, "--max-steps", "2", "--deterministic"])
    assert not torch.are_deterministic_algorithms_enabled()
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["2.pt"]
    state = train_smap.main([*flags, "--max-steps", "3", "--resume",
                             "--num-workers", "1"])
    assert state.step == 3

    records = (load_annotations(data["COCO"][0])
               + load_annotations(data["MUCO"][0]))
    dataset = JointDataset(records, {k: v[1] for k, v in data.items()},
                           SMALL, "train", with_augmentation=True)
    trainer = Trainer(SMALL, TrainerConfig(output_dir=str(tmp_path / "ref"),
                                           log_every=1, seed=1),
                      device="cpu")
    trainer.fit(train_iterator(dataset, 2, 3, seed=1),
                state=trainer.init_state(1), max_steps=3)
    trainer.close()
    got, want = _losses(tmp_path / "run"), _losses(tmp_path / "ref")
    assert [r["step"] for r in got] == [1, 2, 3]
    assert got == want

    frames = _frames_dir(tmp_path / "frames", n=2, seed=6)
    out = test_smap.main(["--ckpt-dir", str(tmp_path / "run"),
                          "--dataset_path", frames, "--batch_size", "2",
                          "--output-dir", str(tmp_path / "res"),
                          "--device", "cpu"])
    with open(out) as f:
        assert len(json.load(f)["3d_pairs"]) == 2
    with pytest.raises(SystemExit, match="no checkpoints"):
        test_smap.main(["--ckpt-dir", str(tmp_path / "none"),
                        "--dataset_path", frames, "--device", "cpu"])


def _run_module(module, *args):
    """``python -m module args`` on one CPU thread (the float sums of a
    matrix product depend on the thread count)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_data_parallel_flag_shards_over_the_local_mesh(
        tmp_path, small_cli, people_in_every_frame, monkeypatch):
    """--data-parallel serves every batch over parallel.mesh.local_mesh
    (patched to two CPU replicas here): serve's lines and test_smap's JSON
    equal the one-device runs."""
    from smap_tpu_torch import serve, test_smap
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.parallel import mesh

    asked, replicas = [], []
    monkeypatch.setattr(mesh, "local_mesh", lambda device: (
        asked.append(device) or mesh.make_mesh([device, device])))
    real_init = SMAPInference.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        replicas.append(len(self.replicas))

    monkeypatch.setattr(SMAPInference, "__init__", init)
    src = _frames_dir(tmp_path / "frames")
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    outs = {}
    for flags in ([], ["--data-parallel"]):
        name = "dp" if flags else "one"
        serve.main(["--source", src, "-p", str(pth), "--out",
                    str(tmp_path / f"{name}.jsonl"), "--batch_size", "2",
                    "--adaptive-capacities", LADDER, "--device", "cpu",
                    *flags])
        outs[name] = test_smap.main(
            ["-p", str(pth), "--dataset_path", src, "--batch_size", "2",
             "--output-dir", str(tmp_path / name), "--device", "cpu",
             *flags])
    assert asked == ["cpu", "cpu"]
    assert replicas.count(2) == 2
    assert ((tmp_path / "dp.jsonl").read_text()
            == (tmp_path / "one.jsonl").read_text())
    with open(outs["dp"]) as f, open(outs["one"]) as g:
        assert json.load(f) == json.load(g)
    with pytest.raises(SystemExit):
        serve.main(["--source", src, "-p", str(pth), "--batch_size", "3",
                    "--device", "cpu", "--data-parallel"])


def test_new_flags_still_default_to_the_card(tmp_path, small_cli):
    """Without --device, --data-parallel asks for every card and
    --distributed for a rank's own: on a host with none they raise; they
    do not run on the CPU."""
    from smap_tpu_torch import serve, test_smap

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    src = _frames_dir(tmp_path / "frames", n=1)
    res = ["--output-dir", str(tmp_path / "res")]
    for main, argv in ((serve.main, ["--source", src]),
                       (test_smap.main, ["--dataset_path", src, *res])):
        with pytest.raises(RuntimeError, match="cuda|card"):
            main([*argv, "-p", str(pth), "--data-parallel"])
    with pytest.raises(RuntimeError, match="cuda|card"):
        test_smap.main(["--dataset_path", src, "-p", str(pth), *res,
                        "--distributed", "--coordinator", "localhost:1",
                        "--num-processes", "2", "--process-id", "0",
                        "--backend", "nccl"])


def test_test_smap_distributed_two_ranks(tmp_path, small_cli,
                                         people_in_every_frame):
    """test_smap -t generate_result --distributed in two gloo ranks:
    each rank its contiguous shard, the results gathered, and rank 0 alone
    writes run_labeled_inference's JSON over the whole set; with
    --profile-dir, each rank writes its own trace."""
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import SMAPInference, run_labeled_inference
    from smap_tpu_torch.parallel.distributed import spawn_ranks
    from torch_dist_workers import cli_rank

    src, annot = _labeled_set(tmp_path, n=5)
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    argvs = [["-t", "generate_result", "-p", str(pth), "--test-json",
              str(annot), "--test-root", src, "--batch_size", "2",
              "--output-dir", str(tmp_path / f"res{r}"), "--distributed",
              "--profile-dir", str(tmp_path / "prof")]
             for r in range(2)]
    outs = spawn_ranks(cli_rank, 2, "test_smap", argvs, SMALL,
                       _two_people(), timeout_s=300)
    assert os.path.exists(outs[0]) and not os.path.exists(outs[1])
    traces = _trace_files(tmp_path / "prof")
    assert len(traces) == 2
    assert sorted(re.search(r"_(rank\d)\.\d+\.pt\.trace\.json$",
                            t).group(1) for t in traces) == ["rank0", "rank1"]
    dataset = JointDataset(load_annotations(str(annot)), {"MUPOTS": src},
                           SMALL, "test")
    want = run_labeled_inference(
        dataset, SMAPInference(small_cli, SMALL, device="cpu"),
        batch_size=2)
    with open(outs[0]) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(want))
    assert len(got["3d_pairs"]) == 5


def test_train_smap_distributed_two_ranks(tmp_path, small_cli):
    """train_smap --distributed in two gloo ranks, one sample a rank: both
    end on the same parameters; rank 0 alone writes the checkpoint,
    metrics.jsonl and log.txt (each rank is given its own --output-dir to
    show it)."""
    from smap_tpu_torch.parallel.distributed import spawn_ranks
    from torch_dist_workers import cli_rank

    data = _train_set(tmp_path)
    argvs = [["--muco-json", data["MUCO"][0], "--muco-root",
              data["MUCO"][1], "--batch-per-device", "1", "--log-every",
              "1", "--max-steps", "2", "--output-dir",
              str(tmp_path / f"run{r}"), "--distributed"] for r in range(2)]
    outs = spawn_ranks(cli_rank, 2, "train_smap", argvs, SMALL,
                       timeout_s=300)
    assert [o["step"] for o in outs] == [2, 2]
    assert outs[0]["params"] == outs[1]["params"]
    assert os.listdir(tmp_path / "run0" / "checkpoints") == ["2.pt"]
    assert [r["step"] for r in _losses(tmp_path / "run0")] == [1, 2]
    assert (tmp_path / "run0" / "log.txt").exists()
    assert os.listdir(tmp_path / "run1" / "checkpoints") == []
    assert not (tmp_path / "run1" / "tb_dir").exists()
    assert not (tmp_path / "run1" / "log.txt").exists()


def test_train_smap_under_torchrun(tmp_path, small_cli):
    """train_smap --distributed --backend gloo under torchrun (``python -m
    torch.distributed.run --standalone --nproc-per-node 2``, the entry
    script tests/torch_dist_workers.py applying the small Config): both
    ranks end on the parameters of the two spawned ranks of
    test_train_smap_distributed_two_ranks, on the same data and flags."""
    import pickle

    from smap_tpu_torch.parallel.distributed import spawn_ranks
    from torch_dist_workers import cli_rank

    data = _train_set(tmp_path)
    args = ["--muco-json", data["MUCO"][0], "--muco-root", data["MUCO"][1],
            "--batch-per-device", "1", "--log-every", "1", "--max-steps",
            "2"]
    config = tmp_path / "config.pkl"
    config.write_bytes(pickle.dumps(SMALL))
    out = tmp_path / "result"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(ROOT, "tests", "torch_dist_workers.py"), "train_smap",
         str(config), str(out), *args, "--output-dir",
         str(tmp_path / "torchrun")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    got = [json.loads((tmp_path / f"result.rank{r}.json").read_text())
           for r in range(2)]
    argvs = [[*args, "--output-dir", str(tmp_path / f"spawned{r}"),
              "--distributed"] for r in range(2)]
    want = spawn_ranks(cli_rank, 2, "train_smap", argvs, SMALL,
                       timeout_s=300)
    assert [g["step"] for g in got] == [w["step"] for w in want] == [2, 2]
    assert got[0]["params"] == got[1]["params"] == want[0]["params"]
    assert os.listdir(tmp_path / "torchrun" / "checkpoints") == ["2.pt"]


@pytest.mark.parametrize("module", ["eval_mupots", "eval_panoptic"])
def test_eval_entry_points_run_as_modules(module):
    out = _run_module(f"smap_tpu_torch.{module}", "--help")
    assert out.returncode == 0, out.stderr
    assert f"python -m smap_tpu_torch.{module}" in out.stdout
    assert "--result-json" in out.stdout


@pytest.mark.parametrize("module", ["serve", "test_smap", "train_smap"])
def test_entry_points_run_as_modules(module):
    out = _run_module(f"smap_tpu_torch.{module}", "--help")
    assert out.returncode == 0, out.stderr
    assert f"python -m smap_tpu_torch.{module}" in out.stdout
    assert "--device" in out.stdout


def test_refinenet_clis(tmp_path):
    """train_refinenet saves one snapshot an epoch; test_refinenet
    evaluates each and picks the best: as train_refinenet and
    evaluate_refinenet in this process compute them."""
    from smap_tpu_torch.config import RefineNetConfig
    from smap_tpu_torch.data.datasets import P2PDataset
    from smap_tpu_torch.models.convert import load_torch_checkpoint
    from smap_tpu_torch.models.refinenet import RefineNet
    from smap_tpu_torch.train.refine import (evaluate_refinenet,
                                             train_refinenet)

    rng = np.random.RandomState(0)
    pairs = []
    for _ in range(96):
        gt = rng.randn(15, 3) * 20
        pred3 = np.concatenate([gt + rng.randn(15, 3), np.ones((15, 1))], -1)
        pred2 = np.concatenate([rng.rand(15, 2) * 400, np.zeros((15, 1)),
                                np.ones((15, 1))], -1)
        pairs.append({"pred_3d": pred3.tolist(), "pred_2d": pred2.tolist(),
                      "gt_3d": gt.tolist(), "root_d": 300.0})
    pj = tmp_path / "pairs.json"
    pj.write_text(json.dumps({"3d_pairs": pairs}))
    snaps = tmp_path / "snaps"
    out = _run_module("smap_tpu_torch.train_refinenet", "--pairs-json",
                      str(pj), "--epochs", "2", "--output-dir", str(snaps),
                      "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(snaps)) == ["epoch_0.pth", "epoch_1.pth"]
    out = _run_module("smap_tpu_torch.test_refinenet", "--pairs-json",
                      str(pj), "--snapshot-dir", str(snaps), "--device",
                      "cpu")
    assert out.returncode == 0, out.stderr

    dataset = P2PDataset(str(pj))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = train_refinenet(dataset, RefineNetConfig(), num_epochs=2,
                               device="cpu", log_fn=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    lines = out.stdout.strip().splitlines()
    errors = {}
    for epoch, model in want.items():
        saved = load_torch_checkpoint(str(snaps / f"epoch_{epoch}.pth"))
        for k, v in model.state_dict().items():
            torch.testing.assert_close(saved[k], v, rtol=1e-6, atol=1e-7)
        loaded = RefineNet(RefineNetConfig())
        loaded.load_state_dict(saved)
        errors[epoch] = evaluate_refinenet(loaded, dataset)[1]
        assert lines[epoch].startswith(
            f"epoch {epoch}: mean {errors[epoch]:.4f} cm")
    best = min(errors, key=errors.get)
    assert lines[-1] == f"best epoch: {best} ({errors[best]:.4f} cm)"


def _trace_files(log_dir):
    return [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]


def test_train_smap_profile_dir(tmp_path, small_cli):
    """--profile-dir: one trace of steps 11-12 (the run ends inside the
    window), and the same losses, checkpoint and weights as the run
    without it."""
    from smap_tpu_torch import train_smap

    data = _train_set(tmp_path)
    flags = ["--muco-json", data["MUCO"][0], "--muco-root", data["MUCO"][1],
             "--batch-per-device", "2", "--log-every", "2", "--seed", "1",
             "--max-steps", "12", "--device", "cpu"]
    prof = tmp_path / "prof"
    traced = train_smap.main([*flags, "--output-dir", str(tmp_path / "a"),
                              "--profile-dir", str(prof)])
    plain = train_smap.main([*flags, "--output-dir", str(tmp_path / "b")])
    assert traced.step == plain.step == 12
    got, want = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert [r["step"] for r in got] == list(range(2, 13, 2))
    assert got == want
    for a, b in zip(traced.model.state_dict().values(),
                    plain.model.state_dict().values()):
        assert torch.equal(a, b)
    assert os.listdir(tmp_path / "a" / "checkpoints") == ["12.pt"]
    assert len(_trace_files(prof)) == 1


def test_test_smap_profile_dir(tmp_path, small_cli, people_in_every_frame):
    """--profile-dir writes one Chrome trace and the same result JSON as
    the run without it."""
    from smap_tpu_torch import test_smap

    src = _frames_dir(tmp_path / "frames", seed=1)
    pth = tmp_path / "smap.pth"
    torch.save(small_cli, pth)
    flags = ["-p", str(pth), "--dataset_path", src, "--batch_size", "2",
             "--device", "cpu"]
    plain = test_smap.main([*flags, "--output-dir", str(tmp_path / "a")])
    prof = tmp_path / "prof"
    traced = test_smap.main([*flags, "--output-dir", str(tmp_path / "b"),
                             "--profile-dir", str(prof)])
    with open(plain) as f, open(traced) as g:
        assert json.load(f) == json.load(g)
    files = _trace_files(prof)
    assert len(files) == 1
    with open(prof / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names


def test_convert_checkpoint_and_visualize_as_modules(tmp_path, monkeypatch,
                                                     small_cli):
    """convert_checkpoint exports a training checkpoint as a process (the
    weights bit for bit) and refuses a directory without one;
    visualize draws a result JSON."""
    from smap_tpu_torch import convert_checkpoint

    monkeypatch.setattr(convert_checkpoint, "Config", lambda: SMALL)
    pth = tmp_path / "smap.pth"
    torch.save({"model": small_cli}, pth)
    run = tmp_path / "run"
    convert_checkpoint.main(["--smap-path", str(pth), "--output-dir",
                             str(run)])
    out = tmp_path / "back.pth"
    proc = _run_module("smap_tpu_torch.convert_checkpoint", "--ckpt-dir",
                       str(run), "--to-torch", str(out))
    assert proc.returncode == 0, proc.stderr
    back = torch.load(out, weights_only=True)["model"]
    assert back.keys() == small_cli.keys()
    assert all(torch.equal(back[k], v) for k, v in small_cli.items())
    proc = _run_module("smap_tpu_torch.convert_checkpoint", "--ckpt-dir",
                       str(tmp_path / "none"), "--to-torch", str(out))
    assert proc.returncode != 0 and "no checkpoint found" in proc.stderr

    pytest.importorskip("matplotlib")
    src = _frames_dir(tmp_path / "frames", n=1, seed=3)
    pose = np.ones((1, 15, 4))
    pose[..., :3] = np.random.RandomState(0).randn(1, 15, 3) * 20
    result = tmp_path / "r.json"
    result.write_text(json.dumps({"3d_pairs": [
        {"image_path": "f0.png", "pred_3d": pose.tolist()}]}))
    proc = _run_module("smap_tpu_torch.visualize", "--result-json",
                       str(result), "--image-root", src, "--out-dir",
                       str(tmp_path / "vis"))
    assert proc.returncode == 0, proc.stderr
    assert os.listdir(tmp_path / "vis") == ["vis_00000.png"]


@pytest.mark.parametrize("module,flag", [("convert_checkpoint", "--to-torch"),
                                         ("visualize", "--result-json")])
def test_tool_entry_points_run_as_modules(module, flag):
    out = _run_module(f"smap_tpu_torch.{module}", "--help")
    assert out.returncode == 0, out.stderr
    assert f"python -m smap_tpu_torch.{module}" in out.stdout
    assert flag in out.stdout
