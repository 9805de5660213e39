"""Single-process sharded serving (``SMAPInference(devices=...)``,
smap_tpu_torch/parallel/mesh.py) and the cross-process gather of labeled
inference (``run_labeled_inference(gather=True)``,
parallel/distributed.py) of the port, on the CPU.

The sharded engine is held bit for bit to the one-device engine: each
image's forward and decode are the same computation in both, on the same
device. Its forward is replaced by the golden corpus's rendered scenes
(tests/golden/decode_corpus.json; random weights decode nobody), plus a
crowded copy of one scene for the overflow fallback and the ladder. The
two-rank gather runs in fresh processes (``spawn_ranks``: a free port, a
rendezvous and a join timeout, every rank killed when one fails) on PNG
frames with known people, as tests/test_multiprocess.py runs the JAX
package's."""

import dataclasses
import hashlib
import json

import cv2
import numpy as np
import pytest
import torch

from scenes import make_scene, render_outputs
from smap_tpu_torch import golden
from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
from smap_tpu_torch.inference import SMAPInference
from smap_tpu_torch.models.smap import init_smap
from smap_tpu_torch.ops.postprocess import PoseResults, ScaleInfo
from smap_tpu_torch.parallel.distributed import spawn_ranks
from smap_tpu_torch.parallel.mesh import local_mesh, make_mesh, shard_batch
from torch_dist_workers import fed_engine, labeled_rank

OUT_HW = (golden.NET_H // golden.STRIDE, golden.NET_W // golden.STRIDE)
CFG = Config(model=ModelConfig(stage_num=1, trunk_width=8,
                               upsample_channels=16, output_shape=OUT_HW,
                               compute_dtype="float32"),
             post=PostProcessConfig(max_peaks=127, assoc_peaks=8),
             input_shape=(golden.NET_H, golden.NET_W), output_shape=OUT_HW)
SPAWN_TIMEOUT_S = 300


def _crowded(out2d):
    """``out2d`` with a grid of isolated extra peaks on the head-top
    channel: more than ``assoc_peaks`` in one joint."""
    out = out2d.copy()
    hm = out[..., 1]
    for y in range(10, 60, 3):
        for x in range(10, 60, 3):
            if hm[y - 2:y + 3, x - 2:x + 3].max() < 0.3 * 255:
                hm[y, x] = 0.35 * 255
    return out


@pytest.fixture(scope="module")
def scenes():
    """(maps, scales) of image i: the five corpus scenes, then scene 0
    crowded; frame i is a tiny frame whose first byte is i."""
    maps, scales = [], []
    scale = min(golden.NET_W / golden.IMG_W, golden.NET_H / golden.IMG_H)
    for _, _, K, out2d, paf_z, rd in golden.scene_inputs():
        maps.append((out2d, paf_z, rd))
        scales.append({"scale": scale, "img_width": float(golden.IMG_W),
                       "img_height": float(golden.IMG_H), "f_x": K[0, 0],
                       "f_y": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]})
    maps.append((_crowded(maps[0][0]),) + maps[0][1:])
    scales.append(scales[0])
    return [tuple(np.asarray(m, np.float32) for m in t) for t in maps], scales


@pytest.fixture
def fed(monkeypatch, scenes):
    """Every engine's forward returns the scene maps of the frames it is
    given; returns frames(ids) and scales(ids)."""
    maps, scales = scenes

    def forward(self, images):
        ids = images[:, 0, 0, 0].tolist()
        return tuple(torch.from_numpy(np.stack([maps[i][k] for i in ids]))
                     .to(self.device) for k in range(3))

    monkeypatch.setattr(SMAPInference, "forward", forward)

    def frames(ids):
        return np.stack([np.full((4, 4, 3), i, np.uint8) for i in ids])

    return frames, lambda ids: [scales[i] for i in ids]


def _engines(**kw):
    sd = init_smap(CFG.model, seed=0).state_dict()
    return (SMAPInference(sd, CFG, device="cpu", **kw),
            SMAPInference(sd, CFG, devices=["cpu", "cpu"], **kw))


def _same(got: PoseResults, want: PoseResults):
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.overflow, want.overflow)
    for i, n in enumerate(want.count.tolist()):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a[i, :n], b[i, :n])


def test_sharded_engine_matches_one_device(fed):
    """Two replicas, each on its half of the batch, give the one-device
    engine's results in batch order: run_batch, run_batch_timed and
    run_stream, with a ScaleInfo already on the device too."""
    frames, scales = fed
    one, two = _engines()
    assert [r.device for r in two.replicas] == [torch.device("cpu")] * 2
    assert two.replicas[1].model is not two.model
    ids = [0, 1, 2, 3, 4, 1]
    want = one.run_batch(frames(ids), scales(ids))
    assert want.count.tolist() == [1, 2, 3, 4, 3, 2]
    _same(two.run_batch(frames(ids), scales(ids)), want)
    _same(two.run_batch(frames(ids), one.scale_info(scales(ids))), want)
    res, times = two.run_batch_timed(frames(ids), scales(ids))
    _same(res, want)
    assert set(times) == {"transfer_ms", "model_ms", "postproc_ms"}
    stream = [(frames(b), scales(b)) for b in ([0, 1], [2, 3], [4, 0])]
    got = list(two.run_stream(stream[:2] + [None] + stream[2:]))
    for g, (f, s) in zip(got, stream):
        _same(g, one.run_batch(f, s))
    with pytest.raises(ValueError, match="not divisible by the 2-device"):
        two.run_batch(frames([0, 1, 2]), scales([0, 1, 2]))


def test_sharded_overflow_fallback_and_ladder_decide_per_batch(fed):
    """A crowded image in one shard re-decodes the whole batch at
    max_peaks (the fallback) or lifts the whole batch to the rung that
    fits (the ladder), as on one device: equal results, equal
    capacities, and the same rung speculated next."""
    frames, scales = fed
    ids = [0, 1, 2, 5]
    for kw in (dict(overflow_fallback=True),
               dict(adaptive_capacities=(8, 16, 40))):
        one, two = _engines(**kw)
        for batch in ([0, 1, 2, 3], ids, [0, 1, 2, 3]):
            want = one.run_batch(frames(batch), scales(batch))
            got = two.run_batch(frames(batch), scales(batch))
            _same(got, want)
            assert got.bodies_2d.shape == want.bodies_2d.shape
            assert two._spec_cap == one._spec_cap
        crowd = one.run_batch(frames(ids), scales(ids))
        assert crowd.bodies_2d.shape[1] > CFG.post.assoc_peaks


@pytest.mark.parametrize("quantized", ["folded", "static"])
def test_replicas_hold_the_transformed_weights(quantized):
    """The serving transform (and calibration) is done once: every
    replica holds the same folded or calibrated int8 weights, and the
    sharded forward and decode equal one device's on a real (small)
    model."""
    small = dataclasses.replace(CFG, input_shape=(64, 96),
                                output_shape=(16, 24),
                                model=dataclasses.replace(
                                    CFG.model, output_shape=(16, 24)))
    sd = init_smap(small.model, seed=1).state_dict()
    frames = np.random.RandomState(2).randint(0, 256, (4, 64, 96, 3),
                                              np.uint8)
    kw = dict(quantized=quantized,
              calibration_batches=frames if quantized == "static" else None)
    one = SMAPInference(sd, small, device="cpu", **kw)
    two = SMAPInference(sd, small, devices=["cpu", "cpu"], **kw)
    assert two.replicas[1].cfg.model.quantized == quantized
    want_sd = one.model.state_dict()
    for r in two.replicas:
        got_sd = r.model.state_dict()
        assert got_sd.keys() == want_sd.keys()
        assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    scale = {"scale": 0.5, "img_width": 192.0, "img_height": 128.0,
             "f_x": 100.0, "f_y": 100.0, "cx": 96.0, "cy": 64.0}
    want = one.run_batch(frames, [scale] * 4)
    got = two.run_batch(frames, [scale] * 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shard_batch_and_meshes():
    devs = make_mesh(["cpu", "cpu"])
    assert devs == (torch.device("cpu"),) * 2
    assert local_mesh("cpu") == (torch.device("cpu"),)
    x = np.arange(12).reshape(4, 3)
    parts = shard_batch(x, devs)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    assert all(isinstance(p, torch.Tensor) for p in parts)
    info = ScaleInfo(*(torch.arange(4.0) + k for k in range(7)))
    halves = shard_batch(info, devs)
    assert all(isinstance(h, ScaleInfo) for h in halves)
    assert halves[1].fx.tolist() == [5.0, 6.0]
    assert shard_batch([{"a": 1}, {"a": 2}], devs) == [[{"a": 1}],
                                                       [{"a": 2}]]
    with pytest.raises(ValueError, match="batch 3 not divisible by the "
                                         "2-device mesh"):
        shard_batch(np.zeros((3, 2)), devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="every card"):
            make_mesh()


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    """Five PNG frames with 1-2 known people each, their annotation JSON
    and the ideal maps of each frame (tests/test_torch_labeled_inference.py
    at a narrower net)."""
    root = tmp_path_factory.mktemp("gather")
    rng = np.random.RandomState(0)
    img_h, img_w, focal = 270, 480, 300.0
    net, out = (128, 208), (32, 52)
    scale = min(net[1] / img_w, net[0] / img_h)
    pad_y = (net[0] - round(img_h * scale)) // 2
    records, maps = [], []
    for i in range(5):
        cv2.imwrite(str(root / f"f{i}.png"),
                    rng.randint(0, 256, (img_h, img_w, 3)).astype(np.uint8))
        K, people = make_scene(rng, num_people=1 + i % 2, img_w=img_w,
                               img_h=img_h, f=focal)
        rows = []
        for joints in people:
            row = np.zeros((15, 11))
            row[:, :2] = (K @ (joints / joints[:, 2:3]).T).T[:, :2]
            row[:, 2] = joints[:, 2]
            row[:, 3] = 2
            row[:, 4:7] = joints
            row[:, 7:] = [focal, focal, img_w / 2, img_h / 2]
            rows.append(row)
        records.append({"dataset": "MUPOTS", "img_paths": f"f{i}.png",
                        "img_height": img_h, "img_width": img_w,
                        "isValidation": 1,
                        "bodys": np.stack(rows).tolist()})
        maps.append(tuple(np.asarray(m, np.float32) for m in render_outputs(
            people, K, img_w, img_h, *out, 4, scale, 0.0, pad_y, sigma=1.0)))
    (root / "annot.json").write_text(json.dumps({"root": records}))
    cfg = Config(model=ModelConfig(stage_num=1, trunk_width=8,
                                   upsample_channels=16, output_shape=out,
                                   compute_dtype="float32"),
                 post=PostProcessConfig(max_peaks=31, assoc_peaks=8),
                 input_shape=net, output_shape=out)
    return root, cfg, maps


def test_two_process_labeled_inference_gather(labeled):
    """Two ranks (joined from torchrun's environment variables), each on
    its contiguous shard (3 and 2 frames), gather: both hold the same
    merged JSON (the same digest), equal to one process's run over the
    whole set, with every person registered; and all_gather_objects keeps
    rank order for payloads of unequal size."""
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import run_labeled_inference

    root, cfg, maps = labeled
    sd = init_smap(cfg.model, seed=0).state_dict()
    annot = str(root / "annot.json")
    got = spawn_ranks(labeled_rank, 2, annot, str(root), cfg, sd, maps, 2,
                      timeout_s=SPAWN_TIMEOUT_S)
    dataset = JointDataset(load_annotations(annot), {"MUPOTS": str(root)},
                           cfg, "test")
    want = run_labeled_inference(dataset, fed_engine(dataset, cfg, sd, maps),
                                 batch_size=2, gather=True)

    def digest(result):
        return hashlib.sha256(json.dumps(result, sort_keys=True)
                              .encode()).hexdigest()

    assert [g["count"] for g in got] == [2, 2]
    assert [g["main"] for g in got] == [True, False]
    assert digest(got[0]["result"]) == digest(got[1]["result"])
    assert got[0]["result"] == json.loads(json.dumps(want))
    pairs = want["3d_pairs"]
    assert [p["image_path"] for p in pairs] == [f"f{i}.png" for i in range(5)]
    assert [len(p["pred_3d"]) for p in pairs] == [1, 2, 1, 2, 1]
    assert all(np.asarray(p["pred_3d"])[:, 2, 3].min() > 0 for p in pairs)
    for g in got:
        assert [x["rank"] for x in g["gathered"]] == [0, 1]
        assert [len(x["payload"]) for x in g["gathered"]] == [10, 17]
