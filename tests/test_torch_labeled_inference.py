"""``run_labeled_inference`` (the ``generate_result`` / ``generate_train``
modes) of the port against the JAX package's (which reads with cv2), on
labeled sets of PNG and of JPEG frames whose people are known in 3D.

Random weights rarely decode a person near a ground-truth root, so both
engines are fed the ideal maps of each frame's people (``tests/scenes.py``)
in place of the forward; the registration, the intrinsics branches, the
tail padding and the shards then run on real matches. The decodes agree
as ``tests/test_torch_inference.py`` holds them (PAIR_RTOL / PAIR_ATOL);
the JSON's structure, counts and order are equal."""

import json

import cv2
import numpy as np
import pytest
import torch

from scenes import make_scene, render_outputs
from test_torch_inference import PAIR_ATOL, PAIR_RTOL

IMG_H, IMG_W = 540, 960
NET_HW, OUT_HW = (256, 416), (64, 104)
FOCAL = 500.0
N_FRAMES = 5


def _frame_key(img: np.ndarray) -> bytes:
    """A normalized frame's identity: a sparse grid of its values (the
    port and JAX normalize the same uint8 to the same float32)."""
    return np.ascontiguousarray(np.asarray(img)[::17, ::29]).tobytes()


@pytest.fixture(scope="module", params=["png", "jpg"])
def labeled(tmp_path_factory, request):
    """Frames with 1-2 people each as unified annotation rows ([x, y, Z, v,
    X, Y, Z, fx, fy, cx, cy]; frame 2's rows 8 wide, frame 3's 4 wide, so
    each intrinsics branch runs; frame 1's second person has its root at
    visibility 1 and is dropped), and the ideal network maps of each
    frame."""
    ext = request.param
    root = tmp_path_factory.mktemp("labeled")
    rng = np.random.RandomState(0)
    records, maps = [], []
    scale = min(NET_HW[1] / IMG_W, NET_HW[0] / IMG_H)
    pad_y = (NET_HW[0] - round(IMG_H * scale)) // 2
    for i in range(N_FRAMES):
        img = rng.randint(0, 256, (IMG_H, IMG_W, 3)).astype(np.uint8)
        cv2.imwrite(str(root / f"f{i}.{ext}"), img)
        K, people = make_scene(rng, num_people=1 + i % 2, img_w=IMG_W,
                               img_h=IMG_H, f=FOCAL)
        rows = []
        for joints in people:
            uv = (K @ (joints / joints[:, 2:3]).T).T[:, :2]
            row = np.zeros((15, 11))
            row[:, :2] = uv
            row[:, 2] = joints[:, 2]
            row[:, 3] = 2
            row[:, 4:7] = joints
            row[:, 7:] = [FOCAL, FOCAL, IMG_W / 2, IMG_H / 2]
            rows.append(row)
        if i == 1:
            rows[1][2, 3] = 1       # root not visible enough: dropped
        rows = np.stack(rows)
        width = {2: 8, 3: 4}.get(i, 11)
        records.append({"dataset": "MUPOTS", "img_paths": f"f{i}.{ext}",
                        "img_height": IMG_H, "img_width": IMG_W,
                        "isValidation": 1,
                        "bodys": rows[..., :width].tolist()})
        maps.append(render_outputs(people, K, IMG_W, IMG_H, *OUT_HW, 4,
                                   scale, 0.0, pad_y, sigma=1.0))
    (root / "annot.json").write_text(json.dumps({"root": records}))
    return root, maps


def _datasets(root):
    from smap_tpu.config import Config as JConfig
    from smap_tpu.config import ModelConfig as JModel
    from smap_tpu.config import PostProcessConfig as JPost
    from smap_tpu.data.datasets import JointDataset as JJointDataset

    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations

    model = dict(stage_num=1, trunk_width=8, upsample_channels=16,
                 output_shape=OUT_HW, compute_dtype="float32")
    post = dict(max_peaks=31, assoc_peaks=8)
    jcfg = JConfig(model=JModel(**model), post=JPost(**post),
                   input_shape=NET_HW, output_shape=OUT_HW)
    cfg = Config(model=ModelConfig(**model), post=PostProcessConfig(**post),
                 input_shape=NET_HW, output_shape=OUT_HW)
    records = load_annotations(str(root / "annot.json"))
    roots = {"MUPOTS": str(root)}
    return (JointDataset(records, roots, cfg, "test"),
            JJointDataset(records, roots, jcfg, "test"), cfg, jcfg)


def _fed_engines(labeled):
    """(port engine, JAX engine, port dataset, JAX dataset): each engine's
    forward returns the ideal maps of the frames it is given (zeros for
    padding)."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.inference import SMAPInference as JSMAPInference
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import smap_state_dict
    from torch_parity import random_variables

    root, maps = labeled
    port_ds, jax_ds, cfg, jcfg = _datasets(root)
    variables = random_variables(JSMAP(jcfg.model),
                                 jnp.zeros((1, *NET_HW, 3), jnp.float32))
    by_frame = {_frame_key(port_ds.get_eval_sample(i)[0]): maps[i]
                for i in range(len(port_ds))}
    zeros = tuple(np.zeros_like(m) for m in maps[0])

    def lookup(images):
        per = [by_frame.get(_frame_key(img), zeros) for img in images]
        return [np.stack(m).astype(np.float32) for m in zip(*per)]

    engine = SMAPInference(smap_state_dict(variables), cfg, device="cpu")
    engine.forward = lambda images: tuple(
        torch.from_numpy(m) for m in lookup(images.numpy()))
    jengine = JSMAPInference(jax.tree.map(np.asarray, variables), jcfg)
    jengine._jit_forward = lambda v, images: tuple(
        jnp.asarray(m) for m in lookup(np.asarray(images)))
    return engine, jengine, port_ds, jax_ds


def _compare(got, want):
    assert got.keys() == want.keys() and got["model_pattern"] == "MIX"
    assert len(got["3d_pairs"]) == len(want["3d_pairs"])
    for g, w in zip(got["3d_pairs"], want["3d_pairs"]):
        assert g.keys() == w.keys()
        for key in g:
            if key in ("image_path", "gt_3d", "gt_2d"):
                assert g[key] == w[key]
            else:
                np.testing.assert_allclose(np.asarray(g[key]),
                                           np.asarray(w[key]),
                                           rtol=PAIR_RTOL, atol=PAIR_ATOL,
                                           err_msg=key)


@pytest.mark.parametrize("mode", ["generate_result", "generate_train"])
def test_run_labeled_inference_matches_jax(labeled, mode):
    from smap_tpu.inference import run_labeled_inference as jrun

    from smap_tpu_torch.inference import run_labeled_inference

    engine, jengine, port_ds, jax_ds = _fed_engines(labeled)
    got = run_labeled_inference(port_ds, engine, mode=mode, batch_size=2)
    want = jrun(jax_ds, jengine, mode=mode, batch_size=2)
    _compare(got, want)
    pairs = got["3d_pairs"]
    if mode == "generate_result":
        assert len(pairs) == N_FRAMES
        # Frame 1's second person is dropped; every kept one is matched.
        assert [len(p["gt_2d"]) for p in pairs] == [1, 1, 1, 2, 1]
        assert all(np.asarray(p["pred_3d"])[:, 2, 3].min() > 0
                   for p in pairs)
    else:
        assert len(pairs) == 6
        assert all(set(p) == {"pred_3d", "pred_2d", "gt_3d", "root_d"}
                   for p in pairs)


def test_run_labeled_inference_shards(labeled):
    """Two contiguous shards together give the whole set, in order."""
    from smap_tpu.inference import run_labeled_inference as jrun

    from smap_tpu_torch.inference import run_labeled_inference

    engine, jengine, port_ds, jax_ds = _fed_engines(labeled)
    whole = run_labeled_inference(port_ds, engine, batch_size=2)
    parts = [run_labeled_inference(port_ds, engine, batch_size=2, shard=s,
                                   num_shards=2, gather=True)
             for s in range(2)]
    for s, part in enumerate(parts):
        _compare(part, jrun(jax_ds, jengine, batch_size=2, shard=s,
                            num_shards=2))
    assert [len(p["3d_pairs"]) for p in parts] == [3, 2]
    assert parts[0]["3d_pairs"] + parts[1]["3d_pairs"] == whole["3d_pairs"]
    with pytest.raises(ValueError, match="mode"):
        run_labeled_inference(port_ds, engine, mode="run_inference")
