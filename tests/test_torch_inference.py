"""The port's serving engine against the JAX package's: the same converted
weights and the same uint8 and I420 frames, with and without flip-TTA and
RefineNet.

Forward and decode are held apart: the network maps are compared at the
model tolerance, and then JAX's maps go through both decoders, so a
near-tie in a random map cannot hide a decode fault."""

import numpy as np
import pytest
import torch

from torch_parity import (INPUT_HW, TINY_MODEL, jax_refinenet, jax_smap,
                          port_configs)

torch.set_num_threads(1)

MAP_RTOL = MAP_ATOL = 1e-4      # as tests/test_torch_model.py
# Decode of identical maps: the refined peak xy differ by <= 1e-4
# (tests/test_torch_nms.py), which the back-projection scales by
# depth / focal; counts and selections are exact.
PAIR_RTOL, PAIR_ATOL = 1e-3, 2e-3
BATCH = 2


def _scene_maps():
    """Rendered people at the engine's output size (two per image), NHWC.
    The random weights' maps stay far below the 0.2 NMS threshold, so the
    decode sees people only where these are added to them."""
    from scenes import make_scene, render_outputs

    maps = []
    for seed in range(BATCH):
        K, people = make_scene(np.random.RandomState(seed), num_people=2,
                               img_w=INPUT_HW[1], img_h=INPUT_HW[0], f=100.0)
        maps.append(render_outputs(people, K, INPUT_HW[1], INPUT_HW[0],
                                   *TINY_MODEL["output_shape"], 4, 1.0, 0.0,
                                   0.0, sigma=0.8))
    return [np.stack(m).astype(np.float32) for m in zip(*maps)]


def _frames(seed):
    rng = np.random.RandomState(seed)
    h, w = INPUT_HW
    u8 = rng.randint(0, 256, (BATCH, h, w, 3)).astype(np.uint8)
    i420 = rng.randint(16, 236, (BATCH, h * 3 // 2, w)).astype(np.uint8)
    scales = [{"scale": 0.05, "img_width": 1920.0, "img_height": 1080.0,
               "f_x": 1500.0, "f_y": 1500.0, "cx": 960.0, "cy": 540.0},
              {"scale": 0.15, "img_width": 640.0, "img_height": 360.0,
               "f_x": 500.0, "f_y": 510.0, "cx": 320.0, "cy": 180.0}]
    return u8, i420, scales


def _engines(do_flip, refine):
    import jax

    from smap_tpu.inference import SMAPInference as JSMAPInference

    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import (refinenet_state_dict,
                                               smap_state_dict)

    jcfg, cfg = port_configs()
    variables = jax_smap()[1]
    refine_vars = jax_refinenet()[1] if refine else None
    jeng = JSMAPInference(jax.tree.map(np.asarray, variables), jcfg,
                          refine_variables=refine_vars, do_flip=do_flip)
    eng = SMAPInference(smap_state_dict(variables), cfg,
                        refine_state_dict=(refinenet_state_dict(refine_vars)
                                           if refine else None),
                        do_flip=do_flip, device="cpu")
    return jeng, eng


def _compare_pairs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert len(g["pred_2d"]) == len(w["pred_2d"])
        for key in ("pred_2d", "pred_3d", "root_d"):
            np.testing.assert_allclose(np.asarray(g[key]),
                                       np.asarray(w[key]), rtol=PAIR_RTOL,
                                       atol=PAIR_ATOL, err_msg=key)


@pytest.mark.parametrize("do_flip,refine", [(False, False), (True, True)])
def test_engine_matches_jax(do_flip, refine):
    import jax.numpy as jnp

    from smap_tpu.inference import SMAPInference as JSMAPInference

    from smap_tpu_torch.ops.postprocess import ScaleInfo

    jeng, eng = _engines(do_flip, refine)
    u8, i420, scales = _frames(seed=int(do_flip))
    names = [f"img{i}.jpg" for i in range(BATCH)]
    for frames in (u8, i420):
        jmaps = [np.array(m) for m in jeng._jit_forward(jeng.variables,
                                                        jnp.asarray(frames))]
        images, info = eng.place(frames, scales)
        maps = eng.forward(images)
        for g, w in zip(maps, jmaps):
            np.testing.assert_allclose(g.numpy(), w, rtol=MAP_RTOL,
                                       atol=MAP_ATOL)

        # Decode JAX's maps, with people added, with both engines.
        dmaps = [m + s for m, s in zip(jmaps, _scene_maps())]
        jinfo = jeng._make_scale_info(scales)
        want = JSMAPInference.results_to_pairs(
            jeng._jit_post(jeng.refine_variables,
                           *(jnp.asarray(m) for m in dmaps), jinfo), names)
        res = eng.postprocess(tuple(torch.from_numpy(m) for m in dmaps),
                              info)
        got = eng.results_to_pairs(res, names)
        _compare_pairs(got, want)
        assert [len(p["pred_2d"]) for p in got] == [2, 2]
        if refine:
            assert all(np.asarray(p["pred_3d"])[..., 3].max() == 1.0
                       for p in got)

        # run_batch is forward + postprocess; run_stream yields run_batch's
        # results in order, through a flush.
        whole = eng.run_batch(frames, scales)
        assert torch.equal(whole.count, eng.postprocess(maps, info).count)
        stream = list(eng.run_stream([(frames, scales), None,
                                      (frames, ScaleInfo(*info)),
                                      (frames, scales)]))
        assert len(stream) == 3
        for r in stream:
            for a, b in zip(r, whole):
                assert torch.equal(a, b)


def test_engine_rejects_missing_card():
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import smap_state_dict

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, cfg = port_configs()
    with pytest.raises(RuntimeError, match="cuda"):
        SMAPInference(smap_state_dict(jax_smap()[1]), cfg, device="cuda")


def test_run_inference_over_a_directory(tmp_path):
    """Images on disk -> the reference JSON: one item per image (the tail
    batch padded and cut), each as run_batch decodes it."""
    cv2 = pytest.importorskip("cv2")
    import json

    from smap_tpu_torch.data.preprocess import letterbox_image
    from smap_tpu_torch.inference import SMAPInference, run_inference
    from smap_tpu_torch.models.convert import smap_state_dict

    _, cfg = port_configs()
    sd = smap_state_dict(jax_smap()[1])
    rng = np.random.RandomState(0)
    (tmp_path / "sub").mkdir()
    names = ["a.png", "b.jpg", "sub/c.png"]
    for name in names:
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 256, (48, 80, 3)).astype(np.uint8))
    out = tmp_path / "out" / "result.json"
    result = run_inference(str(tmp_path), sd, cfg, batch_size=2,
                           output_json=str(out))
    assert json.loads(out.read_text()) == result
    assert [p["image_path"] for p in result["3d_pairs"]] == sorted(names)

    engine = SMAPInference(sd, cfg)
    for pair in result["3d_pairs"]:
        img, scale = letterbox_image(
            cv2.imread(str(tmp_path / pair["image_path"])), cfg.input_shape)
        want = engine.results_to_pairs(
            engine.run_batch(img[None], [scale]), [pair["image_path"]])[0]
        assert pair == want


def test_get_device_cpu_is_unchanged():
    """Only an unindexed CUDA device gains an index (the current card);
    the CPU device is returned as it is."""
    from smap_tpu_torch.runtime import get_device

    assert get_device("cpu") == torch.device("cpu")
    assert get_device(torch.device("cpu")) == torch.device("cpu")
