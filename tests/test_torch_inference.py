"""The port's serving engine against the JAX package's: the same converted
weights and the same uint8 and I420 frames, with and without flip-TTA and
RefineNet.

Forward and decode are held apart: the network maps are compared at the
model tolerance, and then JAX's maps go through both decoders, so a
near-tie in a random map cannot hide a decode fault."""

import dataclasses
import functools

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


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device`` the engine and run_inference ask for the card:
    on a host with none they raise, they do not run on the CPU."""
    from smap_tpu_torch.inference import SMAPInference, run_inference
    from smap_tpu_torch.models.convert import smap_state_dict

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, cfg = port_configs()
    sd = smap_state_dict(jax_smap()[1])
    with pytest.raises(RuntimeError, match="cuda"):
        SMAPInference(sd, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_inference(str(tmp_path), sd, cfg)


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
                           output_json=str(out), device="cpu")
    assert json.loads(out.read_text()) == result
    assert [p["image_path"] for p in result["3d_pairs"]] == sorted(names)

    engine = SMAPInference(sd, cfg, device="cpu")
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


# The ladder's and the fallback's cases: tests/test_inference.py's sparse
# scene (4 people) and crowded maps (a grid of extra peaks on one joint) at
# a 64x104 output, fed to the engine in place of its forward.
LADDER_HW = (64, 104)
LADDER_SCALES = [{"scale": 0.433, "img_width": 1920.0, "img_height": 1080.0,
                  "f_x": 1500.0, "f_y": 1500.0, "cx": 960.0, "cy": 540.0}]


def _ladder_maps():
    """{"sparse", "middle", "crowded"}: NHWC map triples with at most 8,
    9-16 and more than 48 peaks in one joint."""
    from test_inference import _crowded_maps
    from test_ops import _synthetic_heatmaps

    h, w = LADDER_HW
    hm, pafs, rdm, _, _ = _synthetic_heatmaps(np.random.RandomState(42),
                                              num_people=4, h=h, w=w)
    sparse = (np.concatenate([hm.transpose(1, 2, 0) * 255.0,
                              pafs.transpose(1, 2, 0) * 127.0], -1)[None],
              np.random.RandomState(7).randn(1, h, w, 14),
              rdm[None, ..., None])
    maps = {"sparse": sparse,
            "middle": _crowded_maps(h, w, extra_grid=3),
            "crowded": _crowded_maps(h, w, extra_grid=8)}
    return {k: tuple(torch.from_numpy(np.asarray(m, np.float32)) for m in v)
            for k, v in maps.items()}


def _ladder_engine(assoc_peaks=16, **kw):
    """A CPU engine (a 1-stage narrow model; its forward is replaced by
    ``feed``) with max_peaks 127."""
    from smap_tpu_torch.config import Config, ModelConfig, PostProcessConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap

    h, w = LADDER_HW
    mcfg = ModelConfig(stage_num=1, trunk_width=8, upsample_channels=16,
                       output_shape=(h, w), compute_dtype="float32")
    cfg = Config(model=mcfg, post=PostProcessConfig(max_peaks=127,
                                                    assoc_peaks=assoc_peaks),
                 input_shape=(h * 4, w * 4), output_shape=(h, w))
    engine = SMAPInference(init_smap(mcfg).state_dict(), cfg, device="cpu",
                           **kw)
    fed = []

    def feed(*names):
        fed.extend(names)

    engine.forward = lambda images: _LADDER_MAPS()[fed.pop(0)]
    return engine, feed


_LADDER_MAPS = functools.lru_cache(maxsize=None)(_ladder_maps)
_FRAME = np.zeros((1, LADDER_HW[0] * 4, LADDER_HW[1] * 4, 3), np.uint8)


def _assert_same_decode(got, want):
    """Equal counts, and the valid rows of every table equal (the tables'
    capacity may differ)."""
    assert torch.equal(got.count, want.count)
    for i, n in enumerate(want.count.tolist()):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a[i, :n], b[i, :n])


def _full(engine, name):
    info = engine.scale_info(LADDER_SCALES)
    return engine.postprocess(_LADDER_MAPS()[name], info,
                              capacity=engine.cfg.post.max_peaks)


def test_adaptive_capacity_ladder_matches_full_capacity():
    """The first batch runs at the top rung; then each batch at the rung
    its predecessors' counts speculate, re-decoded at the rung that fits
    when it was too small (a mis-speculation), with the full-capacity
    decode's results at every rung."""
    engine, feed = _ladder_engine(adaptive_capacities=(48, 8, 16))
    assert engine.adaptive_capacities == (8, 16, 48)
    decoded = []
    real = engine.postprocess

    def spy(maps, info, plain=False, capacity=None):
        decoded.append(capacity)
        return real(maps, info, plain, capacity)

    engine.postprocess = spy
    steps = [("sparse", [48], 8), ("sparse", [8], 8),
             ("middle", [8, 16], 16),           # mis-speculated
             ("crowded", [16, 127], 127),       # past the top rung
             ("sparse", [127], 8), ("middle", [8, 16], 16)]
    for name, caps, spec in steps:
        feed(name)
        decoded.clear()
        res = engine.run_batch(_FRAME, LADDER_SCALES)
        assert decoded == caps, name
        assert engine._spec_cap == spec
        assert res.bodies_2d.shape[1] == caps[-1]
        assert not bool(res.overflow.any())
        _assert_same_decode(res, _full(engine, name))
    assert int(_full(engine, "crowded").count[0]) > 0


def test_run_stream_with_the_ladder_matches_run_batch():
    """run_stream resolves each batch's rung one batch later, through a
    flush, with run_batch's results."""
    sequence = ["sparse", "middle", "crowded", "sparse", "sparse"]
    engine, feed = _ladder_engine(adaptive_capacities=(8, 16, 48))
    feed(*sequence)
    refs = [engine.run_batch(_FRAME, LADDER_SCALES) for _ in sequence]
    engine, feed = _ladder_engine(adaptive_capacities=(8, 16, 48))
    feed(*sequence)
    items = [(_FRAME, LADDER_SCALES)] * 2 + [None] + [
        (_FRAME, LADDER_SCALES)] * 3
    outs = list(engine.run_stream(items))
    assert len(outs) == len(refs)
    for got, want in zip(outs, refs):
        _assert_same_decode(got, want)


def test_overflow_fallback_decodes_again_at_max_peaks():
    engine, feed = _ladder_engine(assoc_peaks=8, overflow_fallback=True)
    feed("crowded", "sparse")
    res = engine.run_batch(_FRAME, LADDER_SCALES)
    assert res.bodies_2d.shape[1] == 127
    assert not bool(res.overflow.any())
    _assert_same_decode(res, _full(engine, "crowded"))
    res = engine.run_batch(_FRAME, LADDER_SCALES)     # no overflow: as is
    assert res.bodies_2d.shape[1] == 8
    _assert_same_decode(res, _full(engine, "sparse"))

    plain, feed = _ladder_engine(assoc_peaks=8)
    feed("crowded")
    assert bool(plain.run_batch(_FRAME, LADDER_SCALES).overflow[0])


def test_run_stream_with_overflow_fallback_matches_run_batch():
    """Without the ladder, run_stream decodes each batch through run_batch,
    so a crowded batch is decoded again at max_peaks (the JAX engine's
    run_stream cuts it at assoc_peaks)."""
    sequence = ["crowded", "sparse", "crowded"]
    engine, feed = _ladder_engine(assoc_peaks=8, overflow_fallback=True)
    feed(*sequence)
    refs = [engine.run_batch(_FRAME, LADDER_SCALES) for _ in sequence]
    engine, feed = _ladder_engine(assoc_peaks=8, overflow_fallback=True)
    feed(*sequence)
    outs = list(engine.run_stream([(_FRAME, LADDER_SCALES)] * 3))
    assert [o.bodies_2d.shape[1] for o in outs] == [127, 8, 127]
    for got, want, name in zip(outs, refs, sequence):
        assert not bool(got.overflow.any())
        _assert_same_decode(got, want)
        _assert_same_decode(got, _full(engine, name))


def test_engine_guards():
    from smap_tpu_torch.config import Config, ModelConfig
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.quantize import quantize_state_dict
    from smap_tpu_torch.models.smap import init_smap

    with pytest.raises(ValueError, match="already escalates"):
        _ladder_engine(overflow_fallback=True, adaptive_capacities=(8,))
    with pytest.raises(ValueError, match="exceeds max_peaks"):
        _ladder_engine(adaptive_capacities=(8, 128))
    mcfg = ModelConfig(stage_num=1, trunk_width=8, upsample_channels=16,
                       output_shape=(16, 24), compute_dtype="float32")
    cfg = Config(model=mcfg, input_shape=(64, 96), output_shape=(16, 24))
    sd = init_smap(mcfg).state_dict()
    with pytest.raises(ValueError, match="calibration_batches"):
        SMAPInference(sd, cfg, device="cpu", quantized="static")
    static = dataclasses.replace(cfg, model=dataclasses.replace(
        mcfg, quantized="static"))
    with pytest.raises(ValueError, match="no act_scale"):
        SMAPInference(quantize_state_dict(sd), static, device="cpu")


def test_run_batch_timed():
    engine, feed = _ladder_engine()
    feed("sparse", "sparse")
    res, times = engine.run_batch_timed(_FRAME, LADDER_SCALES)
    assert set(times) == {"transfer_ms", "model_ms", "postproc_ms"}
    assert all(t >= 0.0 for t in times.values())
    _assert_same_decode(res, engine.run_batch(_FRAME, LADDER_SCALES))


@pytest.mark.parametrize("wire", ["uint8", "i420"])
def test_int8_engines_serve_wire_frames(wire):
    """quantized=True and "static" (calibrated on the frames in their wire
    format, prepared as serving prepares them): the static engine's maps
    are the dynamic engine's on the calibration batch, bit for bit, and
    both decode; "static" weights are then taken as they are."""
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.convert import smap_state_dict

    _, cfg = port_configs()
    sd = smap_state_dict(jax_smap()[1])
    u8, i420, scales = _frames(seed=3)
    frames = u8 if wire == "uint8" else i420
    dyn = SMAPInference(sd, cfg, device="cpu", quantized=True)
    static = SMAPInference(sd, cfg, device="cpu", quantized="static",
                           calibration_batches=[frames])
    assert static.cfg.model.quantized == "static"
    for a, b in zip(dyn.forward(torch.from_numpy(frames)),
                    static.forward(torch.from_numpy(frames))):
        assert torch.equal(a, b)
    for engine in (dyn, static):
        res = engine.run_batch(frames, scales)
        assert tuple(res.count.shape) == (BATCH,)
    again = SMAPInference(static.model.state_dict(), static.cfg,
                          device="cpu")
    assert torch.equal(again.forward(torch.from_numpy(frames))[0],
                       static.forward(torch.from_numpy(frames))[0])
