"""Rendered scenes and the golden decode corpus, on any device.

``tests/golden/decode_corpus.json`` freezes the JAX package's decode of
five rendered scenes (``tests/make_golden.py``): the base decode at the
full 127-peak capacity and the ``rung8``, ``flip_tta`` and ``refine``
serving variants. This module renders the same scenes (the renderer is
``tests/scenes.py``'s, which ``tests/test_torch_golden.py`` holds this copy
to) and decodes them with the port, so the CPU tests and ``chip_smoke.py``
on the card check the same thing. It needs numpy and torch only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from smap_tpu_torch.config import (FLIP_ORDER, NUM_JOINTS, PAF_FLIP_CHANNEL,
                                   PAF_VECTOR, PostProcessConfig)
from smap_tpu_torch.ops.postprocess import (PoseResults, ScaleInfo,
                                            flip_tta_merge, postprocess_batch)

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden", "decode_corpus.json")
# (seed, num_people) per corpus scene.
SCENES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 3)]
NET_W, NET_H = 832, 512
STRIDE = 4
IMG_W, IMG_H = 1920, 1080
# tests/test_golden.py's tolerances.
RTOL, ATOL = 1e-3, 2e-3


def make_scene(rng, num_people=3, img_w=1920, img_h=1080, f=1500.0):
    """People with plausible articulated geometry (cm) and a camera."""
    K = np.array([[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1]])
    people = []
    for _ in range(num_people):
        root = np.array([rng.uniform(-80, 80), rng.uniform(-20, 20),
                         rng.uniform(350, 700)])
        joints = np.zeros((15, 3))
        joints[2] = root
        joints[0] = root + [rng.uniform(-5, 5), -55, rng.uniform(-8, 8)]
        joints[1] = joints[0] + [rng.uniform(-3, 3), -20, rng.uniform(-5, 5)]
        for (a, b), (dx, dy) in zip(
                PAF_VECTOR[2:], [(18, 2), (6, 28), (4, 26),
                                 (-18, 2), (-6, 28), (-4, 26),
                                 (10, 6), (4, 40), (2, 38),
                                 (-10, 6), (-4, 40), (-2, 38)]):
            joints[b] = joints[a] + [dx + rng.uniform(-2, 2),
                                     dy + rng.uniform(-2, 2),
                                     rng.uniform(-12, 12)]
        people.append(joints)
    return K, people


def render_outputs(people, K, img_w, img_h, out_h, out_w, stride, scale,
                   pad_x, pad_y, sigma=1.5):
    """The ideal network maps of a scene at output resolution
    (heatmaps x255, PAFs x127, delta-Z, normalized root depth)."""
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    hm = np.zeros((out_h, out_w, 15), np.float32)
    paf = np.zeros((out_h, out_w, 28), np.float32)
    paf_z = np.zeros((out_h, out_w, 14), np.float32)
    rd = np.zeros((out_h, out_w, 1), np.float32)

    proj = []
    for joints in people:
        uv = (K @ (joints / joints[:, 2:3]).T).T[:, :2]
        net = uv * scale + [pad_x, pad_y]
        proj.append(net / stride)

    for pi, joints in enumerate(people):
        pts = proj[pi]
        for j in range(15):
            g = np.exp(-((xs - pts[j, 0]) ** 2 + (ys - pts[j, 1]) ** 2)
                       / (2 * sigma ** 2))
            hm[..., j] = np.maximum(hm[..., j], g)
        for li, (a, b) in enumerate(PAF_VECTOR):
            pa, pb = pts[a], pts[b]
            v = pb - pa
            norm = np.hypot(*v)
            if norm < 1:
                continue
            u = v / norm
            t = np.clip(((xs - pa[0]) * u[0] + (ys - pa[1]) * u[1]) / norm,
                        0, 1)
            px, py = pa[0] + t * v[0], pa[1] + t * v[1]
            band = np.hypot(xs - px, ys - py) < 2.0
            paf[..., 2 * li][band] = u[0]
            paf[..., 2 * li + 1][band] = u[1]
            paf_z[..., li][band] = joints[b, 2] - joints[a, 2]
        rx, ry = pts[2].astype(int)
        rd[max(ry - 2, 0):ry + 3, max(rx - 2, 0):rx + 3, 0] = (
            joints[2, 2] / K[0, 0] / scale)

    out2d = np.concatenate([hm * 255.0, paf * 127.0], axis=-1)
    return out2d, paf_z, rd


def scene_inputs() -> Iterator[Tuple[int, int, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]]:
    """(seed, num_people, K, out2d, paf_z, rd) per corpus scene."""
    out_w, out_h = NET_W // STRIDE, NET_H // STRIDE
    scale = min(NET_W / IMG_W, NET_H / IMG_H)
    pad_y = (NET_H - IMG_H * scale) // 2
    for seed, num_people in SCENES:
        rng = np.random.RandomState(seed)
        K, people = make_scene(rng, num_people=num_people)
        out2d, paf_z, rd = render_outputs(people, K, IMG_W, IMG_H, out_h,
                                          out_w, STRIDE, scale, 0.0, pad_y)
        yield seed, num_people, K, out2d, paf_z, rd


def _scale_info(K: np.ndarray, device) -> ScaleInfo:
    scale = min(NET_W / IMG_W, NET_H / IMG_H)
    vals = (scale, float(IMG_W), float(IMG_H), K[0, 0], K[1, 1], K[0, 2],
            K[1, 2])
    return ScaleInfo(*(torch.tensor([v], dtype=torch.float32, device=device)
                       for v in vals))


def _record(seed: int, num_people: int, res: PoseResults) -> Dict:
    n = int(res.count[0])

    def rows(t):
        return np.round(t[0, :n].double().cpu().numpy(), 4).tolist()

    return {"seed": seed, "num_people": num_people, "count": n,
            "bodies_2d": rows(res.bodies_2d),
            "bodies_3d": rows(res.bodies_3d),
            "root_depth": rows(res.root_depth)}


def flipped_maps(out2d: np.ndarray) -> np.ndarray:
    """What a perfectly mirror-equivariant network emits on the W-flipped
    image: flip_W((out2d * sign)[..., perm])."""
    nch = NUM_JOINTS + len(PAF_FLIP_CHANNEL)
    sign = np.ones((nch,), np.float32)
    sign[NUM_JOINTS::2] = -1.0
    perm = list(FLIP_ORDER) + [NUM_JOINTS + c for c in PAF_FLIP_CHANNEL]
    return (out2d * sign)[..., perm][:, ::-1, :]


def decode_golden(device, refine_model: Optional[torch.nn.Module] = None,
                  variants: Optional[Tuple[str, ...]] = None,
                  plain: bool = False) -> Dict[str, List[Dict]]:
    """Decode every corpus scene with the port on ``device``; returns
    {variant: [record per scene]} in the corpus's record layout.
    ``variants`` defaults to "scenes", "rung8", "flip_tta", and "refine"
    when ``refine_model`` (on ``device``, eval mode) is given."""
    from smap_tpu_torch.ops.refine import apply_refinement, build_refine_input

    if variants is None:
        variants = ("scenes", "rung8", "flip_tta") + (
            ("refine",) if refine_model is not None else ())
    if "refine" in variants and refine_model is None:
        raise ValueError("the refine variant needs refine_model")

    full = PostProcessConfig(max_peaks=127, assoc_peaks=127)
    rung8 = PostProcessConfig(max_peaks=127, assoc_peaks=8)
    kw = dict(net_w=float(NET_W), net_h=float(NET_H), stride=STRIDE,
              plain=plain)
    out: Dict[str, List[Dict]] = {v: [] for v in variants}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)[None]).to(device)

    with torch.no_grad():
        for seed, num_people, K, out2d, paf_z, rd in scene_inputs():
            info = _scale_info(K, device)
            maps = (put(out2d), put(paf_z), put(rd))
            if "scenes" in out or "refine" in out:
                res = postprocess_batch(*maps, info, full, **kw)
                if "scenes" in out:
                    out["scenes"].append(_record(seed, num_people, res))
                if "refine" in out:
                    feat = build_refine_input(res.bodies_2d, res.bodies_3d)
                    pred = refine_model(feat.reshape(-1, feat.shape[-1]))
                    refined = apply_refinement(
                        pred.reshape(*feat.shape[:-1], -1), res.bodies_3d)
                    out["refine"].append(_record(
                        seed, num_people, res._replace(bodies_3d=refined)))
            if "rung8" in out:
                res = postprocess_batch(*maps, info, rung8, **kw)
                out["rung8"].append(_record(seed, num_people, res))
            if "flip_tta" in out:
                merged = flip_tta_merge(maps[0], put(flipped_maps(out2d)),
                                        FLIP_ORDER, PAF_FLIP_CHANNEL)
                res = postprocess_batch(merged, maps[1], maps[2], info, full,
                                        **kw)
                out["flip_tta"].append(_record(seed, num_people, res))
    return out


def load_corpus(path: str = GOLDEN_PATH) -> Dict[str, List[Dict]]:
    """{variant: records} of the committed corpus; the base decode is
    ``"scenes"``."""
    with open(path) as f:
        data = json.load(f)
    return {"scenes": data["scenes"], **data["variants"]}


def compare(got: List[Dict], want: List[Dict], label: str = "") -> None:
    """Raise AssertionError unless ``got`` matches ``want``: same seeds,
    equal counts, tables within rtol 1e-3 / atol 2e-3."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} records, want "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if g["seed"] != w["seed"] or g["count"] != w["count"]:
            raise AssertionError(f"{label} seed {g['seed']}: count "
                                 f"{g['count']} want {w['count']}")
        for key in ("bodies_2d", "bodies_3d", "root_depth"):
            np.testing.assert_allclose(
                np.asarray(g[key]), np.asarray(w[key]), rtol=RTOL, atol=ATOL,
                err_msg=f"{label} seed {g['seed']} {key}")
