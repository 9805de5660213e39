"""The port's association (the module that holds kernel B) against the
numpy greedy oracle and the JAX package: the Pallas kernel in interpret
mode, and ``associate(impl="scan")``. The wave schedule and the host-side
plan of the fused CUDA kernel are checked here too: the plain association
run wave by wave, and a numpy transcription of the kernel's algorithm
driven by the plan the wrapper hands it, give the sequential result bit for
bit."""

import numpy as np
import pytest
import torch

from test_pallas_kernels import _greedy_oracle
from torch_parity import jax_peaks_to_torch

torch.set_num_threads(1)


def _tables(rng, B, K, ties=False):
    scores = rng.rand(B, K, K).astype(np.float32) * 2 - 1
    if ties:
        scores = np.round(scores * 4) / 4
    for b in range(B):
        scores[b, rng.rand(K) < 0.3] = -np.inf
    scores[0] = -np.inf                 # an image where nothing is valid
    valid = np.stack([np.arange(K) < rng.randint(0, K + 1)
                      for _ in range(B)])
    return scores, valid


@pytest.mark.parametrize("seed,K,ties", [(0, 40, False), (1, 31, True),
                                         (2, 8, True)])
def test_plain_greedy_matches_oracle_and_pallas(seed, K, ties):
    import jax
    import jax.numpy as jnp

    from smap_tpu.ops.pallas_kernels import associate_limb as jassociate_limb

    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import associate_limb_plain

    rng = np.random.RandomState(seed)
    B = 4
    scores, valid = _tables(rng, B, K, ties)
    kernels.reset_launch_counts()
    got = associate_limb_plain(torch.from_numpy(scores),
                               torch.from_numpy(valid)).numpy()
    assert set(kernels.LAUNCHES.values()) == {0}
    assert got.dtype == np.int32
    oracle = np.stack([_greedy_oracle(scores[b], valid[b]) for b in range(B)])
    np.testing.assert_array_equal(got, oracle)
    # The Pallas kernel, per image and through its batched vmap rule.
    for b in range(B):
        one = jassociate_limb(jnp.asarray(scores[b]), jnp.asarray(valid[b]),
                              interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(one))
    batched = jax.vmap(lambda s, v: jassociate_limb(s, v, interpret=True))(
        jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(batched))


def test_plain_greedy_nan_counts_as_max():
    """torch.argmax / jnp.argmax take NaN as the maximum; NaN is never > 0,
    so such a row takes nothing (the kernel follows the same rule)."""
    from smap_tpu_torch.ops.association import associate_limb_plain

    scores = torch.tensor([[[0.5, float("nan"), 0.9],
                            [0.2, 0.1, 0.3],
                            [0.4, 0.8, 0.1]]])
    got = associate_limb_plain(scores, torch.ones((1, 3), dtype=torch.bool))
    assert got.tolist() == [[-1, 2, 1]]


@pytest.mark.parametrize("seed", [0, 1])
def test_associate_matches_jax_scan(seed):
    import jax.numpy as jnp

    from smap_tpu.config import PAF_VECTOR
    from smap_tpu.ops.association import associate as jassociate
    from smap_tpu.ops.nms import extract_peaks
    from smap_tpu.ops.paf import paf_scores

    from smap_tpu_torch.ops.association import associate

    rng = np.random.RandomState(seed)
    hm = rng.rand(15, 32, 48).astype(np.float32)
    pafs = (rng.rand(28, 32, 48).astype(np.float32) - 0.5) * 2
    rdm = (rng.rand(32, 48) * 5).astype(np.float32)
    jpeaks = extract_peaks(jnp.asarray(hm), max_peaks=31)
    table = paf_scores(jnp.asarray(pafs), jpeaks,
                       jnp.asarray(PAF_VECTOR, jnp.int32), impl="gather")
    want = jassociate(jpeaks, table, jnp.asarray(rdm), impl="scan")

    got = associate(jax_peaks_to_torch(jpeaks),
                    torch.from_numpy(np.array(table))[None],
                    torch.from_numpy(rdm)[None])
    assert int(got.count[0]) == int(want.count) > 0
    # Same table in, same selections out: exact.
    np.testing.assert_array_equal(got.joints[0].numpy(),
                                  np.asarray(want.joints))
    np.testing.assert_array_equal(got.root_depth[0].numpy(),
                                  np.asarray(want.root_depth))
    # Limbs beyond the root were assigned.
    assert (got.joints[0, :, :, 3] > 0).sum() > int(got.count[0])


def test_limb_waves_are_the_skeleton_tree():
    from smap_tpu_torch.config import NUM_LIMBS, PAF_VECTOR, ROOT_IDX
    from smap_tpu_torch.ops.association import limb_waves

    waves = limb_waves(ROOT_IDX)
    assert waves == ((1, 8, 11), (0, 2, 5, 9, 12), (3, 6, 10, 13), (4, 7))
    assert sorted(l for w in waves for l in w) == list(range(NUM_LIMBS))
    # A topological order: each limb's src is the root or the dst of a limb
    # in an earlier wave; no dst is written twice, nor the root.
    written, dsts = {ROOT_IDX}, []
    for wave in waves:
        new = set()
        for limb in wave:
            src, dst = PAF_VECTOR[limb]
            if limb == 1:                    # runs flipped from the root
                src, dst = dst, src
            assert src in written
            new.add(dst)
            dsts.append(dst)
        written |= new
    assert len(set(dsts)) == len(dsts) == NUM_LIMBS
    assert ROOT_IDX not in dsts
    # A root whose limbs do not form a tree has no waves.
    with pytest.raises(ValueError):
        limb_waves(9)


def _jax_inputs(case):
    """(JAX peaks, [L, K, K] table, [H, W] depth map) of one image: random
    maps with the table quantized to 0.25 (ties), or a rendered scene."""
    import jax.numpy as jnp

    from smap_tpu.config import PAF_VECTOR
    from smap_tpu.ops.nms import extract_peaks
    from smap_tpu.ops.paf import paf_scores

    kind, seed = case
    if kind == "random":
        rng = np.random.RandomState(seed)
        hm = rng.rand(15, 32, 48).astype(np.float32)
        pafs = (rng.rand(28, 32, 48).astype(np.float32) - 0.5) * 2
        rdm = (np.round(rng.rand(32, 48) * 4) / 2).astype(np.float32)
        max_peaks = 31
    else:
        from smap_tpu_torch import golden

        _, _, _, out2d, _, rd = list(golden.scene_inputs())[seed]
        maps = np.moveaxis(out2d, -1, 0)
        hm, pafs = maps[:15] / 255.0, (maps[15:] / 127.0).astype(np.float32)
        rdm = rd[..., 0].astype(np.float32)
        max_peaks = 40
    jpeaks = extract_peaks(jnp.asarray(hm, jnp.float32), max_peaks=max_peaks)
    table = np.array(paf_scores(jnp.asarray(pafs), jpeaks,
                                jnp.asarray(PAF_VECTOR, jnp.int32),
                                impl="gather"))
    if kind == "random":
        table = np.round(table * 4) / 4
    return jpeaks, table.astype(np.float32), rdm


@pytest.mark.parametrize("case", [("random", 0), ("random", 1),
                                  ("scene", 0), ("scene", 3)])
def test_wave_order_matches_sequential_and_jax_scan(case, monkeypatch):
    import jax.numpy as jnp

    from smap_tpu.ops.association import associate as jassociate

    from smap_tpu_torch.ops import association
    from smap_tpu_torch.ops.association import associate_plain, limb_waves

    jpeaks, table, rdm = _jax_inputs(case)
    want = jassociate(jpeaks, jnp.asarray(table), jnp.asarray(rdm),
                      impl="scan")
    peaks = jax_peaks_to_torch(jpeaks)
    args = (peaks, torch.from_numpy(table)[None], torch.from_numpy(rdm)[None])
    seq = associate_plain(*args)
    # The plain loop again, the limbs wave by wave, shuffled in each wave.
    rng = np.random.RandomState(len(case[0]) + case[1])
    order = tuple(int(l) for w in limb_waves() for l in rng.permutation(w))
    assert order != association._limb_order(14)
    monkeypatch.setattr(association, "_limb_order", lambda n: order)
    waved = associate_plain(*args)
    for got in (seq, waved):
        np.testing.assert_array_equal(got.joints[0].numpy(),
                                      np.asarray(want.joints))
        np.testing.assert_array_equal(got.root_depth[0].numpy(),
                                      np.asarray(want.root_depth))
        assert int(got.count[0]) == int(want.count) > 0
    # Limbs beyond the root were assigned.
    assert (seq.joints[0, :, :, 3] > 0).sum() > int(seq.count[0])


def test_kernel_plan_is_the_wave_table():
    """The host-side plan ``associate_kernel`` gets: (limb, src, dst,
    flip) rows wave by wave, the wave starts, the bone products rounded as
    the plain version rounds them, and 1 / ds_scale."""
    from smap_tpu_torch.config import BONE_LENGTHS, PAF_VECTOR
    from smap_tpu_torch.ops.association import kernel_plan, limb_waves

    plan = kernel_plan(2, 1.2, 4.0, torch.device("cpu"))
    waves = limb_waves(2)
    assert plan.wave_starts.dtype == plan.steps.dtype == torch.int32
    assert plan.wave_starts.tolist() == [0, 3, 8, 12, 14]
    assert plan.max_wave == 5
    assert [r[0] for r in plan.steps.tolist()] == [l for w in waves
                                                   for l in w]
    for limb, src, dst, flip in plan.steps.tolist():
        assert flip == (limb == 1)
        assert (src, dst) == (PAF_VECTOR[limb][::-1] if flip
                              else PAF_VECTOR[limb])
    lengths = torch.tensor(BONE_LENGTHS, dtype=torch.float32)
    for limb in range(14):
        assert plan.bone[limb].item() == (1.2 * lengths[limb]).item()
    assert plan.bone.dtype == torch.float32
    assert plan.inv_ds_scale == 0.25
    assert kernel_plan(2, 1.2, 4.0, torch.device("cpu")) is plan


def _order_key(v):
    """associate.cu's order_key: NaN above +inf, -0 equal to +0."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def _rank_sort(key):
    """associate.cu's stable rank sort: (sorted keys, source index)."""
    K = len(key)

    def before(a, b):
        return (not np.isnan(a) and np.isnan(b)) or a < b

    sidx = np.empty(K, np.int64)
    for k in range(K):
        rank = sum(before(key[i], key[k])
                   or (i < k and not before(key[k], key[i]))
                   for i in range(K))
        sidx[rank] = k
    return key[sidx], sidx


def _kernel_in_numpy(peaks, table, rdm, plan, root):
    """associate.cu's algorithm, step for step, in float32 numpy, driven by
    the kernel's plan: rank sort, wave schedule, the adjusted score of each
    (person, dst slot) in the kernel's order of operations, the argmax by
    order key then lowest index."""
    xy, sc, cnt = (t.numpy() for t in peaks)
    tab, rdm = table.numpy(), rdm.numpy()
    steps, starts = plan.steps.numpy(), plan.wave_starts.numpy()
    bone, inv = plan.bone.numpy(), np.float32(plan.inv_ds_scale)
    B, J, K = xy.shape[:3]
    H, W = rdm.shape[1:]
    bodies = np.zeros((B, K, J, 4), np.float32)
    root_depth = np.zeros((B, K), np.float32)
    for b in range(B):
        n_person = min(max(int(cnt[b, root]), 0), K)
        x = np.clip(np.trunc(xy[b, root, :, 0]).astype(np.int64), 0, W - 1)
        y = np.clip(np.trunc(xy[b, root, :, 1]).astype(np.int64), 0, H - 1)
        key = np.where(np.arange(K) < n_person, rdm[b, y, x],
                       np.float32(np.inf)).astype(np.float32)
        sdepth, sidx = _rank_sort(key)
        remap = np.tile(np.arange(K), (J, 1))
        remap[root] = sidx
        for p in range(n_person):
            k = sidx[p]
            bodies[b, p, root] = (xy[b, root, k, 0], xy[b, root, k, 1], 0,
                                  sc[b, root, k])
            root_depth[b, p] = sdepth[p]
        for w in range(len(starts) - 1):
            for limb, src, dst, flip in steps[starts[w]:starts[w + 1]]:
                dst_n = min(max(int(cnt[b, dst]), 0), K)
                used = np.zeros(K, bool)
                for p in range(n_person):
                    s = bodies[b, p, src]
                    if not s[3] >= np.float32(1e-5):
                        continue
                    r = remap[src, p]
                    row = tab[b, limb, :, r] if flip else tab[b, limb, r]
                    with np.errstate(all="ignore"):
                        bone_dist = bone[limb] / sdepth[p]
                        dx = s[0] - xy[b, dst, :, 0]
                        dy = s[1] - xy[b, dst, :, 1]
                        dist = np.sqrt(dx * dx + dy * dy)
                        pen = bone_dist / dist * inv - np.float32(1)
                        pen = np.where(pen > 0, np.float32(0), pen)
                        v = np.where(row > 0, row + pen, row)
                    ok = (np.arange(K) < dst_n) & ~used
                    keys = _order_key(np.where(ok, v, np.float32(-np.inf)))
                    top = keys.max()
                    if top > 0x80000000 and top != 0xFFFFFFFF:
                        pick = int(np.flatnonzero(keys == top)[0])
                        used[pick] = True
                        bodies[b, p, dst] = (xy[b, dst, pick, 0],
                                             xy[b, dst, pick, 1], 0,
                                             sc[b, dst, pick])
                        remap[dst, p] = pick
    return bodies, root_depth


@pytest.mark.parametrize("seed,K", [(0, 8), (1, 40), (2, 31)])
def test_kernel_algorithm_with_its_plan_matches_plain(seed, K):
    """On the inputs chip_smoke.py holds the kernel to its plain version
    with: ties, NaN entries and depths, -1 rows, empty joints, an image
    with no root, -0 and +0 depths, dst peaks on their src."""
    from chip_smoke import association_inputs

    from smap_tpu_torch.ops.association import associate_plain, kernel_plan

    peaks, table, rdm = association_inputs(torch.Generator().manual_seed(seed),
                                           5, K, torch.device("cpu"), 32, 48)
    want = associate_plain(peaks, table, rdm)
    plan = kernel_plan(2, 1.2, 4.0, torch.device("cpu"))
    bodies, root_depth = _kernel_in_numpy(peaks, table, rdm, plan, 2)
    np.testing.assert_array_equal(bodies, want.joints.numpy())
    np.testing.assert_array_equal(root_depth, want.root_depth.numpy())
    assert (want.joints[..., 3] > 0).sum() > want.count.sum()


def test_rank_sort_is_torch_stable_sort():
    """The kernel's sort gives torch.sort(stable=True)'s order: NaN last,
    equal keys (-0 and +0 among them) in index order."""
    key = np.array([1.0, np.nan, 0.0, -0.0, np.inf, 1.0, np.nan, -2.0,
                    0.0, np.inf, -0.0, 1.0], np.float32)
    vals, idx = _rank_sort(key)
    want_vals, want_idx = torch.sort(torch.from_numpy(key), stable=True)
    assert idx.tolist() == want_idx.tolist()
    np.testing.assert_array_equal(vals, want_vals.numpy())
