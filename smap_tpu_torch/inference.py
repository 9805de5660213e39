"""Inference API: frames -> multi-person absolute 3D poses (counterpart of
``smap_tpu/inference.py``).

``SMAPInference`` runs the SMAP forward (optionally with flip test-time
augmentation), the batched post-processing and the optional RefineNet lift
on one device, or with ``devices=`` on several: one replica a device, each
batch split between them; the host only moves frames in and results out.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import os
import time
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from smap_tpu_torch.config import (FLIP_ORDER, NUM_JOINTS, PAF_FLIP_CHANNEL,
                                   ROOT_IDX, Config)
from smap_tpu_torch.data.image import imread
from smap_tpu_torch.data.preprocess import letterbox_image, prepare_images
from smap_tpu_torch.evaluation.register import register_pred
from smap_tpu_torch.models.layers import to_compute_dtype
from smap_tpu_torch.models.quantize import (calibrate_activation_scales,
                                            check_static_scales,
                                            fold_bn_state_dict,
                                            quantize_state_dict)
from smap_tpu_torch.models.refinenet import RefineNet
from smap_tpu_torch.models.smap import SMAP
from smap_tpu_torch.ops.nms import _local_max_mask
from smap_tpu_torch.ops.postprocess import (PoseResults, ScaleInfo,
                                            flip_tta_merge, postprocess_batch)
from smap_tpu_torch.ops.refine import apply_refinement, build_refine_input
from smap_tpu_torch.parallel import mesh
from smap_tpu_torch.parallel.distributed import all_gather_objects
from smap_tpu_torch.runtime import compute_dtype, get_device

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Scales = Union[ScaleInfo, Sequence[Mapping[str, float]]]


def _batch_list(batches) -> list:
    """One batch (an array or a tensor) or an iterable of them -> a list."""
    if isinstance(batches, (np.ndarray, torch.Tensor)):
        return [batches]
    return list(batches)


class SMAPInference:
    """Batched inference pipeline on one device, or data parallel over
    several.

    Args:
      state_dict: SMAP weights in the reference layout (the port's
        ``SMAP.state_dict()``, a reference checkpoint, or
        ``models.convert.smap_state_dict`` of JAX variables).
      cfg: serving Config; ``cfg.model.compute_dtype`` is the forward's
        dtype (its outputs are float32 either way).
      refine_state_dict: optional RefineNet weights; enables the lift.
      do_flip: horizontal-flip test-time augmentation, as one 2B forward.
      device: where everything runs: the card unless ``"cpu"`` is asked
        for; ``"cuda"`` raises on a host without a card.
      quantized: the serving weight transform, done once here unless
        ``cfg.model.quantized`` is already set (then ``state_dict`` is
        taken as transformed, and for ``"static"`` as calibrated).
        ``"folded"``: BatchNorm folded into the conv weights
        (``models.quantize.fold_bn_state_dict``). True: int8 convolutions
        (kernel E on the card) on per-output-channel int8 weights with
        BatchNorm folded in (``models.quantize.quantize_state_dict``) and
        a per-tensor activation scale taken from each input on the device.
        ``"static"``: the same with the activation scales frozen from
        ``calibration_batches`` (``models.quantize.
        calibrate_activation_scales``): no per-call reduction; inputs
        hotter than the calibration range clip at +-127. Uncalibrated
        static weights are rejected here.
      calibration_batches: for ``quantized="static"`` only: one batch or
        an iterable of batches in any ``run_batch`` wire format, prepared
        on the engine's device as serving prepares them.
      fuse_stem, fuse_bottleneck: on the folded model, run the stem and
        the eligible bottlenecks as the fused kernels (``SMAP``).
      overflow_fallback: when an image has more peaks in a joint than
        ``cfg.post.assoc_peaks`` (``PoseResults.overflow``), decode the
        batch again at ``cfg.post.max_peaks``, so crowded scenes are not
        cut. It reads the flag on the host, once per batch.
      adaptive_capacities: ascending peak capacities, e.g. ``(8, 16, 40)``:
        the decode's cost grows with the square of its capacity, so each
        batch is decoded at the smallest rung speculated to fit, from the
        peak counts of earlier batches (the first batch at the top rung),
        with no wait between forward and decode. The batch's own count
        (the most peaks in one joint, from the forward's maps) comes to the
        host behind it; if it exceeds the rung, the batch is decoded again
        at the rung that fits (``max_peaks`` above the top rung). The
        results equal those of the full-capacity decode at every rung.
        Not with ``overflow_fallback``, which the ladder already covers.
      devices: several devices (``parallel.mesh.make_mesh``; in place of
        ``device``): one replica on each, with its own weights (transformed
        and calibrated once, on the first), packs and kernel caches. Each
        batch is split into equal contiguous shards
        (``parallel.mesh.shard_batch``: the batch must divide by the device
        count), each run through the forward and decode on its device, and
        the results are concatenated in batch order on the first device.
        The ladder's rung and the overflow fallback's re-decode are decided
        for the whole batch, as on one device. A device may appear twice.
    """

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 cfg: Config = Config(),
                 refine_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 do_flip: bool = False, device="cuda", quantized=False,
                 fuse_stem: bool = False, fuse_bottleneck: bool = False,
                 calibration_batches=None, overflow_fallback: bool = False,
                 adaptive_capacities: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence[Any]] = None):
        if overflow_fallback and adaptive_capacities:
            raise ValueError("adaptive_capacities already escalates; don't "
                             "combine it with overflow_fallback")
        self.mesh = mesh.make_mesh(devices) if devices is not None else (
            get_device(device),)
        self.device = self.mesh[0]
        if quantized and not cfg.model.quantized:
            if quantized == "static" and calibration_batches is None:
                raise ValueError(
                    'quantized="static" needs calibration_batches (or pass '
                    'calibrated weights with cfg.model.quantized="static")')
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, quantized=quantized))
            if quantized == "folded":
                state_dict = fold_bn_state_dict(state_dict)
            else:
                state_dict = quantize_state_dict(state_dict)
            if quantized == "static":
                state_dict = calibrate_activation_scales(
                    state_dict, cfg.model,
                    [prepare_images(self.to_device(b))
                     for b in _batch_list(calibration_batches)])
        if cfg.model.quantized == "static":
            check_static_scales(state_dict)
        self.cfg = cfg
        self.do_flip = do_flip
        self.model = SMAP(cfg.model, fuse_stem=fuse_stem,
                          fuse_bottleneck=fuse_bottleneck)
        self.model.load_state_dict(state_dict, strict=True)
        to_compute_dtype(self.model, self.device,
                         compute_dtype(cfg.model.compute_dtype))
        self.model.eval()
        self.refine_model = None
        if refine_state_dict is not None:
            self.refine_model = RefineNet(cfg.refine)
            self.refine_model.load_state_dict(refine_state_dict, strict=True)
            self.refine_model.to(self.device).eval()
        self.overflow_fallback = overflow_fallback
        self.adaptive_capacities = (tuple(sorted(adaptive_capacities))
                                    if adaptive_capacities else None)
        if (self.adaptive_capacities
                and self.adaptive_capacities[-1] > cfg.post.max_peaks):
            raise ValueError("adaptive capacity exceeds max_peaks")
        # The ladder's rung for the next batch, learnt from the counts of
        # earlier ones; the first batch takes the top rung, so that a cold
        # engine never decodes twice.
        self._spec_cap = (self.adaptive_capacities[-1]
                          if self.adaptive_capacities else None)
        # The replicas that serve the shards of a batch: this engine on the
        # first device, then one engine (with the weights transformed
        # here) on each further device.
        self.replicas = [self] + [
            SMAPInference(state_dict, cfg, refine_state_dict, do_flip,
                          device=d, fuse_stem=fuse_stem,
                          fuse_bottleneck=fuse_bottleneck)
            for d in self.mesh[1:]]

    # -- stages -------------------------------------------------------------

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Maps:
        """Wire-format frames on the device -> (2D, rel-depth, root-depth)
        NHWC float32 maps."""
        images = prepare_images(images)
        if not self.do_flip:
            return self.model.infer(images)
        # The upright and the W-flipped halves in one 2B forward.
        b = images.shape[0]
        both = torch.cat([images, torch.flip(images, dims=[2])], dim=0)
        out2d2, out3d2, outrd2 = self.model.infer(both)
        out2d = flip_tta_merge(out2d2[:b], out2d2[b:], FLIP_ORDER,
                               PAF_FLIP_CHANNEL)
        return out2d, out3d2[:b], outrd2[:b]

    @torch.no_grad()
    def postprocess(self, maps: Maps, info: ScaleInfo, plain: bool = False,
                    capacity: Optional[int] = None) -> PoseResults:
        """Decode NHWC maps (``plain``: with the kernels' plain versions;
        ``capacity``: at that many peaks a joint instead of
        ``cfg.post.assoc_peaks``)."""
        net_h, net_w = self.cfg.input_shape
        post = self.cfg.post
        if capacity is not None:
            post = dataclasses.replace(post, assoc_peaks=capacity)
        results = postprocess_batch(*maps, info, post,
                                    net_w=float(net_w), net_h=float(net_h),
                                    stride=self.cfg.stride, plain=plain)
        if self.refine_model is None:
            return results
        feat = build_refine_input(results.bodies_2d, results.bodies_3d,
                                  root_idx=ROOT_IDX)
        pred = self.refine_model(feat.reshape(-1, feat.shape[-1]))
        refined = apply_refinement(pred.reshape(*feat.shape[:-1], -1),
                                   results.bodies_3d, root_idx=ROOT_IDX)
        return results._replace(bodies_3d=refined)

    # -- placement ----------------------------------------------------------

    def place(self, images, scales: Scales) -> Tuple[torch.Tensor, ScaleInfo]:
        """Frames and metadata onto the device (:meth:`to_device`,
        :meth:`scale_info`)."""
        return self.to_device(images), self.scale_info(scales)

    def to_device(self, images) -> torch.Tensor:
        """Frames (numpy or torch) onto the device. Host frames go through
        pinned memory with a non-blocking copy, so the host does not wait
        for the work queued before them."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.device != self.device:
            if self.device.type == "cuda" and images.device.type == "cpu":
                images = images.pin_memory()
            images = images.to(self.device, non_blocking=True)
        return images

    def scale_info(self, scales: Scales) -> ScaleInfo:
        """Per-image scale dicts -> ScaleInfo on the device (a ScaleInfo
        already there is returned as it is)."""
        if isinstance(scales, ScaleInfo):
            return scales
        keys = ("scale", "img_width", "img_height", "f_x", "f_y", "cx", "cy")
        table = torch.tensor([[float(s[k]) for k in keys] for s in scales],
                             dtype=torch.float32)
        if self.device.type == "cuda":
            table = table.pin_memory()
        table = table.to(self.device, non_blocking=True)
        return ScaleInfo(*table.unbind(dim=1))

    # -- the capacity ladder ------------------------------------------------

    def peak_count(self, out2d: torch.Tensor) -> torch.Tensor:
        """The most peaks in one joint of one image of the batch (at most
        ``max_peaks``), a 0-dim int64 tensor on the device: the decode's
        own NMS mask (``ops.nms._local_max_mask``) on the forward's 2D
        maps, so that ``count > capacity`` is exactly the decode's overflow
        condition."""
        kpt = out2d.float().permute(0, 3, 1, 2)[:, :NUM_JOINTS] / 255.0
        mask = _local_max_mask(kpt, self.cfg.post.nms_threshold)
        return torch.clamp(mask.sum(dim=(-2, -1)).max(),
                           max=self.cfg.post.max_peaks)

    def _rung_for(self, n: int) -> int:
        """The smallest rung that fits ``n`` peaks (``max_peaks`` above the
        top one)."""
        return next((c for c in self.adaptive_capacities if c >= n),
                    self.cfg.post.max_peaks)

    def _count_to_host(self, out2d: torch.Tensor):
        """Queue :meth:`peak_count`'s copy to the host without waiting:
        (the host tensor, the event that says it arrived, or None)."""
        count = self.peak_count(out2d)
        if self.device.type != "cuda":
            return count, None
        host = torch.empty((), dtype=count.dtype, pin_memory=True)
        host.copy_(count, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    # -- data parallelism ---------------------------------------------------

    def _shards(self, images, scales) -> List[Tuple[Any, Scales]]:
        """``(images, scales)`` of each replica: the whole batch for one,
        else its contiguous shard on its device."""
        if len(self.replicas) == 1:
            return [(images, scales)]
        return list(zip(mesh.shard_batch(images, self.mesh),
                        mesh.shard_batch(scales, self.mesh)))

    def _merge(self, results: List[PoseResults]) -> PoseResults:
        """The replicas' results in batch order, on the first device."""
        if len(results) == 1:
            return results[0]
        return PoseResults(*(torch.cat([r[f].to(self.device)
                                        for r in results])
                             for f in range(len(PoseResults._fields))))

    def _sync(self) -> None:
        for d in set(self.mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- dispatch and resolve -----------------------------------------------

    def _dispatch(self, images, scales):
        """Queue a batch: every replica's forward on its shard, then its
        decode (at the ladder's speculated rung), with no wait for the
        devices. Returns what :meth:`_resolve` takes."""
        placed = [r.place(*shard) for r, shard
                  in zip(self.replicas, self._shards(images, scales))]
        maps = [r.forward(x) for r, (x, _) in zip(self.replicas, placed)]
        return self._decode_dispatch(maps, [info for _, info in placed])

    def _decode_dispatch(self, maps: List[Maps], infos: List[ScaleInfo]):
        """Queue each replica's decode of its maps (and, with the ladder,
        its peak count's copy to the host)."""
        cap = self._spec_cap
        items = []
        for r, m, info in zip(self.replicas, maps, infos):
            count = (r._count_to_host(m[0]) if self.adaptive_capacities
                     else None)
            items.append((m, info, r.postprocess(m, info, capacity=cap),
                          count))
        return items, cap

    def _resolve(self, pending) -> PoseResults:
        """Wait for what a dispatched batch's decode depends on: with the
        ladder, the peak counts only (decode again at the rung that fits
        the batch's most peaks if the speculated one was too small, and
        speculate the next batch's rung from it); with the overflow
        fallback, the overflow flags (decode again at ``max_peaks`` if an
        image overflowed). Returns the batch's results."""
        items, cap = pending
        results = [res for _, _, res, _ in items]
        again = None
        if self.adaptive_capacities:
            n = 0
            for _, _, _, (host, ready) in items:
                if ready is not None:
                    ready.synchronize()
                n = max(n, int(host))
            self._spec_cap = self._rung_for(n)
            if n > cap:
                again = self._spec_cap
        elif self.overflow_fallback and any(bool(r.overflow.any())
                                            for r in results):
            again = self.cfg.post.max_peaks
        if again is not None:
            results = [r.postprocess(m, info, capacity=again) for r, (
                m, info, _, _) in zip(self.replicas, items)]
        return self._merge(results)

    # -- entry points -------------------------------------------------------

    def run_batch(self, images, scales: Scales) -> PoseResults:
        """Run one batch.

        Args:
          images: [B, H, W, 3] letterboxed uint8 or normalized float32, or
            packed I420 [B, 3H/2, W] uint8; numpy or torch.
          scales: per-image scale dicts, or a ScaleInfo on the device.

        Returns:
          PoseResults on the (first) device. Without the ladder or the
          overflow fallback the call does not wait for the device; with
          them it waits for the batch's peak count or overflow flag.
        """
        return self._resolve(self._dispatch(images, scales))

    def run_stream(self, batches: Iterable[Optional[Tuple[Any, Scales]]]
                   ) -> Iterator[PoseResults]:
        """Pipelined serving over ``(images, scales)`` items: one
        PoseResults per batch, in order, with one batch in flight: batch
        ``i`` is yielded only after batch ``i + 1`` has been queued, so the
        host's copy and launches of the next batch overlap the device's
        work on this one (the ladder's peak count and the overflow flags
        of batch ``i`` are read only then). A ``None`` item is a flush: the
        batch in flight is yielded at once."""
        pending = None
        for entry in batches:
            if entry is None:
                if pending is not None:
                    yield self._resolve(pending)
                    pending = None
                continue
            item = self._dispatch(*entry)
            if pending is not None:
                yield self._resolve(pending)
            pending = item
        if pending is not None:
            yield self._resolve(pending)

    def run_batch_timed(self, images, scales: Scales
                        ) -> Tuple[PoseResults, Dict[str, float]]:
        """``run_batch`` (without the ladder's or the fallback's second
        decode) with the wall time of each stage, each ended by a
        synchronization of every device: ``transfer_ms`` (frames and
        metadata to the devices), ``model_ms`` (the forward), ``postproc_ms``
        (the decode)."""
        t0 = time.perf_counter()
        placed = [r.place(*shard) for r, shard
                  in zip(self.replicas, self._shards(images, scales))]
        self._sync()
        t1 = time.perf_counter()
        maps = [r.forward(x) for r, (x, _) in zip(self.replicas, placed)]
        self._sync()
        t2 = time.perf_counter()
        results = [r.postprocess(m, info) for r, m, (_, info)
                   in zip(self.replicas, maps, placed)]
        self._sync()
        t3 = time.perf_counter()
        return self._merge(results), {"transfer_ms": (t1 - t0) * 1e3,
                                      "model_ms": (t2 - t1) * 1e3,
                                      "postproc_ms": (t3 - t2) * 1e3}

    @staticmethod
    def results_to_pairs(results: PoseResults, img_paths: Sequence[str],
                         gt_bodys: Optional[Sequence[np.ndarray]] = None,
                         ) -> List[Dict[str, Any]]:
        """Results -> the reference's ``3d_pairs`` items."""
        b2d = results.bodies_2d.cpu().numpy()
        b3d = results.bodies_3d.cpu().numpy()
        rdep = results.root_depth.cpu().numpy()
        counts = results.count.cpu().numpy()
        pairs = []
        for i, path in enumerate(img_paths):
            n = int(counts[i])
            pair = {"pred_2d": b2d[i, :n].tolist(),
                    "pred_3d": b3d[i, :n].tolist(),
                    "root_d": rdep[i, :n].tolist(),
                    "image_path": path}
            if gt_bodys is not None and gt_bodys[i] is not None:
                g = np.asarray(gt_bodys[i])
                pair["gt_3d"] = g[:, :, 4:].tolist()
                pair["gt_2d"] = g[:, :, :4].tolist()
            else:
                pair["gt_3d"] = []
                pair["gt_2d"] = []
            pairs.append(pair)
        return pairs


def image_paths(image_dir: str) -> List[str]:
    """The jpg / png / jpeg files under ``image_dir``, recursively,
    sorted."""
    paths: List[str] = []
    for ext in ("jpg", "png", "jpeg"):
        paths.extend(glob.glob(os.path.join(image_dir, f"**/*.{ext}"),
                               recursive=True))
    return sorted(paths)


def read_frame(path: str) -> np.ndarray:
    """``data.image.imread`` that raises on a missing or unreadable file."""
    img = imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img


def run_labeled_inference(dataset, engine: SMAPInference,
                          mode: str = "generate_result",
                          batch_size: int = 16, root_idx: int = ROOT_IDX,
                          shard: int = 0, num_shards: int = 1,
                          gather: bool = False) -> Dict[str, Any]:
    """Inference over a labeled ``data.datasets.JointDataset`` (the
    ``generate_result`` and ``generate_train`` modes).

    Persons whose ground-truth root has visibility <= 1 are dropped; the
    intrinsics come from the ground-truth rows where they carry them;
    predictions are registered to the ground truth
    (``evaluation.register.register_pred``) before they are written.
    ``generate_train`` keeps one pair per registered person with a root.
    ``shard`` / ``num_shards`` take a contiguous slice of the dataset.
    ``gather=True`` merges the shards of all the processes of the group
    (``parallel.distributed.all_gather_objects``), in rank order, so that
    every rank returns the whole set; a no-op in one process.
    """
    if mode not in ("generate_result", "generate_train"):
        raise ValueError(f"mode {mode!r}")
    result: Dict[str, Any] = {"model_pattern": "MIX", "3d_pairs": []}
    n = len(dataset)
    per = -(-n // num_shards)
    indices = list(range(shard * per, min(n, (shard + 1) * per)))
    # run_stream keeps one batch in flight: the next batch's samples are
    # read and the last one's results registered while it runs.
    meta = collections.deque()

    def batches():
        for start in range(0, len(indices), batch_size):
            idx = indices[start:start + batch_size]
            samples = [dataset.get_eval_sample(i) for i in idx]
            imgs = np.stack([s[0] for s in samples])
            if len(idx) < batch_size:    # pad the tail batch
                imgs = np.concatenate(
                    [imgs, np.zeros((batch_size - len(idx), *imgs.shape[1:]),
                                    imgs.dtype)])
            scales, gt_list = [], []
            for s in samples:
                bodys, scale = s[1], dict(s[3])
                valid = bodys[bodys[:, root_idx, 3] > 1]
                gt_list.append(valid)
                if len(valid) and valid.shape[-1] >= 11:
                    scale.update(f_x=valid[0, 0, 7], f_y=valid[0, 0, 8],
                                 cx=valid[0, 0, 9], cy=valid[0, 0, 10])
                elif len(valid) and valid.shape[-1] >= 8:
                    # Rows 8-10 wide carry only f_x (column 7).
                    scale.update(f_x=valid[0, 0, 7], f_y=valid[0, 0, 7],
                                 cx=scale["img_width"] / 2,
                                 cy=scale["img_height"] / 2)
                else:
                    scale.update(f_x=scale["img_width"],
                                 f_y=scale["img_width"],
                                 cx=scale["img_width"] / 2,
                                 cy=scale["img_height"] / 2)
                scales.append(scale)
            scales += [scales[-1]] * (batch_size - len(idx))
            meta.append((idx, samples, gt_list))
            yield imgs, scales

    for res in engine.run_stream(batches()):
        idx, samples, gt_list = meta.popleft()
        res_np = {k: v.cpu().numpy() for k, v in res._asdict().items()}
        for j in range(len(idx)):
            gt = gt_list[j]
            if len(gt) == 0:
                continue
            m = int(res_np["count"][j])
            new2, new3, newd = register_pred(
                res_np["bodies_2d"][j, :m], res_np["bodies_3d"][j, :m],
                res_np["root_depth"][j, :m], gt, root_idx=root_idx)
            if mode == "generate_train":
                for p in range(len(new3)):
                    if new3[p, root_idx, 3] != 0:
                        result["3d_pairs"].append({
                            "pred_3d": new3[p].tolist(),
                            "pred_2d": new2[p].tolist(),
                            "gt_3d": gt[p][:, 4:7].tolist(),
                            "root_d": float(newd[p])})
            else:
                result["3d_pairs"].append({
                    "pred_2d": new2.tolist(), "pred_3d": new3.tolist(),
                    "root_d": newd.tolist(), "image_path": samples[j][2],
                    "gt_3d": gt[:, :, 4:].tolist(),
                    "gt_2d": gt[:, :, :4].tolist()})
    if gather:
        shards = all_gather_objects(result["3d_pairs"])
        result["3d_pairs"] = [p for s in shards for p in s]
    return result


def run_inference(image_dir: str, state_dict: Mapping[str, torch.Tensor],
                  cfg: Config = Config(),
                  refine_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                  do_flip: bool = False, batch_size: int = 16,
                  output_json: Optional[str] = None, device="cuda",
                  quantized=False, fuse_stem: bool = False,
                  fuse_bottleneck: bool = False, calibration_batches=None,
                  adaptive_capacities: Optional[Sequence[int]] = None,
                  data_parallel: bool = False) -> Dict[str, Any]:
    """Inference over a directory of images (jpg / png / jpeg, recursive;
    ``data.image.imread``, no OpenCV): letterbox on the host,
    run the pipeline, return (and optionally write) the reference's result
    JSON. ``quantized``, ``calibration_batches``, ``fuse_stem``,
    ``fuse_bottleneck`` and ``adaptive_capacities`` go to
    ``SMAPInference``; ``data_parallel`` shards each batch over every card
    of this host (``parallel.mesh.local_mesh``; ``batch_size`` must divide
    by their count)."""
    paths = image_paths(image_dir)
    devices = None
    if data_parallel:
        devices = mesh.local_mesh(device)
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} must be divisible by "
                             f"the {len(devices)} local devices")
    engine = SMAPInference(state_dict, cfg, refine_state_dict, do_flip,
                           device=device, quantized=quantized,
                           fuse_stem=fuse_stem,
                           fuse_bottleneck=fuse_bottleneck,
                           calibration_batches=calibration_batches,
                           adaptive_capacities=adaptive_capacities,
                           devices=devices)
    result: Dict[str, Any] = {"model_pattern": "MIX", "3d_pairs": []}
    chunks = collections.deque()

    def batches():
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            imgs, scales = [], []
            for p in chunk:
                img, scale = letterbox_image(read_frame(p), cfg.input_shape)
                imgs.append(img)
                scales.append(scale)
            # Pad the tail batch to the batch size.
            pad = batch_size - len(chunk)
            imgs.extend([np.zeros_like(imgs[0])] * pad)
            scales.extend([scales[-1]] * pad)
            chunks.append(chunk)
            yield np.stack(imgs), scales

    for res in engine.run_stream(batches()):
        chunk = chunks.popleft()
        names = [os.path.relpath(p, image_dir) for p in chunk]
        result["3d_pairs"].extend(engine.results_to_pairs(
            PoseResults(*(r[:len(chunk)] for r in res)), names))
    if output_json:
        os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(result, f)
    return result
