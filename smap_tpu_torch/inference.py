"""Inference API: frames -> multi-person absolute 3D poses (counterpart of
``smap_tpu/inference.py``).

``SMAPInference`` runs the SMAP forward (optionally with flip test-time
augmentation), the batched post-processing and the optional RefineNet lift
on one device; the host only moves frames in and results out.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import os
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from smap_tpu_torch.config import (FLIP_ORDER, PAF_FLIP_CHANNEL, ROOT_IDX,
                                   Config)
from smap_tpu_torch.data.preprocess import prepare_images
from smap_tpu_torch.models.layers import to_compute_dtype
from smap_tpu_torch.models.quantize import fold_bn_state_dict
from smap_tpu_torch.models.refinenet import RefineNet
from smap_tpu_torch.models.smap import SMAP
from smap_tpu_torch.ops.postprocess import (PoseResults, ScaleInfo,
                                            flip_tta_merge, postprocess_batch)
from smap_tpu_torch.ops.refine import apply_refinement, build_refine_input
from smap_tpu_torch.runtime import compute_dtype, get_device

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Scales = Union[ScaleInfo, Sequence[Mapping[str, float]]]


class SMAPInference:
    """Batched inference pipeline on one device.

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
      quantized: ``"folded"`` serves with BatchNorm folded into the conv
        weights, folded once here (``models.quantize.fold_bn_state_dict``)
        unless ``cfg.model.quantized`` is already ``"folded"``, in which
        case ``state_dict`` is taken as folded. The int8 modes of the JAX
        package are not ported (``ModelConfig`` raises on them).
      fuse_stem, fuse_bottleneck: on the folded model, run the stem and
        the eligible bottlenecks as the fused kernels (``SMAP``).
    """

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 cfg: Config = Config(),
                 refine_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 do_flip: bool = False, device="cuda", quantized=False,
                 fuse_stem: bool = False, fuse_bottleneck: bool = False):
        if quantized and not cfg.model.quantized:
            state_dict = fold_bn_state_dict(state_dict)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, quantized=quantized))
        self.cfg = cfg
        self.device = get_device(device)
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
    def postprocess(self, maps: Maps, info: ScaleInfo,
                    plain: bool = False) -> PoseResults:
        """Decode NHWC maps (``plain``: with the kernels' plain versions)."""
        net_h, net_w = self.cfg.input_shape
        results = postprocess_batch(*maps, info, self.cfg.post,
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
        """Frames and metadata onto the device. Host frames go through
        pinned memory with a non-blocking copy, so the host does not wait
        for the work queued before them."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.device != self.device:
            if self.device.type == "cuda" and images.device.type == "cpu":
                images = images.pin_memory()
            images = images.to(self.device, non_blocking=True)
        return images, self.scale_info(scales)

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

    # -- entry points -------------------------------------------------------

    def run_batch(self, images, scales: Scales) -> PoseResults:
        """Run one batch.

        Args:
          images: [B, H, W, 3] letterboxed uint8 or normalized float32, or
            packed I420 [B, 3H/2, W] uint8; numpy or torch.
          scales: per-image scale dicts, or a ScaleInfo on the device.

        Returns:
          PoseResults on the device (the call does not wait for it).
        """
        images, info = self.place(images, scales)
        return self.postprocess(self.forward(images), info)

    def run_stream(self, batches: Iterable[Optional[Tuple[Any, Scales]]]
                   ) -> Iterator[PoseResults]:
        """Pipelined serving over ``(images, scales)`` items: one
        PoseResults per batch, in order, with one batch in flight: batch
        ``i`` is yielded only after batch ``i + 1`` has been queued, so the
        host's copy and launches of the next batch overlap the device's
        work on this one. A ``None`` item is a flush: the batch in flight
        is yielded at once."""
        pending = None
        for entry in batches:
            if entry is None:
                if pending is not None:
                    yield pending
                    pending = None
                continue
            item = self.run_batch(*entry)
            if pending is not None:
                yield pending
            pending = item
        if pending is not None:
            yield pending

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


def run_inference(image_dir: str, state_dict: Mapping[str, torch.Tensor],
                  cfg: Config = Config(),
                  refine_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                  do_flip: bool = False, batch_size: int = 16,
                  output_json: Optional[str] = None, device="cuda",
                  quantized=False, fuse_stem: bool = False,
                  fuse_bottleneck: bool = False) -> Dict[str, Any]:
    """Inference over a directory of images (jpg / png / jpeg, recursive):
    letterbox on the host (OpenCV), run the pipeline, return (and
    optionally write) the reference's result JSON. ``quantized``,
    ``fuse_stem`` and ``fuse_bottleneck`` go to ``SMAPInference``."""
    from smap_tpu_torch.data.preprocess import letterbox_image

    paths: List[str] = []
    for ext in ("jpg", "png", "jpeg"):
        paths.extend(glob.glob(os.path.join(image_dir, f"**/*.{ext}"),
                               recursive=True))
    paths.sort()
    engine = SMAPInference(state_dict, cfg, refine_state_dict, do_flip,
                           device=device, quantized=quantized,
                           fuse_stem=fuse_stem,
                           fuse_bottleneck=fuse_bottleneck)
    result: Dict[str, Any] = {"model_pattern": "MIX", "3d_pairs": []}
    chunks = collections.deque()

    def batches():
        import cv2

        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            imgs, scales = [], []
            for p in chunk:
                img, scale = letterbox_image(cv2.imread(p, cv2.IMREAD_COLOR),
                                             cfg.input_shape)
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
