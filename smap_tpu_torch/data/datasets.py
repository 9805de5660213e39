"""Datasets over the unified annotation JSON and the training batch
iterator (counterpart of ``smap_tpu/data/datasets.py``; numpy on the
host, PNG and JPEG frames read with no OpenCV).

* ``JointDataset`` reads the unified JSON (rows ``[x, y, Z, v, X, Y, Z,
  fx, fy, cx, cy]``), augments on the host (``data.augmentation``),
  normalizes a train sample through the native library (``data.native``,
  as the JAX package does) and returns fixed-capacity joint tables; the
  labels are rendered on the device inside the train step.
* ``train_iterator``: epoch-seeded shuffles, padded to a multiple of the
  shard count, strided per shard, indexed by iteration so that a resume
  is exact; a thread prefetches batches, and ``num_workers`` processes
  decode and augment the samples.
* ``P2PDataset`` builds RefineNet (input, target) pairs from a
  ``generate_train`` result JSON.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os.path as osp
import queue
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from smap_tpu_torch.config import NUM_JOINTS, ROOT_IDX, Config
from smap_tpu_torch.data.augmentation import augment_sample
from smap_tpu_torch.data.image import imread
from smap_tpu_torch.data.native import normalize_native
from smap_tpu_torch.data.preprocess import normalize_image


def load_annotations(json_path: str) -> List[dict]:
    with open(json_path) as f:
        return json.load(f)["root"]


class JointDataset:
    """Mixed 2D/3D pose dataset over annotation records.

    Args:
      records: annotation records (each with dataset, img_paths,
        img_height, img_width, isValidation, bodys).
      root_paths: dataset name (upper case) -> image root directory.
      stage: 'train' | 'generation' | 'test' ('test' keeps the validation
        records, the others the rest).
    """

    def __init__(self, records: Sequence[dict], root_paths: Dict[str, str],
                 cfg: Config = Config(), stage: str = "train",
                 with_augmentation: bool = False, with_mds: bool = True):
        if stage not in ("train", "test", "generation"):
            raise ValueError(f"stage {stage!r}")
        self.cfg = cfg
        self.stage = stage
        self.with_augmentation = with_augmentation
        self.with_mds = with_mds
        self.root_paths = root_paths
        want_val = stage == "test"
        self.records = [r for r in records
                        if bool(r.get("isValidation", 0)) == want_val]

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, rec: dict) -> np.ndarray:
        path = osp.join(self.root_paths[rec["dataset"].upper()],
                        rec["img_paths"])
        img = imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def get_train_sample(self, index: int, rng: np.random.RandomState):
        """(image f32 normalized [H, W, 3], bodys [P, 15, 11], valids [57],
        scale) with P = cfg.train.max_people."""
        cfg = self.cfg
        rec = self.records[index]
        img = self._load_image(rec)
        bodys = np.asarray(rec["bodys"], np.float64)
        is_coco = rec["dataset"].upper() == "COCO"

        img, bodys, scale = augment_sample(
            img, bodys, rng, cfg.train, cfg.input_shape, is_coco,
            self.with_augmentation)

        valids = np.ones((57,), np.float32)
        if is_coco:
            # COCO has no head-top and no depth labels.
            valids[1] = 0
            valids[NUM_JOINTS] = 0
            valids[NUM_JOINTS + 1] = 0
            valids[NUM_JOINTS + 28:] = 0

        P = cfg.train.max_people
        table = np.zeros((P, NUM_JOINTS, 11), np.float32)
        n = min(len(bodys), P)
        if n:
            cols = min(bodys.shape[-1], 11)
            table[:n, :, :cols] = bodys[:n, :, :cols]
        return normalize_native(img), table, valids, np.float32(scale)

    def get_eval_sample(self, index: int):
        """Test / generation sample: (image f32 normalized, bodys [P, 15,
        C] float64, image path, scale dict), letterboxed without
        augmentation."""
        cfg = self.cfg
        rec = self.records[index]
        img = self._load_image(rec)
        bodys = np.asarray(rec["bodys"], np.float64)
        net_h, net_w = cfg.input_shape
        rs = np.random.RandomState(0)  # no randomness on the eval path
        img2, bodys2, scale_v = augment_sample(
            img, bodys, rs, cfg.train, cfg.input_shape, False, False)
        P = cfg.train.max_people
        width = bodys2.shape[-1] if len(bodys2) else 11
        table = np.zeros((P, NUM_JOINTS, width), np.float64)
        table[:min(len(bodys2), P)] = bodys2[:P]
        scale = {"scale": scale_v,
                 "img_width": rec["img_width"],
                 "img_height": rec["img_height"],
                 "net_width": net_w, "net_height": net_h}
        return normalize_image(img2), table, rec["img_paths"], scale


class P2PDataset:
    """``3d_pairs`` of a result JSON: each pair's predicted 2D and 3D pose
    and its ground-truth 3D pose."""

    def __init__(self, json_path: str, root_idx: int = ROOT_IDX):
        with open(json_path) as f:
            data = json.load(f)
        self.pairs = data["3d_pairs"]
        self.root_idx = root_idx

    def __len__(self) -> int:
        return len(self.pairs)

    def get_sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input [75], target [45]) root-relative encodings: the root's
        2D position and 3D position, then each other joint with a predicted
        depth relative to the root (zeros where it has none)."""
        pair = self.pairs[index]
        pred_3d = np.asarray(pair["pred_3d"], np.float32)
        pred_2d = np.asarray(pair["pred_2d"], np.float32)
        gt_3d = np.asarray(pair["gt_3d"], np.float32)
        r = self.root_idx
        inp = np.zeros((NUM_JOINTS, 5), np.float32)
        inp[r, :2] = pred_2d[r, :2]
        inp[r, 2:] = pred_3d[r, :3]
        for j in range(NUM_JOINTS):
            if j != r and pred_3d[j, 3] > 0:
                inp[j, :2] = pred_2d[j, :2] - pred_2d[r, :2]
                inp[j, 2:] = pred_3d[j, :3] - pred_3d[r, :3]
        gt = gt_3d[:, :3] - gt_3d[r:r + 1, :3]
        return inp.reshape(-1), gt.reshape(-1)


def epoch_indices(n: int, epoch: int, shuffle: bool, num_shards: int,
                  shard: int, seed: int = 0) -> np.ndarray:
    """One epoch's sample order for ``shard``: shuffled from ``seed +
    epoch``, padded to a multiple of ``num_shards`` with its own head,
    then every ``num_shards``-th index from ``shard``."""
    if shuffle:
        g = np.random.RandomState(seed + epoch)
        idx = g.permutation(n)
    else:
        idx = np.arange(n)
    total = -(-n // num_shards) * num_shards
    idx = np.concatenate([idx, idx[:total - n]])
    return idx[shard::num_shards]


# A worker process's dataset, set once by the pool's initializer.
_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_sample(args):
    index, sample_seed = args
    rng = np.random.RandomState(sample_seed)
    return _WORKER_DATASET.get_train_sample(index, rng)


def _sample_seed(seed: int, it: int, k: int, shard: int) -> int:
    """The seed of sample ``k`` of iteration ``it``: each sample's draws
    depend on it alone, so any worker count gives the same batches."""
    return (seed * 7919 + it * 131 + k * 31 + shard) % (2 ** 31)


def train_iterator(dataset: JointDataset, batch_size: int, max_iter: int,
                   start_iter: int = 0, seed: int = 0, num_shards: int = 1,
                   shard: int = 0, prefetch: int = 2,
                   num_workers: int = 0) -> Iterator:
    """``(iteration, TrainBatch)`` from ``start_iter`` to ``max_iter``,
    re-shuffled each epoch, the batch of numpy arrays (images normalized
    float32). A thread assembles up to ``prefetch`` batches ahead; with
    ``num_workers > 0`` the samples are decoded and augmented in a pool of
    that many processes, started with ``spawn``: they import only numpy,
    the dataset and torch's CPU side, never touch CUDA, and inherit no
    thread of this process. Closing the iterator stops the thread and the
    pool; an error in either is raised here."""
    from smap_tpu_torch.train.step import TrainBatch

    n = len(dataset)
    per_epoch = max(len(epoch_indices(n, 0, True, num_shards, shard))
                    // batch_size, 1)
    pool = None
    if num_workers > 0:
        pool = mp.get_context("spawn").Pool(
            num_workers, initializer=_worker_init, initargs=(dataset,))
    else:
        _worker_init(dataset)
    stop = threading.Event()
    out_q: queue.Queue = queue.Queue(maxsize=prefetch)

    def make_batch(it, order, offset):
        jobs = [(int(order[offset + k]), _sample_seed(seed, it, k, shard))
                for k in range(batch_size)]
        if pool is not None:
            samples = pool.map(_worker_sample, jobs)
        else:
            samples = [_worker_sample(job) for job in jobs]
        imgs, bodys, valids, scales = zip(*samples)
        return TrainBatch(images=np.stack(imgs), bodys=np.stack(bodys),
                          valids=np.stack(valids),
                          scales=np.asarray(scales, np.float32))

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            it = start_iter
            while it < max_iter:
                epoch = it // per_epoch
                order = epoch_indices(n, epoch, True, num_shards, shard,
                                      seed)
                offset = (it % per_epoch) * batch_size
                while offset + batch_size <= len(order) and it < max_iter:
                    if not put((it, make_batch(it, order, offset))):
                        return
                    it += 1
                    offset += batch_size
            put(None)
        except BaseException as e:   # handed to the consumer, raised there
            put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
        if pool is not None:
            pool.terminate()
            pool.join()
