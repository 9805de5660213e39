"""Result viewer: each image beside a 3D plot of its predicted skeletons
(counterpart of ``smap_tpu/utils/visualize.py``; the reference's
``lib/visualize/vis.py:15-46`` in zju3dv/SMAP).

Reads the image with ``data.image.imread`` (PNG or JPEG, no OpenCV)
and draws with matplotlib, imported when a figure is drawn: the
port needs it for this viewer only.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from smap_tpu_torch.config import PAF_VECTOR
from smap_tpu_torch.data.image import imread

COLORS = ["r", "g", "b", "c", "m", "y", "k", "orange"]


def plot_pair(pair: dict, image_root: str = "",
              save_path: Optional[str] = None):
    """One ``3d_pairs`` item: the image (blank when it is missing) and its
    ``pred_3d`` skeletons (X right, Z the depth, -Y up). Saved to
    ``save_path`` at 100 dpi, else shown."""
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 6))
    ax_img = fig.add_subplot(1, 2, 1)
    img_path = os.path.join(image_root, pair.get("image_path", ""))
    img = imread(img_path) if os.path.isfile(img_path) else None
    if img is not None:
        ax_img.imshow(img[:, :, ::-1])
    ax_img.axis("off")

    ax3d = fig.add_subplot(1, 2, 2, projection="3d")
    for pi, person in enumerate(np.asarray(pair["pred_3d"], float)):
        color = COLORS[pi % len(COLORS)]
        for a, b in PAF_VECTOR:
            if person[a, 3] > 0 and person[b, 3] > 0:
                ax3d.plot([person[a, 0], person[b, 0]],
                          [person[a, 2], person[b, 2]],
                          [-person[a, 1], -person[b, 1]], c=color)
        vis = person[:, 3] > 0
        ax3d.scatter(person[vis, 0], person[vis, 2], -person[vis, 1],
                     c=color, s=8)
    ax3d.set_xlabel("X")
    ax3d.set_ylabel("Z (depth)")
    ax3d.set_zlabel("-Y")
    if save_path:
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig


def visualize_results(result_json: str, image_root: str = "",
                      out_dir: Optional[str] = None, limit: int = 0) -> None:
    """Every item of a result JSON (the first ``limit`` when > 0), saved
    as ``<out_dir>/vis_<i:05d>.png``, or shown one by one without
    ``out_dir``."""
    with open(result_json) as f:
        result = json.load(f)
    pairs = result["3d_pairs"]
    if limit:
        pairs = pairs[:limit]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for i, pair in enumerate(pairs):
        save = (os.path.join(out_dir, f"vis_{i:05d}.png")
                if out_dir else None)
        plot_pair(pair, image_root, save)
