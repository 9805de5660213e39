"""COCO person-keypoints -> unified mpi15 annotation JSON (counterpart of
``smap_tpu/data/coco_convert.py``; numpy and json only).

Equivalent of the reference converter (``lib/preprocess/create_annot.py``
in zju3dv/SMAP): maps the 17 COCO keypoints onto the mpi15 skeleton,
synthesizing pelvis (mid-hip) and neck (shoulder midpoint shifted 18.5%
toward the head), leaving head-top unlabeled, with fake intrinsics
fx=fy=img_width and principal point at the image center. Output rows are
the unified 11-column format [x, y, Z, v, X, Y, Z, fx, fy, cx, cy]
(lib/preprocess/data_format.md).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

# COCO keypoint indices.
COCO_L_SHO, COCO_R_SHO = 5, 6
COCO_L_ELB, COCO_R_ELB = 7, 8
COCO_L_WRI, COCO_R_WRI = 9, 10
COCO_L_HIP, COCO_R_HIP = 11, 12
COCO_L_KNE, COCO_R_KNE = 13, 14
COCO_L_ANK, COCO_R_ANK = 15, 16

# mpi15 index -> COCO index for directly-mapped joints.
DIRECT_MAP = {
    3: COCO_L_SHO, 4: COCO_L_ELB, 5: COCO_L_WRI,
    6: COCO_L_HIP, 7: COCO_L_KNE, 8: COCO_L_ANK,
    9: COCO_R_SHO, 10: COCO_R_ELB, 11: COCO_R_WRI,
    12: COCO_R_HIP, 13: COCO_R_KNE, 14: COCO_R_ANK,
}

NECK_LIFT = 0.185  # create_annot.py: neck = shoulders + 0.185*(sho - hip)


def coco_person_to_mpi15(kpts: np.ndarray, img_w: int, img_h: int
                         ) -> np.ndarray:
    """[17, 3] COCO (x, y, v) -> [15, 11] unified rows; an unusable person
    has no visible joint (``convert_coco`` drops it)."""
    out = np.zeros((15, 11), np.float64)
    for mpi_idx, coco_idx in DIRECT_MAP.items():
        x, y, v = kpts[coco_idx]
        if v > 0:
            out[mpi_idx, :2] = (x, y)
            out[mpi_idx, 3] = v
    lh, rh = kpts[COCO_L_HIP], kpts[COCO_R_HIP]
    ls, rs = kpts[COCO_L_SHO], kpts[COCO_R_SHO]
    if lh[2] > 0 and rh[2] > 0:
        out[2, :2] = (lh[:2] + rh[:2]) / 2          # pelvis
        out[2, 3] = min(lh[2], rh[2])
    if ls[2] > 0 and rs[2] > 0:
        sho = (ls[:2] + rs[:2]) / 2
        if out[2, 3] > 0:
            neck = sho + NECK_LIFT * (sho - out[2, :2])
        else:
            neck = sho
        out[0, :2] = neck
        out[0, 3] = min(ls[2], rs[2])
    # head-top (index 1) stays unlabeled for COCO.
    out[:, 7] = img_w       # fx
    out[:, 8] = img_w       # fy
    out[:, 9] = img_w / 2   # cx
    out[:, 10] = img_h / 2  # cy
    return out


def convert_coco(coco_json: str, out_json: str,
                 img_prefix: str = "images/train2017") -> int:
    """Convert a COCO person_keypoints annotation file; returns #records."""
    with open(coco_json) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    by_image: Dict[int, List[np.ndarray]] = {}
    for ann in coco["annotations"]:
        if ann.get("num_keypoints", 0) <= 0 or ann.get("iscrowd", 0):
            continue
        im = images[ann["image_id"]]
        kpts = np.asarray(ann["keypoints"], np.float64).reshape(17, 3)
        person = coco_person_to_mpi15(kpts, im["width"], im["height"])
        if person[:, 3].sum() == 0:
            continue
        by_image.setdefault(ann["image_id"], []).append(person)

    root = []
    for image_id, persons in by_image.items():
        im = images[image_id]
        root.append({
            "dataset": "COCO",
            "img_paths": f"{img_prefix}/{im['file_name']}",
            "img_width": im["width"], "img_height": im["height"],
            "isValidation": 0,
            "bodys": [p.tolist() for p in persons]})
    with open(out_json, "w") as f:
        json.dump({"root": root}, f)
    return len(root)
