"""Configuration of the PyTorch port.

``smap_tpu/config.py`` again: the same skeleton constants and the same
field names and defaults for the model, post-processing, training,
RefineNet and top-level bundles. It is its own module, not an import of
``smap_tpu.config``, so that importing the port loads nothing of the JAX
package (``tests/test_torch_imports.py`` checks that, and
``tests/test_torch_convert.py::test_config_mirrors_jax_config`` checks
that every value here equals its counterpart there). The TPU-only knobs
(``paf_impl``, ``paf_parts``, ``assoc_impl``, ``flatten_opt``) are left
out, as are values nothing in the port reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

NUM_JOINTS = 15

FLIP_ORDER: Tuple[int, ...] = (0, 1, 2, 9, 10, 11, 12, 13, 14, 3, 4, 5, 6, 7, 8)

PAF_VECTOR: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, 2),
    (0, 9), (9, 10), (10, 11),
    (0, 3), (3, 4), (4, 5),
    (2, 12), (12, 13), (13, 14),
    (2, 6), (6, 7), (7, 8),
)

NUM_LIMBS = 14

PAF_FLIP_CHANNEL: Tuple[int, ...] = (
    0, 1, 2, 3, 10, 11, 12, 13, 14, 15, 4, 5, 6, 7, 8, 9,
    22, 23, 24, 25, 26, 27, 16, 17, 18, 19, 20, 21,
)

ROOT_IDX = 2

BONE_LENGTHS: Tuple[float, ...] = (
    26.42178982, 48.36980909,
    14.88291009, 31.28002332, 23.915707,
    14.97674918, 31.28002549, 23.91570732,
    12.4644364, 48.26604433, 39.03553194,
    12.4644364, 48.19076948, 39.03553252,
)

INPUT_SHAPE: Tuple[int, int] = (512, 832)  # (height, width)
STRIDE = 4
OUTPUT_SHAPE: Tuple[int, int] = (INPUT_SHAPE[0] // STRIDE,
                                 INPUT_SHAPE[1] // STRIDE)

PIXEL_MEANS_BGR: Tuple[float, float, float] = (0.406, 0.456, 0.485)
PIXEL_STDS_BGR: Tuple[float, float, float] = (0.225, 0.224, 0.229)

# The values of ModelConfig.quantized.
QUANT_MODES: Tuple[Any, ...] = (False, True, "static", "folded")


@dataclasses.dataclass(frozen=True)
class SkeletonConfig:
    """The mpi15 skeleton (``smap_tpu.config.SkeletonConfig``)."""

    num_joints: int = NUM_JOINTS
    num_limbs: int = NUM_LIMBS
    root_idx: int = ROOT_IDX
    paf_vector: Tuple[Tuple[int, int], ...] = PAF_VECTOR
    flip_order: Tuple[int, ...] = FLIP_ORDER
    paf_flip_channel: Tuple[int, ...] = PAF_FLIP_CHANNEL
    bone_lengths: Tuple[float, ...] = BONE_LENGTHS

    @property
    def num_2d_channels(self) -> int:
        """Keypoint heatmaps + x/y PAF channels (43 for mpi15)."""
        return self.num_joints + 2 * self.num_limbs


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SMAP backbone hyper-parameters (``smap_tpu.config.ModelConfig``)."""

    stage_num: int = 3
    upsample_channels: int = 256
    trunk_width: int = 64
    num_joints: int = NUM_JOINTS
    num_limbs: int = NUM_LIMBS
    output_shape: Tuple[int, int] = OUTPUT_SHAPE
    # "bfloat16" or "float32": the dtype the forward computes in. Outputs
    # are float32 either way.
    compute_dtype: str = "bfloat16"
    # False; "folded": BatchNorm folded into each conv's kernel and bias
    # (models.quantize.fold_bn_state_dict), the serving mode of the fused
    # stem and bottleneck kernels; True: int8 convolutions with per-output-
    # channel int8 weights (BatchNorm folded, models.quantize.
    # quantize_state_dict) and a per-tensor activation scale taken from
    # each input; "static": the same with frozen activation scales
    # (models.quantize.calibrate_activation_scales).
    quantized: Any = False
    # Training: recompute each stage in the backward pass
    # (torch.utils.checkpoint), trading compute for activation memory.
    remat: bool = False

    def __post_init__(self):
        if self.quantized not in QUANT_MODES:
            raise ValueError(f"ModelConfig.quantized={self.quantized!r}: "
                             f"expected one of {QUANT_MODES}")

    @property
    def kpt_paf_channels(self) -> int:
        return self.num_joints + 2 * self.num_limbs


@dataclasses.dataclass(frozen=True)
class PostProcessConfig:
    """Peak extraction + association constants
    (``smap_tpu.config.PostProcessConfig``)."""

    max_peaks: int = 127
    # Candidate capacity of PAF scoring and association.
    assoc_peaks: int = 40
    nms_threshold: float = 0.2
    nms_offset: float = 0.5
    inter_threshold: float = 0.05
    inter_min_above_threshold: float = 0.95
    default_nms_threshold: float = 0.1
    num_line_samples: int = 25
    num_depth_samples: int = 10
    ds_scale: float = float(STRIDE)
    bone_factor: float = 1.2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Solver, loss and label settings (``smap_tpu.config.TrainConfig``)."""

    img_per_device: int = 2
    base_lr: float = 2e-4
    weight_decay: float = 8e-6
    max_iter: int = 192_000
    warmup_iters: int = 2400
    warmup_factor: float = 0.1
    checkpoint_period: int = 4800
    # The schedule is quoted for 8 devices; iteration counts rescale by
    # nominal_devices / devices and the learning rate by devices.
    nominal_devices: int = 8
    ohkm: bool = True
    topk: int = 8
    coarse_to_fine: bool = True
    with_mds: bool = True
    max_people: int = 20
    # One odd Gaussian size per label pyramid level, coarse to fine.
    gaussian_kernels: Tuple[Tuple[int, int], ...] = (
        (15, 15), (11, 11), (9, 9), (7, 7), (5, 5))
    paf_line_width: float = 1.0
    # Host augmentation (data.augmentation).
    center_trans_max: float = 40.0
    rotate_max_deg: float = 10.0
    flip_prob: float = 0.5
    scale_min: float = 0.8
    scale_max: float = 1.1
    # One linear warp for rotate + scale + crop + flip in place of the
    # cubic rotation and the linear resize (data.augmentation).
    composed_warp: bool = False


@dataclasses.dataclass(frozen=True)
class RefineNetConfig:
    """RefineNet MLP and its solver (``smap_tpu.config.RefineNetConfig``)."""

    in_dim: int = 75
    out_dim: int = 45
    hidden: Tuple[int, ...] = (160, 256, 256, 128)
    batch_size: int = 1024
    base_lr: float = 0.08
    num_epochs: int = 200
    lr_step: int = 30
    lr_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config bundle."""

    skeleton: SkeletonConfig = SkeletonConfig()
    model: ModelConfig = ModelConfig()
    post: PostProcessConfig = PostProcessConfig()
    train: TrainConfig = TrainConfig()
    refine: RefineNetConfig = RefineNetConfig()
    input_shape: Tuple[int, int] = INPUT_SHAPE
    output_shape: Tuple[int, int] = OUTPUT_SHAPE
    stride: int = STRIDE


def default_config() -> Config:
    return Config()
