"""Frozen configuration dataclasses and presets for the PyTorch port.

The field names, defaults and presets are those of ``x_detector_tpu.config``
(the JAX package's preset tree). They are restated here so that the port
imports nothing of the JAX package on a machine that has no JAX;
``tests/test_torch_port_hygiene.py`` holds the two trees field-for-field
equal. Every function of the port reads its config by attribute only, so it
accepts the JAX package's config objects as well.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOC_CLASSES: Tuple[str, ...] = (
    "background",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
NUM_VOC_CLASSES = len(VOC_CLASSES)  # 21 including background

# Prior-box encode/decode variances (SSD lineage).
PRIOR_SCALING: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """One stride-16 RPN grid, 5 scales x 3 aspect ratios per cell."""
    stride: int = 16
    scales: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclasses.dataclass(frozen=True)
class SSDAnchorConfig:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    scale_min: float = 0.10
    scale_max: float = 0.90
    ratios: Tuple[float, ...] = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)

    @property
    def num_layers(self) -> int:
        return len(self.strides)

    @property
    def anchors_per_cell(self) -> int:
        return len(self.ratios) + 1


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    iou_threshold: float = 0.45
    score_threshold: float = 0.01
    max_output: int = 200
    fast_mode: bool = False
    approx_prefilter: bool = False


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Static RPN proposal stage: top-``pre_nms_topk`` by score, NMS at
    ``nms_threshold``, padded to exactly ``post_nms_topk`` outputs."""
    pre_nms_topk: int = 6000
    post_nms_topk: int = 1000
    pre_nms_topk_eval: int = 1000
    post_nms_topk_eval: int = 512
    nms_threshold: float = 0.7
    min_size: float = 4.0  # pixels; degenerate-proposal filter
    fast_nms: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "lighthead_resnet50"
    backbone: str = "resnet50"            # "resnet50" | "xception_lite"
    family: str = "lighthead"             # "lighthead" | "ssd"
    backbone_stages: Optional[Tuple[int, ...]] = None
    backbone_widths: Optional[Tuple[int, ...]] = None
    backbone_remat_stages: int = 0
    backbone_quant: Optional[str] = None
    # Route the stride-1 separable blocks of Xception-lite through the fused
    # dw3x3 -> 1x1 -> folded BN -> ReLU kernel (inference only).
    backbone_fused_sepconv: bool = False
    num_classes: int = NUM_VOC_CLASSES
    image_size: int = 800
    thin_channels: int = 490              # 10 * 7 * 7
    large_sep_kernel: int = 15
    large_sep_mid: int = 256
    roi_grid: int = 7
    rpn_mid: int = 256
    head_dim: int = 2048
    class_agnostic_box: bool = True
    fpn_fusion: bool = False
    anchors: AnchorConfig = AnchorConfig()
    ssd_anchors: SSDAnchorConfig = SSDAnchorConfig()
    proposals: ProposalConfig = ProposalConfig()
    nms: NMSConfig = NMSConfig()
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


def check_backbone_quant(mode: Optional[str]) -> Optional[str]:
    """``ModelConfig.backbone_quant``, checked: None (the float backbone),
    "calibrate" (record each backbone conv input's abs-max), "calibrate:p<pct>"
    (its pct-th percentile instead, 0 < pct < 100), "int8" (the int8
    backbone) or "act8" (the training probe: float convs whose backward
    reads an int8 copy of the activation)."""
    if mode is None or mode in ("calibrate", "int8", "act8"):
        return mode
    if isinstance(mode, str) and mode.startswith("calibrate:p"):
        pct = float(mode.split(":p", 1)[1])
        if 0.0 < pct < 100.0:
            return mode
    raise ValueError(f"backbone_quant {mode!r}: expected None, 'calibrate',"
                     f" 'calibrate:p<pct>' (0 < pct < 100), 'int8' or "
                     f"'act8'")


def calibration_percentile(mode: str) -> Optional[float]:
    """The percentile of "calibrate:p<pct>", None for the abs-max."""
    return float(mode.split(":p", 1)[1]) if ":p" in mode else None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: int = 800
    max_gt_boxes: int = 100
    include_difficult: bool = False
    letterbox: bool = False
    min_object_covered: float = 0.25
    box_keep_coverage: float = 0.25
    aspect_ratio_range: Tuple[float, float] = (0.5, 2.0)
    area_range: Tuple[float, float] = (0.1, 1.0)
    crop_attempts: int = 50
    crop_sampler: str = "tf"
    brightness_max_delta: float = 32.0 / 255.0
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    saturation_range: Tuple[float, float] = (0.5, 1.5)
    hue_max_delta: float = 0.2
    pixel_means: Tuple[float, float, float] = (123.68, 116.779, 103.939)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    learning_rate: float = 1e-3
    lr_boundaries: Tuple[int, ...] = (80000, 100000)
    lr_decays: Tuple[float, ...] = (1.0, 0.1, 0.01)
    warmup_steps: int = 500
    momentum: float = 0.9
    weight_decay: float = 1e-4
    total_steps: int = 120000
    rpn_batch_size: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    ohem_topk: int = 256
    roi_fg_iou: float = 0.5
    roi_bg_iou_hi: float = 0.5
    roi_bg_iou_lo: float = 0.0
    neg_pos_ratio: float = 3.0
    ssd_match_iou: float = 0.5
    ema_decay: float = 0.0
    grad_accum_steps: int = 1
    checkpoint_every: int = 1000
    keep_checkpoints: int = 5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()


def lighthead_resnet50(image_size: int = 800) -> ExperimentConfig:
    """BASELINE configs 1/4/5: Light-Head R-CNN, ResNet-50 backbone."""
    return ExperimentConfig(
        model=ModelConfig(name="lighthead_resnet50", backbone="resnet50",
                          family="lighthead", image_size=image_size),
        data=DataConfig(image_size=image_size, letterbox=True),
        train=TrainConfig(batch_size=8),
    )


def lighthead_xception(image_size: int = 800) -> ExperimentConfig:
    """BASELINE config 3: Light-Head R-CNN, Xception-lite backbone."""
    return ExperimentConfig(
        model=ModelConfig(name="lighthead_xception", backbone="xception_lite",
                          family="lighthead", image_size=image_size,
                          large_sep_mid=64),
        data=DataConfig(image_size=image_size, letterbox=True),
        train=TrainConfig(batch_size=16),
    )


def ssd_resnet50(image_size: int = 512) -> ExperimentConfig:
    """BASELINE config 2: SSD/X-Det single-shot head, batched NMS."""
    return ExperimentConfig(
        model=ModelConfig(name="ssd_resnet50", backbone="resnet50",
                          family="ssd", image_size=image_size,
                          nms=NMSConfig(iou_threshold=0.45,
                                        score_threshold=0.01, max_output=200,
                                        approx_prefilter=True)),
        data=DataConfig(image_size=image_size),
        train=TrainConfig(batch_size=8, ema_decay=0.99),
    )


def xdet_xception(image_size: int = 512) -> ExperimentConfig:
    """X-Det-style single-shot variant: Xception-lite + top-down fusion."""
    return ExperimentConfig(
        model=ModelConfig(name="xdet_xception", backbone="xception_lite",
                          family="ssd", image_size=image_size,
                          fpn_fusion=True,
                          nms=NMSConfig(iou_threshold=0.45,
                                        score_threshold=0.01, max_output=200,
                                        approx_prefilter=True)),
        data=DataConfig(image_size=image_size),
        train=TrainConfig(batch_size=8),
    )


def config5(world: int = 1, image_size: int = 800, global_batch: int = 128,
            microbatch: int = 8) -> ExperimentConfig:
    """BASELINE config 5: the Light-Head (``lighthead_xception``, config
    4's model) trained data-parallel at a global batch of 128, no warmup.
    Each of ``world`` ranks takes ``global_batch / world`` images in
    microbatches of ``microbatch`` (on one card: 16 of 8)."""
    per_rank = global_batch // world
    if per_rank * world != global_batch or per_rank % microbatch:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"into {world} ranks of microbatches of "
                         f"{microbatch}")
    cfg = lighthead_xception(image_size)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=global_batch, warmup_steps=0,
        grad_accum_steps=per_rank // microbatch))


PRESETS = {
    "lighthead_resnet50": lighthead_resnet50,
    "lighthead_xception": lighthead_xception,
    "ssd_resnet50": ssd_resnet50,
    "xdet_xception": xdet_xception,
}
