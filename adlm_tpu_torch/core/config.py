"""Typed experiment configuration (counterpart of ``adlm_tpu.core.config``).

Frozen dataclasses plus a named registry of experiments.  This is the
port's own copy: the field names, defaults and presets are those of the
JAX package, so a run config saved by either package (``to_json``)
loads in the other (``from_json``), and
``tests/test_torch_ops.py`` holds every preset's JSON equal.

Every reference experiment (reference ``segmentation/configs/*.gin``)
exists as a preset; the class table the reference swapped in by hand is
the field ``DataConfig.class_table``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _asdict(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


@dataclass(frozen=True)
class PPNetConfig:
    """Prototype-network head + backbone selection (reference
    ``construct_PPNet`` / ``PPNet.__init__``, model.py:39-147, 389-418)."""

    base_architecture: str = "deeplabv2_resnet101"
    img_size: int = 513
    # prototypes are always 1x1 kernels in the shipped configs: (P, C)
    num_prototypes: int = 190
    prototype_channels: int = 64
    num_classes: int = 19
    prototype_activation: str = "log"  # 'log' | 'linear'
    add_on_layers_type: str = "deeplab_simple"  # | 'bottleneck' | 'bottleneck_pool' | 'regular'
    bottleneck_stride: Optional[int] = None
    patch_classification: bool = True
    epsilon: float = 1e-4
    # DeepLab specifics (reference deeplab_features.py:52-60)
    deeplab_n_features: int = 64
    deeplab_n_blocks: Tuple[int, ...] = (3, 4, 23, 3)
    atrous_rates: Tuple[int, ...] = (6, 12, 18, 24)
    # MSC scales beyond 1.0 (reference segmentation/utils.py:64-101);
    # empty = single scale
    msc_scales: Tuple[float, ...] = ()
    pretrained: bool = False
    # compute the d=2/4 dilated convs by space-to-batch (numerically
    # exact, identical parameters; see models/layers.ConvBN)
    dilated_space_to_batch: bool = False
    # per-pixel LayerNorm right before the add-on sigmoid: keeps the
    # sigmoid out of saturation when the backbone trains from random
    # init.  Default off: the reference architecture has none.
    presigmoid_ln: bool = False

    @property
    def prototype_shape(self) -> Tuple[int, int, int, int]:
        return (self.num_prototypes, self.prototype_channels, 1, 1)

    @property
    def num_prototypes_per_class(self) -> int:
        assert self.num_prototypes % self.num_classes == 0
        return self.num_prototypes // self.num_classes


@dataclass(frozen=True)
class DataConfig:
    """Dataset + augmentation knobs (reference segmentation/dataset.py:34-50)."""

    class_table: str = "cityscapes"  # 'cityscapes' | 'pascal' | 'mds' (pancreas)
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    image_margin_size: int = 0
    window_size: Tuple[int, int] = (513, 513)
    scales: Tuple[float, ...] = (0.5, 1.5)  # random-scale jitter range
    cells: bool = False  # raw-float images, no /255 (cells.gin)
    dataloader_n_jobs: int = 8
    # "thread" or "process" workers; the sample stream is the same
    dataloader_mode: str = "thread"
    train_key: str = "train"
    # eval-time input resize (labels stay full-res; logits are upsampled
    # to label size) — the reference resizes PASCAL eval inputs to
    # 513x513 (eval_valid.py:144-152)
    eval_resize: Optional[Tuple[int, int]] = None


@dataclass(frozen=True)
class TrainConfig:
    """Phase schedule + losses + per-group LRs (reference
    segmentation/module.py:41-83, train.py:34-48)."""

    random_seed: int = 20220227
    warmup_steps: int = 15000
    joint_steps: int = 150000
    finetune_steps: int = 10000
    warmup_batch_size: int = 2
    joint_batch_size: int = 2
    early_stopping_patience_last_layer: int = 100

    loss_weight_crs_ent: float = 1.0
    loss_weight_l1: float = 1e-4
    loss_weight_kld: float = 0.25

    joint_optimizer_lr_features: float = 2.5e-5
    joint_optimizer_lr_add_on_layers: float = 2.5e-4
    joint_optimizer_lr_prototype_vectors: float = 2.5e-4
    joint_optimizer_weight_decay: float = 5e-4
    warm_optimizer_lr_add_on_layers: float = 2.5e-4
    warm_optimizer_lr_prototype_vectors: float = 2.5e-4
    warm_optimizer_weight_decay: float = 5e-4
    last_layer_optimizer_lr: float = 1e-5

    ignore_void_class: bool = True
    poly_lr_power: float = 0.9
    iter_size: int = 5  # gradient accumulation microbatches

    # optional global-norm gradient clip before every phase optimizer;
    # None = the reference (never clips)
    grad_clip_norm: Optional[float] = None
    # linear LR ramp over the first N joint-phase optimizer updates,
    # then the reference poly decay; 0 = the reference (no ramp)
    joint_lr_warmup_updates: int = 0
    # True reproduces the reference's KLD column indexing with the RAW
    # label (off by one from the CE targets when void is dropped,
    # reference segmentation/module.py:170-178 vs :156-159)
    kld_raw_label_indexing: bool = False
    # 'float32' (the reference numerics) or 'bfloat16'
    compute_dtype: str = "float32"
    # recompute the forward during backprop (activation memory)
    remat: bool = False
    # standardize every frozen BN on a real batch before training
    bn_calibrate: bool = False
    # initialize each prototype from a real feature of its own class
    proto_init_data: bool = False
    # run the iter_size microbatches as one fused forward/backward with
    # group-normalized losses (gradient-identical to the sequence)
    fused_accumulation: bool = False
    # ship train windows as raw uint8 and normalize on the device
    # (requires /255-scaled datasets, cells=False)
    wire_uint8: bool = False


@dataclass(frozen=True)
class UNoiseConfig:
    """U-Noise trainer knobs (reference src/train_noise.py:140-168)."""

    depth: int = 5
    channel_factor: int = 6
    util_depth: int = 5
    util_channel_factor: int = 6
    learning_rate: float = 3e-3
    batch_size: int = 8
    min_scale: float = 1.0
    max_scale: float = 5.0
    noise_coeff: float = 0.001
    epochs: int = 100
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "cityscapes_kld_imnet"
    model: PPNetConfig = field(default_factory=PPNetConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    unoise: UNoiseConfig = field(default_factory=UNoiseConfig)
    load_coco: bool = False

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        raw = json.loads(s)

        def tupleize(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue  # field added since the JSON was saved
                v = d[f.name]
                if isinstance(v, list):
                    v = tuple(v)
                kw[f.name] = v
            return cls(**kw)

        return ExperimentConfig(
            name=raw["name"],
            model=tupleize(PPNetConfig, raw["model"]),
            data=tupleize(DataConfig, raw["data"]),
            train=tupleize(TrainConfig, raw["train"]),
            unoise=tupleize(UNoiseConfig, raw["unoise"]),
            load_coco=raw.get("load_coco", False),
        )


_REGISTRY: Dict[str, ExperimentConfig] = {}


def register_experiment(cfg: ExperimentConfig) -> ExperimentConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_experiment(name: str) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_experiments():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Presets: one per reference gin file (reference segmentation/configs/*.gin).
# ---------------------------------------------------------------------------

_CITYSCAPES_MODEL = PPNetConfig(
    num_prototypes=190, num_classes=19, add_on_layers_type="deeplab_simple"
)
_CITYSCAPES_DATA = DataConfig(class_table="cityscapes", window_size=(513, 513))

# Presets with an active KLD loss set kld_raw_label_indexing=True to
# reproduce the reference's published runs (see TrainConfig).
register_experiment(ExperimentConfig(
    name="cityscapes_kld_imnet",
    model=_CITYSCAPES_MODEL,
    data=_CITYSCAPES_DATA,
    train=TrainConfig(loss_weight_kld=0.25, kld_raw_label_indexing=True),
))

register_experiment(ExperimentConfig(
    name="cityscapes_no_kld_imnet",
    model=_CITYSCAPES_MODEL,
    data=_CITYSCAPES_DATA,
    train=TrainConfig(loss_weight_kld=0.0),
))

register_experiment(ExperimentConfig(
    name="cityscapes_kld_coco",
    model=_CITYSCAPES_MODEL,
    data=_CITYSCAPES_DATA,
    train=TrainConfig(loss_weight_kld=0.25, kld_raw_label_indexing=True),
    load_coco=True,
))

_PASCAL_MODEL = PPNetConfig(
    num_prototypes=210, num_classes=21, img_size=321,
    add_on_layers_type="deeplab_simple", msc_scales=(0.5, 0.75),
)
_PASCAL_DATA = DataConfig(class_table="pascal", window_size=(321, 321),
                          eval_resize=(513, 513))

register_experiment(ExperimentConfig(
    name="pascal_kld_imnet",
    model=_PASCAL_MODEL,
    data=_PASCAL_DATA,
    train=TrainConfig(loss_weight_kld=0.25, kld_raw_label_indexing=True),
))

register_experiment(ExperimentConfig(
    name="pascal_no_kld_imnet",
    model=_PASCAL_MODEL,
    data=_PASCAL_DATA,
    train=TrainConfig(loss_weight_kld=0.0),
))

register_experiment(ExperimentConfig(
    name="pascal_kld_coco",
    model=_PASCAL_MODEL,
    data=_PASCAL_DATA,
    train=TrainConfig(loss_weight_kld=0.25, kld_raw_label_indexing=True),
    load_coco=True,
))

register_experiment(ExperimentConfig(
    name="mds_new",
    model=PPNetConfig(num_prototypes=30, num_classes=3,
                      add_on_layers_type="deeplab_simple"),
    data=DataConfig(class_table="mds", window_size=(513, 513)),
    train=TrainConfig(loss_weight_kld=0.0),
))

# Synthetic-flagship presets (not reference configs): the flagship model
# trained from scratch on a synthetic Cityscapes-layout dataset, which
# needs presigmoid_ln, a 10x feature LR and data-driven prototype init.
_SYNTH_MODEL = dataclasses.replace(_CITYSCAPES_MODEL, presigmoid_ln=True)
_SYNTH_TRAIN = dict(loss_weight_kld=0.25, kld_raw_label_indexing=True,
                    joint_optimizer_lr_features=2.5e-4,
                    proto_init_data=True)

register_experiment(ExperimentConfig(
    name="flagship_synth_demo",
    model=_SYNTH_MODEL,
    data=_CITYSCAPES_DATA,
    # 10% of the reference budget
    train=TrainConfig(warmup_steps=1500, joint_steps=15000,
                      finetune_steps=1000, **_SYNTH_TRAIN),
))

register_experiment(ExperimentConfig(
    name="flagship_synth_full",
    model=_SYNTH_MODEL,
    data=_CITYSCAPES_DATA,
    # the full reference budget (reference
    # segmentation/configs/cityscapes_kld_imnet.gin:20-24)
    train=TrainConfig(**_SYNTH_TRAIN),
))

# Small smoke-test experiment on tiny shapes (not a reference config).
register_experiment(ExperimentConfig(
    name="smoke",
    model=PPNetConfig(num_prototypes=6, num_classes=3,
                      prototype_channels=8, deeplab_n_features=8,
                      deeplab_n_blocks=(1, 1, 1, 1), img_size=65,
                      add_on_layers_type="deeplab_simple"),
    data=DataConfig(class_table="mds", window_size=(65, 65),
                    scales=(0.9, 1.1)),
    train=TrainConfig(warmup_steps=8, joint_steps=8, finetune_steps=8,
                      iter_size=2, warmup_batch_size=2,
                      joint_batch_size=2, loss_weight_kld=0.25),
))

register_experiment(ExperimentConfig(
    name="cells",
    model=PPNetConfig(num_prototypes=50, num_classes=5, img_size=321,
                      add_on_layers_type="deeplab_simple", msc_scales=(0.5, 0.75)),
    data=DataConfig(class_table="cells", window_size=(321, 321), cells=True,
                    mean=(106.51, 106.51, 106.51), std=(7.25, 7.25, 7.25)),
    train=TrainConfig(loss_weight_kld=0.25, kld_raw_label_indexing=True, ignore_void_class=False),
))
