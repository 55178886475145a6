"""Workload configuration (the port's copy of `geovpr.core.config`, the
dataclasses field for field, so that the port reads presets without the
JAX package; `tests/test_torch_config.py` holds the two equal).

Each workload is one frozen dataclass tree: no absolute paths, seeds
threaded explicitly, and every reference experiment is expressible as a
config preset (see `geovpr_torch/cli/presets.py`). Some fields name the JAX
package's machinery (`use_pallas`, `remat`, mesh shapes); the port's
serving path reads the data and model fields and ignores the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline config.

    Mirrors the reference `CampusDataset` contract
    (`swin_transformer/swin_attempt_2.py:55-112`): CSV manifest with columns
    `filename,timestamp,latitude,longitude,angle,Region_ID`, rows whose image
    file is missing are dropped, images resized + normalized.
    """

    train_csv: str = ""
    val_csv: str = ""
    image_root: str = ""
    test_image_dir: str = ""
    image_size: int = 224
    batch_size: int = 64
    # Normalization (ImageNet stats; the HF processors the reference relies
    # on use these for Swin/ConvNeXt/DINOv2 and torchvision for EfficientNet)
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    screen_missing_files: bool = True
    screen_corrupt_images: bool = False  # PIL verify() pass, cf. val_and_test_swin_2.py:80-90
    augment: str = "none"  # none | geo_light | geo_heavy | angle_rot
    shuffle_buffer: int = 0
    num_decode_threads: int = 8
    prefetch_depth: int = 2
    # False matches the reference DataLoader's drop_last=False (every row
    # trains every epoch); shapes stay static anyway — the final partial
    # batch is padded and the padded rows are masked out of loss/metrics.
    # True trades the ragged tail (e.g. 2 of 6,378 train images at bs=16)
    # for one fewer compiled step shape. See docs/DESIGN.md "Parity deltas".
    drop_remainder_train: bool = False
    decoder: str = "pil"       # pil | native (C++ libjpeg, PIL fallback)
    # eval/test-time short-side resize before center-cropping image_size
    # (Resize(256)+CenterCrop(224), validation_script.py:124-129); 0 = plain
    # square resize like every other reference script
    eval_resize_to: int = 0
    # cache decoded+resized images after first epoch: "" off, "ram", or a
    # .npy path for a disk memmap (datasets larger than memory)
    cache_decoded: str = ""


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + head selection.

    family: swin | dinov2 | dinov2_salad | efficientnet | convnext
    variant: e.g. "tiny-224", "base-384", "b0", "base"
    head: linear | mlp | sincos_linear | sincos_mlp | sincos_unit
    pooling: pooler | mean | cls   (Swin pooler vs mean-pool of
             last_hidden_state, cf. swin_attempt_3.py:164-170; DINOv2 CLS
             cf. dino_angle_finetuning.py:45)
    """

    family: str = "swin"
    variant: str = "base-384"
    head: str = "mlp"
    head_hidden: int = 512
    head_dropout: float = 0.3
    out_dim: int = 2
    pooling: str = "pooler"
    # input resolution the backbone is built for; 0 = the family default
    # (224 for dinov2/convnext/efficientnet; swin variants fix their own).
    # cli/train sets this from DataConfig.image_size.
    image_size: int = 0
    freeze_backbone: bool = False  # frozen-descriptor path, dinov2salad_finetuning.py:25-26
    use_pallas: bool = True        # Pallas kernels where available (else pure-XLA path)
    remat: bool = False            # jax.checkpoint each block: activation memory O(1)
    # activations/matmuls compute dtype; params stay fp32 and heads emit
    # fp32 (core/dtypes.py policy). Measured Swin-B-384 fwd on one v5e chip:
    # 334 img/s f32 -> 415 img/s bfloat16
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer/schedule config covering every reference recipe:

    - AdamW lr/wd (`swin_attempt_2.py:157`)
    - plateau LR (factor/patience, `swin_attempt_2.py:159`)
    - cosine annealing (`swin_angle_finetuning_sin_cos.py:93`) and
      warm restarts (`swin_angle_finetuning_gemini.py:188`)
    - differential backbone/head LR (`swin_attempt_3.py:201-208`,
      `dino_v2_gemini.py:169-184`)
    - freeze-then-unfreeze schedule (`dino_v2_gemini.py:187-222`)
    - grad clipping (`swin_angle_finetuning_sin_cos.py:116` clip 5.0;
      `swin_angle_finetuning_gemini.py:215` clip 1.0)
    """

    optimizer: str = "adamw"
    lr: float = 5e-5
    weight_decay: float = 0.01
    backbone_lr_scale: float = 1.0
    no_decay_on_bias_norm: bool = False
    schedule: str = "constant"  # constant | plateau | cosine | cosine_restarts
    plateau_factor: float = 0.2
    plateau_patience: int = 5
    cosine_steps: int = 0            # 0 => derived from epochs * steps_per_epoch
    restart_period: int = 10
    grad_clip_norm: float = 0.0      # 0 disables
    freeze_backbone_epochs: int = 0  # head-only warmup epochs
    unfreeze_lr: float = 0.0         # lr after unfreeze (0 => keep lr)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 50
    seed: int = 42
    early_stop_patience: int = 0     # 0 disables
    save_dir: str = "runs"
    run_name: str = ""
    checkpoint_every: int = 1
    keep_checkpoints: int = 3
    skip_nonfinite_updates: bool = True  # NaN-skip, swin_angle_finetuning_sin_cos.py:110-112
    # Orbax AsyncCheckpointer: disk writes overlap the next epoch's compute;
    # atomic tmp->rename makes mid-write preemption safe (SURVEY.md §5
    # "Failure detection" — the reference's torch.save has neither property)
    async_checkpoint: bool = False
    log_every_steps: int = 50
    # Mesh: data-parallel axis plus optional model axis for TP.
    mesh_shape: Optional[Sequence[int]] = None   # None => (n_devices,)
    mesh_axes: Sequence[str] = ("data",)
    donate_state: bool = True
    # Observability (SURVEY.md §5 "Tracing / profiling" — absent in the
    # reference; first-class here): capture a jax.profiler device trace of
    # `profile_steps` train steps into <run_dir>/profile during epoch 0.
    profile: bool = False
    profile_steps: int = 5
    # jit-purity/NaN debugging (§5 "Race detection / sanitizers" analog):
    # turns on jax_debug_nans for the whole run.
    debug_nans: bool = False
    # Frozen-feature cache: when the backbone is fully frozen
    # (ModelConfig.freeze_backbone) and there is no augmentation, its
    # features are identical every epoch — extract them ONCE and train the
    # head on cached features. The reference recomputes the frozen forward
    # every step for 100 epochs (dinov2salad_finetuning.py:35-36,
    # `with no_grad(): features = feature_extractor(x)`); caching makes
    # epochs head-bound instead of backbone-bound (~1000x fewer FLOPs for
    # the 8448->512->512->2 MLP). Trajectory is provably identical — the
    # cached features are the same arrays the full forward would produce
    # (tests/test_train.py TestFrozenFeatureCache).
    cache_frozen_features: bool = True


@dataclasses.dataclass(frozen=True)
class GeoposeConfig:
    """Lat/lon regression workload (swin_transformer/ family)."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    loss: str = "huber"          # mse | huber
    huber_delta: float = 1.0
    scale_targets: bool = True   # StandardScaler codec on (lat, lon)


@dataclasses.dataclass(frozen=True)
class AngleConfig:
    """Heading regression workload (angle_prediction/ family)."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # direct: scalar degrees + MAAE loss (efficientnet_finetuning.py:66-68)
    # sincos_mse: MSE on encoded pair (en_finetuning_gemini.py:158)
    # sincos_acos: unit-normalized head + acos loss
    #              (swin_angle_finetuning_sin_cos.py:65-69)
    loss: str = "sincos_mse"
    codec_order: str = "cos_sin"  # canonical codec column order for this run


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Descriptor retrieval workload (new capability per BASELINE north star)."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(
        default_factory=lambda: ModelConfig(family="dinov2_salad",
                                            variant="base-14", head="linear"))
    descriptor_dim: int = 8448   # 64 clusters x 128 dims + 256 global
    top_k: int = 5
    index_dtype: str = "bfloat16"
