"""Named workload presets (the port's copy of `geovpr.cli.presets`, as
data: the same names and config trees; `tests/test_torch_config.py` holds
them equal). `build_preset(name)` returns the full config tree;
hyperparameters are cited to the reference lines they reproduce.
`objective_for` gives a preset's objective (loss, decode and metrics).
"""

from __future__ import annotations

from geovpr_torch.core.config import (
    AngleConfig,
    DataConfig,
    GeoposeConfig,
    ModelConfig,
    OptimConfig,
    RetrievalConfig,
    TrainConfig,
)

# ---------------------------------------------------------------- geopose

GEOPOSE_PRESETS = {
    # swin_finetuning.py: Swin-T-224, linear head, MSE, Adam? (AdamW lr 1e-4
    # :87), 50 epochs, ckpt every epoch
    "swin_t224_v1": GeoposeConfig(
        data=DataConfig(image_size=224, batch_size=32),
        model=ModelConfig(family="swin", variant="tiny-224", head="linear"),
        optim=OptimConfig(lr=1e-4, weight_decay=0.0, schedule="constant"),
        train=TrainConfig(epochs=50),
        loss="mse"),
    # swin_finetuning_2.py: + augments, plateau LR, early stop 10
    "swin_t224_v2": GeoposeConfig(
        data=DataConfig(image_size=224, batch_size=32, augment="geo_light"),
        model=ModelConfig(family="swin", variant="tiny-224", head="linear"),
        optim=OptimConfig(lr=1e-4, schedule="plateau", plateau_factor=0.1,
                          plateau_patience=3),
        train=TrainConfig(epochs=50, early_stop_patience=10),
        loss="mse"),
    # swin_attempt_2.py: Swin-B-384, MLP(512, drop 0.3), Huber d=1, AdamW
    # 5e-5/wd 0.01 :157, plateau (0.2, 5) :159, early stop 40 :42 — the best
    # committed geopose run (val MSE 20833)
    "swin_b384_gemini2": GeoposeConfig(
        data=DataConfig(image_size=384, batch_size=16, augment="geo_light"),
        model=ModelConfig(family="swin", variant="base-384", head="mlp",
                          head_hidden=512, head_dropout=0.3),
        optim=OptimConfig(lr=5e-5, weight_decay=0.01, schedule="plateau",
                          plateau_factor=0.2, plateau_patience=5),
        train=TrainConfig(epochs=100, early_stop_patience=40,
                          run_name="gemini_2"),
        loss="huber", huber_delta=1.0),
    # swin_attempt_3.py: albumentations augments, mean-pool, differential LR
    # (backbone 0.1x head) :201-208
    "swin_b384_v4_diff_lr": GeoposeConfig(
        data=DataConfig(image_size=384, batch_size=16, augment="geo_heavy"),
        model=ModelConfig(family="swin", variant="base-384", head="mlp",
                          pooling="mean"),
        optim=OptimConfig(lr=1e-4, backbone_lr_scale=0.1, schedule="plateau"),
        train=TrainConfig(epochs=100, early_stop_patience=40),
        loss="huber"),
    # dinov2salad_finetuning.py: FROZEN DINOv2+SALAD descriptors ->
    # Linear(8448,512) -> ReLU -> Linear(512,2) :28-31 (ONE hidden layer,
    # no dropout), MSE, 100 epochs
    "dinov2salad_frozen_mlp": GeoposeConfig(
        data=DataConfig(image_size=224, batch_size=32),
        model=ModelConfig(family="dinov2_salad", variant="base-14",
                          head="mlp", head_hidden=512, head_dropout=0.0,
                          freeze_backbone=True),
        optim=OptimConfig(lr=1e-3, weight_decay=0.0, backbone_lr_scale=0.0),
        train=TrainConfig(epochs=100),
        loss="mse"),
    # dinov2salad_finetuning_2.py: unfrozen HF dinov2-base mean-pool + MLP,
    # Huber
    "dinov2_meanpool_huber": GeoposeConfig(
        data=DataConfig(image_size=224, batch_size=16, augment="geo_light"),
        model=ModelConfig(family="dinov2", variant="base-14", head="mlp",
                          pooling="mean"),
        optim=OptimConfig(lr=5e-5, weight_decay=0.01, schedule="plateau",
                          plateau_factor=0.2, plateau_patience=5),
        train=TrainConfig(epochs=100, early_stop_patience=40),
        loss="huber"),
}

# ------------------------------------------------------------------ angle

ANGLE_PRESETS = {
    # efficientnet_finetuning.py: B0, direct regression, MAAE loss :66-68
    "efficientnet_direct_maae": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32, eval_resize_to=256),
        model=ModelConfig(family="efficientnet", variant="b0", head="linear",
                          out_dim=1, head_dropout=0.2),
        optim=OptimConfig(lr=1e-4, schedule="constant"),
        train=TrainConfig(epochs=30),
        loss="direct"),
    # en_finetuning_gemini.py: B0 sin/cos [cos,sin], MSE train loss :158,
    # plateau :163, best-by-val-MAAE :251 — the committed MAAE 26.326 run
    "efficientnet_sincos_gemini": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32, augment="geo_light",
                        eval_resize_to=256),
        model=ModelConfig(family="efficientnet", variant="b0",
                          head="sincos_linear", out_dim=2, head_dropout=0.3),
        optim=OptimConfig(lr=1e-4, schedule="plateau", plateau_factor=0.2,
                          plateau_patience=3),
        train=TrainConfig(epochs=50, early_stop_patience=10),
        loss="sincos_mse", codec_order="cos_sin"),
    # swin_angle_finetuning.py: Swin-B-384 direct + MAAE
    "swin_b384_direct_maae": AngleConfig(
        data=DataConfig(image_size=384, batch_size=8),
        model=ModelConfig(family="swin", variant="base-384", head="linear",
                          out_dim=1),
        optim=OptimConfig(lr=1e-4),
        train=TrainConfig(epochs=30),
        loss="direct"),
    # swin_angle_finetuning_sin_cos.py: Swin-T [sin,cos] unit head, acos
    # loss :65-69, grad clip 5 :116, cosine anneal :93
    "swin_t224_sincos_acos": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32),
        model=ModelConfig(family="swin", variant="tiny-224",
                          head="sincos_unit", out_dim=2),
        optim=OptimConfig(lr=1e-4, schedule="cosine", grad_clip_norm=5.0),
        train=TrainConfig(epochs=50),
        loss="sincos_acos", codec_order="sin_cos"),
    # swin_angle_finetuning_gemini.py: Swin-T sincos MLP head, flip-aware
    # targets :59-76, MSE, grad clip 1 :215, warm restarts :188
    "swin_t224_sincos_gemini": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32, augment="geo_light"),
        model=ModelConfig(family="swin", variant="tiny-224",
                          head="sincos_mlp", out_dim=2),
        optim=OptimConfig(lr=1e-4, schedule="cosine_restarts",
                          restart_period=10, grad_clip_norm=1.0),
        train=TrainConfig(epochs=60),
        loss="sincos_mse", codec_order="sin_cos"),
    # convnext_finetuning.py: ConvNeXt-base direct + MAAE :70-72
    "convnext_direct_maae": AngleConfig(
        data=DataConfig(image_size=224, batch_size=16),
        model=ModelConfig(family="convnext", variant="base-224",
                          head="linear", out_dim=1),
        optim=OptimConfig(lr=1e-4),
        train=TrainConfig(epochs=30),
        loss="direct"),
    # dino_angle_finetuning.py: DINOv2 CLS -> linear, %360 in forward, MAAE
    "dinov2_cls_direct_maae": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32),
        model=ModelConfig(family="dinov2", variant="base-14", head="linear",
                          out_dim=1, pooling="cls"),
        optim=OptimConfig(lr=1e-4),
        train=TrainConfig(epochs=30),
        loss="direct"),
    # dino_v2_gemini.py: CLS sincos head, rotation-heavy augments :57-62,
    # freeze-then-unfreeze :187-222, 3-group differential LR + no-decay
    # split :169-184, cosine anneal, early stop 10
    "dinov2_sincos_gemini": AngleConfig(
        data=DataConfig(image_size=224, batch_size=32, augment="angle_rot"),
        model=ModelConfig(family="dinov2", variant="base-14",
                          head="sincos_mlp", out_dim=2, pooling="cls"),
        optim=OptimConfig(lr=1e-4, backbone_lr_scale=0.1,
                          no_decay_on_bias_norm=True, schedule="cosine",
                          freeze_backbone_epochs=5, unfreeze_lr=2e-5),
        train=TrainConfig(epochs=60, early_stop_patience=10),
        loss="sincos_mse", codec_order="sin_cos"),
}

RETRIEVAL_PRESETS = {
    # BASELINE config 4: DINOv2+SALAD descriptors + cosine top-k retrieval
    "dinov2_salad_retrieval": RetrievalConfig(),
}


def build_preset(name: str):
    for table in (GEOPOSE_PRESETS, ANGLE_PRESETS, RETRIEVAL_PRESETS):
        if name in table:
            return table[name]
    known = sorted([*GEOPOSE_PRESETS, *ANGLE_PRESETS, *RETRIEVAL_PRESETS])
    raise ValueError(f"unknown preset {name!r}; known: {known}")


def objective_for(cfg):
    """Config -> the objective (`geovpr.cli.presets.objective_for`)."""
    from geovpr_torch.objectives.angle_codec import SinCosCodec
    from geovpr_torch.objectives.workloads import (AngleDirectObjective,
                                                   AngleSinCosObjective,
                                                   GeoposeObjective)

    if isinstance(cfg, GeoposeConfig):
        return GeoposeObjective(loss_name=cfg.loss,
                                huber_delta=cfg.huber_delta)
    if isinstance(cfg, AngleConfig):
        if cfg.loss == "direct":
            return AngleDirectObjective()
        return AngleSinCosObjective(
            loss_name="acos" if cfg.loss == "sincos_acos" else "mse",
            codec=SinCosCodec(cfg.codec_order))
    raise TypeError(type(cfg))
