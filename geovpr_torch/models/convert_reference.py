"""Full reference-checkpoint converters: trained torch model -> the flax
variables of `RegressionModel` (the port's copy of
`geovpr/models/convert_reference.py`).

`geovpr_torch.cli.convert` imports PRETRAINED BACKBONES (the starting
point of every reference run). This module imports the reference's TRAINED
checkpoints — backbone + regression head together — so a real
`model_best.pth` from the reference repo can be evaluated by the port and
diffed against the committed golden metrics (the parity protocol,
`geovpr_torch.cli.parity`).

Covered checkpoint layouts (the three golden-metric runs):

- ``swin_geopose``: `SwinRegressionModel` of
  `swin_transformer/swin_attempt_2.py:114-128` —
  `backbone.*` (HF SwinModel) + `regressor.{0,3}` (Linear 1024->512,
  ReLU, Dropout, Linear 512->2). Golden: val MSE 20833.22.
- ``dinov2salad_geopose``: `DINOv2RegressionModel` of
  `dinov2salad/dinov2salad_finetuning.py:20-31` —
  `feature_extractor.*` (serizba/salad hub model) + `regressor.{0,2}`
  (Linear 8448->512, ReLU, Linear 512->2). Golden: competition loss
  ~228000 at ckpt 49 (dinov2salad_validation.py:127).
- ``efficientnet_sincos``: `EfficientNetSinCosModel` of
  `angle_prediction/efficient_net/en_finetuning_gemini.py:68-88`
  — `backbone.*` (torchvision efficientnet_b0 with
  `classifier = Sequential(Dropout, Linear(1280, 2))`). Golden: val MAAE
  26.326 deg.

Returned trees nest under RegressionModel's module names
(``params/backbone``, ``params/head``, ``batch_stats/backbone``);
`models/convert_jax.py::state_dict_from_flax` turns them into the
`backbone.*` / `head.*` state_dict of the port's `RegressionModel`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from geovpr_torch.models import convert_torch as ct

RECIPES = ("swin_geopose", "dinov2salad_geopose", "efficientnet_sincos")

# recipe -> the cli.presets entry whose model the converted tree targets
RECIPE_PRESETS = {
    "swin_geopose": "swin_b384_gemini2",
    "dinov2salad_geopose": "dinov2salad_frozen_mlp",
    "efficientnet_sincos": "efficientnet_sincos_gemini",
}


def _strip(state_dict: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _dense(state_dict: Mapping[str, Any], key: str) -> dict:
    """torch nn.Linear -> flax Dense params."""
    w = ct._np(state_dict[f"{key}.weight"])
    return {"kernel": np.ascontiguousarray(w.T),
            "bias": ct._np(state_dict[f"{key}.bias"])}


def convert_reference_checkpoint(recipe: str, state_dict: Mapping[str, Any],
                                 image_size: int = 0, depths=None) -> dict:
    """Convert a full trained reference checkpoint to RegressionModel
    variables. `depths`/`image_size` override the production dims (the
    parity-harness CI tests run tiny stand-in architectures through the
    same code path)."""
    if recipe == "swin_geopose":
        from geovpr_torch.models.swin import SWIN_VARIANTS
        bb = ct.convert_swin_hf(
            _strip(state_dict, "backbone."),
            depths=depths or SWIN_VARIANTS["base-384"]["depths"])
        head = {"hidden0": _dense(state_dict, "regressor.0"),
                "out": _dense(state_dict, "regressor.3")}
    elif recipe == "dinov2salad_geopose":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
        num_layers = (depths if isinstance(depths, int) else
                      DINOV2_VARIANTS["base-14"]["num_layers"])
        grid = (image_size or 224) // 14
        bb = ct.convert_salad_hub(_strip(state_dict, "feature_extractor."),
                                  num_layers=num_layers, target_grid=grid)
        head = {"hidden0": _dense(state_dict, "regressor.0"),
                "out": _dense(state_dict, "regressor.2")}
    elif recipe == "efficientnet_sincos":
        bb = ct.convert_efficientnet_b0(_strip(state_dict, "backbone."))
        head = {"out": _dense(state_dict, "backbone.classifier.1")}
    else:
        raise ValueError(f"unknown recipe {recipe!r}; known: {RECIPES}")

    variables: dict = {"params": {"backbone": bb["params"], "head": head}}
    if bb.get("batch_stats"):
        variables["batch_stats"] = {"backbone": bb["batch_stats"]}
    return variables
