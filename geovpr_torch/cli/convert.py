"""Checkpoint conversion entry point of the port (the counterpart of
`geovpr.cli.convert`, flag for flag): torch/HF/hub state_dict -> flax
msgpack.

    python -m geovpr_torch.cli.convert --family swin --variant base-384 \
        swin_base.pth swin_base.msgpack

Every reference script starts from pretrained torch weights
(`swin_attempt_2.py:117` HF SwinModel; `dinov2salad_finetuning.py:19`
torch.hub serizba/salad; `efficientnet_finetuning.py:53` torchvision;
`convnext_finetuning.py:58` HF ConvNext; `dinov2salad_finetuning_2.py:117`
HF Dinov2). This command turns any of those checkpoint files into the
msgpack that `geovpr_torch.cli.train --pretrained`, `cli.evaluate
--variables`, `cli.retrieve --variables` and `cli.fuse --salad-variables`
read (and the JAX package's CLIs too: the file is flax's format, the tree
flax's layout), auto-selecting the right converter per family and
validating every converted array against the port's model (names AND
shapes) before writing.

Conversion is host work, as in the JAX CLI (which pins itself to the CPU
backend): the model is built on the `meta` device for its names and
shapes only, so the command needs no card and takes no `--device`. It
prints one JSON line: dst, family, variant, the number of converted
arrays, and the model tensors the file leaves uncovered.
"""

from __future__ import annotations

import argparse
import json


FAMILIES = ("swin", "dinov2", "dinov2_facebook", "dinov2_salad",
            "convnext", "efficientnet")


def load_state_dict(path: str) -> dict:
    """Read a checkpoint file into a flat torch-style state_dict.

    Accepts raw state_dicts, full torch checkpoints (`model_state_dict` /
    `state_dict` / `model` wrappers, as the reference writes at
    swin_attempt_2.py:239-247), and `.safetensors` when that library is
    present. `module.` DataParallel prefixes are stripped.
    """
    if path.endswith(".safetensors"):
        try:
            from safetensors import safe_open
        except ImportError as e:
            raise SystemExit("safetensors is not available in this "
                             "environment; convert from a torch .pth/.bin "
                             "file instead") from e
        with safe_open(path, framework="np") as f:
            sd = {k: f.get_tensor(k) for k in f.keys()}
    else:
        import torch
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("model_state_dict", "state_dict", "model"):
            if isinstance(sd, dict) and wrapper in sd \
                    and isinstance(sd[wrapper], dict):
                sd = sd[wrapper]
                break
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    # HF files carry the bare model tree; hub/torchvision sometimes prefix
    # with the top module name — leave detection to the converters, but drop
    # a uniform leading "model." if every key has it
    if sd and all(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()}
    return sd


def convert(family: str, variant: str, state_dict: dict,
            image_size: int = 0) -> dict:
    """Dispatch to the right converter in geovpr_torch.models.convert_torch."""
    from geovpr_torch.models import convert_torch as ct

    if family == "swin":
        from geovpr_torch.models.swin import SWIN_VARIANTS
        return ct.convert_swin_hf(state_dict,
                                  depths=SWIN_VARIANTS[variant]["depths"])
    if family == "convnext":
        from geovpr_torch.models.convnext import CONVNEXT_VARIANTS
        return ct.convert_convnext_hf(
            state_dict, depths=CONVNEXT_VARIANTS[variant]["depths"])
    if family in ("dinov2", "dinov2_facebook", "dinov2_salad"):
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
        num_layers = DINOV2_VARIANTS[variant]["num_layers"]
        grid = (image_size or 224) // 14
        if family == "dinov2_salad":
            return ct.convert_salad_hub(state_dict, num_layers=num_layers,
                                        target_grid=grid)
        # auto-detect layout: HF Dinov2Model vs facebookresearch ViT
        # (fused qkv, `blocks.N.*`) — the hub SALAD backbone's format
        if family == "dinov2_facebook" or not any(
                k.startswith("encoder.layer.") for k in state_dict):
            return ct.convert_dinov2_facebook(
                state_dict, num_layers=num_layers, target_grid=grid)
        return ct.convert_dinov2_hf(state_dict, num_layers=num_layers,
                                    target_grid=grid)
    if family == "efficientnet":
        # torchvision layout starts at features.*; HF at embeddings.*
        if any(k.startswith("features.") for k in state_dict):
            return ct.convert_efficientnet_b0(state_dict)
        return ct.convert_efficientnet_hf(state_dict)
    raise ValueError(f"unknown family {family!r}; known: {FAMILIES}")


def _default_image_size(family: str, variant: str) -> int:
    """The resolution a (family, variant) is built for when the caller
    doesn't pass one. Swin variants FIX their resolution (window
    partitioning), so `convert --family swin --variant base-384` needs no
    extra flag."""
    if family == "swin":
        from geovpr_torch.models.swin import SWIN_VARIANTS
        return SWIN_VARIANTS[variant]["image_size"]
    return 224


def _leaf_count(tree) -> int:
    return sum(_leaf_count(v) if isinstance(v, dict) else 1
               for v in tree.values())


def validate(family: str, variant: str, variables: dict,
             image_size: int = 0) -> dict:
    """Check every converted array against the port's model for (family,
    variant): the model is built on the `meta` device (names and shapes,
    no storage), the converted tree goes through the bridge
    (`state_dict_from_flax`), and `train/state.py::_merge_pretrained`,
    the `--pretrained` path's merge, raises on an unknown name or a shape
    mismatch. Reports the model tensors the file does NOT cover.

    Returns {"covered": n flax arrays, "uncovered": [state_dict names]}.
    """
    import torch

    from geovpr_torch.core.config import ModelConfig
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.registry import build_backbone
    from geovpr_torch.train.state import _merge_pretrained

    size = image_size or _default_image_size(family, variant)
    # layout aliases share one model family in the registry
    registry_family = {"dinov2_facebook": "dinov2"}.get(family, family)
    cfg = ModelConfig(family=registry_family, variant=variant,
                      image_size=size)
    model_sd = build_backbone(cfg, torch.float32, device="meta").state_dict()
    converted = state_dict_from_flax(variables)
    _merge_pretrained(model_sd, converted)
    return {"covered": sum(_leaf_count(variables[c]) for c in variables),
            "uncovered": sorted(set(model_sd) - set(converted))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="torch .pth/.pt/.bin checkpoint (raw "
                               "state_dict or reference-style wrapper)")
    p.add_argument("dst", help="output flax msgpack path")
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--variant", required=True,
                   help="e.g. base-384 (swin), base-14 (dinov2), b0, "
                        "base-224 (convnext)")
    p.add_argument("--image-size", type=int, default=0,
                   help="target input resolution (DINOv2 position "
                        "embeddings are bicubically resized to its patch "
                        "grid at import; default: family default)")
    p.add_argument("--allow-uncovered", action="store_true",
                   help="write the file even if some model parameters were "
                        "not present in the checkpoint (they stay randomly "
                        "initialized at load)")
    args = p.parse_args(argv)

    from geovpr_torch.models.convert_jax import save_flax_msgpack

    sd = load_state_dict(args.src)
    variables = convert(args.family, args.variant, sd,
                        image_size=args.image_size)
    report = validate(args.family, args.variant, variables,
                      image_size=args.image_size)
    if report["uncovered"] and not args.allow_uncovered:
        raise SystemExit(
            f"checkpoint leaves {len(report['uncovered'])} model parameters "
            f"uninitialized (e.g. {report['uncovered'][:5]}); pass "
            f"--allow-uncovered to write anyway")

    save_flax_msgpack(args.dst, variables)
    print(json.dumps({"dst": args.dst, "family": args.family,
                      "variant": args.variant,
                      "arrays": report["covered"],
                      "uncovered": report["uncovered"]}))


if __name__ == "__main__":
    main()
