"""Post-training quantization for the int8 serving path (the port of
`geovpr.models.quantize`).

`quantize_for_serving(model, calib_batches)` runs the calibration batches
through the model's plain float path, as JAX's calibration clone does
(`geovpr/models/dinov2.py:156-160`, `swin.py:386-391`: the fused kernels
never materialize the amaxes it reads), with every `Mlp`, `DinoV2Block`,
`SwinBlock` and `SaladHead` recording
the amax of its calibration points into its `calib` dict. Static scales are
max over batches / 127 (+1e-12), weights are quantized per out-channel
from the model's own weights, and the result is the JAX "quant" tree: the
same key names, (in, out) int8 kernels, 0-d f32 scales. It is installed
into the model's buffers (`install_quant`), which folds the kernels'
arguments once.
"""

from __future__ import annotations

from typing import Iterable

import torch

from geovpr_torch.models.dinov2 import DinoV2Block
from geovpr_torch.models.layers import Mlp
from geovpr_torch.models.salad import SaladHead
from geovpr_torch.models.swin import SwinBlock

_CALIBRATED = (Mlp, DinoV2Block, SwinBlock, SaladHead)


def _flax_path(name: str) -> tuple:
    """A port module name -> its flax scope path (`blocks.3` -> `block3`);
    the inverse of `convert_jax`'s naming."""
    parts, out = name.split(".") if name else [], []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks" and i + 1 < len(parts):
            out.append(f"block{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


@torch.no_grad()
def calibrate(model: torch.nn.Module, calib_batches: Iterable) -> dict:
    """Run the batches (normalised NHWC images) through the plain float
    path (every module's `use_kernels` off for the pass, so that no kernel
    runs, as none does in JAX's calibration); returns {module name:
    {calibration point: amax}}."""
    mods = {n: m for n, m in model.named_modules()
            if isinstance(m, _CALIBRATED)}
    kernel_mods = [m for m in model.modules() if hasattr(m, "use_kernels")]
    use = [m.use_kernels for m in kernel_mods]
    for m in mods.values():
        m.calib = {}
    for m in kernel_mods:
        m.use_kernels = False
    seen = 0
    try:
        for images in calib_batches:
            model(images)
            seen += 1
        stats = {n: m.calib for n, m in mods.items() if m.calib}
    finally:
        for m in mods.values():
            m.calib = None
        for m, u in zip(kernel_mods, use):
            m.use_kernels = u
    if not seen:
        raise ValueError("calib_batches is empty")
    return stats


def quantize_for_serving(model: torch.nn.Module,
                         calib_batches: Iterable) -> dict:
    """Calibrate, build the JAX-layout "quant" tree, install it into the
    model (built with `int8_attn`/`int8_mlp`) and return the tree."""
    stats = calibrate(model, calib_batches)
    modules = dict(model.named_modules())
    quant: dict = {}
    for name, amax in stats.items():
        node = quant
        for part in _flax_path(name):
            node = node.setdefault(part, {})
        node.update(modules[name].quant_state(amax))
    install_quant(model, quant)
    return quant


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def install_quant(model: torch.nn.Module, quant: dict) -> None:
    """Copy a JAX-layout "quant" tree (torch tensors or numpy arrays) into
    the model's quant buffers, keeping int8 leaves int8 and 0-d scales 0-d;
    the blocks' load hooks fold the kernels' arguments. Entries for halves
    the model does not quantize are ignored, as JAX ignores them; a tree
    that matches no buffer at all raises."""
    from geovpr_torch.models.convert_jax import torch_name
    sd = {torch_name(path): torch.as_tensor(v)
          for path, v in _flatten(quant).items()}
    result = model.load_state_dict(sd, strict=False)
    if len(result.unexpected_keys) == len(sd):
        raise ValueError("no quant buffer in the model matches the tree: "
                         "build it with int8_attn / int8_mlp")
