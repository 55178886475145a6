"""Weight bridge from `geovpr` (flax) variables to the port's state_dict.

The inverse of `geovpr/models/convert_torch.py`'s layouts:
- conv kernels (kh, kw, in, out) -> (out, in, kh, kw);
- Dense kernels (in, out) -> nn.Linear weights (out, in);
- the attention's separate query/key/value Dense layers -> one fused
  (D, 3D) `attn.qkv_weight` with q|k|v column blocks and a (3D,) bias; the
  out projection stays (in, out) as `attn.proj_weight`, the layout the fused
  attention kernel takes;
- Swin's PatchMerging `reduction` kernel (no bias) stays (in, out) as
  `reduction_weight`, the layout the fused boundary kernel takes; the
  relative-position bias table keeps its name and layout;
- LayerNorm scale/bias (and the `PScaleBias` scale/bias of Swin's
  norm1/norm2) -> weight/bias; `blockN` -> `blocks.N`; Swin's
  `stage{s}_block{b}` and `stage{s}_downsample` scopes keep their names,
  and `RegressionModel`'s `backbone`/`head` scopes become its submodules;
- the int8 serving "quant" collection, where present, -> the buffers of
  the same names (`backbone.blocks.0.mlp.fc1_kernel_q`, ...), each leaf
  kept as it is: int8 kernels int8 and (in, out), 0-d scales 0-d;
- the "batch_stats" collection (EfficientNet's BatchNorms) -> each
  BatchNorm's buffers, `mean` -> `running_mean`, `var` -> `running_var`;
- depthwise kernels (kh, kw, 1, C) take the same 4-D transpose as any conv,
  to torch's (C, 1, kh, kw); EfficientNet's squeeze-excite `fc1`/`fc2` are
  1x1 convs and ConvNeXt's LayerScale `gamma` a leaf of its block's scope,
  so both map by name.

`load_flax_msgpack` reads the `.msgpack` file `geovpr.cli.retrieve
--variables` reads (flax's `msgpack_serialize` format) without flax or jax;
`save_flax_msgpack` writes one, byte for byte what flax writes for the
same numpy tree, so one file serves both packages.
`optimizer_state_from_flax` carries optax's Adam state (`mu`, `nu`,
`count`, `lr_scale`) across to the port's `train.optimizer.Optimizer`,
the moments through the same name and layout map as the parameters.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_QKV = ("query", "key", "value")


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def torch_name(path: tuple) -> str:
    """A flax path -> the port's dotted state_dict name."""
    parts = []
    for p in path:
        if p.startswith("block") and p[5:].isdigit():
            parts += ["blocks", p[5:]]
        else:
            parts.append(p)
    return ".".join(parts)


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict:
    """Map a (numpy) flax variables tree — `{"params": ...}` (with optional
    "quant" and "batch_stats" collections) or the params tree itself — of
    `DinoV2`, `DinoV2Salad`, `SaladHead`, `SwinTransformer`,
    `EfficientNetB0`, `ConvNeXt` or `RegressionModel`
    (a `scaler` entry beside "params" is not part of it) to the port's
    state_dict: parameters as
    float32 tensors (`load_state_dict` casts them to each parameter's
    dtype: a serving build's compute dtype, a training build's f32, where
    the fused (D, 3D) qkv weight of DINOv2 and Swin keeps JAX's f32 q, k
    and v kernels exactly), quant leaves in their own dtype and shape."""
    params = variables.get("params", variables)
    quant = variables.get("quant", {}) if "params" in variables else {}
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    flat = _flatten(params)
    sd: dict[str, np.ndarray] = {}
    qkv: dict[tuple, dict] = {}
    for path, arr in flat.items():
        *mod, leaf = path
        if len(mod) >= 2 and mod[-2] == "attn" and mod[-1] in _QKV:
            qkv.setdefault(tuple(mod[:-1]), {})[(mod[-1], leaf)] = arr
            continue
        if len(mod) >= 2 and mod[-2] == "attn" and mod[-1] == "proj":
            name = torch_name(tuple(mod[:-1]))
            sd[f"{name}.proj_{'weight' if leaf == 'kernel' else 'bias'}"] = arr
            continue
        if mod and mod[-1] == "reduction" and leaf == "kernel":
            sd[f"{torch_name(tuple(mod[:-1]))}.reduction_weight"] = arr
            continue
        name = torch_name(tuple(mod))
        prefix = f"{name}." if name else ""
        if leaf == "kernel" and arr.ndim == 4:
            sd[prefix + "weight"] = np.transpose(arr, (3, 2, 0, 1))
        elif leaf == "kernel" and arr.ndim == 2:
            sd[prefix + "weight"] = arr.T
        elif leaf == "scale":
            sd[prefix + "weight"] = arr
        else:
            sd[prefix + leaf] = arr
    for mod, parts in qkv.items():
        name = torch_name(mod)
        sd[f"{name}.qkv_weight"] = np.concatenate(
            [parts[(n, "kernel")] for n in _QKV], axis=1)
        sd[f"{name}.qkv_bias"] = np.concatenate(
            [parts[(n, "bias")] for n in _QKV])
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
           for k, v in sd.items()}
    for path, arr in _flatten(quant).items():
        out[torch_name(path)] = torch.from_numpy(np.array(arr, order="C"))
    for (*mod, leaf), arr in _flatten(stats).items():
        out[f"{torch_name(tuple(mod))}.running_{leaf}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return out


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _unpack_ndarray(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        arr = _bf16_bits_to_f32(np.frombuffer(buffer, np.uint16))
    else:
        arr = np.frombuffer(buffer, np.dtype(dtype_name.decode()))
    return arr.reshape(shape)


def _ext_hook(code: int, data: bytes):
    # flax/serialization.py: ext type 1 = ndarray, 3 = numpy scalar
    # (both as msgpack (shape, dtype name, bytes)), 2 = complex
    import msgpack
    if code == 1:
        return _unpack_ndarray(data)
    if code == 3:
        return _unpack_ndarray(data)[()]
    if code == 2:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Undo flax's chunking of leaves larger than 1 GiB."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_msgpack(path: str) -> dict:
    """Read a flax `msgpack_serialize` file into a tree of numpy arrays
    (bf16 leaves widened to f32)."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading flax .msgpack variables needs the "
                          "`msgpack` package, which is not installed") from e
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


# flax/serialization.py's MAX_CHUNK_SIZE: a leaf of more bytes is written
# as a `__msgpack_chunked_array__` of flat chunks (msgpack caps an object
# at 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2**30


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    import msgpack
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    # the inverse of `_ext_hook`, as flax's `_msgpack_ext_pack`
    import msgpack
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(1, _ndarray_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(3, _ndarray_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(2, msgpack.packb((x.real, x.imag)))
    return x


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _packable(tree):
    """The tree as flax hands it to msgpack: every dict rebuilt with its
    keys sorted (flax copies the tree through `jax.tree_util`, which sorts
    them), leaves of more than MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, Mapping):
        return {k: _packable(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def save_flax_msgpack(path: str, tree: Mapping[str, Any]) -> None:
    """Write a tree of numpy arrays (str-keyed dicts, numpy scalars) as
    flax's `msgpack_serialize` does: ext type 1 for an ndarray and 3 for a
    numpy scalar, each as msgpack (shape, dtype name, bytes). The file
    restores with `flax.serialization.msgpack_restore` and with
    `load_flax_msgpack`."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("writing flax .msgpack variables needs the "
                          "`msgpack` package, which is not installed") from e
    data = msgpack.packb(_packable(tree), default=_ext_pack,
                         strict_types=True)
    with open(path, "wb") as f:
        f.write(data)


def _adam_states(tree) -> list:
    """Every node of an optax state tree (numpy leaves; namedtuples, or
    the dicts flax's `to_state_dict` makes of them) that holds Adam's
    `count`, `mu` and `nu`."""
    def field(node, name):
        if isinstance(node, Mapping):
            return node.get(name)
        return getattr(node, name, None)

    if all(field(tree, k) is not None for k in ("count", "mu", "nu")):
        return [tree]
    if isinstance(tree, Mapping):
        children = tree.values()
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return []
    return [s for c in children for s in _adam_states(c)]


def _arrays_only(tree):
    """A moment tree without optax's masked-out (non-array) leaves."""
    if isinstance(tree, Mapping):
        out = {k: _arrays_only(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree if isinstance(tree, np.ndarray) or np.isscalar(tree) \
        else None


def optimizer_state_from_flax(opt_state) -> dict:
    """optax's state of `geovpr.train.optimizer.build_optimizer` (numpy
    leaves) -> the port's `Optimizer.state_dict()`: mu and nu of every
    trained parameter under the port's names (the per-label Adam states of
    a multi-transform merged), the count and lr_scale. The params tree is
    RegressionModel's, so names start with `backbone.` / `head.`."""
    states = _adam_states(opt_state["inner"] if isinstance(opt_state, Mapping)
                          else opt_state)
    if not states:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = {}, {}

    def field(node, name):
        return node[name] if isinstance(node, Mapping) else getattr(node,
                                                                    name)

    for s in states:
        mu.update(state_dict_from_flax(_arrays_only(field(s, "mu"))))
        nu.update(state_dict_from_flax(_arrays_only(field(s, "nu"))))
    lr_scale = (opt_state["lr_scale"] if isinstance(opt_state, Mapping)
                else 1.0)
    return {"mu": mu, "nu": nu, "count": int(field(states[0], "count")),
            "lr_scale": float(np.asarray(lr_scale))}
