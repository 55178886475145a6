"""Parameter sharding rules, tensor parallelism (the port of
`geovpr.parallel.sharding_rules`).

JAX's rules (`geovpr/parallel/sharding_rules.py:26-56`) put Megatron-style
shardings on the parameter tree by name: column-parallel kernels (MLP fc1,
the attention's query / key / value, EfficientNet's squeeze-excite fc1,
SALAD's `*_fc1`, the head's `hidden0`) split their OUTPUT dimension over
the `model` axis, row-parallel ones (fc2, the attention's proj, SALAD's
`*_fc2`) their INPUT dimension; anything that does not divide, and every
other tensor, is replicated. The AdamW moments shard by the same rule.

The port's names and layouts differ by module, and `param_spec` lands the
split on the dimension JAX's rule splits:
- the fused attention `qkv_weight` is (in, 3D), q | k | v column blocks
  (`models/dinov2.py`, `models/swin.py`): its column split cuts each of the
  three thirds by output, so a rank holds the same heads of q, k and v
  (dimension 1 in 3 groups);
- the attention `proj_weight` is (in, out): the row split is dimension 0;
- `nn.Linear` weights (MLP fc1 / fc2, SALAD, the head) are (out, in), and
  the squeeze-excite 1x1 convs (out, in, 1, 1): column is dimension 0, row
  dimension 1.

How a TP step runs: the kernels (K1, K8, K9) take whole weights, as GSPMD
gathers a custom call's sharded operand. So each rank of a `model` line
stores and updates 1/tp of every sharded parameter's AdamW moments and
updates only its slice of the parameter, after the gradients' `data`
all-reduce; the slices are then all-gathered over `model`, so the next
forward, validation and a checkpoint see whole weights. The arithmetic is
world 1's, element for element; what the split saves is the moments'
memory and the update's work. A Megatron split of the activations (each
rank computing its heads and hidden units) is not here (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

COLUMN_PARALLEL = ("fc1", "query", "key", "value", "expand",
                   "feat_fc1", "score_fc1", "token_fc1", "hidden0")
ROW_PARALLEL = ("fc2", "proj", "feat_fc2", "score_fc2",
                "token_fc2")


def param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dimension of the port's tensor `name` that JAX's rule splits over
    `model`, or None (replicated)."""
    if tensor.dim() < 2:
        return None
    *scope, leaf = name.split(".")
    if leaf == "qkv_weight":               # (in, 3D): the q|k|v outputs
        return 1
    if leaf == "proj_weight":              # (in, out): the row split
        return 0
    parent = scope[-1] if scope else ""
    if leaf == "weight" and parent in COLUMN_PARALLEL:
        return 0                           # (out, in[, kh, kw])
    if leaf == "weight" and parent in ROW_PARALLEL:
        return 1
    return None


def split_groups(name: str) -> int:
    """How many blocks the split dimension holds, each cut alike: the
    fused qkv's three thirds, else one."""
    return 3 if name.rsplit(".", 1)[-1] == "qkv_weight" else 1


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of a tensor split on `dim`: the dimension viewed as
    (groups, parts, chunk), part `index` of every group."""

    dim: int
    groups: int
    parts: int
    index: int

    def _view(self, t: torch.Tensor, index: int) -> torch.Tensor:
        size = t.shape[self.dim]
        chunk = size // (self.groups * self.parts)
        return t.unflatten(self.dim, (self.groups, self.parts, chunk)
                           ).select(self.dim + 1, index)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor `t`, contiguous, with the
        split dimension 1/parts as long."""
        return self._view(t, self.index).flatten(
            self.dim, self.dim + 1).contiguous()

    def put_(self, whole: torch.Tensor, part: torch.Tensor,
             index: Optional[int] = None) -> None:
        """Write `part` (as `take` returns it) into its place in `whole`."""
        view = self._view(whole, self.index if index is None else index)
        view.copy_(part.unflatten(self.dim, view.shape[self.dim:
                                                       self.dim + 2]))

    def gather_(self, whole: torch.Tensor, part: torch.Tensor,
                group) -> None:
        """All-gather every rank's `part` over the `model` line `group`
        into `whole`."""
        wire = part.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.parts)]
        dist.all_gather(parts, wire, group=group)
        for i, p in enumerate(parts):
            self.put_(whole, p, i)


def _guarded_spec(name: str, tensor: torch.Tensor, mesh,
                  model_axis: str) -> Optional[int]:
    """`param_spec` with the divisibility guard of `geovpr/parallel/
    sharding_rules.py:47-56`: a tensor whose split does not divide evenly
    over the model axis is replicated."""
    dim = param_spec(name, tensor)
    if dim is None:
        return None
    if tensor.shape[dim] % (split_groups(name)
                            * mesh.axis_size(model_axis)) != 0:
        return None
    return dim


def shard_params(mesh, model: torch.nn.Module,
                 model_axis: str = "model") -> dict:
    """name -> `Shard` of this rank for every parameter the rules split
    over `model_axis` (nothing where the axis is absent or of size 1)."""
    tp = mesh.axis_size(model_axis)
    if tp == 1:
        return {}
    out = {}
    for name, p in model.named_parameters():
        dim = _guarded_spec(name, p, mesh, model_axis)
        if dim is not None:
            out[name] = Shard(dim, split_groups(name), tp,
                              mesh.index(model_axis))
    return out


def shard_state(mesh, state, model_axis: str = "model"):
    """Shard a `TrainState` over `model_axis`: the optimizer keeps this
    rank's part of each split parameter's moments and updates that part
    of the parameter, then gathers it whole (`Optimizer.shard`); the
    parameters, running statistics, scaler and step stay whole on every
    rank. Returns the state."""
    state.opt.shard(shard_params(mesh, state.model, model_axis),
                    mesh.group(model_axis) if model_axis in mesh.shape
                    else None)
    return state
