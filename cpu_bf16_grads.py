"""How far a bf16 training gradient sits from the f32 one, in the JAX package
and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 cpu_bf16_grads.py PRESET [--batch B]
        [--perturb] [--size S]

For one training preset at full width (its published variant), seeded
random weights carried from the JAX model to the port by
`geovpr_torch.models.convert_jax`, and one batch of B seeded images and
targets, computes four gradients of the preset's loss: JAX's in bf16 and
in f32 (`RegressionModel(dtype=...)` under `jax.value_and_grad`, as
`make_train_step`'s `loss_fn`, BatchNorm on the batch's statistics where
the model has any), and the port's plain path (`use_kernels=False`) in
bf16 and in f32. Dropout, DropPath and augmentation are off. Prints, for
each pair, the per-tensor cosine (min, median, the four worst) and the
cosine over all tensors: each bf16 gradient against its own package's
f32 gradient, the two f32 gradients against each other, and the two bf16
gradients. Tensors whose gradient is zero in exact arithmetic (the
attention's key bias; a BatchNorm bias that only a 1x1 conv and another
training-mode BatchNorm follow, EfficientNet's `project.bn.bias`) are
left out. `--perturb` moves LayerScale gammas and norm scales off their
init (gammas to U(0.05, 0.15)), so that every block contributes.

This is a CPU measurement of numerics, not of speed: bf16 on the CPU is
XLA's and oneDNN's, not the card's. It imports both packages and runs
only where JAX is installed.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROUNDOFF = ("attn.qkv_bias", "project.bn.bias")


def _cfgs(preset: str, size: int):
    from geovpr.cli.presets import build_preset as j_build
    from geovpr_torch.cli.presets import build_preset
    out = []
    for build in (j_build, build_preset):
        c = build(preset)
        size = size or c.data.image_size
        out.append(dataclasses.replace(c, model=dataclasses.replace(
            c.model, head_dropout=0.0, image_size=size),
            data=dataclasses.replace(c.data, augment="none",
                                     image_size=size)))
    return out


def _perturb(params):
    def one(path, v):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = name.split("/")[-1]
        key = jax.random.PRNGKey(len(name))
        if leaf == "gamma":
            return jax.random.uniform(key, v.shape, minval=0.05, maxval=0.15)
        if leaf == "scale":
            return v * jax.random.uniform(key, v.shape, minval=0.5,
                                          maxval=1.5)
        return v
    return jax.tree_util.tree_map_with_path(one, params)


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b / (na * nb)) if na and nb else 0.0


def main(argv=None) -> None:
    from geovpr.cli.presets import objective_for as j_objective
    from geovpr.core.config import GeoposeConfig
    from geovpr.data.transforms import normalize as j_normalize
    from geovpr.train.model import RegressionModel as JModel
    from geovpr_torch.cli.presets import objective_for
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.layers import Dropout, DropPath
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import identity_scaler

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("preset")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=0)
    p.add_argument("--perturb", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    jcfg, tcfg = _cfgs(args.preset, args.size)
    if isinstance(jcfg, GeoposeConfig):
        raise SystemExit("angle presets only (the targets are headings)")
    size, b = jcfg.data.image_size, args.batch
    rng = np.random.default_rng(args.seed)
    img = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    ang = rng.uniform(0, 360, b).astype(np.float32)
    mask = np.ones(b, bool)

    variables = JModel(config=jcfg.model, dtype=jnp.float32).init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, size, size, 3)))
    params = variables["params"]
    if args.perturb:
        params = _perturb(params)
    stats = variables.get("batch_stats", {})
    params = jax.tree_util.tree_map(np.asarray, params)
    jobj = j_objective(jcfg)
    enc = jobj.encode_targets(jnp.asarray(ang), None)
    x = j_normalize(jnp.asarray(img))

    def jax_grads(dtype) -> dict:
        m = JModel(config=jcfg.model, dtype=dtype)

        def loss_fn(p):
            v = {"params": p}
            if stats:
                v["batch_stats"] = stats
                preds, _ = m.apply(v, x, train=True, deterministic=True,
                                   mutable=["batch_stats"])
            else:
                preds = m.apply(v, x, train=True, deterministic=True)
            return jobj.loss(preds, enc, jnp.asarray(mask))

        g = jax.jit(jax.grad(loss_fn))(params)
        return {k: v.numpy() for k, v in state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, g)).items()}

    def port_grads(dtype) -> dict:
        model = RegressionModel(tcfg.model, dtype=dtype, train=True)
        sd = {"params": params}
        if stats:
            sd["batch_stats"] = jax.tree_util.tree_map(np.asarray, stats)
        model.load_state_dict(state_dict_from_flax(sd))
        for m in model.modules():
            if isinstance(m, (Dropout, DropPath)):
                m.rate = 0.0
            if hasattr(m, "use_kernels"):
                m.use_kernels = False
        model.train()
        obj = objective_for(tcfg)
        loss = obj.loss(model(normalize(torch.from_numpy(img))),
                        obj.encode_targets(torch.from_numpy(ang),
                                           identity_scaler(2)),
                        torch.from_numpy(mask))
        names = [n for n, _ in model.named_parameters()]
        g = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
        return {n: (np.zeros(q.shape, np.float32) if t is None
                    else t.float().numpy())
                for n, q, t in zip(names, model.parameters(), g)}

    grads = {"jax_f32": jax_grads(jnp.float32),
             "jax_bf16": jax_grads(jnp.bfloat16),
             "port_f32": port_grads(torch.float32),
             "port_bf16": port_grads(torch.bfloat16)}
    print(f"preset={args.preset} size={size} batch={b} "
          f"perturb={args.perturb}")
    for name, (a, c) in (("jax bf16 vs jax f32", ("jax_bf16", "jax_f32")),
                         ("port bf16 vs port f32", ("port_bf16", "port_f32")),
                         ("jax f32 vs port f32", ("jax_f32", "port_f32")),
                         ("jax bf16 vs port bf16", ("jax_bf16",
                                                    "port_bf16"))):
        ga, gc = grads[a], grads[c]
        keys = [k for k in gc if not k.endswith(ROUNDOFF)]
        cos = {k: _cos(ga[k], gc[k]) for k in keys}
        vals = np.array(list(cos.values()))
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
        whole = _cos(np.concatenate([ga[k].ravel() for k in keys]),
                     np.concatenate([gc[k].ravel() for k in keys]))
        print(f"{name}: tensors={len(vals)} min={vals.min():.6f} "
              f"median={np.median(vals):.6f} all={whole:.6f} worst="
              f"{[(k, round(v, 6)) for k, v in worst]}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
