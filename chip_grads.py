"""Where the unfrozen DINOv2-B/14 + SALAD's kernel-vs-plain gradient gap
comes from, on one CUDA card.

    python3 chip_grads.py

Trains the configuration of chip_smoke.py's `[train_disk]` as that phase
does (the preset dinov2salad_frozen_mlp with the backbone unfrozen,
`backbone_lr_scale` 0.1, remat, the cache in RAM, asynchronous
checkpoints, 64 seeded JPEGs, B=32, 2 epochs of 2 steps), so that the
state and the batch are the ones its gradient check reads. On that batch,
dropout and DropPath off, it computes the gradient of every parameter on
these routes:

- `kernel`: K8a forward and K8c backward in every block;
- `plain`: the plain versions of both (bf16), the check's reference;
- `f32`: the plain versions in f32;
- `k8a_only`: K8a forward, the plain backward;
- `k8c_only`: the plain forward, K8c backward;
- `plain_resum`: the plain versions with every f32 product of the
  attention half-block summed in two halves of its inner dimension (the
  same arithmetic in another order: a second plain path as right as the
  first);
- `block_i`: K8a and K8c in block i only, the plain versions elsewhere;
- `plain_masked_as_kernel` / `resum_masked_as_plain`: the plain (resummed)
  path with each ReLU of the SALAD head (feat, score, token MLP) passing
  exactly the units the kernel (plain) path's ReLU passed on this batch.

It prints one `[grads_route]` line per route (the cosine of each tensor's
gradient against the plain path's: the minimum, the worst tensors and the
tensors the check flagged; the relative distance from the f32 gradient
of those tensors, and its root mean square over all, each beside the
plain path's), one `[relu_flips]` line per pair of paths (the units of
each ReLU whose sign differs, and the largest |pre-activation| among them)
and `[cls_diff]` (how far the backbone's CLS output moves). The two SALAD
parameters whose gradient is zero in exact arithmetic are left out, as in
the check. A diagnosis script: it gates nothing and exits 0 once it has
printed.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

WATCH = ("backbone.salad.token_fc1.bias", "backbone.salad.token_fc1.weight",
         "backbone.backbone.cls_token", "backbone.backbone.pos_embed",
         "backbone.salad.score_fc1.bias", "backbone.salad.score_fc1.weight")


def _mm_resum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`ops.mhsa._mm` with its inner dimension summed in two halves."""
    h = a.shape[-1] // 2
    return (torch.matmul(a[..., :h].float(), b[..., :h, :].float())
            + torch.matmul(a[..., h:].float(), b[..., h:, :].float()))


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def trained_state(device):
    """The `[train_disk]` RAM run's trainer and its first training batch."""
    from geovpr_torch.data.pipeline import CachedImageSource, ImageFolderSource

    decoder = cs.native_decoder_probe()
    cfg = cs._disk_cfg(decoder, "ram")
    size, batch = cfg.data.image_size, cfg.data.batch_size
    blocks = cs._dino_blocks(cfg)
    tmp = tempfile.mkdtemp()
    img_dir = os.path.join(tmp, "img")
    os.makedirs(img_dir)
    paths, targets = cs.disk_images(img_dir, cs.DISK_IMAGES,
                                    np.random.default_rng(cs.SEED + 21))

    def source(idx):
        return CachedImageSource(ImageFolderSource(
            paths=[paths[i] for i in idx], targets=targets[idx],
            image_size=size, num_threads=8, decoder=decoder))

    trainer, _ = cs.train_run(
        cfg, source(np.arange(cs.DISK_IMAGES)), source(np.arange(cs.DISK_VAL)),
        device, os.path.join(tmp, "ram"), cs.DISK_EPOCHS,
        {"fused_mhsa_train_fwd": (2 * blocks, 0),
         "fused_mhsa_bwd_all": (blocks, 0),
         "fused_mhsa_block": (0, blocks)}, "dinov2salad-unfrozen-ram")
    tb = next(iter(cs._train_batches(source(np.arange(cs.DISK_IMAGES)),
                                     device, batch)))
    return trainer, tb


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_grads: no CUDA device is available", file=sys.stderr)
        return 1
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = cs.card_line()
    print(card)
    load_library()
    t0 = time.perf_counter()
    trainer, batch = trained_state(device)
    st, model = trainer.state, trainer.state.model
    cs._drop_rates(model, 0.0)
    model.train()
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)
    names = [n for n, _ in model.named_parameters()]
    keep = [i for i, n in enumerate(names) if n not in cs.ROUNDOFF_GRADS]
    blocks = cs.kernel_blocks(model)
    compute = model.backbone.dtype
    probe = cs.SaladRelus()
    cls_out, seen = {}, []
    model.backbone.backbone.register_forward_hook(
        lambda mod, args, out: seen.append(out.cls.detach().float()))

    def grads(route, kernels=(), dtype=compute, masks=None):
        probe.seen, probe.masks = [], masks
        seen.clear()
        for i, m in enumerate(blocks):
            m.use_kernels = i in kernels
        cs.set_compute_dtype(model, dtype)
        try:
            with cs.kept_batch_stats(model):
                loss = trainer.objective.loss(
                    model(trainer._normalize(batch["image"])), enc,
                    batch["mask"])
                g = torch.autograd.grad(loss, list(model.parameters()))
            cls_out[route] = seen[0]
            return [g[i].float() for i in keep], list(probe.seen)
        finally:
            for m in blocks:
                m.use_kernels = True
            cs.set_compute_dtype(model, compute)

    every = range(len(blocks))
    with cs.salad_relus(probe):
        run = {"kernel": grads("kernel", every), "plain": grads("plain"),
               "f32": grads("f32", dtype=torch.float32)}
        with patched(mh, "fused_mhsa_bwd_all",
                     lambda *a: mh.mhsa_train_bwd_reference(*a)):
            run["k8a_only"] = grads("k8a_only", every)
        with patched(mh, "fused_mhsa_train_fwd",
                     mh.mhsa_train_fwd_reference):
            run["k8c_only"] = grads("k8c_only", every)
        with patched(mh, "_mm", _mm_resum):
            run["plain_resum"] = grads("plain_resum")
        for b in every:
            run[f"block_{b}"] = grads(f"block_{b}", (b,))
        signs = {r: [x > 0 for x in run[r][1]] for r in
                 ("kernel", "plain", "plain_resum")}
        run["plain_masked_as_kernel"] = grads(
            "plain_masked_as_kernel", masks=signs["kernel"])
        with patched(mh, "_mm", _mm_resum):
            run["resum_masked_as_plain"] = grads(
                "resum_masked_as_plain", masks=signs["plain"])

    kept = [names[i] for i in keep]
    ref, f32 = run["plain"][0], run["f32"][0]

    def rel(g, r):
        return [(a - b).norm().item() / (b.norm().item() or 1.0)
                for a, b in zip(g, r)]

    plain_err = rel(ref, f32)
    plain_rms = float(np.sqrt(np.mean(np.square(plain_err))))
    for route, (g, _) in run.items():
        if route in ("plain", "f32"):
            continue
        against = run["kernel"][0] if route == "plain_masked_as_kernel" \
            else ref
        cos = {n: cs._cosine(a, b) for n, a, b in zip(kept, g, against)}
        err = rel(g, f32)
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
        cs.phase("grads_route", route=route,
                 against="kernel" if route == "plain_masked_as_kernel"
                 else "plain", tensors=len(cos), min_cosine=worst[0][1],
                 below_0_999=sum(v < 0.999 for v in cos.values()),
                 worst=repr(worst),
                 watch=repr({n: round(cos[n], 6) for n in WATCH}),
                 f32_rel_err_watch=repr({
                     n: (round(err[kept.index(n)], 6),
                         round(plain_err[kept.index(n)], 6))
                     for n in WATCH}),
                 f32_rms_ratio=float(np.sqrt(np.mean(np.square(err))))
                 / plain_rms)
    for a, b in (("kernel", "plain"), ("plain_resum", "plain"),
                 ("kernel", "plain_resum")):
        flips = []
        for which, xa, xb in zip(("feat", "score", "token"), run[a][1],
                                 run[b][1]):
            d = (xa > 0) != (xb > 0)
            band = torch.maximum(xa.float().abs(), xb.float().abs())[d]
            flips.append((which, int(d.sum()), xa.numel(),
                          float(band.max()) if d.any() else 0.0))
        cs.phase("relu_flips", pair=f"{a}/{b}", flips=repr(flips))
    for r in ("kernel", "plain_resum", "k8a_only", "k8c_only"):
        d = (cls_out[r] - cls_out["plain"]).abs()
        cs.phase("cls_diff", route=r, against="plain",
                 max_abs=d.max().item(),
                 rel_norm=(d.norm() / cls_out["plain"].norm()).item(),
                 f32_rel_norm=((cls_out[r] - cls_out["f32"]).norm()
                               / cls_out["f32"].norm()).item())
    cs.phase("chip_grads", card=repr(card),
             seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
