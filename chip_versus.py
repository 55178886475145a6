"""K2, K7, K8b, K8c, K9a, K9b and K9c times, the window-7 attention half,
the w8a8 models' and the Swin-T-224 heading model's img/s and the
Swin-B-384 and DINOv2-B/14 training steps' device time of several
checkouts, in turns, on one CUDA card.

    python3 chip_versus.py [--only=SECTION,...] CHECKOUT [CHECKOUT ...]

Each argument (`.` for this checkout, or an unpacked `git archive` of an
earlier commit in a gitignored directory) runs in a process of its own,
with its own `geovpr_torch` and `chip_smoke.py` first on the path, builds
its own kernels and prints `[versus]` lines: the CUDA-event ms of K2 at
DINOv2-B/14's 64x257x768x12, of K8b at DINOv2's training shapes
16x257x768x12 (base-14) and 16x257x1024x16 (large-14) and K8c at
16x257x768x12, each in ROUNDS rounds of turns with its library yardstick
(the backward of F.scaled_dot_product_attention on the same q, k, v for
K8b, `library_k1`'s whole backward for K8c; the order reversed every other
round), of K9c at the three Swin-B-384 stages that take it (B=16), of
K9a and of the core backward (K9b's launch, which K9c's launch 3 shares)
at the four Swin-B-384 stages (B=16), each whole and kernel by kernel
(the device ms of each kernel name under torch.profiler), the
ms per B=64 batch and img/s of the w8a8 DINOv2-B/14 + SALAD descriptors
(224 px) and the w8a8 Swin-B-384 geopose model (384 px), each calibrated
on its first batch, and one training step of Swin-B-384 (preset
swin_b384_gemini2) and of DINOv2-B/14 (dinov2_meanpool_huber), B=16: host
ms per step over 5 synchronised steps, and the device-busy ms of one step
under torch.profiler. Section k7: K7 at Swin-T-224's four stages at B=64,
on pre-split windows (`window_attention_kernel`) and, where the checkout
has it, on the raster qkv (`window_attention_raster`), each in CUDA graphs
(`ms`, the host's launch cost left out) and by CUDA events around calls
launched from Python (`event_ms`); then the whole
window-7 attention half (`swin_attn_block_unfused` as the model's serving
path calls it) at each stage, its CUDA-event ms and, under
torch.profiler, the device ms and calls of each kernel and the calls of
each aten op. Section angle: the Swin-T-224 heading model (preset
swin_t224_sincos_gemini, bf16) at B=64, ms per batch, img/s and its
`[breakdown]`. Section k1: K1 at 64x257x768x12 and K8a (K1's launches,
keeping qkv and ctx) at 16x257x768x12, by CUDA events around K1_CALLS
calls launched from Python (`event_ms`, the wrappers' host work included)
and in CUDA graphs (`ms`). Inputs and weights are chip_smoke.py's, from
seed 0. Name the checkouts in turns (`OLD . . OLD`) to compare two on one
card. `--only` runs the named sections alone, of: k1, k2, k7, angle, k9c,
k9, models, k8, swin_step, dinov2_step. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
ITERS = 10
ROUNDS = 4
K1_CALLS = 200
SECTIONS = ("k1", "k2", "k7", "angle", "k9c", "k9", "models", "k8",
            "swin_step", "dinov2_step")
# Swin-T-224 at B=64, stages 0-3: K7's (BW, H, N, nW; nW 0 unshifted) and
# the half's (B, C, H, resolution, window, shift), shifted where the stage
# has shifted blocks
K7_STAGES = ((4096, 3, 49, 64), (1024, 6, 49, 16), (256, 12, 49, 4),
             (64, 24, 49, 0))
HALF_STAGES = ((64, 96, 3, 56, 7, 3), (64, 192, 6, 28, 7, 3),
               (64, 384, 12, 14, 7, 3), (64, 768, 24, 7, 7, 0))


def _train_step_times(cs, dev, line, preset: str, name: str) -> None:
    """One training step of `preset` on a fixed batch of 16 synthetic
    images (dropout and DropPath off): host ms over 5 synchronised steps,
    then the device-busy ms of one step under torch.profiler."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import fit_scaler
    from geovpr_torch.train.state import create_train_state
    from geovpr_torch.train.steps import make_train_step

    cfg = build_preset(preset)
    size = cfg.data.image_size
    src = cs.synthetic_val(cs.TRAIN_BATCH, size,
                           np.random.default_rng(cs.SEED + 7))
    model = RegressionModel(dataclasses.replace(cfg.model, image_size=size),
                            dtype=torch.bfloat16, train=True).to(dev)
    st = create_train_state(model, cfg.optim, seed=cs.SEED,
                            scaler=fit_scaler(src.targets),
                            out_dim=cfg.model.out_dim)
    cs._drop_rates(model, 0.0)
    step = make_train_step(objective_for(cfg))
    batch = {"image": torch.from_numpy(src.images).to(dev),
             "target": torch.from_numpy(src.targets).to(dev),
             "mask": torch.ones(cs.TRAIN_BATCH, dtype=torch.bool,
                                device=dev)}
    for _ in range(2):
        step(st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(st, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(st, batch)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3
    line(name, f"B{cs.TRAIN_BATCH}", ms,
         device_busy_ms=busy if busy else "not measured")
    del model, st, batch
    torch.cuda.empty_cache()


def _k1_times(cs, dev, line) -> None:
    """K1 at DINOv2-B/14's serving shape and K8a at its training shape:
    `cuda_ms` over K1_CALLS calls (`event_ms`) and `graph_ms` (`ms`)."""
    from geovpr_torch.ops import mhsa as mh

    a, _ = cs.k8_case(cs.K8_MAIN, dev)
    fa = cs._k8_fwd_args(a, cs.K8_MAIN[3])
    b, n, d, h = cs.MAIN_SHAPE
    x, vecs, mats = cs.block_inputs(b, n, d, torch.Generator().manual_seed(
        cs.SEED), dev)
    k1 = (x, vecs["ln_scale"], vecs["ln_bias"], mats["wqkv"], vecs["bqkv"],
          mats["wo"], vecs["bo"], vecs["gamma"], h)
    with torch.no_grad():
        for name, shape, fn in (
                ("K8a", cs.K8_MAIN, lambda: mh.fused_mhsa_train_fwd(*fa)),
                ("K1", cs.MAIN_SHAPE, lambda: mh.fused_mhsa_block(*k1))):
            line(name, "B{}_N{}_D{}_H{}".format(*shape), cs.graph_ms(fn),
                 event_ms=cs.cuda_ms(fn, K1_CALLS))
    del a, fa, x, vecs, mats, k1
    torch.cuda.empty_cache()


def _k8_times(cs, dev, line) -> None:
    """K8b at both DINOv2 training shapes and K8c at base-14's, each in
    ROUNDS rounds of turns with its library yardstick."""
    import torch.nn.functional as F

    from geovpr_torch.ops import mhsa as mh

    for shape in cs.K8_SHAPES:
        h, d = shape[3], shape[2]
        tag = "B{}_N{}_D{}_H{}".format(*shape)
        a, g = cs.k8_case(shape, dev)
        fa = cs._k8_fwd_args(a, h)
        with torch.no_grad():
            res = mh.fused_mhsa_train_fwd(*fa)
        qh, kh, vh = (mh._heads(t, h).contiguous().requires_grad_()
                      for t in res[1].split(d, dim=-1))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qh, kh, vh)
        g_o = torch.randn(o.shape, device=dev, dtype=o.dtype)
        fns = {"K8b": lambda: mh.fused_mhsa_bwd_core(res[1], g, h),
               "K8b_sdpa_backward": lambda: torch.autograd.grad(
                   o, (qh, kh, vh), g_o, retain_graph=True)}
        if mh.bwd_all_ok(d):
            ba = cs._k8_bwd_args(a, res, g, h)
            leaves = [t.detach().requires_grad_() for t in fa[:8]]
            with torch.enable_grad():
                y_lib = cs.library_k1(*leaves, h)
            fns["K8c"] = lambda: mh.fused_mhsa_bwd_all(*ba)
            fns["K8c_library_k1_backward"] = lambda: torch.autograd.grad(
                y_lib, leaves, g, retain_graph=True)
        names = list(fns)
        for r in range(ROUNDS):
            for name in names if r % 2 == 0 else names[::-1]:
                with torch.enable_grad():
                    ms = cs.cuda_ms(fns[name], ITERS)
                line(name, tag, ms, round=r)
        del a, g, res, qh, kh, vh, o, fns
        torch.cuda.empty_cache()


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name with its template arguments, without
    its return type, namespace and parameters."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def _k9_times(cs, dev, line) -> None:
    """K9a and the core backward (`fused_swin_attn_bwd_core`: the core and
    the reduce of its dbias partials) at the four Swin-B-384 stages: the
    CUDA-event ms of a whole call, then the device ms of each kernel of
    one call by name under torch.profiler (averaged over ITERS calls)."""
    from torch.profiler import ProfilerActivity, profile

    from geovpr_torch.ops import swin_block as sb

    with torch.no_grad():
        for shape in cs.K9_SHAPES:
            tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
            a, g, geom = cs.k9_case(shape, dev)
            geo = tuple(geom.values())
            fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
                  a["wo"], a["bo"], a["table"], *geo, 1e-5)
            _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*fa)
            fns = (("K9a", lambda: sb.fused_swin_attn_train_fwd(*fa)),
                   ("K9b", lambda: sb.fused_swin_attn_bwd_core(qkv, p, g,
                                                               *geo)))
            for name, fn in fns:
                ms = cs.cuda_ms(fn, ITERS)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(ITERS):
                        fn()
                    torch.cuda.synchronize()
                kernels = {_kernel_name(e.key):
                           e.self_device_time_total / ITERS / 1e3
                           for e in prof.key_averages()
                           if e.self_device_time_total > 0}
                line(name, tag, ms, kernels=kernels)
            del a, g, qkv, ctx, p, fns
            torch.cuda.empty_cache()


def _profiled(fn):
    """Device ms and calls of each kernel name, and calls of each aten op,
    over ITERS calls of fn under torch.profiler (per call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    kernels, ops = {}, {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[_kernel_name(e.key)[:100]] = (
                e.self_device_time_total / ITERS / 1e3, e.count / ITERS)
        elif e.key.startswith("aten::"):
            ops[e.key] = e.count / ITERS
    return kernels, ops


def _k7_times(cs, dev, line) -> None:
    """K7 at Swin-T-224's four stages (B=64) on pre-split windows and, in
    a checkout that has it, on the raster qkv; then the window-7
    attention half at each stage as the model's serving path runs it, whole
    (CUDA events) and kernel by kernel (torch.profiler)."""
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops import window_attention as wa

    raster = getattr(wa, "window_attention_raster", None)
    with torch.inference_mode():
        for shape, half in zip(K7_STAGES, HALF_STAGES):
            tag = "BW{}_H{}_N{}_nW{}".format(*shape)
            args = cs.k7_case(shape, dev)
            fns = {"K7": lambda: wa.window_attention_kernel(*args)}
            if raster is not None:
                rargs = cs.k7_raster_case(half, dev)
                fns["K7_raster"] = lambda: raster(*rargs)
            for name, fn in fns.items():
                line(name, tag, cs.graph_ms(fn), event_ms=cs.cuda_ms(fn,
                                                                     ITERS))
            del args, fns
        for half in HALF_STAGES:
            b, c, h, res, win, shift = half
            x, blk = cs.swin_block_case(half, dev)
            args = cs.k4_args(x, blk)[:8]
            attn = raster or wa.window_attention_kernel

            def fn():
                return sb.swin_attn_block_unfused(
                    *args, num_heads=h, resolution=res, window=win,
                    shift=shift, attention=attn)

            ms = cs.cuda_ms(fn, ITERS)
            kernels, ops = _profiled(fn)
            line("window7_half", "B{}_C{}_H{}_S{}_w{}_shift{}".format(*half),
                 ms, kernels=kernels, ops=ops)
            del x, blk, args
    torch.cuda.empty_cache()


def _angle_times(cs, dev, line, card: str, label: str) -> None:
    """The Swin-T-224 heading model at B=64, bf16: ms per batch (CUDA
    events) and img/s, then chip_smoke.py's `[breakdown]` of one batch."""
    import numpy as np

    from geovpr_torch.data.transforms import normalize

    source = cs.synthetic_val(cs.ANGLE_BATCH, 224,
                              np.random.default_rng(cs.SEED), angles=True)
    images = torch.from_numpy(source.images).to(dev)
    model, _ = cs.angle_model(dev, cs.ANGLE_PRESET)
    with torch.inference_mode():
        x = normalize(images)
        ms = cs.cuda_ms(lambda: model(x), ITERS)
    line("swin_t224_angle", f"B{cs.ANGLE_BATCH}", ms,
         img_per_s=cs.ANGLE_BATCH * 1e3 / ms)
    cs.breakdown(model, images, card, f"swin-t-bf16@{label}",
                 batch=cs.ANGLE_BATCH)
    del model, images, x
    torch.cuda.empty_cache()


def run(label: str, sections=SECTIONS) -> None:
    """In the child: this process's checkout's kernels and models, the
    sections of SECTIONS named in `sections`."""
    import numpy as np

    import chip_smoke as cs
    from geovpr_torch.cli.retrieve import build_model
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.models.quantize import quantize_for_serving
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops._build import load_library
    from geovpr_torch.ops.mhsa import fused_mhsa_block_int8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    load_library()

    def line(name, shape, ms, **more):
        cs.phase("versus", checkout=label, card=repr(card), name=name,
                 shape=shape, ms=ms, **more)

    if "k1" in sections:
        _k1_times(cs, dev, line)
    if "k2" in sections:
        with torch.inference_mode():
            b, n, d, h = cs.MAIN_SHAPE
            x, k2, _ = cs.int8_block_case(b, n, d, h, dev)
            line("K2", f"B{b}_N{n}_D{d}_H{h}", cs.cuda_ms(
                lambda: fused_mhsa_block_int8(x, **k2, num_heads=h), ITERS))
            del x, k2
    if "k7" in sections:
        _k7_times(cs, dev, line)
    if "angle" in sections:
        _angle_times(cs, dev, line, card, label)
    if "k9c" in sections:
        with torch.no_grad():
            for shape in cs.K9_SHAPES[:3]:
                a, g, geom = cs.k9_case(shape, dev)
                geo = tuple(geom.values())
                _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(
                    a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"],
                    a["bqkv"], a["wo"], a["bo"], a["table"], *geo, 1e-5)
                ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"],
                      a["wo"], qkv, ctx, p, g, *geo, 1e-5)
                line("K9c", "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
                     cs.cuda_ms(lambda: sb.fused_swin_attn_bwd_all(*ba),
                                ITERS))
                del a, g, qkv, ctx, p, ba
            torch.cuda.empty_cache()
    if "k9" in sections:
        _k9_times(cs, dev, line)
    if "models" in sections:
        with torch.inference_mode():
            gallery = cs.synthetic_gallery(cs.BATCH, cs.IMAGE_SIZE,
                                           np.random.default_rng(cs.SEED))
            images = normalize(torch.from_numpy(gallery.images).to(dev))
            model = build_model(cs.VARIANT, cs.IMAGE_SIZE, dev, seed=cs.SEED,
                                int8=True)
            quantize_for_serving(model, [images])
            ms = cs.cuda_ms(lambda: model(images), ITERS)
            line("dinov2_b14_salad_int8", f"B{cs.BATCH}", ms,
                 img_per_s=cs.BATCH * 1e3 / ms)
            del model, images

            source = cs.synthetic_val(cs.SWIN_BATCH, 384,
                                      np.random.default_rng(cs.SEED))
            images = normalize(torch.from_numpy(source.images).to(dev))
            model, _ = cs.swin_model(dev, source.targets, int8=True)
            quantize_for_serving(model, [images])
            ms = cs.cuda_ms(lambda: model(images), ITERS)
            line("swin_b384_int8", f"B{cs.SWIN_BATCH}", ms,
                 img_per_s=cs.SWIN_BATCH * 1e3 / ms)
            del model, images
        torch.cuda.empty_cache()
    if "k8" in sections:
        _k8_times(cs, dev, line)
    if "swin_step" in sections:
        _train_step_times(cs, dev, line, cs.TRAIN_PRESET,
                          "swin_b384_train_step")
    if "dinov2_step" in sections:
        _train_step_times(cs, dev, line, "dinov2_meanpool_huber",
                          "dinov2_b14_train_step")


def _child(checkout: Path, label: str, sections) -> None:
    code = (f"import sys; sys.path[:0] = [{str(checkout)!r}]\n"
            f"import geovpr_torch\n"
            f"assert geovpr_torch.__file__.startswith({str(checkout)!r})\n"
            f"import importlib.util as u\n"
            f"spec = u.spec_from_file_location('chip_versus_run', "
            f"{str(REPO / 'chip_versus.py')!r})\n"
            f"mod = u.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            f"mod.run({label!r}, {tuple(sections)!r})\n")
    subprocess.run([sys.executable, "-c", code], cwd=checkout, check=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sections = SECTIONS
    if argv and argv[0].startswith("--only="):
        sections = tuple(argv.pop(0)[len("--only="):].split(","))
        if not set(sections) <= set(SECTIONS):
            print(f"chip_versus: sections are {SECTIONS}", file=sys.stderr)
            return 2
    if not argv:
        print(__doc__.strip().splitlines()[4], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_versus: no CUDA device is available", file=sys.stderr)
        return 1
    for i, arg in enumerate(argv):
        checkout = Path(arg).resolve()
        _child(checkout, f"{i}:{arg}", sections)
    return 0


if __name__ == "__main__":
    sys.exit(main())
