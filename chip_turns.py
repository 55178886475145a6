"""The f32 ViT attention half-block's kernels of several checkouts, in
turns in one process, on one CUDA card: its forward (K1.f32, K8a.f32), the
attention-backward core (K8b.f32) and the whole backward (K8c.f32).

    python3 chip_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT (`.` for this one, or an unpacked `git archive` of another
commit in a gitignored directory) has its kernels built from its own
`geovpr_torch/csrc` into its own build directory by its own
`geovpr_torch/ops/_build.py`, and every library is loaded into this one
process, so that the checkouts share the card, its clocks and the inputs.
The inputs are chip_smoke.py's (this checkout's) from seed 0, K8b.f32's and
K8c.f32's residuals from the plain f32 forward. Each time is the mean of
ITERS calls of one checkout's C entry captured in a CUDA graph
(`chip_smoke.graph_ms`: the host's launch cost left out), the checkouts
in turns, forward then backward order, for ROUNDS rounds:
- K8b.f32 (`geovpr_vit_f32_bwd_core`) at 16x257x1024x16 (DINOv2-L/14's
  training shape, where the split backward runs it) and 16x257x768x12
  (DINOv2-B/14's);
- K8c.f32 (`geovpr_vit_f32_bwd_all`) at 16x257x768x12, whole, and those
  of its launches that run the core or a product one by one
  (`geovpr_vit_f32_bwd_all_parts`, on buffers a whole call filled): da,
  dWo, dgamma, the core, dWqkv, dh;
- K1.f32 at 64x257x768x12 and K8a.f32 (the same launches) at
  16x257x768x12 (`geovpr_mhsa_f32_parts`), whole and each of its four
  launches (LayerNorm, QKV GEMM, attention, out projection) alone on
  buffers a whole call filled; beside the attention launch, one f32
  `F.scaled_dot_product_attention` on the heads of the same qkv (TF32
  off), a yardstick that the port never calls;
- K6.f32's GEMM launch at Swin-B-384's first boundary, 64x96^2x128
  (`geovpr_patch_merge_f32_parts`), alone on buffers a whole call filled.
Then one call of each under torch.profiler: the device ms of each kernel
name. Each checkout's outputs are printed beside the first checkout's
(relative Frobenius error) and held against its own second call, bit for
bit, and to be finite. Prints the card's name and power limit,
then `[turns]` lines, and exits non-zero if a check fails. Needs one CUDA
card.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

ITERS = 10
ROUNDS = 3
K8B_SHAPES = ((16, 257, 1024, 16), (16, 257, 768, 12))
K8C_SHAPE = (16, 257, 768, 12)
# K8c's launches that run the core or a product (K8C_PARTS' indices)
K8C_TIMED = {"da": 2, "dwo": 3, "dgamma": 4, "core": 5, "dwqkv": 7,
             "dh": 9}
# the order of K8c's scratch and output pointers after its ten inputs
K8C_BUFS = ("dy", "da", "dqkv", "h", "stats", "pds", "part", "dx", "dwqkv",
            "dbqkv", "dwo", "dbo", "dgamma", "dls", "dlb")
K8C_OUTS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma")
# K1.f32's and K8a.f32's shapes (the four launches of one C entry)
K1_SHAPES = {"K1.f32": (64, 257, 768, 12), "K8a.f32": (16, 257, 768, 12)}
K1_PARTS = ("layernorm", "qkv_gemm", "attention", "out_proj")
K6_SHAPE = (64, 128, 96)  # (B, C, resolution)


def load(checkouts: list) -> list:
    """Build (where needed, the checkouts' builds at once) and load each
    checkout's kernels with its own `_build.py`; raise the f32 training
    and serving kernels' shared-memory limits."""
    from concurrent.futures import ThreadPoolExecutor

    mods = []
    for i, checkout in enumerate(checkouts):
        path = Path(checkout).resolve() / "geovpr_torch" / "ops" / "_build.py"
        spec = importlib.util.spec_from_file_location(f"_turns_build_{i}",
                                                      path)
        mods.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])
    with ThreadPoolExecutor(len(mods)) as pool:
        libs = list(pool.map(lambda m: m.load_library(), mods))
    for checkout, lib in zip(checkouts, libs):
        for init in ("geovpr_f32_train_init", "geovpr_f32_serving_init"):
            rc = getattr(lib, init)()
            if rc != 0:
                raise RuntimeError(f"{checkout}: {init} failed: {rc}")
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def f32(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def k8b(lib, qkv, da, h):
    """fn() running K8b.f32 of `lib` into its own output and scratch, and
    the output."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    out = torch.empty_like(qkv)
    pds = f32(qkv.device, lib.geovpr_vit_f32_core_scratch_floats(b, n, h))
    args = (qkv.data_ptr(), da.data_ptr(), out.data_ptr(), pds.data_ptr(),
            b, n, d, h, float((d // h) ** -0.5))

    def fn():
        rc = lib.geovpr_vit_f32_bwd_core(*args, stream())
        if rc != 0:
            raise RuntimeError(f"geovpr_vit_f32_bwd_core: CUDA error {rc}")
    fn.scratch = pds  # alive as long as fn: a CUDA graph keeps its pointer
    return fn, out


def k8c(lib, ins, shape):
    """fn(part) running K8c.f32 of `lib` (all its launches for part None,
    else that launch alone) into its own buffers, and the buffers."""
    b, n, d, h = shape
    m, dev = b * n, ins[0].device
    bufs = dict(dy=f32(dev, m, d), da=f32(dev, m, d),
                dqkv=f32(dev, m, 3 * d), h=f32(dev, m, d),
                stats=f32(dev, m, 2),
                pds=f32(dev, lib.geovpr_vit_f32_core_scratch_floats(b, n, h)),
                part=f32(dev, lib.geovpr_vit_f32_scratch_floats(b, n, d)),
                dx=f32(dev, m, d), dwqkv=f32(dev, d, 3 * d),
                dbqkv=f32(dev, 3 * d), dwo=f32(dev, d, d), dbo=f32(dev, d),
                dgamma=f32(dev, d), dls=f32(dev, d), dlb=f32(dev, d))
    args = (*(t.data_ptr() for t in ins),
            *(bufs[k].data_ptr() for k in K8C_BUFS), b, n, d, h, 1e-6,
            float((d // h) ** -0.5))

    def fn(part=None):
        rc = (lib.geovpr_vit_f32_bwd_all(*args, stream()) if part is None
              else lib.geovpr_vit_f32_bwd_all_parts(*args, part, part,
                                                    stream()))
        if rc != 0:
            raise RuntimeError(f"geovpr_vit_f32_bwd_all: CUDA error {rc}")
    return fn, bufs


def k1(lib, args):
    """fn(part) running K1.f32 of `lib` (its four launches for part None,
    else that launch alone) on `args` (f32_k1_case's) into its own qkv,
    ctx and out, and those buffers."""
    x, *rest, h = args
    b, n, d = x.shape
    bufs = (f32(x.device, b, n, 3 * d), f32(x.device, b, n, d),
            f32(x.device, b, n, d))
    ka = (*(t.data_ptr() for t in (x, *rest, *bufs)), b, n, d, h, 1e-6)

    def fn(part=None):
        first, last = (0, 3) if part is None else (part, part)
        rc = lib.geovpr_mhsa_f32_parts(*ka, first, last, stream())
        if rc != 0:
            raise RuntimeError(f"geovpr_mhsa_f32_parts: CUDA error {rc}")
    fn.scratch = bufs  # alive as long as fn (see k8b)
    return fn, bufs


def k6_gemm(lib, k6):
    """fn() of K6.f32's GEMM launch in `lib`, alone on buffers one whole
    call filled from `k6` (merge_case's arguments)."""
    xm, ls, lb, w, res = k6
    bm, c, dev = xm.shape[0], xm.shape[-1], xm.device
    mb = (f32(dev, bm, res * res // 4, 4 * c),
          f32(dev, bm, res * res // 4, 2 * c))
    ma = (*(t.data_ptr() for t in (xm, ls, lb, w, *mb)), bm, res, c, 1e-5)

    def part(first, last):
        def fn():
            rc = lib.geovpr_patch_merge_f32_parts(*ma, first, last, stream())
            if rc != 0:
                raise RuntimeError(f"geovpr_patch_merge_f32_parts: CUDA "
                                   f"error {rc}")
        fn.scratch = mb  # alive as long as fn (see k8b)
        return fn

    part(0, 1)()
    return part(1, 1)


def kernel_ms(fn) -> dict:
    """The device ms of each kernel name in one call of fn()."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "", 1).split("(")[0][:60]
            out[name] = round(out.get(name, 0.0)
                              + e.self_device_time_total / 1e3, 4)
    return out


def turns(fns: list) -> list:
    """graph_ms of each fn, in turns forward then backward, ROUNDS
    rounds; the runs of each."""
    runs = [[] for _ in fns]
    for r in range(ROUNDS):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            runs[i].append(cs.graph_ms(fns[i], ITERS))
    return runs


def rel(got, want) -> float:
    return ((got.double() - want.double()).norm()
            / (want.double().norm() or 1.0)).item()


def main(argv: list) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__ if not argv else "chip_turns: no CUDA device",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from geovpr_torch.ops import mhsa as mh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = load(argv)
    failed = []

    def report(what, tag, runs, outs, kernels):
        for c, r, o, k in zip(argv, runs, outs, kernels):
            ok = o["repeat_equal"] and all(v == v for v in o["rel"].values())
            if not ok:
                failed.append(f"{c} {what} {tag}")
            print(f"[turns] name={what} shape={tag} checkout={c} "
                  f"ms={sum(r) / len(r)} runs={r} rel_err={o['rel']} "
                  f"repeat_equal={o['repeat_equal']} kernels={k}",
                  flush=True)

    with torch.no_grad():
        for shape in K8B_SHAPES:
            h, tag = shape[3], "B{}_N{}_D{}_H{}".format(*shape)
            args, da = cs.f32_train_case(shape, dev)
            qkv = mh.mhsa_train_fwd_reference(*args[:8], h, 1e-6)[1]
            calls = [k8b(lib, qkv, da, h) for lib in libs]
            outs = []
            for fn, out in calls:
                fn()
                first = out.clone()
                fn()
                torch.cuda.synchronize()
                outs.append(dict(rel={"dqkv": rel(out, calls[0][1])},
                                 repeat_equal=torch.equal(first, out)))
            runs = turns([fn for fn, _ in calls])
            report("K8b.f32", tag, runs, outs,
                   [kernel_ms(fn) for fn, _ in calls])
            del args, da, qkv, calls
            torch.cuda.empty_cache()

        shape, h = K8C_SHAPE, K8C_SHAPE[3]
        tag = "B{}_N{}_D{}_H{}".format(*shape)
        args, g = cs.f32_train_case(shape, dev)
        x, ls, lb, wqkv, bqkv, wo, bo, gamma = args[:8]
        res = mh.mhsa_train_fwd_reference(*args[:8], h, 1e-6)
        ins = (x, res[1], res[2], g, wqkv, wo, bo, gamma, ls, lb)
        calls = [k8c(lib, ins, shape) for lib in libs]
        outs = []
        for fn, bufs in calls:
            fn()
            first = {k: bufs[k].clone() for k in K8C_OUTS}
            fn()
            torch.cuda.synchronize()
            outs.append(dict(
                rel={k: rel(bufs[k], calls[0][1][k]) for k in K8C_OUTS},
                repeat_equal=all(torch.equal(first[k], bufs[k])
                                 for k in K8C_OUTS)))
        runs = turns([fn for fn, _ in calls])
        report("K8c.f32", tag, runs, outs,
               [kernel_ms(fn) for fn, _ in calls])
        for part, i in K8C_TIMED.items():
            runs = turns([lambda fn=fn, i=i: fn(i) for fn, _ in calls])
            for c, r in zip(argv, runs):
                print(f"[turns] name=K8c.f32.{part} shape={tag} "
                      f"checkout={c} ms={sum(r) / len(r)} runs={r}",
                      flush=True)
        del calls, ins, res, args, g
        torch.cuda.empty_cache()
        for name, shape in K1_SHAPES.items():
            h, tag = shape[3], "B{}_N{}_D{}_H{}".format(*shape)
            args = cs.f32_k1_case(shape, dev)
            calls = [k1(lib, args) for lib in libs]
            outs = []
            for fn, bufs in calls:
                fn()
                first = [t.clone() for t in bufs]
                fn()
                torch.cuda.synchronize()
                outs.append(dict(
                    rel={k: rel(t, w) for k, t, w in zip(
                        ("qkv", "ctx", "out"), bufs, calls[0][1])},
                    repeat_equal=all(torch.equal(a, t)
                                     for a, t in zip(first, bufs))))
            runs = turns([fn for fn, _ in calls])
            report(name, tag, runs, outs, [kernel_ms(fn) for fn, _ in calls])
            for i, part in enumerate(K1_PARTS):
                runs = turns([lambda fn=fn, i=i: fn(i) for fn, _ in calls])
                for c, r in zip(argv, runs):
                    print(f"[turns] name={name}.{part} shape={tag} "
                          f"checkout={c} ms={sum(r) / len(r)} runs={r}",
                          flush=True)
            d = shape[2]
            q, k, v = (mh._heads(t, h).contiguous()
                       for t in calls[0][1][0].split(d, dim=-1))
            r = [cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                             ITERS) for _ in range(ROUNDS)]
            print(f"[turns] name={name}.attention.sdpa_f32 shape={tag} "
                  f"ms={sum(r) / len(r)} runs={r}", flush=True)
            del args, calls, q, k, v
            torch.cuda.empty_cache()
        k6 = cs.merge_case(K6_SHAPE, dev, dtype=torch.float32)
        runs = turns([k6_gemm(lib, k6) for lib in libs])
        for c, r in zip(argv, runs):
            print(f"[turns] name=K6.f32.gemm checkout={c} "
                  f"ms={sum(r) / len(r)} runs={r}", flush=True)
    print(f"[turns] ok={not failed} failed={failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
