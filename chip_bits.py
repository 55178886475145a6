"""Bit-for-bit comparison of kernel outputs between this checkout and
another one (an earlier commit, unpacked), on one CUDA card.

    python3 chip_bits.py OTHER_CHECKOUT

Each checkout runs in a process of its own (its `geovpr_torch` and its
`chip_smoke.py` first on the path, this file's `run`), builds its own
kernels, and saves the outputs of the kernels it runs here on inputs its
chip_smoke.py draws from seed 0: K1 (bf16 serving) and K8a (K1's
launches, keeping qkv and ctx) at 64x257x768x12 and 2x1370x768x12, K2 (the
w8a8 ViT attention half-block) at 64x257x768x12, K3 (the w8a8 MLP
half-block) at 64x257x768x12, at Swin-B-384's stage 0 and 3 widths (B=16)
and at ConvNeXt-B's stage 2 with the separate residual (B=16), K4 and K5
(the bf16 and w8a8 Swin half-blocks) at stage 0 (B=16), K2 and K5 in the
attention mode the environment gives (the default where neither
GEOVPR_INT8_QK nor GEOVPR_INT8_PV is set) and in int8 P.V and bf16 scores
too, K6 at C =
128, K9a (the Swin training forward, its y, qkv, ctx and p) and K9b (the
core backward) at stages 0 and 3 and K9c (the whole backward) at stage 0
(B=16), K8b and K8c (the ViT half-block's backward) at 16x257x768x12,
K7 (on pre-split windows) at Swin-T-224's stage 0, the Swin-T-224
heading model (preset swin_t224_sincos_gemini, bf16; K7 and K6 in it) on
chip_smoke.py's 64 seed-0 images: its pooled features and predictions;
and the f32 forms: K1.f32 at 64x257x768x12 and 2x1370x768x12 (its two
attention routes), K4.f32 at Swin-B-384's stage 0 (B=16), K6.f32 at C =
128, K7.f32's raster mode at Swin-T-224's stage 0 (B=64), K8a.f32, K8b.f32
and K8c.f32 at 16x257x768x12, K8b and K8c on K8a's residuals, K8c also on
the plain forward's (`K8c.f32.plain_fwd.*`: its own bits, whatever K8a's
ctx). The
inputs are saved beside the outputs and compared too, so a change in how
they are drawn shows as such. It prints one line per tensor and exits
non-zero if any differs. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
K1_SHAPES = ((64, 257, 768, 12), (2, 1370, 768, 12))
SWIN_SHAPES = ((16, 128, 4, 96, 12, 6), (16, 1024, 32, 12, 12, 0))
K7_SHAPE = (1024, 3, 49, 64)
K7_RASTER_SHAPE = (64, 96, 3, 56, 7, 3)
K9_SHAPE = (16, 128, 4, 96, 12, 6)
K9_STAGE3 = (16, 1024, 32, 12, 12, 0)
K8_SHAPE = (16, 257, 768, 12)
CONVNEXT_K3_SHAPE = (16, 14, 512)


def run(out_path: str) -> None:
    """In the child: this process's checkout's kernels on its inputs."""
    import numpy as np

    import chip_smoke as cs
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops.mlp_int8 import fused_mlp_block_int8
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8,
                                             fused_swin_attn_bwd_all,
                                             fused_swin_attn_bwd_core,
                                             fused_swin_attn_train_fwd)
    from geovpr_torch.ops.window_attention import (window_attention_kernel,
                                                   window_attention_raster)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    with torch.inference_mode():
        for b, n, d, h in K1_SHAPES:
            tag = f"B{b}_N{n}_D{d}"
            gen = torch.Generator().manual_seed(cs.SEED + n)
            x, vecs, mats = cs.block_inputs(b, n, d, gen, dev)
            args = (x, vecs["ln_scale"], vecs["ln_bias"], mats["wqkv"],
                    vecs["bqkv"], mats["wo"], vecs["bo"], vecs["gamma"], h)
            res[f"input.K1.{tag}.x"] = x
            res[f"input.K1.{tag}.wqkv"] = mats["wqkv"]
            res[f"K1.{tag}.out"] = mh.fused_mhsa_block(*args)
            out, qkv, ctx = mh.fused_mhsa_train_fwd(*args)
            res.update({f"K8a.{tag}.out": out, f"K8a.{tag}.qkv": qkv,
                        f"K8a.{tag}.ctx": ctx})
        b, n, d, h = K1_SHAPES[0]
        x, k2, k3 = cs.int8_block_case(b, n, d, h, dev)
        res["input.K3.x"] = x
        res["input.K3.w1q_t"] = k3["w1q_t"]
        res["K3.out"] = fused_mlp_block_int8(x, **k3)
        res["input.K2.wqkv_q_t"] = k2["wqkv_q_t"]
        res["K2.out"] = mh.fused_mhsa_block_int8(x, **k2, num_heads=h)
        for mode in ("int8_pv", "bf16_scores"):
            with cs.int8_mode(mode):
                x, k2, _ = cs.int8_block_case(b, n, d, h, dev)
            res[f"K2.{mode}.out"] = mh.fused_mhsa_block_int8(x, **k2,
                                                             num_heads=h)
            with cs.int8_mode(mode):
                x, blk = cs.swin_block_case(SWIN_SHAPES[0], dev, int8=True)
            res[f"K5.{mode}.out"] = fused_swin_attn_block_int8(
                x, **cs.k5_kwargs(blk))
        del x, k2, k3, blk
        h2, xr, k3 = cs.convnext_k3_case(CONVNEXT_K3_SHAPE, dev)
        res["input.K3.convnext.x"] = h2
        res["K3.convnext.out"] = fused_mlp_block_int8(h2, **k3, residual=xr)
        del h2, xr, k3
        for shape in SWIN_SHAPES:
            tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
            x, blk = cs.swin_block_case(shape, dev, int8=True)
            k3 = blk._folded_args(blk._k3)
            res[f"input.K3.{tag}.x"] = x
            res[f"input.K3.{tag}.w2q_t"] = k3["w2q_t"]
            res[f"K3.{tag}.out"] = fused_mlp_block_int8(x, **k3, ln_eps=1e-5)
        x, blk = cs.swin_block_case(SWIN_SHAPES[0], dev, x_scale=1e-2)
        res["input.K4.x"] = x
        res["K4.out"] = fused_swin_attn_block(*cs.k4_args(x, blk))
        x, blk = cs.swin_block_case(SWIN_SHAPES[0], dev, int8=True)
        res["input.K5.x"] = x
        res["K5.out"] = fused_swin_attn_block_int8(x, **cs.k5_kwargs(blk))
        m = cs.merge_case((16, 128, 96), dev)
        res["input.K6.x"] = m[0]
        res["K6.out"] = fused_patch_merge(*m)
        a, g, geom = cs.k9_case(K9_SHAPE, dev)
        res["input.K9a.x"] = a["x"]
        outs = fused_swin_attn_train_fwd(
            *(a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv",
                             "wo", "bo", "table")), *geom.values(), 1e-5)
        res.update({f"K9a.{i}": o for i, o in enumerate(outs)})
        dqkv, dbias = fused_swin_attn_bwd_core(outs[1], outs[3], g,
                                               *geom.values())
        res.update({"K9b.dqkv": dqkv, "K9b.dbias": dbias})
        outs = fused_swin_attn_bwd_all(
            *(a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wo")),
            outs[1], outs[2], outs[3], g, *geom.values(), 1e-5)
        res.update({f"K9c.{k}": o for k, o in zip(cs.K8_OUTS[:7] + (
            "dbias",), outs)})
        a, g, geom = cs.k9_case(K9_STAGE3, dev)
        res["input.K9a.stage3.x"] = a["x"]
        outs = fused_swin_attn_train_fwd(
            *(a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv",
                             "wo", "bo", "table")), *geom.values(), 1e-5)
        res.update({f"K9a.stage3.{i}": o for i, o in enumerate(outs)})
        dqkv, dbias = fused_swin_attn_bwd_core(outs[1], outs[3], g,
                                               *geom.values())
        res.update({"K9b.stage3.dqkv": dqkv, "K9b.stage3.dbias": dbias})
        a, g = cs.k8_case(K8_SHAPE, dev)
        res["input.K8.x"] = a["x"]
        _, qkv, ctx = mh.fused_mhsa_train_fwd(*cs._k8_fwd_args(a, K8_SHAPE[3]))
        res["K8b.dqkv"] = mh.fused_mhsa_bwd_core(qkv, g, K8_SHAPE[3])
        outs = mh.fused_mhsa_bwd_all(*cs._k8_bwd_args(a, (None, qkv, ctx), g,
                                                      K8_SHAPE[3]))
        res.update({f"K8c.{k}": o for k, o in zip(cs.K8_OUTS, outs)})
        f32 = torch.float32
        args = cs.f32_k1_case(K1_SHAPES[0], dev)
        res["input.K1.f32.x"] = args[0]
        res["K1.f32.out"] = mh.fused_mhsa_block(*args)
        args = cs.f32_k1_case(K1_SHAPES[1], dev)
        res["input.K1.f32.N1370.x"] = args[0]
        res["K1.f32.N1370.out"] = mh.fused_mhsa_block(*args)
        x, blk = cs.swin_block_case(SWIN_SHAPES[0], dev, x_scale=1e-2,
                                    dtype=f32)
        res["input.K4.f32.x"] = x
        res["K4.f32.out"] = fused_swin_attn_block(*cs.k4_args(x, blk))
        m = cs.merge_case((16, 128, 96), dev, dtype=f32)
        res["input.K6.f32.x"] = m[0]
        res["K6.f32.out"] = fused_patch_merge(*m)
        args = cs.k7_raster_case(K7_RASTER_SHAPE, dev, dtype=f32)
        res["input.K7.f32.qkv"] = args[0]
        res["K7.f32.out"] = window_attention_raster(*args)
        args, g = cs.f32_train_case(K8_SHAPE, dev)
        h = K8_SHAPE[3]
        res["input.K8.f32.x"] = args[0]
        out, qkv, ctx = mh.fused_mhsa_train_fwd(*args[:8], h, 1e-6)
        res.update({"K8a.f32.out": out, "K8a.f32.qkv": qkv,
                    "K8a.f32.ctx": ctx})
        res["K8b.f32.dqkv"] = mh.fused_mhsa_bwd_core(qkv, g, h)
        x, ls, lb, wqkv, _, wo, bo, gamma = args[:8]
        outs = mh.fused_mhsa_bwd_all(x, ls, lb, wqkv, wo, bo, gamma, qkv, ctx,
                                     g, h, 1e-6)
        res.update({f"K8c.f32.{k}": o for k, o in zip(cs.K8_OUTS, outs)})
        _, qkv, ctx = mh.mhsa_train_fwd_reference(*args[:8], h, 1e-6)
        outs = mh.fused_mhsa_bwd_all(x, ls, lb, wqkv, wo, bo, gamma, qkv, ctx,
                                     g, h, 1e-6)
        res.update({f"K8c.f32.plain_fwd.{k}": o
                    for k, o in zip(cs.K8_OUTS, outs)})
        del args, g, x, qkv, ctx, outs
        q, k, v, bias, mask = cs.k7_case(K7_SHAPE, dev)
        res["input.K7.q"] = q
        res["K7.out"] = window_attention_kernel(q, k, v, bias, mask)
        del q, k, v, bias, mask
        source = cs.synthetic_val(cs.ANGLE_BATCH, 224,
                                  np.random.default_rng(cs.SEED), angles=True)
        images = torch.from_numpy(source.images).to(dev)
        model, _ = cs.angle_model(dev, cs.ANGLE_PRESET)
        out = model.backbone(normalize(images))
        res["input.angle.images"] = images
        res["angle.swin_t224.pooled"] = out.pooled
        res["angle.swin_t224.pred"] = model.head(model.pool(out))
        torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in res.items()}, out_path)


def _child(checkout: Path, out: Path) -> None:
    code = (f"import sys; sys.path[:0] = [{str(checkout)!r}]\n"
            f"import geovpr_torch\n"
            f"assert geovpr_torch.__file__.startswith({str(checkout)!r})\n"
            f"import importlib.util as u\n"
            f"spec = u.spec_from_file_location('chip_bits_run', "
            f"{str(REPO / 'chip_bits.py')!r})\n"
            f"mod = u.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            f"mod.run({str(out)!r})\n")
    subprocess.run([sys.executable, "-c", code], cwd=checkout, check=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_bits: no CUDA device is available", file=sys.stderr)
        return 1
    other = Path(argv[0]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        mine, theirs = Path(tmp) / "this.pt", Path(tmp) / "other.pt"
        _child(REPO, mine)
        _child(other, theirs)
        a, b = torch.load(mine), torch.load(theirs)
    differ = []
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            print(f"[bits] {key} only in {'this' if key in a else 'other'}")
            differ.append(key)
            continue
        same = a[key].shape == b[key].shape and torch.equal(a[key], b[key])
        share = 1.0 if same else (
            (a[key] == b[key]).float().mean().item()
            if a[key].shape == b[key].shape else 0.0)
        print(f"[bits] {key} shape={tuple(a[key].shape)} equal={same} "
              f"equal_share={share}")
        if not same:
            differ.append(key)
    print(f"[bits] other={other} differ={differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
