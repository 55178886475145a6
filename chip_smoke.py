"""Chip smoke test of the PyTorch / H100 port (`geovpr_torch`).

    python3 chip_smoke.py

Needs one CUDA card and exits non-zero on any failure, printing no result.
It builds the port's kernels from `geovpr_torch/csrc/` with nvcc (one
process per source, in parallel), checks each against its plain PyTorch
version on the card, and drives the port's serving and training paths
end to end from seeded random weights:

- retrieve (`geovpr_torch.cli.retrieve.run_retrieval`), DINOv2-B/14 + SALAD
  at full width: bf16 (K1 in every block) and int8 (calibrated on the
  first batch; K2 and K3 in every block, int8 index);
- geopose (`geovpr_torch.cli.evaluate.run_evaluate`), Swin-B-384 + MLP
  head (preset swin_b384_gemini2) at full width: bf16 (K4 in every block)
  and int8 (calibrated on the first batch; K5 and K3 in every block), K6 at
  every stage boundary on both;
- angle (`run_evaluate` with the preset's angle objective), bf16 at full
  width: Swin-T-224 at window 7 + sin/cos MLP head (preset
  swin_t224_sincos_gemini; K7's raster mode in every block, K6 at every
  boundary), and
  EfficientNet-B0 (efficientnet_sincos_gemini) and ConvNeXt-B
  (convnext_direct_maae), which run on cuDNN and launch no kernel of the
  port;
- fuse (`geovpr_torch.cli.fuse.main`) on 192 non-square JPEGs and a
  256-image gallery, run directories of full-width models written with
  the port's `save_checkpoint`: bf16 Swin-B-384 geopose + Swin-T-224 angle
  + DINOv2-B/14 + SALAD retrieval with --save-index; --int8 with the
  ConvNeXt-B angle head (K3 with the pre-dwconv residual in every block);
  EfficientNet-B0 on its dual geometry with --load-index; and the w8a8
  Swin-T-224 head (torch int8 attention, K3) in a FusedPipeline;
- training (`geovpr_torch.cli.train.run_train`), Swin-B-384 + MLP head
  (preset swin_b384_gemini2) at full width and the preset's B=16: two
  epochs of 4 steps with validation and checkpoints (K9a in every block,
  K9c in the 22 blocks with C <= 512, K9b in the 2 with C = 1024; K4 and
  K6 in validation), a resumed epoch, kernel-vs-plain gradients and a
  fixed-batch descent;
- DINOv2 training (`run_train`) at full width: DINOv2-B/14 with mean
  pooling and the MLP head (preset dinov2_meanpool_huber, B=16: K8a and
  K8c in every block, K1 in validation), then `geovpr_torch.cli.evaluate
  --run-dir` on the run it wrote; the same preset at large-14 (D = 1024,
  24 blocks: K8a and K8b in every block); and dinov2_cls_direct_maae (CLS,
  linear head, B=32); each with resumed epochs and kernel-vs-plain
  gradients;
- the rest of the transformer training presets (`run_train`) at full
  width, cut only in data and epochs: dinov2_sincos_gemini (DINOv2-B/14,
  angle_rot, B=32) across the freeze -> unfreeze boundary (K8a and K8c in
  every block of every step of both phases, K1 in validation; the backbone
  untouched through the frozen epoch, a resume across the boundary);
  dinov2salad_frozen_mlp (DINOv2-B/14 + SALAD, B=32) with the
  frozen-feature cache (K1 once per extraction batch, then no launch a
  step) and without it, bit-equal; and swin_t224_sincos_gemini
  (Swin-T-224, window 7, B=32), which trains on torch ops as JAX trains on
  XLA there (no launch a step; K7 and K6 in validation);
- the CNN training presets (`run_train`) at full width, cut only in data
  and epochs: efficientnet_direct_maae and efficientnet_sincos_gemini
  (EfficientNet-B0, B=32, BatchNorm in training mode) and
  convnext_direct_maae (ConvNeXt-B, B=16), on cuDNN and cuBLAS (no launch
  a step or a bf16 validation batch): the running statistics against
  flax's formula, a NaN step and a resume bit for bit, bf16 against f32
  gradients; `cli.evaluate --run-dir` on each run, with `--int8` on the
  ConvNeXt run (K3 in every block);
- the multi-process path (`geovpr_torch.parallel`), on the one card:
  `cli.train.main --multihost --coordinator 127.0.0.1:<port>
  --num-processes 1 --process-id 0` in a child process (a one-rank NCCL
  mesh) on swin_b384_gemini2 (B=16, two epochs of 2 steps: K9a, K9c and
  K9b a step, K4 and K6 in validation) and efficientnet_direct_maae
  (B=32), and `cli.retrieve --multihost --int8` (K2 and K3 a batch, the
  sharded index), each bit-equal to the same CLI without a mesh
  (losses, every checkpoint tensor: parameters, moments, BatchNorm
  statistics; the matches CSV), with the step's ms beside the run without
  a mesh and the all-reduce of the whole gradient; then two ranks over
  gloo on the one card (host-staged collectives), DINOv2-B/14 on
  dinov2_meanpool_huber's B=16 global batch for two steps against one
  process (K8a and K8c a step on each rank), and a two-shard int8 search;
- weight import and the parity protocol, on seeded reference-layout
  checkpoints at full width that a small exporter here writes from the
  port's models (HF `SwinModel` keys at base-384 with `regressor.0/3` in
  the `model_state_dict` wrapper; the serizba/salad hub keys with a
  1 + 37^2 position table and `regressor.0/2`; torchvision's
  EfficientNet-B0 with its classifier; `salad/dino_salad.ckpt`), each
  converted back bit-equal (the resized table aside): `python -m
  geovpr_torch.cli.convert` on the Swin-B-384 backbone (its msgpack read
  back bit-equal), then in a child `cli.train --pretrained` from that
  file (one epoch of 2 steps: K9a, K9c and K9b a step) and `cli.parity`
  leg by leg against golden numbers this script computes through the
  plain path from the same weights: every leg passes, the kernel path's
  predictions against the plain path's, K4 24, K6 3 and K1 12 launches a
  batch.

Kernels checked: K1 (bf16 ViT attention half-block), K2 and K3 (its w8a8
form and the w8a8 MLP half-block, K3 also at the four Swin-B-384 stage
widths and at ConvNeXt-B's four stages with the separate residual), K4 and K5 (the Swin window-attention half-block, bf16 and w8a8),
K6 (Swin PatchMerging), K7 (the window-7 attention core, on the raster
qkv and on pre-split windows; the window-7 half is also timed op by op),
and K9a, K9b and K9c (the Swin attention half-block's training
forward, core backward and whole backward), and K8a, K8b and K8c (the same
for the ViT attention half-block of DINOv2; K8a launches K1's kernels and
keeps the qkv and ctx they write). K1's four launches (LayerNorm, the TMA
+ wgmma QKV GEMM, the attention, the out projection) are also timed one
by one, each beside its own bound, at K1's and K8a's shapes, and so are
K2's four (LN-quant, the TMA + wgmma int8 GEMMs, the int8-score
attention) at 64x257x768, K4's four (LayerNorm, the same GEMMs, the
TMA-fed window attention) and K5's four (LN-quant, the int8 GEMMs, the
int8-score window attention) at the four Swin-B-384 stages, K3's three
(LN-quant, fc1, fc2) at those stages' widths and at 64x257x768, K6's two
(the merge-LN pass, the GEMM) at its three boundaries, and K9c's nine
(its four TMA + wgmma products, the column sums, the core, the LN
recompute and VJP) at the three Swin-B-384 training stages that take it,
K9a's four (LayerNorm, the TMA + wgmma QKV GEMM with its scaled-q copy,
the TMA-fed two-pass window attention that stores p, the out projection)
at the four Swin-B-384 stages, and K8c's eleven (dy, its five TMA + wgmma
products, the column sums, the TMA-fed core, the LN recompute and VJP) at
DINOv2-B/14's training shape; K9a and K9b (the core backward) are also
timed whole at the four Swin-B-384 stages, K9c at the three that take it,
and K8b at both DINOv2 training shapes (base-14's, and large-14's, where
it runs alone). For
each path it
compares the kernel path with the plain path for the whole model, counts
the kernels' launches, times the path and the kernels (beside their plain
versions, one library yardstick each and their bounds), and profiles one
batch. Every time is printed beside the card's name and power limit. The
second-to-last line is a JSON record of the kernels; the last line is the
JSON device record.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
VARIANT, IMAGE_SIZE, BATCH = "base-14", 224, 64
N_GALLERY, N_QUERY, TOP_K = 256, 64, 5
KERNEL_SHAPES = ((64, 257, 768, 12), (3, 50, 384, 6), (2, 1370, 768, 12))
MAIN_SHAPE = KERNEL_SHAPES[0]
# K1 check. x is drawn at 1e-2: LayerNorm removes the scale, so q, k and v
# are as at scale 1, but the output is mostly the attention branch (about
# 0.1 in size) instead of the residual, so the bf16 rounding of a large
# residual no longer hides an error in the branch. The kernel's max and mean
# |error| against the f32 plain version may exceed the bf16 plain version's
# by these factors.
K1_X_SCALE = 1e-2
K1_MAX_RATIO, K1_MEAN_RATIO = 1.25, 1.1
MIN_COSINE = 0.9999
# K2/K3 check (kernel against its plain version, both bf16 out): at most
# INT8_MAX_SHARE of the elements off by more than 1e-3, so that a
# systematic fault cannot hide, and max |error| <= 1.5 * max|one dequant
# step| + 1e-3 (the JAX package's own bound, tests/test_pallas_ops.py:
# 458-460, stated there for f32 outputs) + two bf16 spacings at the largest
# output. The spacings are the bf16 store: a rare int8 rounding flip (an
# f32 reduction ordered differently lands on the other side of .5) shifts a
# row by a few dequant steps, which can round one bf16 step apart; the
# healthy K2 read 0.03125 = one spacing at |out| ~5 on an H100 80GB HBM3
# at 700 W, 7.7x the bound applied per element without them.
INT8_ABS_TOL, INT8_MAX_SHARE = 1e-3, 0.01
MIN_COSINE_INT8 = 0.999
# the card's published dense peaks (NVIDIA H100 SXM data sheet)
PEAK_BF16, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12
PEAK_F32 = 67e12                     # outside the tensor cores
# Swin-B-384 geopose serving (preset swin_b384_gemini2) at B=64: the K4/K5
# shapes (B, C, H, resolution, window, shift) of stages 0-3 (shifted where
# the stage has shifted blocks) and the K6 boundaries (B, C, resolution)
SWIN_PRESET, SWIN_BATCH, SWIN_N_VAL = "swin_b384_gemini2", 64, 192
SWIN_ATTN_SHAPES = ((64, 128, 4, 96, 12, 6), (64, 256, 8, 48, 12, 6),
                    (64, 512, 16, 24, 12, 6), (64, 1024, 32, 12, 12, 0))
SWIN_MERGE_SHAPES = ((64, 128, 96), (64, 256, 48), (64, 512, 24))
SWIN_MAIN, MERGE_MAIN = SWIN_ATTN_SHAPES[0], SWIN_MERGE_SHAPES[0]
# launches per batch of 64 images: one K4 (bf16) or K5 + K3 (int8) per
# block (2 + 2 + 18 + 2), one K6 per stage boundary
SWIN_BLOCKS, SWIN_BOUNDARIES = 24, 3
# angle serving at B=64: Swin-T-224 (window 7; one K7 per block, 2 + 2 + 6
# + 2, one K6 per boundary), then the two CNN presets. K7's checked shapes
# on pre-split windows (BW, H, N, nW; nW 0 = unshifted) are Swin-T-224's
# four stages and a window-12 case (N 144) that shows the kernel is not
# tied to N = 49; on the raster qkv (B, C, H, resolution, window, shift)
# the same four stages, shifted where the stage has shifted blocks.
ANGLE_PRESET, ANGLE_BATCH, ANGLE_N_VAL = "swin_t224_sincos_gemini", 64, 192
CNN_PRESETS = ("efficientnet_sincos_gemini", "convnext_direct_maae")
SWIN_T_BLOCKS = 12
SWIN_T_DEPTHS = (2, 2, 6, 2)
K7_SHAPES = ((4096, 3, 49, 64), (1024, 6, 49, 16), (256, 12, 49, 4),
             (64, 24, 49, 0), (256, 16, 144, 0))
K7_MAIN = K7_SHAPES[0]
K7_RASTER_SHAPES = ((64, 96, 3, 56, 7, 3), (64, 192, 6, 28, 7, 3),
                    (64, 384, 12, 14, 7, 3), (64, 768, 24, 7, 7, 0))
K7_RASTER_MAIN = K7_RASTER_SHAPES[0]
# the SFU's ex2 rate: 16 a clock an SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), 132 SMs at
# the H100 SXM's 1,980 MHz boost clock
SFU_EX2_PER_S = 132 * 16 * 1.98e9
# Swin-T-224's K6 boundaries (B, C, resolution): 2C = 192 ends on a partial
# 128-column output tile of patch_merge.cu, which Swin-B's never do
SWIN_T_MERGE_SHAPES = ((64, 96, 56), (64, 192, 28), (64, 384, 14))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(b, n, d, gen, device, x_scale=K1_X_SCALE):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    x = r(b, n, d, scale=x_scale).bfloat16()
    vecs = dict(ln_scale=r(d, scale=0.1) + 1, ln_bias=r(d, scale=0.1),
                bqkv=r(3 * d, scale=0.1), bo=r(d, scale=0.1),
                gamma=r(d, scale=0.5))
    mats = dict(wqkv=r(d, 3 * d, scale=d ** -0.5).bfloat16(),
                wo=r(d, d, scale=d ** -0.5).bfloat16())
    return x, vecs, mats


def k1_errors(b, n, d, h, device, x_scale=K1_X_SCALE) -> dict:
    """Max and mean |error| of K1 and of the bf16 plain version, each
    against the plain version in f32, on one seeded input."""
    from geovpr_torch.ops.mhsa import fused_mhsa_block, mhsa_block_reference

    gen = torch.Generator().manual_seed(SEED + n)
    x, vecs, mats = block_inputs(b, n, d, gen, device, x_scale)

    def args(xx, cast):
        return (xx, vecs["ln_scale"], vecs["ln_bias"], cast(mats["wqkv"]),
                vecs["bqkv"], cast(mats["wo"]), vecs["bo"], vecs["gamma"], h)

    ident = lambda t: t  # noqa: E731
    with torch.inference_mode():
        ref32 = mhsa_block_reference(*args(x.float(), torch.Tensor.float))
        plain = mhsa_block_reference(*args(x, ident))
        got = fused_mhsa_block(*args(x, ident))
        torch.cuda.synchronize()
    k_err = (got.float() - ref32).abs()
    p_err = (plain.float() - ref32).abs()
    return dict(finite=bool(torch.isfinite(got).all()),
                kernel_max=k_err.max().item(), kernel_mean=k_err.mean().item(),
                plain_max=p_err.max().item(), plain_mean=p_err.mean().item())


def int8_block_case(b, n, d, h, device, seed=SEED, x_scale=1.0):
    """x and the folded arguments of K2 and K3 for one DINOv2 block with
    seeded random weights (vectors perturbed, so a dropped bias or scale
    shows), its static scales calibrated on x through the plain float path
    as `quantize_for_serving` does."""
    from geovpr_torch.models.dinov2 import DinoV2Block
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    gen = torch.Generator().manual_seed(seed + n)
    blk = DinoV2Block(d, h, dtype=torch.bfloat16, int8_attn=True,
                      int8_mlp=True)
    init_weights_(blk, gen)
    with torch.no_grad():
        for p in (blk.norm1.weight, blk.norm2.weight):
            p.add_(torch.randn(d, generator=gen) * 0.1)
        for p in (blk.norm1.bias, blk.norm2.bias, blk.attn.qkv_bias,
                  blk.attn.proj_bias, blk.mlp.fc1.bias, blk.mlp.fc2.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for p in (blk.ls1.gamma, blk.ls2.gamma):
            p.copy_(torch.randn(d, generator=gen) * 0.5)
    x = (torch.randn(b, n, d, generator=gen) * x_scale).bfloat16().to(device)
    blk = blk.to(device).eval()
    quantize_for_serving(blk, [x])
    return x, blk._folded_args(blk._k2), blk._folded_args(blk._k3)


def bf16_spacing(v: torch.Tensor) -> torch.Tensor:
    """The distance between neighbouring bf16 values at |v|."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def int8_errors(got, want, step: float) -> dict:
    err = (got.float() - want.float()).abs()
    bound = (1.5 * step + INT8_ABS_TOL
             + 2 * bf16_spacing(want.float().abs().max()).item())
    return dict(finite=bool(torch.isfinite(got.float()).all()),
                max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                step=step, max_bound=bound,
                share_over_1e3=(err > INT8_ABS_TOL).float().mean().item())


def int8_within_bound(e: dict) -> bool:
    return (e["finite"] and e["max_abs_err"] <= e["max_bound"]
            and e["share_over_1e3"] <= INT8_MAX_SHARE)


def int8_kernels_vs_plain(device) -> dict:
    """Phase 3b: K2 and K3 against their plain versions at the main path's
    shapes (K3 at the same rows), K3's separate-residual variant at the
    main shape; scales calibrated on the seeded x."""
    from geovpr_torch.ops.mhsa import (fused_mhsa_block_int8,
                                       mhsa_block_int8_reference)
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)

    errs = {}
    for shape in KERNEL_SHAPES:
        b, n, d, h = shape
        x, k2, k3 = int8_block_case(b, n, d, h, device)
        res = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            SEED), device="cpu").bfloat16().to(device)
        runs = [("K2", lambda f, **kw: f(x, **k2, num_heads=h), (
                    fused_mhsa_block_int8, mhsa_block_int8_reference),
                 (k2["so_eff"] * k2["gamma"]).abs().max().item()),
                ("K3", lambda f, **kw: f(x, **k3, **kw), (
                    fused_mlp_block_int8, mlp_block_int8_reference),
                 (k3["s2_eff"] * k3["gamma"]).abs().max().item())]
        for name, call, (kernel, plain), step in runs:
            variants = [{}] + ([{"residual": res}]
                               if name == "K3" and shape == MAIN_SHAPE else [])
            for kw in variants:
                with torch.inference_mode():
                    got = call(kernel, **kw)
                    torch.cuda.synchronize()
                    want = call(plain, **kw)
                e = int8_errors(got, want, step)
                tag = name + ("_residual" if kw else "")
                phase("kernel", name=tag, shape="B{}_N{}_D{}_H{}".format(
                    *shape), **e, max_share=INT8_MAX_SHARE)
                check(int8_within_bound(e),
                      f"{tag} error outside its bound at {shape}: {e}")
                errs[(tag, shape)] = e["max_abs_err"]
    return errs


def k1_within_bound(e: dict) -> bool:
    return (e["finite"]
            and e["kernel_max"] <= K1_MAX_RATIO * e["plain_max"]
            and e["kernel_mean"] <= K1_MEAN_RATIO * e["plain_mean"])


def kernel_vs_plain(device) -> dict:
    """Phase 3: K1 against its plain version at the main path's shapes."""
    errs = {}
    for shape in KERNEL_SHAPES:
        e = k1_errors(*shape, device)
        phase("kernel", shape="B{}_N{}_D{}_H{}".format(*shape),
              x_scale=K1_X_SCALE, **e,
              max_bound=K1_MAX_RATIO * e["plain_max"],
              mean_bound=K1_MEAN_RATIO * e["plain_mean"])
        check(k1_within_bound(e),
              f"K1 error outside its bound at {shape}: {e}")
        errs[shape] = e["kernel_max"]
    return errs


def synthetic_gallery(n: int, size: int, rng):
    """Images with distinct layouts (an upsampled random 8x8 colour field
    plus noise) and distinct positions 100 m apart."""
    from geovpr_torch.data.pipeline import ArraySource

    cell = size // 8
    base = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.float32)
    up = np.repeat(np.repeat(base, cell, 1), cell, 2)
    imgs = np.clip(up + rng.normal(0, 20, up.shape), 0, 255).astype(np.uint8)
    latlon = np.stack([219000.0 + 100.0 * np.arange(n),
                       143000.0 + np.zeros(n)], 1).astype(np.float32)
    names = [f"g_{i:04d}.jpg" for i in range(n)]
    return ArraySource(imgs, latlon, names)


def kernel_counters():
    from geovpr_torch.ops.mhsa import fused_mhsa_block, fused_mhsa_block_int8
    from geovpr_torch.ops.mlp_int8 import fused_mlp_block_int8
    return {"fused_mhsa_block": fused_mhsa_block,
            "fused_mhsa_block_int8": fused_mhsa_block_int8,
            "fused_mlp_block_int8": fused_mlp_block_int8}


def slice_end_to_end(model, device, gallery, out_dir, int8=False) -> dict:
    """Phase 4 (bf16) / 8 (int8): the retrieve main path through
    run_retrieval, every launch count set to 0 just before and read just
    after. Returns the counts."""
    from geovpr_torch.cli.retrieve import run_retrieval
    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.retrieval.index import load_index

    queries = ArraySource(gallery.images[:N_QUERY], gallery.targets[:N_QUERY],
                          [f"q_{i:04d}.jpg" for i in range(N_QUERY)])
    index_path = os.path.join(out_dir, "gallery_index.npz")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_retrieval(model, gallery, queries, batch_size=BATCH,
                        top_k=TOP_K, positive_radius=25.0, out_dir=out_dir,
                        device=device, save_index_path=index_path, int8=int8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_batches = -(-N_GALLERY // BATCH) + -(-N_QUERY // BATCH)
    n_layers = len(model.backbone.blocks)
    expected = dict.fromkeys(counters, 0)
    for k in (("fused_mhsa_block_int8", "fused_mlp_block_int8") if int8
              else ("fused_mhsa_block",)):
        expected[k] = n_layers * n_batches
    phase("slice", path="int8" if int8 else "bf16", wall_s=wall,
          launches=launches, expected_launches=expected, **{
              k: v for k, v in out.items() if k.startswith("recall")})
    check(launches == expected,
          f"kernel launches {launches}, expected {expected}")

    index, meta = load_index(index_path, device)
    rows = index._db[:index.size].float()
    if index._db_scale is not None:
        rows = rows * index._db_scale[:index.size, None]
    norms = rows.norm(dim=1)
    phase("descriptors", path="int8 index rows" if int8 else "bf16 index rows",
          shape=tuple(rows.shape), max_norm_dev=(norms - 1).abs().max().item())
    check(tuple(rows.shape) == (N_GALLERY, model.descriptor_dim),
          f"descriptors {tuple(rows.shape)}")
    check(bool(torch.isfinite(rows).all()), "non-finite descriptors")
    check(bool(((norms - 1).abs() <= 1e-3).all()), "descriptors not unit")
    check(out["recall@1"] == 1.0, f"recall@1 {out['recall@1']}")
    with open(out["matches_csv"], newline="") as f:
        rows_csv = list(csv.DictReader(f))
    check(len(rows_csv) == N_QUERY * TOP_K, f"{len(rows_csv)} CSV rows")
    top1 = {r["query_filename"]: r["match_filename"] for r in rows_csv
            if r["rank"] == "1"}
    check(all(top1[f"q_{i:04d}.jpg"] == f"g_{i:04d}.jpg"
              for i in range(N_QUERY)), "a query's top-1 is not itself")
    return launches


def kernel_path_vs_plain_path(model, images, bound=MIN_COSINE,
                              path="bf16") -> torch.Tensor:
    """Phase 5 (bf16) / 9 (int8): whole-model descriptors, kernel path vs
    plain path; returns the kernel path's descriptors."""
    from geovpr_torch.data.transforms import normalize

    blocks = model.backbone.blocks
    with torch.inference_mode():
        x = normalize(images)
        got = model(x).pooled.float()
        for blk in blocks:
            blk.use_kernels = False
        try:
            want = model(x).pooled.float()
        finally:
            for blk in blocks:
                blk.use_kernels = True
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    norms = got.norm(dim=1)
    phase("model", path=path, min_cosine=cos.min().item(),
          mean_cosine=cos.mean().item(), bound=bound,
          max_norm_dev=(norms - 1).abs().max().item())
    check(cos.min().item() >= bound,
          f"{path} kernel vs plain path cosine {cos.min().item()} < {bound}")
    check(bool(((norms - 1).abs() <= 1e-3).all()), f"{path} not unit-norm")
    return got


def interleaved_ms(fns: dict, iters: int) -> dict:
    """CUDA-event ms of each fn, run in turns a, b, c, c, b, a; returns
    the mean of each fn's two runs and the runs."""
    names = list(fns)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        runs[k].append(cuda_ms(fns[k], iters=iters))
    return {k: (sum(v) / 2, v) for k, v in runs.items()}


def bounds(kind: str, b, n, d, h, residual=False) -> dict:
    """The least time the card could take for one call at these shapes:
    the larger of bytes (each input read once, each output written once)
    over 3.35 TB/s and operations over the peak rate of their type."""
    m, dh = b * n, d // h
    att = 2 * b * h * n * n * dh         # one of q.k^T, P.V
    io = 2 * m * d * 2                   # bf16 x in, out out
    if kind == "K1":
        ops_t = (2 * m * d * 4 * d + 2 * att) / PEAK_BF16
        nbytes = io + 4 * d * d * 2 + (2 * d + 3 * d + 2 * d) * 4
    elif kind == "K2":
        ops_t = (2 * m * d * 4 * d + att) / PEAK_INT8 + att / PEAK_BF16
        nbytes = io + 4 * d * d + (2 * d + 6 * d + 3 * d) * 4
    else:
        hid = 4 * d
        ops_t = 4 * m * d * hid / PEAK_INT8
        nbytes = io + (m * d * 2 if residual else 0) + 2 * d * hid + (
            2 * d + 2 * hid + 3 * d) * 4
    bytes_t = nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3)


def library_k1(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, h):
    """K1's yardstick (timed only here, never called by the port):
    F.layer_norm -> torch.matmul -> F.scaled_dot_product_attention ->
    torch.matmul + epilogue, all bf16."""
    import torch.nn.functional as F
    b, n, d = x.shape
    hx = F.layer_norm(x.float(), (d,), ln_scale, ln_bias, 1e-6).bfloat16()
    qkv = (torch.matmul(hx, wqkv) + bqkv).bfloat16()
    q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        b, n, d)
    return ((torch.matmul(o, wo) + bo) * gamma + x).bfloat16()


def part_bound(ops, peak, nbytes) -> dict:
    """The least time of one launch: `ops` operations at `peak` against
    `nbytes` at 3.35 TB/s."""
    ops_t, bytes_t = ops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3,
                ops=ops)


def k1_part_bounds(part: str, b, n, d, h, gamma=True) -> dict:
    """The least time of one of K1's four launches at (B, N, D, H), B N
    rows attending in groups of N: bytes (each input read once, each
    output written once) over 3.35 TB/s against operations at their peak
    (the products in bf16, LayerNorm's ~8 f32 operations an element).
    K4's launches are the same with B windows of N tokens and no gamma."""
    m = b * n
    if part == "layernorm":      # x -> LN(x); scale and bias
        return part_bound(8 * m * d, PEAK_F32, 2 * m * d * 2 + 2 * d * 4)
    if part == "qkv_gemm":       # LN(x), Wqkv, bqkv -> qkv
        return part_bound(2 * m * d * 3 * d, PEAK_BF16, m * d * 2 + 3 * d * d
                          * 2 + 3 * d * 4 + m * 3 * d * 2)
    if part == "attention":      # qkv -> ctx: q k^T and P V, once each
        return part_bound(4 * b * h * n * n * (d // h), PEAK_BF16,
                          m * 3 * d * 2 + m * d * 2)
    # ctx, Wo, bo, gamma, x -> out
    return part_bound(2 * m * d * d, PEAK_BF16, 3 * m * d * 2 + d * d * 2 + (
        2 if gamma else 1) * d * 4)


def k2_part_bounds(part: str, b, n, d, h) -> dict:
    """The least time of one of K2's four launches at (B, N, D, H), M = B
    N rows: bytes (each input read once, each output written once) over
    3.35 TB/s against operations at their peak (the int8 products at
    1,979 TOP/s, P V at the bf16 989 TFLOP/s)."""
    m = b * n
    if part == "ln_quant":
        return ln_quant_bound(m, d)
    if part == "qkv_gemm":       # xq, Wqkv, sqkv, bqkv -> qk8, v
        return part_bound(2 * m * d * 3 * d, PEAK_INT8, m * d + 3 * d * d
                          + 6 * d * 4 + m * 2 * d + m * d * 2)
    if part == "attention":      # qk8, v -> ctx8
        # q k^T in int8 and P V in bf16: the pair's rate is their mix
        att = 2 * b * h * n * n * (d // h)
        ops_t = att / PEAK_INT8 + att / PEAK_BF16
        return part_bound(2 * att, 2 * att / ops_t,
                          m * 2 * d + m * d * 2 + m * d)
    # ctx8, Wo, so, bo, gamma, x -> out
    return part_bound(2 * m * d * d, PEAK_INT8, m * d + d * d + 3 * d * 4
                      + 2 * m * d * 2)


def k4_part_bounds(part: str, shape) -> dict:
    """K1's formulas for one of K4's four launches at (B, C, H, S, w,
    shift): the B S^2 / w^2 windows of N = w^2 tokens in place of K1's
    images, no gamma."""
    b, c, h, res, win, _ = shape
    return k1_part_bounds(part, b * res * res // (win * win), win * win, c,
                          h, gamma=False)


def ln_quant_bound(m, d) -> dict:
    """The LN-quant launch of K3 and K5: x (M, D) bf16 read, the int8 rows
    written, ~8 f32 operations an element."""
    return part_bound(8 * m * d, PEAK_F32, m * d * 2 + m * d + 2 * d * 4)


def k5_part_bounds(part: str, shape) -> dict:
    """The least time of one of K5's four launches at (B, C, H, S, w,
    shift), M = B S^2 rows: bytes (each input read once, each output
    written once) over 3.35 TB/s against operations at their peak (the
    int8 products at 1,979 TOP/s, P V at the bf16 989 TFLOP/s)."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    if part == "ln_quant":
        return ln_quant_bound(m, c)
    if part == "qkv_gemm":       # xq, Wqkv, sqkv, bqkv -> qk8, v
        return part_bound(2 * m * c * 3 * c, PEAK_INT8, m * c + 3 * c * c
                          + 6 * c * 4 + m * 2 * c + m * c * 2)
    if part == "attention":      # qk8, v, table -> ctx8
        # q k^T in int8 and P V in bf16: the pair's rate is their mix
        ops = 4 * m * n * c
        ops_t = 2 * m * n * c / PEAK_INT8 + 2 * m * n * c / PEAK_BF16
        return part_bound(ops, ops / ops_t, m * 2 * c + m * c * 2 + m * c
                          + (2 * win - 1) ** 2 * h * 4)
    # ctx8, Wo, so, bo, x -> out
    return part_bound(2 * m * c * c, PEAK_INT8, m * c + c * c + 2 * c * 4
                      + 2 * m * c * 2)


def k3_part_bounds(part: str, m, d, hid) -> dict:
    """The least time of one of K3's three launches on M rows of width D
    (hidden HID), the residual x (bytes and operations as
    `k5_part_bounds`)."""
    if part == "ln_quant":
        return ln_quant_bound(m, d)
    if part == "fc1":            # xq, W1, s1, b1 -> the int8 hidden
        return part_bound(2 * m * d * hid, PEAK_INT8, m * d + hid * d
                          + 2 * hid * 4 + m * hid)
    # the hidden, W2, s2, b2, gamma, res -> out
    return part_bound(2 * m * hid * d, PEAK_INT8, m * hid + hid * d
                      + 3 * d * 4 + 2 * m * d * 2)


def k6_part_bounds(part: str, shape) -> dict:
    """One of K6's two launches at (B, C, S): the merge-LN pass (x read
    once, bf16 LN(merged) (M2, 4C) written; ~8 f32 operations an element)
    and the GEMM (LN(merged) and W read, out written)."""
    b, c, res = shape
    m2 = b * (res // 2) ** 2
    if part == "merge_ln":
        return part_bound(8 * m2 * 4 * c, PEAK_F32,
                          2 * m2 * 4 * c * 2 + 2 * 4 * c * 4)
    return part_bound(2 * m2 * 4 * c * 2 * c, PEAK_BF16,
                      m2 * 4 * c * 2 + 8 * c * c * 2 + m2 * 2 * c * 2)


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, `iters` calls captured in one CUDA
    graph and replayed, so that the host's cost of launching (Python,
    ctypes, tens of microseconds a call) does not count."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parts_split(card: str, name: str, tag: str, parts, launch,
                bound) -> dict:
    """The launches `parts` of one kernel timed one by one (`launch(i)`
    runs launch i alone, on buffers a whole call has filled) by
    `graph_ms`, each beside its bound `bound(part)`, and all of them
    together the same way: `[kernel_time] name=<name>.<part>` and
    `[kernel_split] name=<name>`."""
    out = {}
    whole = graph_ms(lambda: [launch(i) for i in range(len(parts))])
    for i, part in enumerate(parts):
        out[part] = dict(ms=graph_ms(lambda: launch(i)), **bound(part))
        phase("kernel_time", card=repr(card), name=f"{name}.{part}",
              shape=tag, timed="cuda_graph", **out[part])
    total = sum(v["ms"] for v in out.values())
    phase("kernel_split", card=repr(card), name=name, shape=tag,
          graph_ms=whole, sum_ms=total,
          bound_sum_ms=sum(v["bound_ms"] for v in out.values()),
          **{f"{k}_share": v["ms"] / total for k, v in out.items()})
    return out


def k1_part_times(x, args: dict, h: int, card: str, name: str) -> dict:
    """K1's four launches (LayerNorm, QKV GEMM, attention, out projection)
    timed one by one on x and the half-block's arguments `args` by
    `parts_split` (the event time of a call launched from Python is in
    `[kernel_time] name=K1` / `K8a`). The launches are not counted
    (`k1_launch_part`)."""
    from geovpr_torch.ops import mhsa as mh

    b, n, d = x.shape
    got = mh._check(x, *(args[k] for k in ("ln_scale", "ln_bias", "wqkv",
                                           "bqkv", "wo", "bo", "gamma")), h)
    bufs = (torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device),
            torch.empty_like(x), torch.empty_like(x))
    with torch.inference_mode():
        return parts_split(
            card, name, f"B{b}_N{n}_D{d}_H{h}", mh.K1_PARTS,
            lambda i: mh.k1_launch_part(i, x, got, h, 1e-6, bufs),
            lambda part: k1_part_bounds(part, b, n, d, h))


def k2_part_times(x, k2: dict, h: int, card: str) -> dict:
    """K2's four launches (LN-quant, QKV GEMM, int8-score attention, out
    projection) timed one by one on x and the half-block's folded
    arguments `k2` by `parts_split`, beside `k2_part_bounds`; the launches
    are not counted (`k2_launch_part`)."""
    from geovpr_torch.ops import mhsa as mh

    b, n, d = x.shape
    with torch.inference_mode():
        bufs = mh.k2_buffers(x)
        return parts_split(
            card, "K2", f"B{b}_N{n}_D{d}_H{h}", mh.K2_PARTS,
            lambda i: mh.k2_launch_part(i, x, **k2, num_heads=h, bufs=bufs),
            lambda part: k2_part_bounds(part, b, n, d, h))


def library_k2(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
               wo_q_t, so_eff, bo, gamma, cs, num_heads):
    """K2's yardstick: F.layer_norm -> quantize -> torch._int_mm (qkv) ->
    dequant -> F.scaled_dot_product_attention in bf16 -> quantize ->
    torch._int_mm (out projection) + epilogue."""
    import torch.nn.functional as F
    b, n, d = x.shape
    xq = torch.clamp(torch.round(F.layer_norm(x.float(), (d,), None, None,
                                              1e-6) * ln_scale_q + ln_bias_q),
                     -127, 127).to(torch.int8).reshape(-1, d)
    qkv = (torch._int_mm(xq, wqkv_q_t.t()) * sqkv_eff + bqkv_eff).bfloat16()
    q, k, v = (t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v)
    c8 = torch.clamp(torch.round(o.transpose(1, 2).reshape(-1, d).float()),
                     -127, 127).to(torch.int8)
    out = torch._int_mm(c8, wo_q_t.t()) * so_eff + bo
    return (out.reshape(b, n, d) * gamma + x).bfloat16()


def library_k3(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1, w2q_t, s2_eff,
               b2, gamma, inv_a_mid, ln_eps=1e-6, residual=None):
    """K3's yardstick: F.layer_norm + two torch._int_mm with the
    quantize / GELU / dequant steps between them (and the separate
    residual where there is one)."""
    import torch.nn.functional as F
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    xq = torch.clamp(torch.round(F.layer_norm(xf.float(), (d,), None, None,
                                              ln_eps) * ln_scale_q
                                 + ln_bias_q),
                     -127, 127).to(torch.int8)
    hmid = F.gelu(torch._int_mm(xq, w1q_t.t()) * s1_eff + b1,
                  approximate="tanh")
    gq = torch.clamp(torch.round(hmid * inv_a_mid), -127, 127).to(torch.int8)
    y = torch._int_mm(gq, w2q_t.t()) * s2_eff + b2
    res = xf if residual is None else residual.reshape(-1, d)
    return (y * gamma + res).bfloat16().reshape(x.shape)


def kernel_times(device, card: str) -> dict:
    """Phase 6b: K1, K2 and K3 at the main path's shape, each in turns with
    its plain version and its library yardstick, beside its bound."""
    from geovpr_torch.ops.mhsa import (fused_mhsa_block, fused_mhsa_block_int8,
                                       mhsa_block_int8_reference,
                                       mhsa_block_reference)
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)

    b, n, d, h = MAIN_SHAPE
    x1, vecs, mats = block_inputs(b, n, d, torch.Generator().manual_seed(
        SEED), device)
    a1 = (x1, vecs["ln_scale"], vecs["ln_bias"], mats["wqkv"], vecs["bqkv"],
          mats["wo"], vecs["bo"], vecs["gamma"], h)
    x, k2, k3 = int8_block_case(b, n, d, h, device)
    out = {}
    with torch.inference_mode():
        cases = {
            "K1": {"kernel": lambda: fused_mhsa_block(*a1),
                   "plain": lambda: mhsa_block_reference(*a1),
                   "library": lambda: library_k1(*a1)},
            "K2": {"kernel": lambda: fused_mhsa_block_int8(x, **k2,
                                                           num_heads=h),
                   "plain": lambda: mhsa_block_int8_reference(x, **k2,
                                                              num_heads=h),
                   "library": lambda: library_k2(x, **k2, num_heads=h)},
            "K3": {"kernel": lambda: fused_mlp_block_int8(x, **k3),
                   "plain": lambda: mlp_block_int8_reference(x, **k3),
                   "library": lambda: library_k3(x, **k3)}}
        for name, fns in cases.items():
            t = interleaved_ms(fns, iters=10)
            out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                             library_ms=t["library"][0],
                             runs={k: v[1] for k, v in t.items()},
                             **bounds(name, b, n, d, h))
            phase("kernel_time", card=repr(card), name=name,
                  shape="B{}_N{}_D{}_H{}".format(*MAIN_SHAPE), **out[name])
    out["K1"]["parts"] = k1_part_times(x1, {**vecs, **mats}, h, card, "K1")
    out["K2"]["parts"] = k2_part_times(x, k2, h, card)
    out["K3"]["parts"] = k3_part_times(x, k3, card, 1e-6)
    return out


def k3_part_times(x, k3: dict, card: str, ln_eps: float) -> dict:
    """K3's three launches (LN-quant, fc1, fc2) timed one by one on x and
    the half-block's folded arguments `k3` by `parts_split`, beside
    `k3_part_bounds`; the launches are not counted (`k3_launch_part`)."""
    from geovpr_torch.ops import mlp_int8 as mi

    d, hid = x.shape[-1], k3["w1q_t"].shape[0]
    m = x.numel() // d
    with torch.inference_mode():
        bufs = mi.k3_buffers(x, hid)
        return parts_split(
            card, "K3", f"M{m}_D{d}_HID{hid}", mi.K3_PARTS,
            lambda i: mi.k3_launch_part(i, x, **k3, ln_eps=ln_eps, bufs=bufs),
            lambda part: k3_part_bounds(part, m, d, hid))


def model_times(model, images, card: str, path: str, batch=BATCH) -> None:
    """Phase 6 (bf16) / 10 (int8): CUDA-event ms per B=64 batch of
    descriptor extraction (images on the device, weights resident), img/s
    and peak device memory."""
    from geovpr_torch.data.transforms import normalize

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        ms_batch = cuda_ms(lambda: model(normalize(images)), iters=10)
        peak = torch.cuda.max_memory_allocated()
    phase("times", card=repr(card), path=path, batch=batch,
          ms_per_batch=ms_batch, img_per_s=batch * 1e3 / ms_batch,
          peak_mem_bytes=peak)


def breakdown(model, images, card: str, path: str = "bf16",
              batch=BATCH) -> None:
    """Phase 7 (bf16) / 11 (int8): device time by kernel for one batch
    of `model` (`breakdown_fn`)."""
    from geovpr_torch.data.transforms import normalize

    breakdown_fn(lambda: model(normalize(images)), card, path, batch)


def breakdown_fn(fn, card: str, path: str, batch: int) -> None:
    """Device time by kernel for one call of fn() (torch.profiler), and
    the device's idle share of that window (the profiler's own overhead
    inflates the window, so the share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        phase("breakdown", card=repr(card), path=path,
              device_time="not measured")
        return
    phase("breakdown", card=repr(card), path=path, batch=batch,
          window_ms=wall_ms,
          device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        phase("device_time", path=path, ms=e.self_device_time_total / 1e3,
              calls=e.count, share=e.self_device_time_total / 1e3 / busy_ms,
              name=e.key[:90])



# ----------------------------------------------------------- Swin / K4-K6 --

def swin_block_case(shape, device, int8=False, seed=SEED, x_scale=1.0):
    """x and a Swin block at one stage's widths, seeded random weights with
    perturbed vectors and a random relative-position table (so that a
    dropped bias, scale or table shows); int8: its static scales calibrated
    on x through the plain float path."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving
    from geovpr_torch.models.swin import SwinBlock

    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + c + shift)
    blk = SwinBlock(c, h, res, win, shift, dtype=torch.bfloat16,
                    int8_attn=int8, int8_mlp=int8)
    init_weights_(blk, gen)
    perturb_swin_(blk, gen)
    x = (torch.randn(b, res * res, c, generator=gen) * x_scale).bfloat16()
    blk = blk.to(device).eval()
    x = x.to(device)
    if int8:
        quantize_for_serving(blk, [x])
    return x, blk


@torch.no_grad()
def perturb_swin_(model, gen) -> None:
    """LayerNorm vectors and attention biases off their init values, the
    relative-position tables (zero at init, as in JAX) drawn at unit
    scale: a random model that uses every input of K4-K6."""
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif p.dim() == 1 and "norm" in name and name.endswith("weight"):
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.1)
        elif p.dim() == 1 and ("norm" in name or "attn" in name):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)


def k4_args(x, blk):
    a = blk.attn
    return (x, blk.norm1.weight, blk.norm1.bias, a.qkv_weight, a.qkv_bias,
            a.proj_weight, a.proj_bias, a.relative_position_bias_table,
            blk.num_heads, blk.resolution, blk.window, blk.shift)


def k5_kwargs(blk):
    return dict(blk._folded_args(blk._k5),
                table=blk.attn.relative_position_bias_table,
                num_heads=blk.num_heads, resolution=blk.resolution,
                window=blk.window, shift=blk.shift)


def ratio_errors(kernel, plain, args, f32_args) -> dict:
    """K1's bound applied to another bf16 kernel: max and mean |error| of
    the kernel and of the bf16 plain version, each against the plain
    version in f32."""
    with torch.inference_mode():
        ref32 = plain(*f32_args)
        want = plain(*args)
        got = kernel(*args)
        torch.cuda.synchronize()
    k_err = (got.float() - ref32).abs()
    p_err = (want.float() - ref32).abs()
    return dict(finite=bool(torch.isfinite(got.float()).all()),
                kernel_max=k_err.max().item(), kernel_mean=k_err.mean().item(),
                plain_max=p_err.max().item(), plain_mean=p_err.mean().item())


def f32(args):
    return [a.float() if isinstance(a, torch.Tensor) else a for a in args]


def merge_case(shape, device, seed=SEED):
    b, c, res = shape
    gen = torch.Generator().manual_seed(seed + c)
    x = torch.randn(b, res * res, c, generator=gen).bfloat16().to(device)
    ln_s = (1 + 0.1 * torch.randn(4 * c, generator=gen)).to(device)
    ln_b = (0.1 * torch.randn(4 * c, generator=gen)).to(device)
    w = (torch.randn(4 * c, 2 * c, generator=gen) * (4 * c) ** -0.5
         ).bfloat16().to(device)
    return x, ln_s, ln_b, w, res


def swin_kernels_vs_plain(device, attn_shapes=SWIN_ATTN_SHAPES,
                          merge_shapes=SWIN_MERGE_SHAPES) -> dict:
    """Phase 12: K4, K5 and K3 (the int8 block's MLP half) at the four
    Swin-B-384 B=64 stage shapes (x for K4 at 1e-2, as K1's check), K6 at
    the three boundaries, each against its plain version: K4 and K6 under
    K1's ratio bound, K5 and K3 under K2's. The angle phase calls it again
    with no attention shape, for K6 at Swin-T-224's boundaries."""
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)
    from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                              patch_merge_reference)
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8,
                                             swin_attn_block_int8_reference,
                                             swin_attn_block_reference)

    errs = {}
    for shape in attn_shapes:
        tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
        x, blk = swin_block_case(shape, device, x_scale=K1_X_SCALE)
        args = k4_args(x, blk)
        e = ratio_errors(fused_swin_attn_block, swin_attn_block_reference,
                         args, f32(args))
        phase("kernel", name="K4", shape=tag, x_scale=K1_X_SCALE, **e,
              max_bound=K1_MAX_RATIO * e["plain_max"],
              mean_bound=K1_MEAN_RATIO * e["plain_mean"])
        check(k1_within_bound(e), f"K4 error outside its bound at {shape}: "
                                  f"{e}")
        errs[("K4", shape)] = e["kernel_max"]
        del x, blk, args

        x, blk = swin_block_case(shape, device, int8=True)
        kw = k5_kwargs(blk)
        with torch.inference_mode():
            got = fused_swin_attn_block_int8(x, **kw)
            torch.cuda.synchronize()
            want = swin_attn_block_int8_reference(x, **kw)
        e = int8_errors(got, want, kw["so_eff"].abs().max().item())
        phase("kernel", name="K5", shape=tag, **e, max_share=INT8_MAX_SHARE)
        check(int8_within_bound(e), f"K5 error outside its bound at {shape}:"
                                    f" {e}")
        errs[("K5", shape)] = e["max_abs_err"]
        # K3 at the stage's widths (rows B S^2, D = C, hidden 4C), on x
        k3 = blk._folded_args(blk._k3)
        with torch.inference_mode():
            got = fused_mlp_block_int8(x, **k3, ln_eps=1e-5)
            torch.cuda.synchronize()
            want = mlp_block_int8_reference(x, **k3, ln_eps=1e-5)
        e = int8_errors(got, want, (k3["s2_eff"] * k3["gamma"]).abs().max()
                        .item())
        phase("kernel", name="K3", shape=tag, **e, max_share=INT8_MAX_SHARE)
        check(int8_within_bound(e), f"K3 error outside its bound at {shape}:"
                                    f" {e}")
        errs[("K3", shape)] = e["max_abs_err"]
        del x, blk, kw, k3, got, want
    for shape in merge_shapes:
        args = merge_case(shape, device)
        e = ratio_errors(fused_patch_merge, patch_merge_reference, args,
                         f32(args))
        phase("kernel", name="K6", shape="B{}_C{}_S{}".format(*shape), **e,
              max_bound=K1_MAX_RATIO * e["plain_max"],
              mean_bound=K1_MEAN_RATIO * e["plain_mean"])
        check(k1_within_bound(e), f"K6 error outside its bound at {shape}: "
                                  f"{e}")
        errs[("K6", shape)] = e["kernel_max"]
    return errs


def swin_model(device, targets, int8=False):
    """The preset's RegressionModel (Swin-B-384 + MLP head 512) in bf16 on
    the card, from seed 0 (`build_model`), perturbed as
    `perturb_swin_`; the target scaler fitted on `targets`."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.objectives.scaler import scaler_from_arrays

    model, _ = build_model(build_preset(SWIN_PRESET), "cpu", seed=SEED,
                           int8=int8)
    perturb_swin_(model, torch.Generator().manual_seed(SEED))
    scaler = scaler_from_arrays(targets.mean(0), targets.std(0))
    return model.to(device), scaler.to(device)


def synthetic_val(n: int, size: int, rng, angles: bool = False):
    """Images as `synthetic_gallery`'s, (lat, lon) targets around the
    reference campus's scale, or with `angles` headings in [0, 360)."""
    from geovpr_torch.data.pipeline import ArraySource

    cell = size // 8
    base = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.float32)
    up = np.repeat(np.repeat(base, cell, 1), cell, 2)
    imgs = np.clip(up + rng.normal(0, 20, up.shape), 0, 255).astype(np.uint8)
    if angles:
        targets = rng.uniform(0.0, 360.0, n).astype(np.float32)
    else:
        targets = np.stack([219000.0 + rng.normal(0, 300.0, n),
                            143000.0 + rng.normal(0, 100.0, n)], 1).astype(
                                np.float32)
    return ArraySource(imgs, targets, [f"v_{i:04d}.jpg" for i in range(n)])


def swin_counters():
    from geovpr_torch.ops.mlp_int8 import fused_mlp_block_int8
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8)
    from geovpr_torch.ops.window_attention import (window_attention_kernel,
                                                   window_attention_raster)
    return {"fused_swin_attn_block": fused_swin_attn_block,
            "fused_swin_attn_block_int8": fused_swin_attn_block_int8,
            "fused_mlp_block_int8": fused_mlp_block_int8,
            "fused_patch_merge": fused_patch_merge,
            "window_attention_kernel": window_attention_kernel,
            "window_attention_raster": window_attention_raster}


def geopose_end_to_end(model, scaler, device, source, out_dir,
                       int8=False) -> tuple[dict, np.ndarray]:
    """Phase 13 (bf16) / 16 (int8): the geopose path through run_evaluate
    (int8: calibration on the first batch, then the w8a8 model), every
    kernel's launch count set to 0 just before and read just after."""
    from geovpr_torch.cli.evaluate import run_evaluate

    counters = {**kernel_counters(), **swin_counters()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, preds = run_evaluate(model, scaler, source, batch_size=SWIN_BATCH,
                              out_dir=out_dir, device=device, int8=int8,
                              submission_csv="preds.csv")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_batches = -(-len(source) // SWIN_BATCH)
    expected = dict.fromkeys(counters, 0)
    expected["fused_patch_merge"] = SWIN_BOUNDARIES * n_batches
    for k in (("fused_swin_attn_block_int8", "fused_mlp_block_int8") if int8
              else ("fused_swin_attn_block",)):
        expected[k] = SWIN_BLOCKS * n_batches
    phase("geopose", path="int8" if int8 else "bf16", wall_s=wall,
          batches=n_batches, launches=launches, expected_launches=expected,
          **out["metrics"])
    check(launches == expected,
          f"kernel launches {launches}, expected {expected}")
    check(preds.shape == (len(source), 2) and bool(np.isfinite(preds).all()),
          f"predictions {preds.shape}, finite {np.isfinite(preds).all()}")
    check(all(np.isfinite(v) for v in out["metrics"].values()),
          f"metrics {out['metrics']}")
    with open(out["validation_csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == len(source), f"{len(rows)} validation CSV rows")
    check(os.path.isfile(out["submission_csv"]), "no submission CSV")
    return launches, preds


def swin_kernel_path_vs_plain_path(model, images, bound=MIN_COSINE,
                                   path="bf16"):
    """Phase 14 (bf16) / 17 (int8): pooled features and predictions of the
    kernel path against the plain path on one batch; returns the kernel
    path's pooled features."""
    from geovpr_torch.data.transforms import normalize

    def forward():
        out = model.backbone(normalize(images))
        return out.pooled.float(), model.head(model.pool(out))

    layers = model.backbone.blocks
    with torch.inference_mode():
        pooled, preds = forward()
        for m in layers:
            m.use_kernels = False
        try:
            pooled_p, preds_p = forward()
        finally:
            for m in layers:
                m.use_kernels = True
    cos = torch.nn.functional.cosine_similarity(pooled, pooled_p, dim=1)
    cos_pred = torch.nn.functional.cosine_similarity(preds, preds_p, dim=1)
    phase("swin_model", path=path, pooled_min_cosine=cos.min().item(),
          pooled_mean_cosine=cos.mean().item(),
          pred_min_cosine=cos_pred.min().item(),
          pred_max_abs_diff=(preds - preds_p).abs().max().item(),
          bound=bound)
    check(cos.min().item() >= bound and cos_pred.min().item() >= bound,
          f"{path} Swin kernel vs plain path cosine {cos.min().item()}, "
          f"predictions {cos_pred.min().item()} < {bound}")
    check(bool(torch.isfinite(pooled).all()), f"{path} pooled not finite")
    return pooled


def swin_bounds(kind: str, shape) -> dict:
    """The least time of one call of K4 / K5 at (B, C, H, S, w, shift), or
    of K6 at (B, C, S): bytes over 3.35 TB/s against operations over the
    peak of their type (the JAX cost estimate: 8 BW N C^2 + 4 BW H N^2 dh
    for the half-block)."""
    if kind == "K6":
        b, c, res = shape
        m2 = b * (res // 2) ** 2
        ops = 2 * m2 * 4 * c * 2 * c
        ops_t = ops / PEAK_BF16
        nbytes = b * res * res * c * 2 + m2 * 2 * c * 2 + 8 * c * c * 2 \
            + 8 * c * 4
    else:
        b, c, h, res, win, _ = shape
        m, n = b * res * res, win * win
        bw = m // n
        att = 2 * bw * h * n * n * (c // h)      # one of q.k^T, P.V
        proj = 8 * m * c * c
        ops = proj + 2 * att
        wbytes = 4 * c * c * (2 if kind == "K4" else 1)
        nbytes = 2 * m * c * 2 + wbytes + (2 * c + 6 * c + 2 * c) * 4 + (
            (2 * win - 1) ** 2 * h * 4)
        if kind == "K4":
            ops_t = ops / PEAK_BF16
        else:
            ops_t = (proj + att) / PEAK_INT8 + att / PEAK_BF16
    bytes_t = nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3,
                ops=ops)


def library_mask(table, h, b, res, win, shift):
    """The yardsticks' float attention mask, bf16 (BW, H, N, N): the
    relative-position bias [+ the shift mask, window w of an image taking
    mask w]."""
    from geovpr_torch.ops.window_attention import (relative_position_bias,
                                                   shift_mask)
    n = win * win
    mask = relative_position_bias(table, win)[None]
    sm = shift_mask(res, win, shift, table.device)
    if sm is not None:
        mask = (mask.reshape(1, 1, h, n, n) + sm[None, :, None]).reshape(
            1, -1, h, n, n).expand(b, -1, -1, -1, -1).reshape(-1, h, n, n)
    return mask.bfloat16()


def library_k4(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table, h, res,
               win, shift, ln_eps=1e-5):
    """K4's yardstick (timed only here, never called by the port):
    F.layer_norm -> torch.matmul -> windows (torch.roll + partition) ->
    F.scaled_dot_product_attention with bias [+ mask] as a float mask ->
    back to raster -> torch.matmul + bias + residual, all bf16."""
    import torch.nn.functional as F

    from geovpr_torch.ops.window_attention import from_windows, to_windows
    b, l, c = x.shape
    hx = F.layer_norm(x.float(), (c,), ln_scale, ln_bias, ln_eps).bfloat16()
    qkv = to_windows((torch.matmul(hx, wqkv) + bqkv).bfloat16(), res, win,
                     shift)
    bw, n, _ = qkv.shape
    q, k, v = (t.reshape(bw, n, h, c // h).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=library_mask(table, h, b, res, win, shift))
    o = from_windows(o.transpose(1, 2).reshape(bw, n, c), res, win, shift)
    return (torch.matmul(o, wo) + bo + x).bfloat16()


def library_k5(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
               wo_q_t, so_eff, bo, cs, table, num_heads, resolution, window,
               shift, ln_eps=1e-5):
    """K5's yardstick: F.layer_norm -> quantize -> torch._int_mm (qkv) ->
    dequant -> K4's windowed bf16 SDPA with the float bias/mask (q and k in
    their int8 units, scaled by cs) -> quantize -> torch._int_mm (out
    projection) + epilogue."""
    import torch.nn.functional as F

    from geovpr_torch.ops.window_attention import from_windows, to_windows
    b, l, c = x.shape
    h, win = num_heads, window
    xq = torch.clamp(torch.round(F.layer_norm(
        x.float(), (c,), None, None, ln_eps) * ln_scale_q + ln_bias_q),
        -127, 127).to(torch.int8).reshape(-1, c)
    qkv = (torch._int_mm(xq, wqkv_q_t.t()) * sqkv_eff + bqkv_eff).bfloat16()
    qkv = to_windows(qkv.reshape(b, l, 3 * c), resolution, win, shift)
    bw, n, _ = qkv.shape
    q, k, v = (t.reshape(bw, n, h, c // h).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=library_mask(table, h, b, resolution, win, shift),
        scale=float(cs))
    o = from_windows(o.transpose(1, 2).reshape(bw, n, c), resolution, win,
                     shift)
    c8 = torch.clamp(torch.round(o.reshape(-1, c).float()), -127,
                     127).to(torch.int8)
    out = torch._int_mm(c8, wo_q_t.t()) * so_eff + bo
    return (out.reshape(b, l, c) + x).bfloat16()


def library_k6(x, ln_scale, ln_bias, w, res, ln_eps=1e-5):
    """K6's yardstick: the 2x2 gather -> F.layer_norm -> torch.matmul."""
    import torch.nn.functional as F

    from geovpr_torch.ops.patch_merge import merge_gather
    m = merge_gather(x, res)
    ln = F.layer_norm(m.float(), (m.shape[-1],), ln_scale, ln_bias,
                      ln_eps).bfloat16()
    return torch.matmul(ln, w)


def swin_kernel_times(device, card: str) -> dict:
    """Phase 19: K4, K5 and K3 at every stage of Swin-B-384 at B=64 (K3 at
    the stage's widths: rows B S^2, D = C, hidden 4C), K6 at every
    boundary, each in turns with its plain version and its library
    yardstick, beside its bound."""
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)
    from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                              patch_merge_reference)
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8,
                                             swin_attn_block_int8_reference,
                                             swin_attn_block_reference)

    out = {}

    def record(name, shape, tag, fns, bound=None):
        t = interleaved_ms(fns, iters=3)
        out[(name, shape)] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                                  library_ms=t["library"][0],
                                  runs={k: v[1] for k, v in t.items()},
                                  **(bound or swin_bounds(name, shape)))
        phase("kernel_time", card=repr(card), name=name, shape=tag,
              **out[(name, shape)])

    with torch.inference_mode():
        for shape in SWIN_ATTN_SHAPES:
            tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
            x, blk = swin_block_case(shape, device)
            a = k4_args(x, blk)
            record("K4", shape, tag, {
                "kernel": lambda: fused_swin_attn_block(*a),
                "plain": lambda: swin_attn_block_reference(*a),
                "library": lambda: library_k4(*a)})
            x, blk = swin_block_case(shape, device, int8=True)
            kw = k5_kwargs(blk)
            record("K5", shape, tag, {
                "kernel": lambda: fused_swin_attn_block_int8(x, **kw),
                "plain": lambda: swin_attn_block_int8_reference(x, **kw),
                "library": lambda: library_k5(x, **kw)})
            k3 = dict(blk._folded_args(blk._k3), ln_eps=1e-5)
            b, c, h, res, _, _ = shape
            record("K3", shape, tag, {
                "kernel": lambda: fused_mlp_block_int8(x, **k3),
                "plain": lambda: mlp_block_int8_reference(x, **k3),
                "library": lambda: library_k3(x, **k3)},
                bounds("K3", b, res * res, c, h))
            del x, blk, a, kw, k3
        for shape in SWIN_MERGE_SHAPES:
            m = merge_case(shape, device)
            record("K6", shape, "B{}_C{}_S{}".format(*shape), {
                "kernel": lambda: fused_patch_merge(*m),
                "plain": lambda: patch_merge_reference(*m),
                "library": lambda: library_k6(*m)})
    return out


def swin_part_times(device, card: str) -> dict:
    """Phase 19b: K4's four launches, K5's four and K3's three at every
    Swin-B-384 stage and K6's two at every boundary, one by one beside
    `k4_part_bounds` / `k5_part_bounds` / `k3_part_bounds` /
    `k6_part_bounds`, after one whole call has filled the buffers they
    read; the launches are not counted (`k4_launch_part`,
    `k5_launch_part`, `k3_launch_part`, `k6_launch_part`)."""
    from geovpr_torch.ops import patch_merge as pm
    from geovpr_torch.ops import swin_block as sb

    out = {}
    with torch.inference_mode():
        for shape in SWIN_ATTN_SHAPES:
            b, c, _, res, _, _ = shape
            x, blk = swin_block_case(shape, device)
            a = k4_args(x, blk)
            bufs = (torch.empty((b * res * res, 3 * c), dtype=x.dtype,
                                device=device),
                    torch.empty((b * res * res, c), dtype=x.dtype,
                                device=device), torch.empty_like(x))
            out[("K4", shape)] = parts_split(
                card, "K4", "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
                sb.K4_PARTS,
                lambda i: sb.k4_launch_part(i, *a, bufs=bufs),
                lambda part: k4_part_bounds(part, shape))
            del x, blk, a, bufs
            x, blk = swin_block_case(shape, device, int8=True)
            kw = k5_kwargs(blk)
            bufs = sb.k5_buffers(x)
            out[("K5", shape)] = parts_split(
                card, "K5", "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
                sb.K5_PARTS,
                lambda i: sb.k5_launch_part(i, x, **kw, bufs=bufs),
                lambda part: k5_part_bounds(part, shape))
            out[("K3", shape)] = k3_part_times(
                x, blk._folded_args(blk._k3), card, 1e-5)
            del x, blk, kw, bufs
        for shape in SWIN_MERGE_SHAPES:
            b, c, res = shape
            m = merge_case(shape, device)
            bufs = (torch.empty((b, res * res // 4, 4 * c),
                                dtype=torch.bfloat16, device=device),
                    torch.empty((b, res * res // 4, 2 * c),
                                dtype=torch.bfloat16, device=device))
            out[("K6", shape)] = parts_split(
                card, "K6", "B{}_C{}_S{}".format(*shape), pm.K6_PARTS,
                lambda i: pm.k6_launch_part(i, *m, bufs=bufs),
                lambda part: k6_part_bounds(part, shape))
    return out


def swin_path(device, card: str) -> dict:
    """Phases 13-18: the geopose path end to end, bf16 then int8, each
    with its kernel-vs-plain comparison, img/s and profile."""
    source = synthetic_val(SWIN_N_VAL, 384, np.random.default_rng(SEED))
    images = torch.from_numpy(source.images[:SWIN_BATCH]).to(device)
    model, scaler = swin_model(device, source.targets)
    with tempfile.TemporaryDirectory() as tmp:
        launches, preds = geopose_end_to_end(model, scaler, device, source,
                                             tmp)
    pooled = swin_kernel_path_vs_plain_path(model, images)
    model_times(model, images, card, "swin-bf16", batch=SWIN_BATCH)
    breakdown(model, images, card, "swin-bf16", batch=SWIN_BATCH)
    state = model.state_dict()
    del model

    model8, scaler = swin_model(device, source.targets, int8=True)
    model8.load_state_dict(state, strict=False)
    with tempfile.TemporaryDirectory() as tmp:
        launches8, preds8 = geopose_end_to_end(model8, scaler, device,
                                               source, tmp, int8=True)
    pooled8 = swin_kernel_path_vs_plain_path(model8, images,
                                             MIN_COSINE_INT8, "int8")
    cos = torch.nn.functional.cosine_similarity(pooled8, pooled, dim=1)
    cos_pred = torch.nn.functional.cosine_similarity(
        torch.from_numpy(preds8), torch.from_numpy(preds), dim=1)
    phase("swin_int8_vs_bf16", pooled_min_cosine=cos.min().item(),
          pooled_mean_cosine=cos.mean().item(),
          pred_min_cosine=cos_pred.min().item())
    model_times(model8, images, card, "swin-int8", batch=SWIN_BATCH)
    breakdown(model8, images, card, "swin-int8", batch=SWIN_BATCH)
    return {"bf16": launches, "int8": launches8}


# ------------------------------------------------------ angle heads / K7 --

def k7_case(shape, device, seed=SEED):
    """K7's operands at (BW, H, N, nW): q, k and v drawn N(0, 1) in bf16,
    the (H, N, N) bias gathered from a relative-position table drawn at
    unit scale (a perturbed table: zero at init), and the real shift mask
    of a stage of nW windows of side sqrt(N) (None where nW is 0)."""
    from geovpr_torch.ops.window_attention import (relative_position_bias,
                                                   shift_mask)
    bw, h, n, nw = shape
    win = int(round(n ** 0.5))
    gen = torch.Generator().manual_seed(seed + bw + h + n)
    q, k, v = (torch.randn(bw, h, n, 32, generator=gen).bfloat16().to(device)
               for _ in range(3))
    table = torch.randn((2 * win - 1) ** 2, h, generator=gen)
    bias = relative_position_bias(table, win).contiguous().to(device)
    mask = (shift_mask(win * int(round(nw ** 0.5)), win, win // 2, device)
            if nw else None)
    return q, k, v, bias, mask


def k7_raster_case(shape, device, seed=SEED):
    """K7's raster operands at (B, C, H, resolution, window, shift): the
    unfused half's qkv (B, L, 3C) drawn N(0, 1) in bf16 and a
    relative-position table ((2w-1)^2, H) drawn at unit scale (f32), with
    the geometry: `window_attention_raster`'s arguments."""
    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + b + c + res + shift)
    qkv = torch.randn(b, res * res, 3 * c, generator=gen).bfloat16()
    table = torch.randn((2 * win - 1) ** 2, h, generator=gen)
    return qkv.to(device), table.to(device), h, res, win, shift


def k7_kernels_vs_plain(device, shapes=K7_SHAPES,
                        raster_shapes=K7_RASTER_SHAPES) -> dict:
    """Phase 20: K7 against its plain version under K1's ratio bound, on
    pre-split windows at Swin-T-224's B=64 stage shapes (shifted at stages
    0-2) and at N = 144, and on the raster qkv at the same four stages; the
    raster launch also bit-equal to the split launch on the gathered
    windows, its context scattered back. Keys: the split shapes, and
    ("raster", shape)."""
    from geovpr_torch.ops.window_attention import (
        window_attention_kernel, window_attention_raster,
        window_attention_raster_reference,
        window_attention_serving_reference, windowed_attention)

    errs = {}
    for shape in shapes:
        args = k7_case(shape, device)
        e = ratio_errors(window_attention_kernel,
                         window_attention_serving_reference, args, f32(args))
        phase("kernel", name="K7", shape="BW{}_H{}_N{}_nW{}".format(*shape),
              **e, max_bound=K1_MAX_RATIO * e["plain_max"],
              mean_bound=K1_MEAN_RATIO * e["plain_mean"])
        check(k1_within_bound(e), f"K7 error outside its bound at {shape}: "
                                  f"{e}")
        errs[shape] = e["kernel_max"]
    for shape in raster_shapes:
        args = k7_raster_case(shape, device)
        e = ratio_errors(window_attention_raster,
                         window_attention_raster_reference, args, f32(args))
        with torch.inference_mode():
            same = torch.equal(window_attention_raster(*args),
                               windowed_attention(window_attention_kernel,
                                                  *args))
        phase("kernel", name="K7_raster",
              shape="B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape), **e,
              max_bound=K1_MAX_RATIO * e["plain_max"],
              mean_bound=K1_MEAN_RATIO * e["plain_mean"],
              equal_to_split=same)
        check(k1_within_bound(e), f"K7 raster error outside its bound at "
                                  f"{shape}: {e}")
        check(same, f"K7 raster launch differs from the split launch at "
                    f"{shape}")
        errs[("raster", shape)] = e["kernel_max"]
    return errs


@torch.no_grad()
def perturb_cnn_(model, gen) -> None:
    """Norm, BatchNorm and bias vectors and ConvNeXt's LayerScale off their
    init values, BatchNorm running means off 0 and variances off 1: a
    random model that uses every input of its layers."""
    for name, p in model.named_parameters():
        if p.dim() != 1:
            continue
        noise = torch.randn(p.shape, generator=gen) * 0.1
        if name.endswith("weight") and not name.endswith("gamma"):
            p.add_(noise.to(p.device, p.dtype))
        else:
            p.copy_(noise)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
        elif name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)


def angle_model(device, preset):
    """The preset's RegressionModel in bf16 on the card, from seed 0
    (`build_model`), perturbed as `perturb_swin_` (Swin) or `perturb_cnn_`;
    returns it and the preset's config."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset

    cfg = build_preset(preset)
    model, _ = build_model(cfg, "cpu", seed=SEED)
    perturb = perturb_swin_ if cfg.model.family == "swin" else perturb_cnn_
    perturb(model, torch.Generator().manual_seed(SEED))
    return model.to(device), cfg


def angle_end_to_end(model, cfg, device, source, out_dir,
                     per_batch: dict) -> dict:
    """Phase 21 (Swin-T) / 24 (CNNs): the angle path through run_evaluate
    with the preset's objective, every kernel's launch count set to 0 just
    before and read just after; `per_batch` the expected launches of a
    batch. Returns the counts."""
    from geovpr_torch.cli.evaluate import run_evaluate
    from geovpr_torch.cli.presets import objective_for

    counters = {**kernel_counters(), **swin_counters()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, preds = run_evaluate(model, None, source, batch_size=ANGLE_BATCH,
                              out_dir=out_dir, device=device,
                              objective=objective_for(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_batches = -(-len(source) // ANGLE_BATCH)
    expected = dict.fromkeys(counters, 0)
    expected.update({k: v * n_batches for k, v in per_batch.items()})
    phase("angle", family=cfg.model.family, wall_s=wall, batches=n_batches,
          launches=launches, expected_launches=expected, **out["metrics"])
    check(launches == expected,
          f"kernel launches {launches}, expected {expected}")
    check(preds.shape == (len(source),) and bool(np.isfinite(preds).all())
          and bool(((preds >= 0) & (preds < 360)).all()),
          f"angles {preds.shape}, range [{preds.min()}, {preds.max()}]")
    check(set(out["metrics"]) == {"maae", "mse"}
          and all(np.isfinite(v) for v in out["metrics"].values()),
          f"metrics {out['metrics']}")
    with open(out["validation_csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == len(source), f"{len(rows)} validation CSV rows")
    return launches


def angle_path(device, card: str) -> dict:
    """Phases 21-25: the angle path end to end at B=64, bf16: Swin-T-224
    (K7's raster launches and K6's per batch, kernel path against plain
    path, img/s, profile), then EfficientNet-B0 and ConvNeXt-B (no kernel
    of the port; finite outputs, img/s, profile). Returns the Swin-T
    launch counts."""
    from geovpr_torch.data.transforms import normalize

    source = synthetic_val(ANGLE_N_VAL, 224, np.random.default_rng(SEED),
                           angles=True)
    images = torch.from_numpy(source.images[:ANGLE_BATCH]).to(device)
    model, cfg = angle_model(device, ANGLE_PRESET)
    with tempfile.TemporaryDirectory() as tmp:
        launches = angle_end_to_end(model, cfg, device, source, tmp, {
            "window_attention_raster": SWIN_T_BLOCKS,
            "fused_patch_merge": SWIN_BOUNDARIES})
    swin_kernel_path_vs_plain_path(model, images, path="swin-t-bf16")
    model_times(model, images, card, "swin-t-bf16", batch=ANGLE_BATCH)
    breakdown(model, images, card, "swin-t-bf16", batch=ANGLE_BATCH)
    del model
    for preset in CNN_PRESETS:
        model, cfg = angle_model(device, preset)
        with tempfile.TemporaryDirectory() as tmp:
            angle_end_to_end(model, cfg, device, source, tmp, {})
        with torch.inference_mode():
            out = model.backbone(normalize(images))
            preds = model.head(model.pool(out))
        phase("cnn_model", preset=preset, pooled_shape=tuple(out.pooled.shape),
              pooled_abs_max=out.pooled.abs().max().item(),
              pred_abs_max=preds.abs().max().item())
        check(out.pooled.shape == (ANGLE_BATCH, model.backbone.num_features)
              and bool(torch.isfinite(out.pooled).all())
              and bool(torch.isfinite(preds).all()),
              f"{preset}: pooled {tuple(out.pooled.shape)} or predictions "
              f"not finite")
        path = cfg.model.family + "-bf16"
        model_times(model, images, card, path, batch=ANGLE_BATCH)
        breakdown(model, images, card, path, batch=ANGLE_BATCH)
        del model
    return launches


def k7_bounds(shape) -> dict:
    """The least time of one K7 call at (BW, H, N, nW): q, k, v read once
    and out written once (bf16), the bias and mask read once (f32), over
    3.35 TB/s, against q.k^T and P.V (4 BW H N^2 dh) at the bf16 peak;
    beside it the BW H N^2 exp2s at the SFU's rate."""
    bw, h, n, nw = shape
    nbytes = 4 * bw * h * n * 32 * 2 + (h + nw) * n * n * 4
    ops_t = 4 * bw * h * n * n * 32 / PEAK_BF16
    bytes_t = nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3,
                exp2s=bw * h * n * n,
                exp2_ms=bw * h * n * n / SFU_EX2_PER_S * 1e3)


def k7_raster_bounds(shape) -> dict:
    """The least time of one raster K7 call at (B, C, H, resolution,
    window, shift): qkv read once and ctx written once (bf16), the table
    read once (f32), over 3.35 TB/s, against the products at the bf16 peak
    (`k7_bounds` of the same windows: BW = B nW, nW shifted windows)."""
    b, c, h, res, win, shift = shape
    nw = (res // win) ** 2
    inner = k7_bounds((b * nw, h, win * win, nw if shift else 0))
    nbytes = b * res * res * 4 * c * 2 + (2 * win - 1) ** 2 * h * 4
    bytes_t = nbytes / PEAK_BYTES
    ops_t = inner["ops_bound_ms"] / 1e3
    return dict(inner, bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                bytes_bound_ms=bytes_t * 1e3)


def library_k7_mask(bias, mask, bw):
    """The float mask of K7's yardstick: bias [+ each window's shift mask]
    tiled to (BW, H, N, N) bf16 (window w takes mask w mod nW), built once,
    outside the timing."""
    m = bias[None] if mask is None else bias[None] + mask[:, None]
    return m.bfloat16().repeat(bw // m.shape[0], 1, 1, 1)


def interleaved_graph_ms(fns: dict, iters: int = 20) -> dict:
    """`graph_ms` of each fn (the host's launch cost left out), run in
    turns a, b, c, c, b, a; returns the mean of each fn's two runs and the
    runs."""
    names = list(fns)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        runs[k].append(graph_ms(fns[k], iters))
    return {k: (sum(v) / 2, v) for k, v in runs.items()}


def k7_kernel_times(device, card: str) -> dict:
    """Phase 26: K7 at Swin-T-224's four stages (B=64), in its raster mode
    (the serving path's) and on pre-split windows, each in turns with its
    plain version and its library yardstick (F.scaled_dot_product_attention
    on the pre-split q, k, v with bias + mask as a float (BW, H, N, N)
    mask; never on the port's path), each call captured in CUDA graphs
    (`graph_ms`), beside its bound. Returns the stage-0 raster times."""
    import torch.nn.functional as F

    from geovpr_torch.ops.window_attention import (
        _windows_qkv, relative_position_bias, shift_mask,
        window_attention_kernel, window_attention_raster,
        window_attention_raster_reference,
        window_attention_serving_reference)

    out = {}
    for stage, (shape, rshape) in enumerate(zip(K7_SHAPES,
                                                K7_RASTER_SHAPES)):
        rargs = k7_raster_case(rshape, device)
        qkv, table, h, res, win, shift = rargs
        q, k, v = (t.contiguous() for t in
                   _windows_qkv(qkv, res, win, shift, h))
        bias = relative_position_bias(table, win).contiguous()
        mask = shift_mask(res, win, shift, device)
        args = (q, k, v, bias, mask)
        lib_mask = library_k7_mask(bias, mask, shape[0])
        launches = SWIN_T_DEPTHS[stage]
        with torch.inference_mode():
            t = interleaved_graph_ms({
                "raster": lambda: window_attention_raster(*rargs),
                "split": lambda: window_attention_kernel(*args),
                "raster_plain": lambda: window_attention_raster_reference(
                    *rargs),
                "split_plain": lambda: window_attention_serving_reference(
                    *args),
                "library": lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=lib_mask)})
        runs = {k: v[1] for k, v in t.items()}
        row = dict(ms=t["raster"][0], plain_ms=t["raster_plain"][0],
                   library_ms=t["library"][0], **k7_raster_bounds(rshape))
        phase("kernel_time", card=repr(card), name="K7_raster",
              shape="B{}_C{}_H{}_S{}_w{}_shift{}".format(*rshape),
              stage=stage, launches_per_batch=launches, timed="cuda_graph",
              **row, runs=runs)
        phase("kernel_time", card=repr(card), name="K7",
              shape="BW{}_H{}_N{}_nW{}".format(*shape), stage=stage,
              timed="cuda_graph", ms=t["split"][0],
              plain_ms=t["split_plain"][0], library_ms=t["library"][0],
              **k7_bounds(shape))
        out[rshape] = row
        del rargs, qkv, q, k, v, args, lib_mask
    torch.cuda.empty_cache()
    return out[K7_RASTER_MAIN]


def k7_half_times(device, card: str) -> None:
    """Phase 27: the window-7 attention half (`swin_attn_block_unfused` as
    the model's serving path calls it, K7's raster mode inside) at
    Swin-T-224's four stages (B=64): CUDA-event ms of a call, then under
    torch.profiler the device ms and calls of each kernel name and the
    calls of each aten op (a call, averaged over 10)."""
    from torch.profiler import ProfilerActivity, profile

    from geovpr_torch.ops.swin_block import swin_attn_block_unfused
    from geovpr_torch.ops.window_attention import window_attention_raster

    iters = 10
    for rshape in K7_RASTER_SHAPES:
        b, c, h, res, win, shift = rshape
        x, blk = swin_block_case(rshape, device)
        args = k4_args(x, blk)[:8]

        def half():
            return swin_attn_block_unfused(
                *args, num_heads=h, resolution=res, window=win, shift=shift,
                attention=window_attention_raster)

        with torch.inference_mode():
            ms = cuda_ms(half, iters)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    half()
                torch.cuda.synchronize()
        kernels = {e.key[:100]: (e.self_device_time_total / iters / 1e3,
                                 e.count / iters)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")}
        ops = {e.key: e.count / iters for e in prof.key_averages()
               if e.key.startswith("aten::")}
        phase("window7_half", card=repr(card),
              shape="B{}_C{}_H{}_S{}_w{}_shift{}".format(*rshape), ms=ms,
              device_ms=sum(v[0] for v in kernels.values()) or
              "not measured", kernels=kernels, ops=ops)
        # on the card K7 reads and writes the raster rows itself (a CPU
        # rehearsal runs its plain version, which gathers)
        check(device.type != "cuda"
              or not {"aten::roll", "aten::permute"} & set(ops),
              f"the window-7 half gathers its windows: {sorted(ops)}")
        del x, blk, args
    torch.cuda.empty_cache()


# ------------------------------------------------------ fused pipeline --

# `geovpr_torch.cli.fuse.main` on 192 non-square JPEGs (480x360 and
# 360x480) and a 256-image gallery, batches of 64: (a) bf16 Swin-B-384
# geopose + Swin-T-224 angle + DINOv2-B/14 + SALAD retrieval with
# --save-index; (b) --int8, the ConvNeXt-B angle head; (c) the
# EfficientNet-B0 angle head on its dual geometry (Resize(256) +
# CenterCrop(224) from the decode) with --load-index of (a)'s index. Then a
# FusedPipeline of the window-7 Swin-T-224 angle head alone in w8a8.
FUSE_N_TEST, FUSE_N_GALLERY, FUSE_BATCH = 192, 256, 64
FUSE_SIZES = ((480, 360), (360, 480))
FUSE_TOP_K = 5
# the stream: the largest head size (Swin-B-384's; EfficientNet's
# Resize(256) in (c))
FUSE_STREAMS = {"fuse-bf16": 384, "fuse-int8": 384, "fuse-dual": 256}
DINO_BLOCKS, CONVNEXT_BLOCKS = 12, 36
# ConvNeXt-B's K3 shapes at B=64 (B, side, C; hidden 4C), the pre-dwconv
# stream as the separate residual
CONVNEXT_K3_SHAPES = ((64, 56, 128), (64, 28, 256), (64, 14, 512),
                      (64, 7, 1024))


def fuse_images(root: str, rng) -> tuple:
    """The test folder and the gallery (images and manifest): non-square
    JPEGs of an upsampled random 8x8 colour field plus noise, the gallery
    100 m apart."""
    from PIL import Image

    def image(i):
        w, h = FUSE_SIZES[i % 2]
        base = Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(
            np.uint8)).resize((w, h), Image.BILINEAR)
        arr = np.asarray(base, np.float32) + rng.normal(0, 20, (h, w, 3))
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))

    test_dir, img_dir = os.path.join(root, "test"), os.path.join(root, "img")
    os.makedirs(test_dir)
    os.makedirs(img_dir)
    for i in range(FUSE_N_TEST):
        image(i).save(os.path.join(test_dir, f"t_{i:04d}.jpg"), quality=90)
    gallery_csv = os.path.join(root, "gallery.csv")
    with open(gallery_csv, "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(FUSE_N_GALLERY):
            image(i).save(os.path.join(img_dir, f"g_{i:04d}.jpg"), quality=90)
            f.write(f"g_{i:04d}.jpg,0,{219000.0 + 100.0 * i},143000.0,0,1\n")
    return test_dir, img_dir, gallery_csv


def fuse_run_dir(root: str, preset: str) -> str:
    """A run directory in the port trainer's format (`save_checkpoint`)
    holding the preset's model at full width from seed 0, perturbed as
    `swin_model` / `angle_model` perturb it; a geopose scaler at the
    campus's scale."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.objectives.scaler import (identity_scaler,
                                                scaler_from_arrays)
    from geovpr_torch.train.checkpoint import save_checkpoint
    from geovpr_torch.train.state import TrainState, build_optimizer

    cfg = build_preset(preset)
    model, scaler = build_model(cfg, "cpu", seed=SEED)
    perturb = perturb_swin_ if cfg.model.family == "swin" else perturb_cnn_
    perturb(model, torch.Generator().manual_seed(SEED))
    scaler = (identity_scaler(2) if scaler is None else
              scaler_from_arrays([219000.0, 143000.0], [300.0, 100.0]))
    run = os.path.join(root, "runs", preset)
    save_checkpoint(os.path.join(run, "best"), TrainState(
        0, model, build_optimizer(model, cfg.optim), scaler, SEED), 1)
    return run


def read_csv(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def fuse_cli(argv: list, expected: dict, path: str) -> tuple:
    """One `geovpr_torch.cli.fuse.main` run, every kernel's launch count set
    to 0 just before and read just after and held to `expected`; its JSON
    record and its CSVs checked: a row per test image sorted by filename
    with finite values, FUSE_TOP_K matches a test image. Returns (record,
    launches)."""
    from geovpr_torch.cli.fuse import main as fuse_main

    counters = {**kernel_counters(), **swin_counters()}
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fuse_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(expected)
    lines = out.getvalue().strip().splitlines()
    rec = json.loads(lines[-1])
    phase("fuse", path=path, wall_s=wall, launches=launches,
          expected_launches=want, notes=repr(lines[:-1]), **rec)
    check(launches == want, f"fuse {path}: launches {launches}, expected "
          f"{want}")
    check(rec["num_images"] == FUSE_N_TEST, f"fuse {path}: {rec}")
    names = [f"t_{i:04d}.jpg" for i in range(FUSE_N_TEST)]
    for key in ("geopose_csv", "angle_csv"):
        if key in rec:
            rows = read_csv(rec[key])
            vals = np.array([[float(v) for k, v in r.items()
                              if k != "filename"] for r in rows])
            check([r["filename"] for r in rows] == names
                  and bool(np.isfinite(vals).all()),
                  f"fuse {path}: {key} rows or values")
    if "retrieval_csv" in rec:
        rows = read_csv(rec["retrieval_csv"])
        ranks = {}
        for r in rows:
            ranks.setdefault(r["query_filename"], []).append(int(r["rank"]))
        check(sorted(ranks) == names and all(
            v == list(range(1, FUSE_TOP_K + 1)) for v in ranks.values())
            and all(np.isfinite(float(r["score"])) for r in rows),
            f"fuse {path}: retrieval rows")
    return rec, launches


def component_outputs(pipe, images, images_alt=None) -> dict:
    """Each component's pooled features and raw outputs on one batch, from
    the stream as the pipeline feeds it (descriptors: the descriptor)."""
    from geovpr_torch.data.transforms import normalize

    x = images.float() / 255.0
    out = {}
    with torch.inference_mode():
        for name, model, size, resize_to in (
                ("geopose", pipe.geopose_model, pipe.geopose_size, 0),
                ("angle", pipe.angle_model, pipe.angle_size,
                 pipe.angle_resize_to)):
            if model is None:
                continue
            inp = (normalize(images_alt) if name == "angle"
                   and images_alt is not None
                   else pipe._head_input(x, size, resize_to))
            o = model.backbone(inp)
            out[name] = (o.pooled.float(), model.head(model.pool(o)).float())
        if pipe.descriptor_model is not None:
            d = pipe.descriptor_model(pipe._head_input(
                x, pipe.descriptor_size)).pooled.float()
            out["descriptor"] = (d, d)
    return out


def fuse_kernel_vs_plain(pipe, images, images_alt, bound, path) -> None:
    """Each component's kernel path against its plain path
    (`use_kernels = False` on every module that has it) on one batch:
    pooled-feature and output cosines at least `bound`."""
    models = [m for m in (pipe.geopose_model, pipe.angle_model,
                          pipe.descriptor_model) if m is not None]
    mods = [m for model in models for m in model.modules()
            if hasattr(m, "use_kernels")]
    got = component_outputs(pipe, images, images_alt)
    for m in mods:
        m.use_kernels = False
    try:
        want = component_outputs(pipe, images, images_alt)
    finally:
        for m in mods:
            m.use_kernels = True
    cos = torch.nn.functional.cosine_similarity
    for name, (pooled, preds) in got.items():
        pw, qw = want[name]
        c_pool = cos(pooled, pw, dim=1).min().item()
        c_pred = cos(preds, qw, dim=1).min().item()
        phase("fuse_model", path=path, component=name,
              pooled_min_cosine=c_pool, out_min_cosine=c_pred, bound=bound)
        check(c_pool >= bound and c_pred >= bound,
              f"fuse {path} {name}: kernel vs plain cosine {c_pool}, "
              f"{c_pred} < {bound}")


def fuse_times(pipe, images, images_alt, card: str, path: str) -> dict:
    """CUDA-event ms of the fused forward of one batch (images on the
    device: the decode excluded) and of each head alone on the same
    stream (its resize and normalize included), img/s; `[fuse_times]`."""
    x = images.float() / 255.0
    heads = {}
    with torch.inference_mode():
        fused = cuda_ms(lambda: pipe.forward(images, images_alt), iters=10)
        if pipe.geopose_model is not None:
            heads["geopose"] = cuda_ms(lambda: pipe.geopose_model(
                pipe._head_input(x, pipe.geopose_size)), iters=10)
        if pipe.angle_model is not None and images_alt is None:
            heads["angle"] = cuda_ms(lambda: pipe.angle_model(
                pipe._head_input(x, pipe.angle_size, pipe.angle_resize_to)),
                iters=10)
        if pipe.descriptor_model is not None:
            heads["descriptor"] = cuda_ms(lambda: pipe.descriptor_model(
                pipe._head_input(x, pipe.descriptor_size)), iters=10)
    b = images.shape[0]
    phase("fuse_times", card=repr(card), path=path, batch=b, ms=fused,
          img_per_s=b * 1e3 / fused,
          **{f"{k}_ms": v for k, v in heads.items()},
          **{f"{k}_img_per_s": b * 1e3 / v for k, v in heads.items()},
          heads_sum_ms=sum(heads.values()))
    return {"ms": fused, **heads}


def fuse_batch(source, device):
    """The first batch of `source` on the device (the decode done once)."""
    batch = source.get_batch(np.arange(FUSE_BATCH))
    alt = batch.get("image_alt")
    return (torch.from_numpy(batch["image"]).to(device),
            None if alt is None else torch.from_numpy(alt).to(device))


def fuse_path(device, card: str) -> dict:
    """The `[fuse]` phase: `cli.fuse.main` (a), (b), (c) with their launch
    counts and CSVs, the geopose and dual-geometry angle predictions
    against `evaluate_and_predict` on the same run directories, each
    component's kernel path against its plain path, the fused img/s and
    the resize matmuls' ms, a profile of one bf16 batch; then the w8a8
    window-7 angle head in a FusedPipeline. Returns the launches of every
    counted run, summed per kernel."""
    from geovpr_torch.cli import fuse
    from geovpr_torch.cli.common import load_trained
    from geovpr_torch.cli.evaluate import calibrate_int8, evaluate_and_predict
    from geovpr_torch.cli.presets import objective_for
    from geovpr_torch.data.pipeline import ImageFolderSource
    from geovpr_torch.pipeline.fused import FusedPipeline, resize_for_head

    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    n_test = -(-FUSE_N_TEST // FUSE_BATCH)
    n_gal = -(-FUSE_N_GALLERY // FUSE_BATCH)
    with tempfile.TemporaryDirectory() as root:
        test_dir, img_dir, gallery_csv = fuse_images(
            root, np.random.default_rng(SEED))
        runs = {p: fuse_run_dir(root, p) for p in (
            SWIN_PRESET, ANGLE_PRESET, *CNN_PRESETS)}
        index = os.path.join(root, "gallery_index.npz")
        common = ["--test-dir", test_dir, "--device", str(device),
                  "--top-k", str(FUSE_TOP_K)]
        gallery = ["--gallery-csv", gallery_csv, "--image-root", img_dir]
        geo = ["--geopose-preset", SWIN_PRESET, "--geopose-run",
               runs[SWIN_PRESET]]
        argv = {
            "fuse-bf16": common + gallery + geo + [
                "--angle-preset", ANGLE_PRESET, "--angle-run",
                runs[ANGLE_PRESET], "--save-index", index],
            "fuse-int8": common + gallery + geo + [
                "--int8", "--angle-preset", CNN_PRESETS[1], "--angle-run",
                runs[CNN_PRESETS[1]]],
            "fuse-dual": common + [
                "--load-index", index, "--angle-preset", CNN_PRESETS[0],
                "--angle-run", runs[CNN_PRESETS[0]]]}
        expected = {
            "fuse-bf16": {
                "fused_mhsa_block": DINO_BLOCKS * (n_gal + n_test),
                "fused_swin_attn_block": SWIN_BLOCKS * n_test,
                "fused_patch_merge": 2 * SWIN_BOUNDARIES * n_test,
                "window_attention_raster": SWIN_T_BLOCKS * n_test},
            "fuse-int8": {
                "fused_mhsa_block_int8": DINO_BLOCKS * (n_gal + n_test),
                "fused_mlp_block_int8": DINO_BLOCKS * (n_gal + n_test) + (
                    SWIN_BLOCKS + CONVNEXT_BLOCKS) * n_test,
                "fused_swin_attn_block_int8": SWIN_BLOCKS * n_test,
                "fused_patch_merge": SWIN_BOUNDARIES * n_test},
            "fuse-dual": {"fused_mhsa_block": DINO_BLOCKS * n_test}}
        recs = {}
        for path in ("fuse-bf16", "fuse-int8", "fuse-dual"):
            out_dir = os.path.join(root, path)
            recs[path], launches = fuse_cli(
                argv[path] + ["--out-dir", out_dir], expected[path], path)
            add(launches)
        check({k: r["stream_size"] for k, r in recs.items()}
              == FUSE_STREAMS, f"stream sizes {recs}")

        # the geopose head at its own size and the dual geometry's angle
        # head against evaluate_and_predict on the same run directories
        names = [f"t_{i:04d}.jpg" for i in range(FUSE_N_TEST)]
        paths = [os.path.join(test_dir, n) for n in names]
        for path, preset, key in (("fuse-bf16", SWIN_PRESET, "geopose_csv"),
                                  ("fuse-dual", CNN_PRESETS[0],
                                   "angle_csv")):
            model, scaler, cfg = load_trained(preset, runs[preset],
                                              device=device)
            src = ImageFolderSource(
                paths=paths, targets=np.zeros(
                    (FUSE_N_TEST, 2) if key == "geopose_csv" else FUSE_N_TEST,
                    np.float32),
                image_size=cfg.data.image_size, filenames=names,
                resize_to=cfg.data.eval_resize_to)
            _, want = evaluate_and_predict(model, scaler, src, FUSE_BATCH,
                                           device, objective_for(cfg))
            rows = read_csv(recs[path][key])
            got = np.array([[float(v) for k, v in r.items()
                             if k != "filename"] for r in rows])
            want = want.reshape(got.shape)
            if key == "geopose_csv":
                err = np.abs(got - want).max()
                bound = 1e-4 * float(scaler.scale.min())
            else:
                d = np.abs(got - want)
                err, bound = np.minimum(d, 360 - d).max(), 1e-3
            phase("fuse_vs_evaluate", path=path, preset=preset,
                  max_abs_diff=err, bound=bound)
            check(err <= bound, f"fuse {path} {preset} against "
                  f"evaluate_and_predict: {err} > {bound}")
            del model

        # the pipelines again, for their kernels against the plain paths,
        # times and one profile
        for path, bound in (("fuse-bf16", MIN_COSINE),
                            ("fuse-int8", MIN_COSINE_INT8)):
            pipe, source, _ = fuse.build_pipeline(fuse.parse_args(
                argv[path] + ["--out-dir", os.path.join(root, "again")]))
            images, alt = fuse_batch(source, device)
            fuse_kernel_vs_plain(pipe, images, alt, bound, path)
            fuse_times(pipe, images, alt, card, path)
            if path == "fuse-bf16":
                x = images.float() / 255.0
                with torch.inference_mode():
                    ms = cuda_ms(lambda: resize_for_head(x, 224), iters=10)
                # the descriptor and the angle head each take one
                phase("fuse_resize", card=repr(card), batch=FUSE_BATCH,
                      shape=f"{x.shape[1]}to224", ms=ms,
                      per_batch_ms=2 * ms)
                breakdown_fn(lambda: pipe.forward(images), card, path,
                             FUSE_BATCH)
            del pipe, source, images, alt
            torch.cuda.empty_cache()

        # the w8a8 window-7 heading head (Swin-T-224) in a FusedPipeline
        model, _, cfg = load_trained(ANGLE_PRESET, runs[ANGLE_PRESET],
                                     device=device, int8=True)
        source = ImageFolderSource(
            paths=paths, targets=np.zeros((FUSE_N_TEST, 1), np.float32),
            image_size=cfg.data.image_size, filenames=names)
        calibrate_int8(model, source, cfg.data.batch_size, device)
        pipe = FusedPipeline(angle_model=model,
                             angle_size=cfg.data.image_size,
                             angle_codec=objective_for(cfg).codec,
                             batch_size=FUSE_BATCH, device=device)
        counters = {**kernel_counters(), **swin_counters()}
        for fn in counters.values():
            fn.launches = 0
        res = pipe.run(source)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        want.update(fused_mlp_block_int8=SWIN_T_BLOCKS * n_test,
                    fused_patch_merge=SWIN_BOUNDARIES * n_test)
        angles = res["angle"]
        phase("fuse", path="fuse-int8-swin-t", launches=launches,
              expected_launches=want, angle_min=float(angles.min()),
              angle_max=float(angles.max()))
        check(launches == want, f"fuse int8 Swin-T: launches {launches}, "
              f"expected {want}")
        check(angles.shape == (FUSE_N_TEST,) and bool(
            ((angles >= 0) & (angles < 360)).all()), "int8 Swin-T angles")
        add(launches)
        images, _ = fuse_batch(source, device)
        fuse_kernel_vs_plain(pipe, images, None, MIN_COSINE_INT8,
                             "fuse-int8-swin-t")
        fuse_times(pipe, images, None, card, "fuse-int8-swin-t")
        del pipe, model
    torch.cuda.empty_cache()
    return total


def convnext_k3_case(shape, device, seed=SEED):
    """K3's arguments at one ConvNeXt-B stage: a block with seeded random
    weights, perturbed (gamma off its 1e-6 init), its static scales
    calibrated on x through the float path; returns the dwconv's output h
    (K3's x), the pre-dwconv stream x (K3's residual) and the folded
    arguments."""
    from geovpr_torch.models.convnext import LN_EPS, ConvNeXtBlock, _conv_nhwc
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    b, side, c = shape
    gen = torch.Generator().manual_seed(seed + c)
    blk = ConvNeXtBlock(c, dtype=torch.bfloat16, int8_mlp=True)
    init_weights_(blk, gen)
    perturb_cnn_(blk, gen)
    x = torch.randn(b, side, side, c, generator=gen).bfloat16().to(device)
    blk = blk.to(device).eval()
    quantize_for_serving(blk, [x])
    with torch.inference_mode():
        h = _conv_nhwc(blk.dwconv, x).contiguous()
    return h, x, dict(blk._folded_args(blk._k3), ln_eps=LN_EPS)


def convnext_k3(device, card: str) -> dict:
    """K3 at ConvNeXt-B's four stage shapes with the separate residual:
    against its plain version under the K2/K3 rule (`[kernel]
    name=K3_convnext`), then timed in turns with the plain version and the
    library yardstick beside its bound (`[kernel_time] name=K3`)."""
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)

    out = {}
    for shape in CONVNEXT_K3_SHAPES:
        b, side, c = shape
        tag = "convnext_B{}_S{}_C{}".format(*shape)
        h, x, k3 = convnext_k3_case(shape, device)
        with torch.inference_mode():
            got = fused_mlp_block_int8(h, **k3, residual=x)
            torch.cuda.synchronize()
            want = mlp_block_int8_reference(h, **k3, residual=x)
            e = int8_errors(got, want,
                            (k3["s2_eff"] * k3["gamma"]).abs().max().item())
            phase("kernel", name="K3_convnext", shape=tag, **e,
                  max_share=INT8_MAX_SHARE)
            check(int8_within_bound(e),
                  f"K3 error outside its bound at ConvNeXt {shape}: {e}")
            t = interleaved_ms({
                "kernel": lambda: fused_mlp_block_int8(h, **k3, residual=x),
                "plain": lambda: mlp_block_int8_reference(h, **k3,
                                                          residual=x),
                "library": lambda: library_k3(h, **k3, residual=x)},
                iters=5)
        out[shape] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                          library_ms=t["library"][0],
                          runs={k: v[1] for k, v in t.items()},
                          max_abs_err=e["max_abs_err"],
                          **bounds("K3", b, side * side, c, 1,
                                   residual=True))
        phase("kernel_time", card=repr(card), name="K3", shape=tag,
              **out[shape])
        del h, x, k3, got, want
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- Swin training / K9a-K9c --

# Swin-B-384 geopose training (preset swin_b384_gemini2) at its B=16: the
# K9 shapes (B, C, H, resolution, window, shift) of stages 0-3; stage 3
# (C = 1024) takes the split backward (K9b and torch products), the others
# K9c. Launches per training step: K9a in every block (24), K9c in the 22
# blocks with C <= 512, K9b in the 2 with C = 1024.
TRAIN_BATCH = 16
K9_SHAPES = ((16, 128, 4, 96, 12, 6), (16, 256, 8, 48, 12, 6),
             (16, 512, 16, 24, 12, 6), (16, 1024, 32, 12, 12, 0))
K9_MAIN = K9_SHAPES[0]


def k9_case(shape, device, seed=SEED):
    """K9's operands at one stage: x at K1_X_SCALE (bf16), LN vectors and
    biases off their init, bf16 matrices at fan-in scale, a table drawn
    N(0, 1) (zero at init), and an upstream gradient g drawn N(0, 1)."""
    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + c + shift)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen) * scale

    args = dict(x=r(b, res * res, c, scale=K1_X_SCALE).bfloat16(),
                ln_scale=1 + r(c, scale=0.1), ln_bias=r(c, scale=0.1),
                wqkv=r(c, 3 * c, scale=c ** -0.5).bfloat16(),
                bqkv=r(3 * c, scale=0.1),
                wo=r(c, c, scale=c ** -0.5).bfloat16(), bo=r(c, scale=0.1),
                table=r((2 * win - 1) ** 2, h))
    g = r(b, res * res, c).bfloat16()
    geom = dict(num_heads=h, resolution=res, window=win, shift=shift)
    return ({k: v.to(device) for k, v in args.items()}, g.to(device), geom)


# An output that is a sum over every row (dbo = sum g) can come out of the
# bf16 and f32 plain versions bit-equal (the same f32 sum of the same bf16
# values), so the ratio bound is 0; the kernel sums in another order. Its
# bounds are floored at F32_SUM_REL of the f32 plain version's max and mean
# |value|: the roundoff of an f32 sum of 10^5 terms is ~1e-6 relative.
F32_SUM_REL = 1e-5


def k9_ratio(name, tag, got, want, ref32) -> dict:
    """K1's ratio bound on one output: the kernel's max and mean |error|
    against the f32 plain version within 1.25x and 1.1x the bf16 plain
    version's (floored at F32_SUM_REL of the output's scale)."""
    k_err = (got.float() - ref32.float()).abs()
    p_err = (want.float() - ref32.float()).abs()
    scale = ref32.float().abs()
    e = dict(finite=bool(torch.isfinite(got.float()).all()),
             kernel_max=k_err.max().item(), kernel_mean=k_err.mean().item(),
             plain_max=p_err.max().item(), plain_mean=p_err.mean().item())
    bounds = dict(
        max_bound=max(K1_MAX_RATIO * e["plain_max"],
                      F32_SUM_REL * scale.max().item()),
        mean_bound=max(K1_MEAN_RATIO * e["plain_mean"],
                       F32_SUM_REL * scale.mean().item()))
    phase("kernel", name=name, shape=tag, **e, **bounds)
    check(e["finite"] and e["kernel_max"] <= bounds["max_bound"]
          and e["kernel_mean"] <= bounds["mean_bound"],
          f"{name} error outside its bound at {tag}: {e}, {bounds}")
    return e


def k9_kernels_vs_plain(device, shapes=K9_SHAPES) -> dict:
    """K9a, K9b and K9c (stage 3: the split backward through K9b) against
    their plain versions at the Swin-B-384 B=16 stage shapes, every output
    under K1's ratio bound. The backward kernels take the bf16 plain
    forward's residuals, so that each is checked alone; the f32 plain
    version runs on the f32 forward's. Returns the max errors of y (K9a),
    dqkv (K9b) and dx (K9c) by shape."""
    from geovpr_torch.ops import swin_block as sb

    errs = {}
    for shape in shapes:
        tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
        a, g, geom = k9_case(shape, device)
        geo = tuple(geom.values())
        a32 = {k: v.float() for k, v in a.items()}
        fwd_args = lambda d: (d["x"], d["ln_scale"], d["ln_bias"], d["wqkv"],
                              d["bqkv"], d["wo"], d["bo"], d["table"], *geo,
                              1e-5)
        with torch.no_grad():
            got = sb.fused_swin_attn_train_fwd(*fwd_args(a))
            torch.cuda.synchronize()
            want = sb._train_plain_fwd(*fwd_args(a))
            ref32 = sb._train_plain_fwd(*fwd_args(a32))
        for i, out in enumerate(("y", "qkv", "ctx", "p")):
            e = k9_ratio(f"K9a.{out}", tag, got[i], want[i], ref32[i])
            if out == "y":
                errs[("K9a", shape)] = e["kernel_max"]
        del got

        _, qkv, ctx, p = want
        _, qkv32, ctx32, p32 = ref32
        da = torch.randn(g.shape, generator=torch.Generator().manual_seed(
            SEED + 1)).bfloat16().to(device)
        def core_plain(qk, pp, dd):
            dq, db = sb.swin_attn_core_bwd_reference(
                sb._raster_to_rows(qk, *geo[1:]), pp,
                sb._raster_to_rows(dd, *geo[1:]), geo[0])
            return sb._rows_to_raster(dq, *geo[1:]), db

        with torch.no_grad():
            got = sb.fused_swin_attn_bwd_core(qkv, p, da, *geo)
            torch.cuda.synchronize()
            want_c = core_plain(qkv, p, da)
            ref_c = core_plain(qkv32, p32, da.float())
        for i, out in enumerate(("dqkv", "dbias")):
            e = k9_ratio(f"K9b.{out}", tag, got[i], want_c[i], ref_c[i])
            if out == "dqkv":
                errs[("K9b", shape)] = e["kernel_max"]
        del got, want_c, ref_c

        split = shape[1] > 512
        bwd_args = lambda d, qk, cx, pp, gg: (
            d["x"], d["ln_scale"], d["ln_bias"], d["wqkv"], d["wo"], qk, cx,
            pp, gg, *geo, 1e-5)
        with torch.no_grad():
            kern = sb.swin_attn_train_bwd_split if split else \
                sb.fused_swin_attn_bwd_all
            got = kern(*bwd_args(a, qkv, ctx, p, g))
            torch.cuda.synchronize()
            want_b = sb._train_plain_bwd(*bwd_args(a, qkv, ctx, p, g),
                                         split=split)
            ref_b = sb._train_plain_bwd(*bwd_args(a32, qkv32, ctx32, p32,
                                                  g.float()), split=split)
        name = "K9b_split" if split else "K9c"
        dts = (None, None, None, torch.bfloat16, None, torch.bfloat16, None,
               None)
        for i, out in enumerate(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                                 "dbo", "dbias")):
            gt = got[i] if dts[i] is None else got[i].to(dts[i])
            e = k9_ratio(f"{name}.{out}", tag, gt, want_b[i], ref_b[i])
            if out == "dx":
                errs[(name, shape)] = e["kernel_max"]
        del a, a32, g, got, want, ref32, want_b, ref_b
        torch.cuda.empty_cache()
    return errs


def k9_bounds(kind: str, shape) -> dict:
    """The least time of one K9 call at (B, C, H, S, w, shift): each input
    read once and each output written once (bf16 streams, f32 vectors,
    biases, table and weight gradients) over 3.35 TB/s, against the
    products at the bf16 peak (JAX's cost estimates: 8 M C^2 + 4 BW H N^2
    dh forward, 8 BW H N^2 dh for the core backward, + 16 M C^2 for the
    whole backward)."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    att = 2 * bw * h * n * n * (c // h)          # one N x N x dh product
    p_bytes = bw * h * n * n * 2
    if kind == "K9a":
        # reads x, the weights, ln_scale, ln_bias, bqkv, bo and the table;
        # writes y, qkv, ctx and p
        ops = 8 * m * c * c + 2 * att
        nbytes = m * c * 2 + 4 * c * c * 2 + 6 * c * 4 \
            + (2 * win - 1) ** 2 * h * 4 + (3 * m * c + 2 * m * c) * 2 \
            + p_bytes
    elif kind == "K9b":
        ops = 4 * att
        nbytes = (3 * m * c + m * c + 3 * m * c) * 2 + p_bytes + h * n * n * 4
    else:
        # reads x, qkv, ctx, g, p, the weights, ln_scale and ln_bias; writes
        # dx, dls, dlb, dwqkv, dbqkv, dwo, dbo (f32) and dbias (f32)
        ops = 4 * att + 16 * m * c * c
        nbytes = (4 * m * c + 3 * m * c) * 2 + p_bytes + 4 * c * c * 2 \
            + 2 * c * 4 + (4 * c * c + 6 * c) * 4 + h * n * n * 4
    ops_t, bytes_t = ops / PEAK_BF16, nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3)


def k9_kernel_times(device, card: str, shape=K9_MAIN,
                    names=("K9a", "K9b", "K9c")) -> dict:
    """K9a, K9b and K9c (those of `names`) at one Swin-B-384 stage (B=16;
    stage 0 by default), each in turns with
    its plain version and its library yardstick (`library_k4`'s forward for
    K9a and its whole backward for K9c, each with K4's residual add, one
    elementwise pass; for K9b the backward of F.scaled_dot_product_attention
    alone, on the same windows and float mask), beside its bound."""
    import torch.nn.functional as F

    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops.window_attention import to_windows

    a, g, geom = k9_case(shape, device)
    geo = tuple(geom.values())
    fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"], a["wo"],
          a["bo"], a["table"], *geo, 1e-5)
    out = {}
    with torch.no_grad():
        _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*fa)
    ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"], qkv, ctx,
          p, g, *geo, 1e-5)
    b, c = shape[0], shape[1]
    leaves = [t.detach().requires_grad_() for t in fa[:8]]
    qkv_w = to_windows(qkv, *geo[1:])
    n = qkv_w.shape[1]
    qh, kh, vh = (t.reshape(-1, n, geo[0], c // geo[0]).transpose(1, 2)
                  .contiguous().requires_grad_()
                  for t in qkv_w.split(c, dim=-1))
    lib_mask = library_mask(a["table"], geo[0], b, *geo[1:])
    with torch.enable_grad():
        y_lib = library_k4(*leaves, *geo)
        o_lib = F.scaled_dot_product_attention(qh, kh, vh,
                                               attn_mask=lib_mask)
    g_o = torch.randn(o_lib.shape, device=device, dtype=o_lib.dtype)
    cases = {
        "K9a": {"kernel": lambda: sb.fused_swin_attn_train_fwd(*fa),
                "plain": lambda: sb._train_plain_fwd(*fa),
                "library": lambda: library_k4(*fa[:8], *geo)},
        "K9b": {"kernel": lambda: sb.fused_swin_attn_bwd_core(qkv, p, g,
                                                              *geo),
                "plain": lambda: sb.swin_attn_core_bwd_reference(
                    sb._raster_to_rows(qkv, *geo[1:]), p,
                    sb._raster_to_rows(g, *geo[1:]), geo[0]),
                "library": lambda: torch.autograd.grad(
                    o_lib, (qh, kh, vh), g_o, retain_graph=True)},
        "K9c": {"kernel": lambda: sb.fused_swin_attn_bwd_all(*ba),
                "plain": lambda: sb._train_plain_bwd(*ba, split=False),
                "library": lambda: torch.autograd.grad(
                    y_lib, leaves, g, retain_graph=True)}}
    for name in names:
        fns = cases[name]
        with torch.no_grad() if name == "K9a" else torch.enable_grad():
            t = interleaved_ms(fns, iters=5)
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         runs={k: v[1] for k, v in t.items()},
                         **k9_bounds(name, shape))
        phase("kernel_time", card=repr(card), name=name,
              shape="B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
              **out[name])
    return out


def k9a_part_bounds(part: str, shape) -> dict:
    """The least time of one of K9a's four launches at (B, C, H, S, w,
    shift), M = B S^2 rows: its inputs read once and its outputs written
    once over 3.35 TB/s, against its products at the bf16 peak or its f32
    operations (the LayerNorm) at 67 TFLOP/s."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    if part == "layernorm":      # x, ln_scale, ln_bias -> h
        return part_bound(8 * m * c, PEAK_F32, 2 * m * c * 2 + 2 * c * 4)
    if part == "qkv_gemm":       # h, Wqkv, bqkv -> qkv, the scaled q copy
        return part_bound(6 * m * c * c, PEAK_BF16,
                          (m * c + 3 * c * c + 4 * m * c) * 2 + 3 * c * 4)
    if part == "attention":      # q copy, k, v, table -> ctx, p
        att = 2 * bw * h * n * n * (c // h)
        return part_bound(2 * att, PEAK_BF16,
                          4 * m * c * 2 + bw * h * n * n * 2
                          + (2 * win - 1) ** 2 * h * 4)
    # ctx, Wo, bo -> y
    return part_bound(2 * m * c * c, PEAK_BF16,
                      (2 * m * c + c * c) * 2 + c * 4)


def k9a_part_times(device, card: str, shapes=K9_SHAPES) -> dict:
    """K9a's four launches (`K9A_PARTS`) timed one by one in CUDA graphs by
    `parts_split`, beside `k9a_part_bounds`, at the four Swin-B-384
    stages (B=16), after one whole call has filled the buffers they read.
    The launches are not counted (`k9a_launch_part`)."""
    from geovpr_torch.ops import swin_block as sb

    out = {}
    for shape in shapes:
        tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
        a, _, geom = k9_case(shape, device)
        fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
              a["wo"], a["bo"], a["table"], *geom.values(), 1e-5)
        with torch.no_grad():
            bufs = sb.k9a_buffers(a["x"], geom["num_heads"], geom["window"])
            for i in range(len(sb.K9A_PARTS)):
                sb.k9a_launch_part(i, *fa, bufs=bufs)
            out[shape] = parts_split(
                card, "K9a", tag, sb.K9A_PARTS,
                lambda i: sb.k9a_launch_part(i, *fa, bufs=bufs),
                lambda part: k9a_part_bounds(part, shape))
        del a, fa, bufs
        torch.cuda.empty_cache()
    return out


def k9c_part_bounds(part: str, shape) -> dict:
    """The least time of one of K9c's launches (with the reduce of its
    partial sums) at (B, C, H, S, w, shift), M = B S^2 rows: its inputs
    read once and its outputs written once (bf16 streams, f32 vectors and
    weight gradients) over 3.35 TB/s, against its products at the bf16
    peak or its f32 operations (column sums, the LayerNorm recompute and
    VJP) at 67 TFLOP/s."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    if part == "da":             # g, Wo -> da
        return part_bound(2 * m * c * c, PEAK_BF16,
                          2 * m * c * 2 + c * c * 2)
    if part == "dwo":            # ctx, g -> dWo (f32)
        return part_bound(2 * m * c * c, PEAK_BF16,
                          2 * m * c * 2 + c * c * 4)
    if part == "dbo":            # g -> dbo
        return part_bound(m * c, PEAK_F32, m * c * 2 + c * 4)
    if part == "core":           # qkv, p, da -> dqkv, dbias
        att = 2 * bw * h * n * n * (c // h)
        return part_bound(4 * att, PEAK_BF16, (3 * m * c + m * c
                                               + 3 * m * c) * 2
                          + bw * h * n * n * 2 + h * n * n * 4)
    if part == "ln_rows":        # x, ln_scale, ln_bias -> h, stats
        return part_bound(8 * m * c, PEAK_F32,
                          2 * m * c * 2 + 2 * c * 4 + m * 8)
    if part == "dwqkv":          # h, dqkv -> dWqkv (f32)
        return part_bound(6 * m * c * c, PEAK_BF16,
                          4 * m * c * 2 + 3 * c * c * 4)
    if part == "dbqkv":          # dqkv -> dbqkv
        return part_bound(3 * m * c, PEAK_F32, 3 * m * c * 2 + 3 * c * 4)
    if part == "dh":             # dqkv, Wqkv -> dh
        return part_bound(6 * m * c * c, PEAK_BF16,
                          4 * m * c * 2 + 3 * c * c * 2)
    # x, dh, stats, ln_scale -> dx, dls, dlb
    return part_bound(10 * m * c, PEAK_F32,
                      3 * m * c * 2 + m * 8 + 3 * c * 4)


def k9c_part_times(device, card: str, shapes=K9_SHAPES[:3]) -> dict:
    """K9c's launches (`K9C_PARTS`, each with the reduce of its partial
    sums) timed one by one in CUDA graphs by `parts_split`, beside
    `k9c_part_bounds`, at the Swin-B-384 stages that take K9c (B=16), and
    the whole K9c called from Python (CUDA events,
    `[kernel_time] name=K9c.call`). The launches are not counted
    (`k9c_launch_part`)."""
    from geovpr_torch.ops import swin_block as sb

    out = {}
    for shape in shapes:
        tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
        a, g, geom = k9_case(shape, device)
        geo = tuple(geom.values())
        with torch.no_grad():
            _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(
                a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
                a["wo"], a["bo"], a["table"], *geo, 1e-5)
            ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"],
                  qkv, ctx, p, g, *geo, 1e-5)
            call = cuda_ms(lambda: sb.fused_swin_attn_bwd_all(*ba), iters=5)
            phase("kernel_time", card=repr(card), name="K9c.call", shape=tag,
                  ms=call, timed="cuda_events", **k9_bounds("K9c", shape))
            bufs = sb.k9c_buffers(a["x"], geo[0], geo[1], geo[2])
            out[shape] = parts_split(
                card, "K9c", tag, sb.K9C_PARTS,
                lambda i: sb.k9c_launch_part(i, *ba, bufs=bufs),
                lambda part: k9c_part_bounds(part, shape))
            out[shape]["call_ms"] = call
        del a, g, qkv, ctx, p, ba, bufs
        torch.cuda.empty_cache()
    return out


# DINOv2 training (preset dinov2_meanpool_huber) at its B=16: the K8
# shapes (B, N, D, H) of base-14, which takes K8c, and of large-14, where
# JAX's size gate (`bwd_all_ok`) fails and the split backward runs K8b and
# torch products.
K8_SHAPES = ((16, 257, 768, 12), (16, 257, 1024, 16))
K8_MAIN = K8_SHAPES[0]
K8_OUTS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma")


def k8_case(shape, device, seed=SEED):
    """K8's operands at one shape: K1's block inputs (x at K1_X_SCALE,
    vectors off their init, bf16 matrices at fan-in scale) and an upstream
    gradient g drawn N(0, 1)."""
    b, n, d, h = shape
    gen = torch.Generator().manual_seed(seed + d)
    x, vecs, mats = block_inputs(b, n, d, gen, device)
    g = torch.randn(b, n, d, generator=gen).bfloat16().to(device)
    return {"x": x, **vecs, **mats}, g


def _k8_fwd_args(a, h):
    return (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
            a["wo"], a["bo"], a["gamma"], h, 1e-6)


def _k8_bwd_args(a, res, g, h):
    return (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"],
            a["bo"], a["gamma"], res[1], res[2], g, h, 1e-6)


def k8_kernels_vs_plain(device, shapes=K8_SHAPES) -> dict:
    """K8a, K8b and the whole backward (K8c where `bwd_all_ok`, else the
    split composition through K8b) against their plain versions, every
    output under K9's ratio bound. The backward kernels take the bf16 plain
    forward's residuals, so that each is checked alone; the f32 plain
    version runs on the f32 forward's. Also prints the share of K8a's
    saved qkv that equals the bf16 plain version's bit for bit. Returns the
    max errors of out (K8a), dqkv (K8b) and dx (K8c) by shape."""
    from geovpr_torch.ops import mhsa as mh

    errs = {}
    for shape in shapes:
        h = shape[3]
        tag = "B{}_N{}_D{}_H{}".format(*shape)
        a, g = k8_case(shape, device)
        a32 = {k: v.float() for k, v in a.items()}
        with torch.no_grad():
            got = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, h))
            torch.cuda.synchronize()
            want = mh.mhsa_train_fwd_reference(*_k8_fwd_args(a, h))
            ref32 = mh.mhsa_train_fwd_reference(*_k8_fwd_args(a32, h))
        for i, out in enumerate(("out", "qkv", "ctx")):
            e = k9_ratio(f"K8a.{out}", tag, got[i], want[i], ref32[i])
            if out == "out":
                errs[("K8a", shape)] = e["kernel_max"]
        phase("k8a_qkv", shape=tag,
              bit_equal_share=(got[1] == want[1]).float().mean().item(),
              max_abs_diff=(got[1].float() - want[1].float()).abs().max()
              .item())
        del got

        da = torch.randn(g.shape, generator=torch.Generator().manual_seed(
            SEED + 1)).bfloat16().to(device)
        with torch.no_grad():
            got = mh.fused_mhsa_bwd_core(want[1], da, h)
            torch.cuda.synchronize()
            e = k9_ratio("K8b.dqkv", tag, got,
                         mh.mhsa_attn_bwd_core_reference(want[1], da, h),
                         mh.mhsa_attn_bwd_core_reference(ref32[1], da.float(),
                                                         h))
        errs[("K8b", shape)] = e["kernel_max"]
        del got, da

        split = not mh.bwd_all_ok(shape[2])
        with torch.no_grad():
            if split:
                got = mh.mhsa_train_bwd_reference(
                    *_k8_bwd_args(a, want, g, h), split=True,
                    core=mh.fused_mhsa_bwd_core)
            else:
                got = mh.fused_mhsa_bwd_all(*_k8_bwd_args(a, want, g, h))
            torch.cuda.synchronize()
            want_b = mh.mhsa_train_bwd_reference(
                *_k8_bwd_args(a, want, g, h), split=split)
            ref_b = mh.mhsa_train_bwd_reference(
                *_k8_bwd_args(a32, ref32, g.float(), h), split=split)
        name = "K8b_split" if split else "K8c"
        for i, out in enumerate(K8_OUTS):
            e = k9_ratio(f"{name}.{out}", tag, got[i], want_b[i], ref_b[i])
            if out == "dx":
                errs[(name, shape)] = e["kernel_max"]
        del a, a32, g, got, want, ref32, want_b, ref_b
        torch.cuda.empty_cache()
    return errs


def k8_bounds(kind: str, shape) -> dict:
    """The least time of one K8 call at (B, N, D, H): each input read once
    and each output written once (bf16 streams and matrices, f32 vectors
    and weight gradients) over 3.35 TB/s, against the products at the bf16
    peak (8 M D^2 + two N x N x dh products a head forward; five such
    products for the core backward; + 18 M D^2 for the whole backward:
    da, dWo, the y recompute, dWqkv and dh)."""
    b, n, d, h = shape
    m = b * n
    att = 2 * b * h * n * n * (d // h)       # one N x N x dh product
    if kind == "K8a":
        # reads x, the weights and 7 D of vectors; writes out, qkv, ctx
        ops = 8 * m * d * d + 2 * att
        nbytes = m * d * 2 + 4 * d * d * 2 + 7 * d * 4 + 5 * m * d * 2
    elif kind == "K8b":
        # reads qkv and da, writes dqkv
        ops = 5 * att
        nbytes = 7 * m * d * 2
    else:
        # reads x, qkv, ctx, g, the weights, bo, gamma, ln_scale, ln_bias;
        # writes dx and the f32 dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb
        ops = 5 * att + 18 * m * d * d
        nbytes = 7 * m * d * 2 + 4 * d * d * 2 + 4 * d * 4 \
            + (4 * d * d + 7 * d) * 4
    ops_t, bytes_t = ops / PEAK_BF16, nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3)


def k8_kernel_times(device, card: str, shape=K8_MAIN,
                    names=("K8a", "K8b", "K8c")) -> dict:
    """K8a, K8b and K8c (those of `names`) at one DINOv2 training shape
    (B=16; DINOv2-B/14's by default), each in turns with its plain version
    and its library yardstick (`library_k1`'s forward for K8a and its whole
    backward for K8c; for K8b the backward of F.scaled_dot_product_attention
    alone, on the same q, k, v), beside its bound; K8a also launch by
    launch."""
    import torch.nn.functional as F

    from geovpr_torch.ops import mhsa as mh

    h = shape[3]
    a, g = k8_case(shape, device)
    fa = _k8_fwd_args(a, h)
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*fa)
    ba = _k8_bwd_args(a, res, g, h)
    d = shape[2]
    leaves = [t.detach().requires_grad_() for t in fa[:8]]
    qh, kh, vh = (mh._heads(t, h).contiguous().requires_grad_()
                  for t in res[1].split(d, dim=-1))
    with torch.enable_grad():
        y_lib = library_k1(*leaves, h)
        o_lib = F.scaled_dot_product_attention(qh, kh, vh)
    g_o = torch.randn(o_lib.shape, device=device, dtype=o_lib.dtype)
    cases = {
        "K8a": {"kernel": lambda: mh.fused_mhsa_train_fwd(*fa),
                "plain": lambda: mh.mhsa_train_fwd_reference(*fa),
                "library": lambda: library_k1(*fa[:9])},
        "K8b": {"kernel": lambda: mh.fused_mhsa_bwd_core(res[1], g, h),
                "plain": lambda: mh.mhsa_attn_bwd_core_reference(res[1], g,
                                                                 h),
                "library": lambda: torch.autograd.grad(
                    o_lib, (qh, kh, vh), g_o, retain_graph=True)},
        "K8c": {"kernel": lambda: mh.fused_mhsa_bwd_all(*ba),
                "plain": lambda: mh.mhsa_train_bwd_reference(*ba),
                "library": lambda: torch.autograd.grad(
                    y_lib, leaves, g, retain_graph=True)}}
    out = {}
    for name in names:
        fns = cases[name]
        with torch.no_grad() if name == "K8a" else torch.enable_grad():
            t = interleaved_ms(fns, iters=5)
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         runs={k: v[1] for k, v in t.items()},
                         **k8_bounds(name, shape))
        phase("kernel_time", card=repr(card), name=name,
              shape="B{}_N{}_D{}_H{}".format(*shape), **out[name])
    if "K8a" in names:
        out["K8a"]["parts"] = k1_part_times(a["x"], a, h, card, "K8a")
    return out


def k8c_part_bounds(part: str, shape) -> dict:
    """The least time of one of K8c's launches (with the reduce of its
    partial sums) at (B, N, D, H), M = B N rows: its inputs read once and
    its outputs written once (bf16 streams and matrices, f32 vectors and
    weight gradients) over 3.35 TB/s, against its products at the bf16
    peak or its f32 operations (scaling, column sums, the LayerNorm
    recompute and VJP) at 67 TFLOP/s."""
    b, n, d, h = shape
    m = b * n
    if part == "dy":             # g, gamma -> dy
        return part_bound(m * d, PEAK_F32, 2 * m * d * 2 + d * 4)
    if part == "dbo":            # g, gamma -> dbo
        return part_bound(2 * m * d, PEAK_F32, m * d * 2 + 2 * d * 4)
    if part == "da":             # dy, Wo -> da
        return part_bound(2 * m * d * d, PEAK_BF16,
                          2 * m * d * 2 + d * d * 2)
    if part == "dwo":            # ctx, dy -> dWo (f32)
        return part_bound(2 * m * d * d, PEAK_BF16,
                          2 * m * d * 2 + d * d * 4)
    if part == "dgamma":         # ctx, Wo, bo, g -> dgamma
        return part_bound(2 * m * d * d, PEAK_BF16,
                          2 * m * d * 2 + d * d * 2 + 2 * d * 4)
    if part == "core":           # qkv, da -> dqkv
        return part_bound(5 * 2 * b * h * n * n * (d // h), PEAK_BF16,
                          7 * m * d * 2)
    if part == "ln_rows":        # x, ln_scale, ln_bias -> h, stats
        return part_bound(8 * m * d, PEAK_F32,
                          2 * m * d * 2 + 2 * d * 4 + m * 8)
    if part == "dwqkv":          # h, dqkv -> dWqkv (f32)
        return part_bound(6 * m * d * d, PEAK_BF16,
                          4 * m * d * 2 + 3 * d * d * 4)
    if part == "dbqkv":          # dqkv -> dbqkv
        return part_bound(3 * m * d, PEAK_F32, 3 * m * d * 2 + 3 * d * 4)
    if part == "dh":             # dqkv, Wqkv -> dh
        return part_bound(6 * m * d * d, PEAK_BF16,
                          4 * m * d * 2 + 3 * d * d * 2)
    # x, dh, stats, ln_scale, g -> dx, dls, dlb
    return part_bound(11 * m * d, PEAK_F32,
                      4 * m * d * 2 + m * 8 + 3 * d * 4)


def k8c_part_times(device, card: str, shape=K8_MAIN) -> dict:
    """K8c's launches (`K8C_PARTS`, each with the reduce of its partial
    sums) timed one by one in CUDA graphs by `parts_split`, beside
    `k8c_part_bounds`, at DINOv2-B/14's training shape (B=16), and the
    whole K8c called from Python (CUDA events, `[kernel_time]
    name=K8c.call`). The launches are not counted (`k8c_launch_part`)."""
    from geovpr_torch.ops import mhsa as mh

    h = shape[3]
    tag = "B{}_N{}_D{}_H{}".format(*shape)
    a, g = k8_case(shape, device)
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, h))
        ba = _k8_bwd_args(a, res, g, h)
        call = cuda_ms(lambda: mh.fused_mhsa_bwd_all(*ba), iters=5)
        phase("kernel_time", card=repr(card), name="K8c.call", shape=tag,
              ms=call, timed="cuda_events", **k8_bounds("K8c", shape))
        bufs = mh.k8c_buffers(a["x"], h)
        out = parts_split(card, "K8c", tag, mh.K8C_PARTS,
                          lambda i: mh.k8c_launch_part(i, *ba, bufs=bufs),
                          lambda part: k8c_part_bounds(part, shape))
    out["call_ms"] = call
    del a, g, res, ba, bufs
    torch.cuda.empty_cache()
    return out


TRAIN_PRESET, TRAIN_N, TRAIN_N_VAL, TRAIN_EPOCHS = (
    "swin_b384_gemini2", 64, 32, 2)
# launches per step: K9a in all 24 blocks, K9c in the 22 with C <= 512,
# K9b in the 2 with C = 1024
TRAIN_K9C_BLOCKS, TRAIN_K9B_BLOCKS = 22, 2
# DINOv2 training at full width: dinov2_meanpool_huber (base-14, 12
# blocks, B=16; K8a and K8c in every block, K1 in validation), its
# large-14 form (24 blocks, D = 1024: K8a and K8b in every block) and
# dinov2_cls_direct_maae (base-14 at its own B=32). (preset, variant or
# None for the preset's, batch, training images, validation images,
# epochs)
DINO_CASES = (("dinov2_meanpool_huber", None, 16, 64, 32, 2),
              ("dinov2_cls_direct_maae", None, 32, 64, 32, 2),
              ("dinov2_meanpool_huber", "large-14", 16, 32, 16, 2))


def train_counters() -> dict:
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import swin_block as sb
    return {**kernel_counters(), **swin_counters(),
            "fused_swin_attn_train_fwd": sb.fused_swin_attn_train_fwd,
            "fused_swin_attn_bwd_all": sb.fused_swin_attn_bwd_all,
            "fused_swin_attn_bwd_core": sb.fused_swin_attn_bwd_core,
            "fused_mhsa_train_fwd": mh.fused_mhsa_train_fwd,
            "fused_mhsa_bwd_all": mh.fused_mhsa_bwd_all,
            "fused_mhsa_bwd_core": mh.fused_mhsa_bwd_core}


@torch.no_grad()
def _drop_rates(model, rate) -> list:
    """Set every DropPath / Dropout rate of `model` to `rate`, a float or
    a list of rates in module order; returns the rates it replaced."""
    from geovpr_torch.models.layers import Dropout, DropPath
    mods = [m for m in model.modules() if isinstance(m, (Dropout, DropPath))]
    old = [m.rate for m in mods]
    for i, m in enumerate(mods):
        m.rate = rate[i] if isinstance(rate, list) else rate
    return old


def _cosine(a, b) -> float:
    """Cosine of two gradients; 1 where both are exactly zero (a sum of
    signs that cancels, as the direct MAAE loss gives its head bias)."""
    if not (a.any() or b.any()):
        return 1.0
    return torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()


GRAD_F32_RATIO = 1.25


@contextlib.contextmanager
def kept_batch_stats(model):
    """Put every BatchNorm running statistic of `model` back after the
    block: a probe's extra train-mode forwards must not move them."""
    from geovpr_torch.models.layers import batch_stat_buffers
    bufs = batch_stat_buffers(model)
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, old in zip(bufs, saved):
                b.copy_(old)


def set_compute_dtype(model, dtype) -> None:
    """The compute dtype of the backbone and of every submodule that keeps
    its own (EfficientNet's ConvBNAct and SqueezeExcite)."""
    for m in model.backbone.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def train_grads_vs_plain(trainer, batch, path: str,
                         against_f32: bool = False) -> None:
    """`_train_grads_vs_plain` with the running statistics kept."""
    with kept_batch_stats(trainer.state.model):
        _train_grads_vs_plain(trainer, batch, path, against_f32)


def _train_grads_vs_plain(trainer, batch, path: str,
                          against_f32: bool = False) -> None:
    """On one batch with dropout and DropPath off, the gradient of every
    parameter on the kernel path against the plain path, cosine >= 0.999
    for each tensor. Beside it, for the worst relative-position table of a
    Swin model (the worst tensor of any other), the cosine of the kernel
    path's and of the bf16 plain path's gradient, each against the plain
    path run in f32 (`[train_grads_f32]`): where the two are alike, the
    kernel's departure is the bf16 path's own cancellation.

    `against_f32` holds the gradient to the f32 plain path instead
    (`[train_grads_f32_bound]`): each tensor's distance from it, over the
    f32 gradient's norm, squared and averaged over the tensors, for the
    kernel path at most GRAD_F32_RATIO squared times the bf16 plain
    path's (the factor the training kernels' own outputs are held to).
    Where the bf16 path's own error is a percent of the gradient (sin/cos
    MSE on DINOv2-B/14's CLS: the bf16 plain path's gradient reads cosine
    0.988 against the f32 path's), two bf16 paths cannot agree to 0.999
    however right each is, and one tensor's ratio of two such errors
    scatters by a quarter; the mean over the model's tensors does not,
    while a tensor whose gradient is wrong outright still moves it."""
    st, model = trainer.state, trainer.state.model
    saved = _drop_rates(model, 0.0)
    model.train()
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)
    names = [n for n, _ in model.named_parameters()]
    compute_dtype = model.backbone.dtype

    blocks = getattr(model.backbone, "blocks", [])

    def grads(kernels: bool, dtype=compute_dtype):
        for m in blocks:
            m.use_kernels = kernels
        set_compute_dtype(model, dtype)
        try:
            loss = trainer.objective.loss(
                model(trainer._normalize(batch["image"])), enc,
                batch["mask"])
            return torch.autograd.grad(loss, list(model.parameters()))
        finally:
            for m in blocks:
                m.use_kernels = True
            set_compute_dtype(model, compute_dtype)

    got, want = grads(True), grads(False)
    cos = {n: _cosine(a, b) for n, a, b in zip(names, got, want)}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    phase("train_grads", path=path, tensors=len(cos),
          min_cosine=worst[0][1], worst=repr(worst),
          bound="kernel-vs-f32 below" if against_f32 else 0.999)
    if against_f32:
        ref = grads(False, torch.float32)
        _drop_rates(model, saved)
        ek, ep, ratio = {}, {}, {}
        for n, k, p, r in zip(names, got, want, ref):
            scale = r.float().norm().item() or 1.0
            ek[n] = (k.float() - r.float()).norm().item() / scale
            ep[n] = (p.float() - r.float()).norm().item() / scale
            ratio[n] = ek[n] / ep[n] if ep[n] else (
                1.0 if not ek[n] else float("inf"))
        mk = sum(v * v for v in ek.values()) / len(ek)
        mp = sum(v * v for v in ep.values()) / len(ep)
        rms = (mk / mp) ** 0.5 if mp else (1.0 if not mk else float("inf"))
        top = sorted(ratio.items(), key=lambda kv: -kv[1])[:3]
        phase("train_grads_f32_bound", path=path, tensors=len(ratio),
              rms_ratio=rms, kernel_rms_rel_err=mk ** 0.5,
              plain_rms_rel_err=mp ** 0.5, worst_tensors=repr([
                  (n, r, cos[n], _cosine(got[names.index(n)],
                                         ref[names.index(n)]),
                  _cosine(want[names.index(n)], ref[names.index(n)]))
                  for n, r in top]), bound=GRAD_F32_RATIO)
        check(rms <= GRAD_F32_RATIO,
              f"kernel path's gradient further from the f32 path than "
              f"{GRAD_F32_RATIO} x the bf16 plain path's: {rms}, {top}")
        return
    tables = {n: c for n, c in cos.items()
              if n.endswith("relative_position_bias_table")}
    name = min(tables or cos, key=(tables or cos).get)
    i = names.index(name)
    ref = grads(False, torch.float32)[i]
    _drop_rates(model, saved)
    phase("train_grads_f32", path=path, tensor=name,
          kernel_vs_plain=cos[name], kernel_vs_f32=_cosine(got[i], ref),
          plain_vs_f32=_cosine(want[i], ref))
    check(min(cos.values()) >= 0.999,
          f"kernel vs plain gradient cosine below 0.999: {worst}")


def train_loss_falls(device, preset: str = TRAIN_PRESET,
                     steps: int = 5) -> None:
    """A fresh model of `preset`, dropout and DropPath off, `steps` steps
    on one fixed batch of 16 synthetic images: the last loss is below the
    first. Adam's first step from a random init overshoots (the second
    loss is the largest), so the run needs steps enough to come back
    below the start: 5 for Swin-B-384; 12 for DINOv2-B/14, whose fifth
    loss still read 0.623 against a first of 0.519 on an H100."""
    import dataclasses

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import fit_scaler
    from geovpr_torch.train.state import create_train_state
    from geovpr_torch.train.steps import make_train_step

    cfg = build_preset(preset)
    geo = isinstance(cfg, GeoposeConfig)
    size = cfg.data.image_size
    src = synthetic_val(TRAIN_BATCH, size, np.random.default_rng(SEED + 7),
                        angles=not geo)
    model = RegressionModel(dataclasses.replace(cfg.model, image_size=size),
                            dtype=torch.bfloat16, train=True).to(device)
    st = create_train_state(model, cfg.optim, seed=SEED,
                            scaler=fit_scaler(src.targets) if geo else None,
                            out_dim=cfg.model.out_dim)
    _drop_rates(model, 0.0)
    step = make_train_step(objective_for(cfg))
    batch = {"image": torch.from_numpy(src.images).to(device),
             "target": torch.from_numpy(src.targets).to(device),
             "mask": torch.ones(TRAIN_BATCH, dtype=torch.bool,
                                device=device)}
    losses = [float(step(st, batch)["loss"]) for _ in range(steps)]
    phase("train_fixed_batch", preset=preset, losses=losses)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss on a fixed batch did not fall: {losses}")


def train_times(trainer, batch, card: str, path: str, step=None,
                phase_name: str = "") -> None:
    """`_train_times` with the running statistics kept."""
    with kept_batch_stats(trainer.state.model):
        _train_times(trainer, batch, card, path, step, phase_name)


def _train_times(trainer, batch, card: str, path: str, step=None,
                 phase_name: str = "") -> None:
    """ms per training step (host clock around 5 synchronised steps on one
    batch), img/s and peak device memory; one step under torch.profiler
    (device busy and idle share, top device ops). `step` defaults to the
    trainer's step; `phase_name` labels a freeze phase."""
    from torch.profiler import ProfilerActivity, profile

    step = step or trainer._train_step
    st = trainer.state
    b = batch["image"].shape[0]
    tag = {"phase": phase_name} if phase_name else {}
    step(st, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step(st, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = (sum(e.self_device_time_total for e in kernels) / 1e3
               if kernels else None)
    phase("train_times", card=repr(card), path=path, **tag, batch=b,
          ms_per_step=ms, img_per_s=b * 1e3 / ms, peak_mem_bytes=peak,
          device_busy_ms=busy_ms if kernels else "not measured",
          idle_share=1 - busy_ms / wall_ms if kernels else "not measured")
    if not kernels:
        phase("breakdown", card=repr(card), path=path, **tag,
              device_time="not measured")
        return
    phase("breakdown", card=repr(card), path=path, **tag, batch=b,
          window_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=1 - busy_ms / wall_ms)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        phase("device_time", path=path, **tag,
              ms=e.self_device_time_total / 1e3, calls=e.count,
              share=e.self_device_time_total / 1e3 / busy_ms,
              name=e.key[:90])


def train_run(cfg, train_src, val_src, device, save_dir: str, epochs: int,
              expected_per: dict, tag: str, expected_once=None,
              pretrained=None):
    """`run_train` with every launch count set to 0 just before and read
    just after: the counts must equal `expected_per` ({counter: (per
    step, per validation batch)}; every other counter 0) plus
    `expected_once` ({counter: launches per run}, the frozen-feature
    cache's extraction), the losses and validation metrics finite, and the
    run directory complete. `pretrained` (a state_dict) is laid over the
    seeded init. Returns the trainer and the counts."""
    from geovpr_torch.cli.train import run_train

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = run_train(cfg, train_src, val_src, save_dir=save_dir,
                        device=device, epochs=epochs, pretrained=pretrained)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    b = cfg.data.batch_size
    steps = epochs * (len(train_src) // b)
    val_batches = epochs * -(-len(val_src) // b)
    expected = dict.fromkeys(counters, 0)
    expected.update({k: s * steps + v * val_batches
                     for k, (s, v) in expected_per.items()})
    for k, n in (expected_once or {}).items():
        expected[k] += n
    hist = trainer.history
    phase("train", path=tag, batch=b, steps=steps, wall_s=wall,
          launches=launches, expected_launches=expected,
          per_step={k: launches[k] / steps for k, (s, _) in
                    expected_per.items() if s},
          step_losses=trainer.step_losses, history=json.dumps(hist))
    check(launches == expected,
          f"{tag}: kernel launches {launches}, expected {expected}")
    check(len(hist) == epochs
          and all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_mse"])
                  for r in hist), f"{tag}: training history {hist}")
    run = trainer.run_dir
    check(all(os.path.isfile(os.path.join(run, d, "state.pt"))
              for d in [f"checkpoint_{e}" for e in range(epochs)] + ["best"])
          and os.path.isfile(os.path.join(run, "metrics.jsonl")),
          f"{tag}: run directory {sorted(os.listdir(run))}")
    return trainer, launches


def train_resume(cfg, train_src, val_src, device, tmp: str, trainer,
                 tag: str, pretrained=None) -> None:
    """A run resumed from the first epoch's checkpoint: every step loss of
    its epochs, and every tensor of its last checkpoint (parameters and
    BatchNorm running statistics), must repeat the unbroken run's bit for
    bit."""
    import shutil

    from geovpr_torch.cli.train import run_train

    unbroken = {e: trainer.step_losses[e] for e in trainer.step_losses
                if e > 0}
    epochs = len(trainer.history)
    resumed_dir = os.path.join(tmp, f"resumed_{tag}")
    os.makedirs(resumed_dir)
    shutil.copytree(os.path.join(trainer.run_dir, "checkpoint_0"),
                    os.path.join(resumed_dir, "checkpoint_0"))
    resumed = run_train(cfg, train_src, val_src, save_dir=tmp, device=device,
                        epochs=epochs, resume=resumed_dir,
                        pretrained=pretrained)
    got = resumed.step_losses
    last = f"checkpoint_{epochs - 1}"
    a, b = (torch.load(os.path.join(r.run_dir, last, "state.pt"),
                       weights_only=True)["params"]
            for r in (trainer, resumed))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    stats = sum(k.endswith(("running_mean", "running_var")) for k in a)
    phase("train_resume", path=tag, unbroken=unbroken, resumed=got,
          equal=got == unbroken, tensors=len(a), running_stats=stats,
          tensors_differ=len(differ))
    check(got == unbroken and not differ,
          f"{tag}: resumed losses {got} != unbroken {unbroken}, or tensors "
          f"differ: {differ[:5]}")


def train_path(device, card: str) -> dict:
    """The training path at full width: `run_train` on swin_b384_gemini2
    (B=16, geo_light, dropout 0.3, DropPath 0.1) over 64 synthetic images
    with synthetic (lat, lon) and a fitted scaler, two epochs of 4 steps
    with a validation pass (32 images) and a checkpoint each, every launch
    count set to 0 just before and read just after; then a run resumed
    from the first epoch's checkpoint, whose steps must repeat the unbroken
    run's losses bit for bit; the kernel-vs-plain gradients, a falling
    loss on a fixed batch, and the step's times. Returns the launch counts
    of the unbroken run."""
    from geovpr_torch.cli.presets import build_preset

    cfg = build_preset(TRAIN_PRESET)
    rng = np.random.default_rng(SEED + 3)
    train_src = synthetic_val(TRAIN_N, 384, rng)
    val_src = synthetic_val(TRAIN_N_VAL, 384, rng)
    with tempfile.TemporaryDirectory() as tmp:
        trainer, launches = train_run(
            cfg, train_src, val_src, device, tmp, TRAIN_EPOCHS, {
                "fused_swin_attn_train_fwd": (SWIN_BLOCKS, 0),
                "fused_swin_attn_bwd_all": (TRAIN_K9C_BLOCKS, 0),
                "fused_swin_attn_bwd_core": (TRAIN_K9B_BLOCKS, 0),
                "fused_swin_attn_block": (0, SWIN_BLOCKS),
                "fused_patch_merge": (0, SWIN_BOUNDARIES)}, "swin-b-train")
        batch = next(iter(_train_batches(train_src, device)))
        train_grads_vs_plain(trainer, batch, "swin-b-train")
        train_times(trainer, batch, card, "swin-b-train")
        train_resume(cfg, train_src, val_src, device, tmp, trainer,
                     "swin-b-train")
        del trainer
        torch.cuda.empty_cache()
    train_loss_falls(device)
    return launches


def evaluate_run_dir(preset: str, run_dir: str, source, batch: int,
                     blocks: int, device, tag: str, per_batch=None,
                     extra=()) -> dict:
    """`geovpr_torch.cli.evaluate.main --run-dir <run> --checkpoint best
    [extra]` on `source` (targets (lat, lon), or headings) written out as
    PNGs with a label CSV, every launch count set to 0 just before and
    read just after: finite metrics, one CSV row per image, and the
    launches `per_batch` ({counter: launches a batch}; default K1 in each
    of `blocks` blocks) in every batch, every other counter 0. Returns the
    counts."""
    from PIL import Image

    from geovpr_torch.cli.evaluate import main as evaluate

    counters = train_counters()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "img"))
        with open(os.path.join(tmp, "labels.csv"), "w") as f:
            f.write("filename,timestamp,latitude,longitude,angle,"
                    "Region_ID\n")
            for name, img, t in zip(source.filenames, source.images,
                                    source.targets):
                name = name.replace(".jpg", ".png")
                Image.fromarray(img).save(os.path.join(tmp, "img", name))
                lat, lon, ang = ((float(t[0]), float(t[1]), 0.0)
                                 if np.ndim(t) else (0.0, 0.0, float(t)))
                f.write(f"{name},0,{lat!r},{lon!r},{ang!r},1\n")
        out = io.StringIO()
        for fn in counters.values():
            fn.launches = 0
        with contextlib.redirect_stdout(out):
            evaluate(["--preset", preset, "--run-dir", run_dir,
                      "--checkpoint", "best", "--val-csv",
                      os.path.join(tmp, "labels.csv"), "--image-root",
                      os.path.join(tmp, "img"), "--batch-size", str(batch),
                      "--out-dir", tmp, "--device", str(device), *extra])
        torch.cuda.synchronize()
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        with open(rec["validation_csv"]) as f:
            rows = f.read().splitlines()
    n = len(source)
    launches = {k: fn.launches for k, fn in counters.items()}
    expected = dict.fromkeys(counters, 0)
    for k, v in (per_batch or {"fused_mhsa_block": blocks}).items():
        expected[k] = v * -(-n // batch)
    phase("evaluate_run_dir", path=tag, extra=" ".join(extra),
          metrics=json.dumps(rec["metrics"]), rows=len(rows) - 1,
          launches={k: v for k, v in launches.items() if v})
    check(all(np.isfinite(v) for v in rec["metrics"].values())
          and len(rows) == n + 1 and launches == expected,
          f"{tag}: evaluate --run-dir gave {rec}, {len(rows) - 1} rows, "
          f"launches {launches}, expected {expected}")
    return launches


def dinov2_train_path(device, card: str) -> dict:
    """The DINOv2 training path at full width through `run_train`, from
    seeded random weights on synthetic images and targets, for each of
    DINO_CASES: the launches (K8a and K8c, or K8b where `bwd_all_ok`
    fails, in every block of every step; K1 in every block of every
    validation batch; nothing else), finite losses and metrics, the run
    directory, the kernel-vs-plain gradients and a resumed run that repeats
    the unbroken run's losses bit for bit. On dinov2_meanpool_huber also
    the step's times and profile, `cli.evaluate --run-dir` on the run it
    wrote, and a falling loss on a fixed batch. Returns the launch counts
    summed over the cases."""
    import dataclasses

    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    from geovpr_torch.ops.mhsa import bwd_all_ok

    total = {}
    for preset, variant, batch, n_train, n_val, epochs in DINO_CASES:
        cfg = build_preset(preset)
        if variant:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, variant=variant))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, batch_size=batch))
        variant = cfg.model.variant
        spec = DINOV2_VARIANTS[variant]
        blocks = spec["num_layers"]
        tag = f"{preset}-{variant}"
        geo = isinstance(cfg, GeoposeConfig)
        rng = np.random.default_rng(SEED + 5)
        size = cfg.data.image_size
        train_src = synthetic_val(n_train, size, rng, angles=not geo)
        val_src = synthetic_val(n_val, size, rng, angles=not geo)
        bwd = ("fused_mhsa_bwd_all" if bwd_all_ok(spec["hidden_size"])
               else "fused_mhsa_bwd_core")
        with tempfile.TemporaryDirectory() as tmp:
            trainer, launches = train_run(
                cfg, train_src, val_src, device, tmp, epochs, {
                    "fused_mhsa_train_fwd": (blocks, 0), bwd: (blocks, 0),
                    "fused_mhsa_block": (0, blocks)}, tag)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            tb = next(iter(_train_batches(train_src, device, batch)))
            train_grads_vs_plain(trainer, tb, tag)
            if (preset, variant) == ("dinov2_meanpool_huber", "base-14"):
                train_times(trainer, tb, card, "dinov2-b-train")
                evaluate_run_dir(preset, trainer.run_dir, val_src, batch,
                                 blocks, device, tag)
            train_resume(cfg, train_src, val_src, device, tmp, trainer, tag)
            del trainer
            torch.cuda.empty_cache()
    train_loss_falls(device, "dinov2_meanpool_huber", steps=12)
    return total


# The rest of the transformer training presets at full width, cut only
# in data and epochs: (preset, batch, training images, validation images,
# epochs). dinov2_sincos_gemini also cuts freeze_backbone_epochs 5 -> 1 so
# that the run crosses the unfreeze.
SINCOS_CASE = ("dinov2_sincos_gemini", 32, 96, 32, 2)
SALAD_CASE = ("dinov2salad_frozen_mlp", 32, 128, 32, 2)
SWIN_T_TRAIN_CASE = ("swin_t224_sincos_gemini", 32, 96, 32, 2)


def _case_cfg(case, **optim):
    import dataclasses

    from geovpr_torch.cli.presets import build_preset
    preset, batch = case[:2]
    cfg = build_preset(preset)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        optim=dataclasses.replace(cfg.optim, **optim))


def _case_sources(case, cfg, seed):
    from geovpr_torch.core.config import GeoposeConfig
    _, _, n_train, n_val, _ = case
    rng = np.random.default_rng(SEED + seed)
    size = cfg.data.image_size
    angles = not isinstance(cfg, GeoposeConfig)
    return (synthetic_val(n_train, size, rng, angles=angles),
            synthetic_val(n_val, size, rng, angles=angles))


def _reduced(case, cfg, **extra) -> str:
    preset, batch, n_train, n_val, epochs = case
    cuts = [f"train_images={n_train}", f"val_images={n_val}",
            f"epochs={epochs} (preset {cfg.train.epochs})", *(
                f"{k}={v}" for k, v in extra.items())]
    return "; ".join(cuts)


def _dino_blocks(cfg) -> int:
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    return DINOV2_VARIANTS[cfg.model.variant]["num_layers"]


def _init_params(cfg) -> dict:
    """The parameters `create_train_state` draws for `cfg` (drawn on the
    CPU from the run's seed, the same on any device), on the CPU."""
    import dataclasses

    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel
    model = RegressionModel(
        dataclasses.replace(cfg.model, image_size=cfg.data.image_size),
        dtype=torch.bfloat16, train=True)
    init_weights_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.state_dict()


def _check_backbone_unchanged(params: dict, init: dict, tag: str,
                              what: str) -> None:
    """Every backbone tensor of `params` equal to `init` bit for bit, and
    some head tensor moved."""
    moved = [k for k, v in params.items() if not torch.equal(
        v.detach().cpu(), init[k])]
    bad = [k for k in moved if k.startswith("backbone.")]
    phase("train_frozen", path=tag, what=what, backbone_tensors=sum(
        k.startswith("backbone.") for k in init), backbone_moved=len(bad),
        head_moved=len(moved) - len(bad))
    check(not bad and moved, f"{tag}: {what}: backbone tensors moved "
          f"{bad[:5]}, moved {moved[:5]}")


def dinov2_sincos_path(device, card: str) -> dict:
    """dinov2_sincos_gemini at full width (DINOv2-B/14, CLS, sin/cos MLP
    head, angle_rot on the device, B=32) through `run_train`: two epochs
    of 3 steps with `freeze_backbone_epochs` 1, so that epoch 0 trains the
    head alone and epoch 1, after the unfreeze, the whole model. K8a and
    K8c run in every block of every step of both phases (JAX computes the
    frozen backbone's gradient and zeroes it in the optimizer), K1 in
    every block of every validation batch. The backbone is bit for bit
    the init after epoch 0 (`checkpoint_0`); the kernel-vs-plain
    gradients on the unfrozen model; a run resumed at epoch 1 from
    `checkpoint_0`, which unfreezes as it starts, repeats the unbroken
    run's losses bit for bit; the step's times in each phase. Returns the
    launch counts."""
    import dataclasses

    from geovpr_torch.train.state import build_optimizer

    case = SINCOS_CASE
    cfg = _case_cfg(case, freeze_backbone_epochs=1)
    tag = f"{case[0]}-{cfg.model.variant}"
    train_src, val_src = _case_sources(case, cfg, 11)
    blocks = _dino_blocks(cfg)
    phase("train_case", path=tag, reduced=repr(_reduced(
        case, cfg, freeze_backbone_epochs="1 (preset 5)")))
    with tempfile.TemporaryDirectory() as tmp:
        trainer, launches = train_run(
            cfg, train_src, val_src, device, tmp, case[4], {
                "fused_mhsa_train_fwd": (blocks, 0),
                "fused_mhsa_bwd_all": (blocks, 0),
                "fused_mhsa_block": (0, blocks)}, tag)
        ck = torch.load(os.path.join(trainer.run_dir, "checkpoint_0",
                                     "state.pt"), weights_only=True)
        _check_backbone_unchanged(ck["params"], _init_params(cfg), tag,
                                  "after epoch 0 (frozen)")
        check(not trainer._frozen_phase
              and set(trainer.state.opt.mu) == set(
                  dict(trainer.state.model.named_parameters())),
              f"{tag}: the run did not end unfrozen")
        tb = next(iter(_train_batches(train_src, device, case[1])))
        train_grads_vs_plain(trainer, tb, tag, against_f32=True)
        train_times(trainer, tb, card, tag, phase_name="unfrozen")
        st = trainer.state
        st.opt = build_optimizer(st.model, dataclasses.replace(
            cfg.optim, backbone_lr_scale=0.0), trainer._total_steps,
            trainer._steps_per_epoch)
        train_times(trainer, tb, card, tag, phase_name="frozen")
        train_resume(cfg, train_src, val_src, device, tmp, trainer, tag)
        del trainer, st
        torch.cuda.empty_cache()
    return launches


def salad_frozen_path(device, card: str) -> dict:
    """dinov2salad_frozen_mlp at full width (DINOv2-B/14 + SALAD, the
    8,448-d descriptor, MLP head, B=32) through `run_train`: two epochs of
    4 steps with the frozen-feature cache (K1 in every block of every
    extraction batch, once per run over the training and validation
    images, then no kernel launch in any step or validation batch), and
    the same run without it (K1 in every block of every step and
    validation batch, the backbone under no grad). The two runs' losses,
    validation metrics and parameters agree bit for bit, and the backbone
    and SALAD are the init's. Then the cached step's and the uncached
    step's times. Returns the cached run's launch counts plus the
    uncached run's."""
    import dataclasses

    case = SALAD_CASE
    cfg = _case_cfg(case)
    tag = f"{case[0]}-{cfg.model.variant}"
    train_src, val_src = _case_sources(case, cfg, 12)
    b, blocks = case[1], _dino_blocks(cfg)
    extract = -(-len(train_src) // b) + -(-len(val_src) // b)
    phase("train_case", path=tag, reduced=repr(_reduced(case, cfg)))
    init = _init_params(cfg)
    total, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for cache in (True, False):
            c = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, cache_frozen_features=cache))
            name = f"{tag}-{'cached' if cache else 'uncached'}"
            trainer, launches = train_run(
                c, train_src, val_src, device, tmp, case[4],
                {} if cache else {"fused_mhsa_block": (blocks, blocks)},
                name, expected_once={"fused_mhsa_block": blocks * extract}
                if cache else None)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            _check_backbone_unchanged(trainer.state.model.state_dict(), init,
                                      name, "after the run")
            runs[cache] = trainer
        cached, plain = runs[True], runs[False]
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k != "seconds"}
        head_equal = all(
            torch.equal(a, plain.state.model.state_dict()[k])
            for k, a in cached.state.model.state_dict().items())
        same = (cached.step_losses == plain.step_losses
                and [strip(r) for r in cached.history]
                == [strip(r) for r in plain.history] and head_equal)
        phase("train_cache", path=tag, equal=same,
              cached=cached.step_losses, uncached=plain.step_losses,
              params_equal=head_equal)
        check(same, f"{tag}: the cached run differs from the uncached one")
        tb = next(iter(_train_batches(train_src, device, b)))
        train_times(plain, tb, card, tag, phase_name="uncached")
        feats, _, step, _ = cached._maybe_cache_frozen_features(
            train_src, None)
        fb = next(iter(_train_batches(feats, device, b)))
        train_times(cached, fb, card, tag, step=step, phase_name="cached")
        del cached, plain, runs
        torch.cuda.empty_cache()
    return total


def swin_t_train_path(device, card: str) -> dict:
    """swin_t224_sincos_gemini at full width (Swin-T-224, window 7, sin/cos
    MLP head, geo_light, DropPath 0.1, cosine with warm restarts, clip
    1.0, B=32) through `run_train`: two epochs of 3 steps. JAX trains
    window 7 on its XLA route (`pallas_ok` needs `deterministic`), so no
    kernel of the port runs in a step; validation runs K7's raster entry
    in every block and K6 at every boundary. Then the kernel-vs-plain
    gradients (the same route under grad, so equal) with the f32
    reference, and the step's times. Returns the launch counts."""
    case = SWIN_T_TRAIN_CASE
    cfg = _case_cfg(case)
    tag = case[0]
    train_src, val_src = _case_sources(case, cfg, 13)
    phase("train_case", path=tag, reduced=repr(_reduced(case, cfg)))
    with tempfile.TemporaryDirectory() as tmp:
        trainer, launches = train_run(
            cfg, train_src, val_src, device, tmp, case[4], {
                "window_attention_raster": (0, SWIN_T_BLOCKS),
                "fused_patch_merge": (0, len(SWIN_T_DEPTHS) - 1)}, tag)
        tb = next(iter(_train_batches(train_src, device, case[1])))
        train_grads_vs_plain(trainer, tb, tag)
        train_times(trainer, tb, card, tag)
        del trainer
        torch.cuda.empty_cache()
    return launches


# The CNN training presets at full width (EfficientNet-B0 at 224 with
# BatchNorm in training mode, ConvNeXt-B at 224), cut only in data and
# epochs: (preset, batch, training images, validation images, epochs).
CNN_TRAIN_CASES = (("efficientnet_direct_maae", 32, 96, 32, 2),
                   ("efficientnet_sincos_gemini", 32, 96, 32, 2),
                   ("convnext_direct_maae", 16, 48, 32, 2))
CONVNEXT_BLOCKS = 36            # ConvNeXt-B: 3 + 3 + 27 + 3, one K3 each
EFFICIENTNET_BATCHNORMS = 49
# the running statistics after a step against flax's formula recomputed in
# f64 on that step's BatchNorm inputs: max |error| over the tensor's
# largest element
BN_STAT_RTOL = 1e-5
# a gradient that is zero in exact arithmetic (a BatchNorm bias that only
# a 1x1 conv and another training-mode BatchNorm follow): roundoff in
# every path, so its cosine is not read
CNN_ROUNDOFF_GRADS = ("project.bn.bias",)
# the bf16 gradient's per-tensor cosine against the f32 path's, at least:
# EfficientNet-B0 no further from f32 than JAX's own bf16 gradient sits
# (0.9316 on the CPU, `cpu_bf16_grads.py efficientnet_sincos_gemini
# --batch 8`; the port 0.9824 there); ConvNeXt-B under its CPU reading
# (0.9926, `cpu_bf16_grads.py convnext_direct_maae --batch 2 --perturb`)
CNN_GRAD_MIN_COSINE = {"efficientnet": 0.93, "convnext": 0.99}


def _state_snapshot(st) -> dict:
    """The float state a training step moves, and its counters."""
    return {"model": {k: v.clone() for k, v in st.model.state_dict().items()},
            "mu": {k: v.clone() for k, v in st.opt.mu.items()},
            "nu": {k: v.clone() for k, v in st.opt.nu.items()},
            "count": st.opt.count, "step": st.step}


def _state_equal(st, snap) -> list:
    """The names of the tensors of `st` that differ from `snap`."""
    sd = st.model.state_dict()
    return ([k for k, v in snap["model"].items() if not torch.equal(v, sd[k])]
            + [f"mu.{k}" for k, v in snap["mu"].items()
               if not torch.equal(v, st.opt.mu[k])]
            + [f"nu.{k}" for k, v in snap["nu"].items()
               if not torch.equal(v, st.opt.nu[k])])


def _state_restore(st, snap) -> None:
    st.model.load_state_dict(snap["model"])
    for key in ("mu", "nu"):
        for k, v in snap[key].items():
            getattr(st.opt, key)[k].copy_(v)
    st.opt.count, st.step = snap["count"], snap["step"]


def _perturbed_backbone(cfg) -> dict:
    """The backbone tensors of the seeded init `create_train_state` draws
    for `cfg`, with norm and bias vectors, LayerScale gammas and the
    BatchNorm running statistics moved off their init (`perturb_cnn_`), to
    lay over a run's init as `pretrained`."""
    import dataclasses

    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel
    model = RegressionModel(
        dataclasses.replace(cfg.model, image_size=cfg.data.image_size),
        dtype=torch.bfloat16, train=True)
    init_weights_(model, torch.Generator().manual_seed(cfg.train.seed))
    perturb_cnn_(model, torch.Generator().manual_seed(SEED + 21))
    return {k: v for k, v in model.state_dict().items()
            if k.startswith("backbone.")}


def bn_stats_vs_flax(trainer, batch, tag: str) -> None:
    """One training step with a hook on every BatchNorm: each running mean
    and variance after it must equal 0.9 times its value before plus 0.1
    times flax's statistic of that step's BatchNorm input (the conv
    output), recomputed in f64: the mean over (B, H, W), and the biased
    variance max(E[x^2] - E[x]^2, 0); max |error| at most BN_STAT_RTOL of
    the tensor's largest element. The state is put back after it."""
    from geovpr_torch.models.layers import BatchNorm

    st = trainer.state
    bns = [m for m in st.model.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.double(), m.running_var.double()) for m in bns]
    stats = {}

    def hook(i):
        def fn(mod, args, out):
            x = args[0].detach().double()
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0)
            stats[i] = (mean, var)
        return fn

    snap = _state_snapshot(st)
    hooks = [m.register_forward_hook(hook(i)) for i, m in enumerate(bns)]
    try:
        m = trainer._train_step(st, batch)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    worst, where = 0.0, ""
    for i, bn in enumerate(bns):
        for got, old, new, name in (
                (bn.running_mean, before[i][0], stats[i][0], "mean"),
                (bn.running_var, before[i][1], stats[i][1], "var")):
            want = 0.9 * old + 0.1 * new
            err = ((got.double() - want).abs().max()
                   / want.abs().max().clamp(min=1e-30)).item()
            if err > worst:
                worst, where = err, f"{i}.{name}"
    moved = sum(not torch.equal(bn.running_var.double(), before[i][1])
                for i, bn in enumerate(bns))
    _state_restore(st, snap)
    phase("train_bn_stats", path=tag, batchnorms=len(bns), moved=moved,
          max_rel_err=worst, worst=where, bound=BN_STAT_RTOL,
          skipped=float(m["skipped"]))
    check(len(bns) == EFFICIENTNET_BATCHNORMS and len(stats) == len(bns)
          and moved == len(bns) and worst <= BN_STAT_RTOL
          and float(m["skipped"]) == 0.0,
          f"{tag}: running statistics against flax's formula: {worst} at "
          f"{where}, {moved} of {len(bns)} moved")


def nan_step_keeps_state(trainer, batch, tag: str) -> None:
    """A step on the batch with NaN targets: skipped, and every parameter,
    Adam moment and BatchNorm running statistic bit-equal to its value
    before it. The counters are put back after it."""
    st = trainer.state
    snap = _state_snapshot(st)
    bad = dict(batch, target=torch.full_like(batch["target"], float("nan")))
    m = trainer._train_step(st, bad)
    differ = _state_equal(st, snap)
    phase("train_nan_step", path=tag, skipped=float(m["skipped"]),
          loss=float(m["loss"]), tensors=len(snap["model"]) + 2 * len(
              snap["mu"]), tensors_differ=len(differ))
    check(float(m["skipped"]) == 1.0 and not differ,
          f"{tag}: the NaN step was not skipped or moved {differ[:5]}")
    _state_restore(st, snap)


def cnn_grads_vs_f32(trainer, batch, tag: str) -> None:
    """The bf16 training gradient against the same step's in f32, per
    tensor, on one batch with dropout and stochastic depth off (the
    running statistics kept): the cosine of each tensor but those in
    CNN_ROUNDOFF_GRADS at least the family's CNN_GRAD_MIN_COSINE."""
    st, model = trainer.state, trainer.state.model
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)
    names = [n for n, _ in model.named_parameters()]
    dtype = model.backbone.dtype

    def grads(dt):
        set_compute_dtype(model, dt)
        try:
            loss = trainer.objective.loss(
                model(trainer._normalize(batch["image"])), enc,
                batch["mask"])
            return torch.autograd.grad(loss, list(model.parameters()))
        finally:
            set_compute_dtype(model, dtype)

    with kept_batch_stats(model):
        saved = _drop_rates(model, 0.0)
        model.train()
        g16, g32 = grads(dtype), grads(torch.float32)
        _drop_rates(model, saved)
    cos = {n: _cosine(a, b) for n, a, b in zip(names, g16, g32)
           if not n.endswith(CNN_ROUNDOFF_GRADS)}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    flat = [(a.double().flatten(), b.double().flatten())
            for n, a, b in zip(names, g16, g32) if n in cos]
    whole = torch.nn.functional.cosine_similarity(
        torch.cat([a for a, _ in flat]), torch.cat([b for _, b in flat]),
        dim=0).item()
    bound = CNN_GRAD_MIN_COSINE[model.config.family]
    phase("train_grads_f32", path=tag, tensors=len(cos),
          min_cosine=worst[0][1],
          median_cosine=float(np.median(list(cos.values()))),
          all_cosine=whole, worst=repr(worst), bound=bound)
    check(worst[0][1] >= bound,
          f"{tag}: bf16 gradient against f32 below {bound}: {worst}")


def cnn_train_path(device, card: str) -> dict:
    """The CNN training presets at full width through `run_train`, for each
    of CNN_TRAIN_CASES: EfficientNet-B0 (BatchNorm on the batch's
    statistics, its running ones moving as flax's) and ConvNeXt-B, from
    seeded weights with norm and bias vectors, LayerScale gammas and the
    running statistics perturbed off their init, two epochs of 3 steps.
    No kernel of the port runs in a step or in a validation batch (cuDNN
    and cuBLAS under autograd, as JAX trains both on XLA). Checks: finite
    losses and metrics; every running statistic moved off its start; one
    step's statistics against flax's formula in f64; a NaN-target step
    bit-equal; a resumed run bit-equal, losses and every tensor of its
    last checkpoint; the bf16 gradient against f32; `cli.evaluate
    --run-dir` on the run (and, for ConvNeXt, `--int8`: K3 in every block
    of every batch, held to its plain version); the step's times. Returns
    the launch counts."""
    from geovpr_torch.cli.common import load_trained
    from geovpr_torch.cli.evaluate import calibrate_int8
    from geovpr_torch.models.layers import batch_stat_buffers

    total = {}
    for case in CNN_TRAIN_CASES:
        preset, batch = case[:2]
        cfg = _case_cfg(case)
        tag = preset
        train_src, val_src = _case_sources(case, cfg, 14)
        pre = _perturbed_backbone(cfg)
        eff = cfg.model.family == "efficientnet"
        t0 = time.perf_counter()
        phase("train_case", path=tag, reduced=repr(_reduced(case, cfg)),
              start="seeded init, perturb_cnn_ on the backbone")
        with tempfile.TemporaryDirectory() as tmp:
            trainer, launches = train_run(
                cfg, train_src, val_src, device, tmp, case[4], {}, tag,
                pretrained=pre)
            bufs = dict(zip(
                [n for n, b in trainer.state.model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))],
                batch_stat_buffers(trainer.state.model)))
            moved = [k for k, v in bufs.items()
                     if not torch.equal(v.cpu(), pre[k])]
            phase("train_batch_stats", path=tag, tensors=len(bufs),
                  moved=len(moved))
            check(len(moved) == len(bufs) == (
                2 * EFFICIENTNET_BATCHNORMS if eff else 0),
                f"{tag}: running statistics moved {len(moved)} of "
                f"{len(bufs)}")
            tb = next(iter(_train_batches(train_src, device, batch)))
            if eff:
                bn_stats_vs_flax(trainer, tb, tag)
            nan_step_keeps_state(trainer, tb, tag)
            train_resume(cfg, train_src, val_src, device, tmp, trainer, tag,
                         pretrained=pre)
            cnn_grads_vs_f32(trainer, tb, tag)
            train_times(trainer, tb, card, tag)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            run_dir = trainer.run_dir
            del trainer
            torch.cuda.empty_cache()
            evaluate_run_dir(preset, run_dir, val_src, batch, 0, device,
                             tag, per_batch={})
            if not eff:
                got = evaluate_run_dir(
                    preset, run_dir, val_src, batch, 0, device,
                    f"{tag}-int8", extra=("--int8",),
                    per_batch={"fused_mlp_block_int8": CONVNEXT_BLOCKS})
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
                model, _, _ = load_trained(preset, run_dir, device=device,
                                           int8=True)
                calibrate_int8(model, val_src, batch, device)
                images = torch.from_numpy(val_src.images[:batch]).to(device)
                swin_kernel_path_vs_plain_path(model, images,
                                               MIN_COSINE_INT8,
                                               f"{tag}-int8-run")
                del model
                torch.cuda.empty_cache()
        phase("train_case_seconds", path=tag, s=time.perf_counter() - t0)
    return total


def _train_batches(source, device, batch: int = TRAIN_BATCH):
    from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
    return prefetch_to_device(iterate_batches(source, batch), device)


# ----------------------------------------------------------- parallel --
# The multi-process path (`geovpr_torch.parallel`) on the one card:
# (a) world 1 over NCCL, each CLI as a user launches it (`--multihost
# --coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0`) in a
# child process, against the same CLI without a mesh in this process:
# (preset, batch, image side, train images, val images, epochs)
PAR_TRAIN_CASES = (("swin_b384_gemini2", 16, 384, 32, 16, 2),
                   ("efficientnet_direct_maae", 32, 224, 64, 32, 2))
# retrieve --int8: (gallery images, query images, batch) at 224 px
PAR_RETRIEVE = (64, 32, 32)
# (b) world 2 over gloo, both ranks on the one card (gloo stages each
# collective through the host): dinov2_meanpool_huber at the preset's
# B=16 global batch, two steps, against world 1 on the same global batch;
# a sharded int8 search of (gallery rows, queries, k) at 8448-d
PAR_GLOO_CASE = ("dinov2_meanpool_huber", 16, 224, 2)
PAR_GLOO_SEARCH = (4096, 64, 5)
PAR_MIN_COSINE, PAR_LOSS_RTOL = 0.9999, 1e-3
PAR_STEP_TIMES = 5


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_images(root: str, name: str, n: int, size: int, rng,
               angles: bool = False) -> str:
    """n square JPEGs of `synthetic_val`'s images under root/img and a
    label CSV root/{name}.csv; returns the CSV's path."""
    from PIL import Image

    src = synthetic_val(n, size, rng, angles)
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    path = os.path.join(root, f"{name}.csv")
    with open(path, "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(n):
            fname = f"{name}_{i:04d}.jpg"
            Image.fromarray(src.images[i]).save(os.path.join(img_dir, fname),
                                                quality=95)
            lat, lon = ((219000.0 + 100.0 * i, 143000.0) if angles
                        else tuple(src.targets[i]))
            ang = src.targets[i] if angles else 0.0
            f.write(f"{fname},0,{lat},{lon},{ang},1\n")
    return path


def par_step_times(trainer, source) -> dict:
    """ms a step on the first batch (host clock over PAR_STEP_TIMES
    synchronised steps, after one more); under a mesh the same step
    without it in turns (mesh, none, none, mesh: medians of each), and one
    all-reduce of a flat f32 buffer the size of the trained parameters
    (CUDA events over 10, after 3)."""
    import torch.distributed as dist

    from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
    from geovpr_torch.data.transforms import build_augment
    from geovpr_torch.train.steps import make_train_step
    mesh = trainer.mesh
    batch = next(prefetch_to_device(iterate_batches(
        source, trainer.data_cfg.batch_size), trainer.device, mesh=mesh))

    def ms(step):
        step(trainer.state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_STEP_TIMES):
            step(trainer.state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / PAR_STEP_TIMES * 1e3

    if mesh is None:
        return {"ms_per_step": ms(trainer._train_step)}
    aug = trainer.data_cfg.augment
    plain = make_train_step(
        trainer.objective, normalize_fn=trainer._normalize,
        augment_fn=build_augment(aug) if aug != "none" else None,
        skip_nonfinite=trainer.train_cfg.skip_nonfinite_updates)
    turns = [("mesh", trainer._train_step), ("none", plain),
             ("none", plain), ("mesh", trainer._train_step)]
    got = {"mesh": [], "none": []}
    for name, step in turns:
        got[name].append(ms(step))
    out = {"ms_per_step": float(np.median(got["mesh"])),
           "ms_per_step_same_process_no_mesh": float(np.median(got["none"])),
           "turns_ms": got}
    n = sum(p.numel() for name, p in trainer.state.params.items()
            if trainer.state.opt.trains(name))
    flat = torch.zeros(n, device=trainer.device)
    for _ in range(3):
        dist.all_reduce(flat, group=mesh.group("data"))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        dist.all_reduce(flat, group=mesh.group("data"))
    end.record()
    torch.cuda.synchronize()
    out.update(grad_values=n, grad_allreduce_ms=start.elapsed_time(end) / 10)
    return out


def par_cli_job(job: dict) -> dict:
    """One CLI run (`cli.train.main` or `cli.retrieve.main` on `argv`),
    every launch count set to 0 just before it and read just after (for
    training: as `run_train` returns, before the step times that follow
    it while the process group is still up)."""
    import geovpr_torch.cli.train as cli_train
    from geovpr_torch.cli.retrieve import main as retrieve_main

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    rec = {}
    if job["cli"] == "retrieve":
        retrieve_main(job["argv"])
        torch.cuda.synchronize()
        rec["launches"] = {k: fn.launches for k, fn in counters.items()}
        return rec
    orig = cli_train.run_train

    def run_train(cfg, train_source, val_source=None, **kw):
        trainer = orig(cfg, train_source, val_source, **kw)
        torch.cuda.synchronize()
        rec.update(launches={k: fn.launches for k, fn in counters.items()},
                   step_losses=trainer.step_losses, run_dir=trainer.run_dir,
                   history=[{k: v for k, v in r.items() if k != "seconds"}
                            for r in trainer.history])
        rec.update(par_step_times(trainer, train_source))
        return trainer

    cli_train.run_train = run_train
    try:
        cli_train.main(job["argv"])
    finally:
        cli_train.run_train = orig
    return rec


def parallel_child(spec_path: str) -> int:
    """A child process of the [parallel] phase: every job of the spec
    through `par_cli_job`, one JSON line of results."""
    from geovpr_torch.ops._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    with open(spec_path) as f:
        spec = json.load(f)
    print("[parallel_child] " + json.dumps(
        [par_cli_job(job) for job in spec["jobs"]]), flush=True)
    return 0


def par_run_child(args: list, tag: str, timeout: float = 900.0) -> list:
    """Run this script as a child with `args`; its `[parallel_child]`
    lines, parsed. A failed child fails the phase."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"{tag}: child exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("[parallel_child] ")]


def _state_files(run_dir: str) -> dict:
    out = {}
    for d in sorted(os.listdir(run_dir)):
        path = os.path.join(run_dir, d, "state.pt")
        if os.path.isfile(path):
            out[d] = torch.load(path, map_location="cpu", weights_only=True)
    return out


def _tensors_equal(a, b, where: str, differ: list) -> int:
    """Compare two checkpoint trees leaf by leaf; returns the tensors
    compared, appending the names that differ."""
    if isinstance(a, dict):
        if set(a) != set(b):
            differ.append(f"{where}: keys")
            return 0
        return sum(_tensors_equal(a[k], b[k], f"{where}.{k}", differ)
                   for k in a)
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            differ.append(where)
        return 1
    if a != b:
        differ.append(where)
    return 0


def parallel_world1(device, card: str, root: str) -> dict:
    """(a): each CLI once in a child over a one-rank NCCL mesh, then the
    same CLI here without a mesh; the launches, losses, checkpoints
    (parameters, moments, BatchNorm statistics) and matches must be equal
    bit for bit. Returns the launch counts of both runs, summed."""
    rng = np.random.default_rng(SEED + 17)
    jobs, expected = [], []
    for preset, b, size, n_train, n_val, epochs in PAR_TRAIN_CASES:
        angles = "efficientnet" in preset
        d = os.path.join(root, preset)
        os.makedirs(d)
        train_csv = par_images(d, "train", n_train, size, rng, angles)
        val_csv = par_images(d, "val", n_val, size, rng, angles)
        argv = ["--preset", preset, "--train-csv", train_csv,
                "--val-csv", val_csv, "--image-root", os.path.join(d, "img"),
                "--epochs", str(epochs), "--batch-size", str(b),
                "--device", device.type]
        jobs.append({"cli": "train", "tag": preset, "argv": argv,
                     "save": os.path.join(d, "runs")})
        steps, vals = epochs * (n_train // b), epochs * -(-n_val // b)
        per = ({"fused_swin_attn_train_fwd": SWIN_BLOCKS * steps,
                "fused_swin_attn_bwd_all": TRAIN_K9C_BLOCKS * steps,
                "fused_swin_attn_bwd_core": TRAIN_K9B_BLOCKS * steps,
                "fused_swin_attn_block": SWIN_BLOCKS * vals,
                "fused_patch_merge": SWIN_BOUNDARIES * vals}
               if preset.startswith("swin") else {})
        expected.append((steps, per))
    n_gal, n_q, rb = PAR_RETRIEVE
    d = os.path.join(root, "retrieve")
    os.makedirs(d)
    g_csv = par_images(d, "gallery", n_gal, IMAGE_SIZE, rng)
    q_csv = par_images(d, "query", n_q, IMAGE_SIZE, rng)
    jobs.append({"cli": "retrieve", "tag": "retrieve-int8", "argv": [
        "--gallery-csv", g_csv, "--query-csv", q_csv, "--image-root",
        os.path.join(d, "img"), "--int8", "--batch-size", str(rb),
        "--top-k", str(TOP_K), "--variant", VARIANT, "--image-size",
        str(IMAGE_SIZE), "--device", device.type], "save": d})
    batches = -(-n_gal // rb) + -(-n_q // rb)
    expected.append((0, {"fused_mhsa_block_int8": DINO_BLOCKS * batches,
                         "fused_mlp_block_int8": DINO_BLOCKS * batches}))

    def argv_for(job, mesh: bool):
        out_flag = "--out-dir" if job["cli"] == "retrieve" else "--save-dir"
        argv = job["argv"] + [out_flag, os.path.join(
            job["save"], "mesh" if mesh else "single")]
        if mesh:
            argv += ["--multihost", "--coordinator",
                     f"127.0.0.1:{free_port()}", "--num-processes", "1",
                     "--process-id", "0"]
        return argv

    spec = os.path.join(root, "world1.json")
    with open(spec, "w") as f:
        json.dump({"jobs": [dict(j, argv=argv_for(j, True)) for j in jobs]},
                  f)
    t0 = time.perf_counter()
    mesh_recs = par_run_child(["--parallel-child", spec], "parallel-world1")
    check(len(mesh_recs) == 1, f"child printed {len(mesh_recs)} records")
    mesh_recs = mesh_recs[0]
    child_s = time.perf_counter() - t0
    totals = {}
    for job, got, (steps, per) in zip(jobs, mesh_recs, expected):
        # through JSON as the child's record came (epoch keys as strings)
        want = json.loads(json.dumps(par_cli_job(dict(
            job, argv=argv_for(job, False)))))
        tag = job["tag"]
        exp = dict.fromkeys(got["launches"], 0)
        exp.update(per)
        for name, rec in (("nccl-world1", got), ("no-mesh", want)):
            phase("parallel", world=1, backend="nccl" if name !=
                  "no-mesh" else "none", path=tag, run=name,
                  launches=rec["launches"], expected_launches=exp,
                  per_step={k: v / steps for k, v in rec["launches"].items()
                            if v and steps})
            check(rec["launches"] == exp,
                  f"{tag} {name}: launches {rec['launches']}, expected {exp}")
        for k in exp:
            totals[k] = totals.get(k, 0) + got["launches"][k] + \
                want["launches"][k]
        if job["cli"] == "retrieve":
            a, b = (read_csv(os.path.join(job["save"], m,
                                          "retrieval_matches.csv"))
                    for m in ("mesh", "single"))
            phase("parallel_retrieve", world=1, path=tag, rows=len(a),
                  equal=a == b)
            check(len(a) == n_q * TOP_K and a == b,
                  f"{tag}: the sharded search's matches differ")
            continue
        differ = []
        files_a, files_b = (_state_files(r["run_dir"]) for r in (got, want))
        n = _tensors_equal(files_a, files_b, "checkpoints", differ)
        stats = sum(k.endswith(("running_mean", "running_var"))
                    for k in files_a["best"]["params"])
        equal = (got["step_losses"] == want["step_losses"]
                 and got["history"] == want["history"] and not differ)
        phase("parallel_train", world=1, backend="nccl", path=tag,
              card=repr(card), checkpoints=sorted(files_a),
              tensors_compared=n, running_stats=stats,
              step_losses=got["step_losses"], equal=equal,
              differ=differ[:5])
        check(equal and n > 0, f"{tag}: the NCCL world-1 run differs from "
              f"the run without a mesh: {differ[:5]}")
        phase("parallel_times", world=1, backend="nccl", path=tag,
              card=repr(card), ms_per_step_mesh=got["ms_per_step"],
              ms_per_step_no_mesh=got["ms_per_step_same_process_no_mesh"],
              overhead_ms=got["ms_per_step"]
              - got["ms_per_step_same_process_no_mesh"],
              turns_ms=got["turns_ms"],
              ms_per_step_no_mesh_run=want["ms_per_step"],
              grad_values=got["grad_values"],
              grad_allreduce_ms=got["grad_allreduce_ms"])
    phase("parallel_world1_seconds", child=child_s,
          total=time.perf_counter() - t0)
    return totals


def _gloo_cfg():
    from geovpr_torch.cli.presets import build_preset
    return build_preset(PAR_GLOO_CASE[0])


def _gloo_batches():
    """The global batches of (b): synthetic images and (lat, lon)."""
    _, b, size, steps = PAR_GLOO_CASE
    src = synthetic_val(b * steps, size, np.random.default_rng(SEED + 23))
    return [{"image": src.images[i * b:(i + 1) * b],
             "target": src.targets[i * b:(i + 1) * b],
             "mask": np.ones(b, bool)} for i in range(steps)]


def _gloo_search_data():
    n, q, _ = PAR_GLOO_SEARCH
    rng = np.random.default_rng(SEED + 29)
    g = rng.normal(size=(n, 8448)).astype(np.float32)
    qs = g[rng.integers(0, n, q)] + 0.5 * rng.normal(size=(q, 8448))
    return (g / np.linalg.norm(g, axis=1, keepdims=True),
            (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(
                np.float32))


def _gloo_state(device):
    """The preset's model (bf16 compute, f32 parameters) from seed SEED,
    its vectors perturbed off their init (`perturb_cnn_`: a bias at zero
    is all update, and Adam's first steps turn a roundoff gradient into
    +-lr of either sign), on `device`, with its scaler at the campus's
    scale."""
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import scaler_from_arrays
    from geovpr_torch.train.state import create_train_state

    cfg = _gloo_cfg()
    model = RegressionModel(
        dataclasses.replace(cfg.model, image_size=PAR_GLOO_CASE[2]),
        dtype=getattr(torch, cfg.model.compute_dtype), train=True).to(device)
    state = create_train_state(
        model, cfg.optim, SEED, scaler_from_arrays([219000.0, 143000.0],
                                                   [300.0, 100.0]))
    with torch.no_grad():
        perturb_cnn_(state.model, torch.Generator().manual_seed(SEED))
    return cfg, state


def _gloo_steps(device, mesh) -> tuple:
    """Two steps of (b) on this rank's rows of each global batch (all of
    them without a mesh); (losses, state, launches, host ms a step)."""
    from geovpr_torch.cli.presets import objective_for
    from geovpr_torch.data.pipeline import prefetch_to_device
    from geovpr_torch.data.transforms import build_augment
    from geovpr_torch.train.steps import make_train_step

    cfg, state = _gloo_state(device)
    step = make_train_step(objective_for(cfg),
                           augment_fn=build_augment(cfg.data.augment),
                           mesh=mesh)
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, ms = [], []
    for batch in prefetch_to_device(iter(_gloo_batches()), device, mesh=mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, state, {k: fn.launches for k, fn in
                           counters.items() if fn.launches}, ms


def parallel_gloo_rank(rank: int, spec_path: str) -> int:
    """One rank of (b): world 2 over gloo on cuda:0, against the world-1
    reference this script saved at `spec`'s path."""
    from geovpr_torch.ops._build import load_library
    from geovpr_torch.parallel import create_mesh, initialize_distributed
    from geovpr_torch.retrieval.index import DescriptorIndex

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    with open(spec_path) as f:
        spec = json.load(f)
    device = initialize_distributed(spec["rdzv"], 2, rank,
                                    device=spec["device"], backend="gloo")
    mesh = create_mesh()
    losses, state, launches, ms = _gloo_steps(device, mesh)
    ref = torch.load(spec["ref"], map_location=device, weights_only=True)
    cos, key_bias = {}, 0.0
    for k, v in state.model.state_dict().items():
        if not (v.is_floating_point() and v.numel() > 1):
            continue
        a, b = v.double().flatten(), ref["params"][k].double().flatten()
        if k.endswith("attn.qkv_bias"):
            # the key bias: its gradient is roundoff (a constant added to
            # a softmax row), which Adam scales to about +-lr a step of
            # either sign; bounded, not compared by cosine
            c = a.numel() // 3
            key_bias = max(key_bias, float((a[c:2 * c] - b[c:2 * c])
                                           .abs().max()))
            a, b = torch.cat([a[:c], a[2 * c:]]), torch.cat([b[:c],
                                                             b[2 * c:]])
        cos[k] = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))
    worst = min(cos, key=cos.get)
    g, q = _gloo_search_data()
    index = DescriptorIndex(dim=g.shape[1], device=device, quantize=True,
                            mesh=mesh).build(g)
    _, idx = index.search(q, k=PAR_GLOO_SEARCH[2])
    checksum = float(sum(v.double().sum() for v in
                         state.model.state_dict().values()
                         if v.is_floating_point()))
    print("[parallel_child] " + json.dumps({
        "rank": rank, "losses": losses, "ref_losses": ref["losses"],
        "min_cosine": cos[worst], "worst": worst, "tensors": len(cos),
        "key_bias_max_diff": key_bias,
        "key_bias_bound": 2 * 1.03 * PAR_GLOO_CASE[3] * state.opt.cfg.lr,
        "launches": launches, "ms_per_step": ms, "checksum": checksum,
        "search_equal": bool(torch.equal(idx.cpu(), ref["indices"].cpu()))}),
        flush=True)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_gloo(device, card: str, root: str) -> dict:
    """(b): the world-1 reference here (no mesh), then two ranks over gloo
    on this card, each its rows of the same global batches; every
    parameter's cosine to the reference >= PAR_MIN_COSINE, the losses
    within PAR_LOSS_RTOL, the ranks equal, the sharded int8 search's
    indices the unsharded search's. Returns the ranks' launch counts,
    summed."""
    from geovpr_torch.retrieval.index import DescriptorIndex

    losses, state, launches, ms = _gloo_steps(device, None)
    g, q = _gloo_search_data()
    _, idx = DescriptorIndex(dim=g.shape[1], device=device,
                             quantize=True).build(g).search(
        q, k=PAR_GLOO_SEARCH[2])
    ref_path = os.path.join(root, "gloo_ref.pt")
    torch.save({"params": {k: v.cpu() for k, v in
                           state.model.state_dict().items()},
                "losses": losses, "indices": idx.cpu()}, ref_path)
    del state
    torch.cuda.empty_cache()
    spec = os.path.join(root, "gloo.json")
    with open(spec, "w") as f:
        json.dump({"rdzv": f"file://{os.path.join(root, 'gloo_rdzv')}",
                   "ref": ref_path, "device": device.type}, f)
    t0 = time.perf_counter()
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--parallel-gloo", str(r), spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(here)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}:\n"
              f"{out[-2000:]}\n{err[-3000:]}")
        recs += [json.loads(line.split(" ", 1)[1]) for line in
                 out.splitlines() if line.startswith("[parallel_child] ")]
    check(len(recs) == 2, f"{len(recs)} gloo rank records")
    steps, b = PAR_GLOO_CASE[3], PAR_GLOO_CASE[1]
    exp = {"fused_mhsa_train_fwd": DINO_BLOCKS * steps,
           "fused_mhsa_bwd_all": DINO_BLOCKS * steps}
    for rec in recs:
        rel = max(abs(a - w) / max(abs(w), 1e-12)
                  for a, w in zip(rec["losses"], rec["ref_losses"]))
        phase("parallel_gloo", world=2, backend="gloo (host-staged)",
              rank=rec["rank"], card=repr(card), batch=b,
              rank_rows=b // 2, losses=rec["losses"],
              world1_losses=rec["ref_losses"], loss_max_rel_diff=rel,
              loss_bound=PAR_LOSS_RTOL, min_param_cosine=rec["min_cosine"],
              worst_tensor=rec["worst"], tensors=rec["tensors"],
              cosine_bound=PAR_MIN_COSINE,
              key_bias_max_diff=rec["key_bias_max_diff"],
              key_bias_bound=rec["key_bias_bound"], launches=rec["launches"],
              expected_launches=exp, search_equal=rec["search_equal"],
              host_staged_ms_per_step=rec["ms_per_step"],
              world1_ms_per_step=ms)
        check(rel <= PAR_LOSS_RTOL, f"gloo rank {rec['rank']}: loss off "
              f"by {rel}")
        check(rec["min_cosine"] >= PAR_MIN_COSINE,
              f"gloo rank {rec['rank']}: {rec['worst']} cosine "
              f"{rec['min_cosine']}")
        check(rec["key_bias_max_diff"] <= rec["key_bias_bound"],
              f"gloo rank {rec['rank']}: key bias off by "
              f"{rec['key_bias_max_diff']}")
        check(rec["launches"] == exp, f"gloo rank {rec['rank']}: launches "
              f"{rec['launches']}, expected {exp}")
        check(rec["search_equal"], "the 2-shard int8 search differs")
    check(recs[0]["checksum"] == recs[1]["checksum"],
          "the two ranks' parameters differ")
    phase("parallel_gloo_seconds", ranks=time.perf_counter() - t0)
    total = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def parallel_path(device, card: str) -> dict:
    """The [parallel] phase: (a) then (b). Returns the launch counts of
    every run in it (children's included)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        totals = parallel_world1(device, card, root)
        for k, v in parallel_gloo(device, card, root).items():
            totals[k] = totals.get(k, 0) + v
    phase("parallel_seconds", s=time.perf_counter() - t0)
    return totals


# convert and parity (`convert_parity_path`): seeded reference-layout
# checkpoints of the parity legs at full width (Swin-B-384 at 384 px,
# DINOv2-B/14 + SALAD at 224 px from the hub's 518-px position grid,
# EfficientNet-B0 at 224 px), `cli.convert` and `cli.parity` run as
# children. CP_N_VAL images: two Swin batches of 16, one DINOv2 + SALAD
# and one EfficientNet batch of 32; `cli.train --pretrained` takes one
# epoch of CP_TRAIN_STEPS steps of CP_TRAIN_BATCH.
CP_N_VAL, CP_N_SALAD, CP_HUB_GRID = 32, 8, 37
CP_TRAIN_BATCH, CP_TRAIN_STEPS = 4, 2
CP_RECIPES = ("swin_geopose", "dinov2salad_geopose", "efficientnet_sincos")


def export_swin_hf(sd: dict, depths) -> dict:
    """The port's SwinTransformer state_dict -> HF `SwinModel` keys, the
    converse of `convert_swin_hf` and the bridge: q, k and v cut out of
    the fused (C, 3C) qkv, (in, out) weights transposed to torch's."""
    out = {"embeddings.patch_embeddings.projection.weight":
           sd["patch_embed.weight"],
           "embeddings.patch_embeddings.projection.bias": sd["patch_embed.bias"],
           "embeddings.norm.weight": sd["embed_norm.weight"],
           "embeddings.norm.bias": sd["embed_norm.bias"],
           "layernorm.weight": sd["norm.weight"],
           "layernorm.bias": sd["norm.bias"]}
    for s, depth in enumerate(depths):
        for b in range(depth):
            t, f = f"encoder.layers.{s}.blocks.{b}", f"stage{s}_block{b}"
            w, bias = sd[f"{f}.attn.qkv_weight"], sd[f"{f}.attn.qkv_bias"]
            c = w.shape[0]
            for j, name in enumerate(("query", "key", "value")):
                out[f"{t}.attention.self.{name}.weight"] = \
                    w[:, j * c:(j + 1) * c].t()
                out[f"{t}.attention.self.{name}.bias"] = \
                    bias[j * c:(j + 1) * c]
            out[f"{t}.attention.self.relative_position_bias_table"] = \
                sd[f"{f}.attn.relative_position_bias_table"]
            out[f"{t}.attention.output.dense.weight"] = \
                sd[f"{f}.attn.proj_weight"].t()
            out[f"{t}.attention.output.dense.bias"] = sd[f"{f}.attn.proj_bias"]
            for hf, port in (("layernorm_before", "norm1"),
                             ("layernorm_after", "norm2"),
                             ("intermediate.dense", "mlp.fc1"),
                             ("output.dense", "mlp.fc2")):
                for leaf in ("weight", "bias"):
                    out[f"{t}.{hf}.{leaf}"] = sd[f"{f}.{port}.{leaf}"]
        if s < len(depths) - 1:
            t, f = f"encoder.layers.{s}.downsample", f"stage{s}_downsample"
            out[f"{t}.norm.weight"] = sd[f"{f}.norm.weight"]
            out[f"{t}.norm.bias"] = sd[f"{f}.norm.bias"]
            out[f"{t}.reduction.weight"] = sd[f"{f}.reduction_weight"].t()
    return out


def export_dinov2_hub(sd: dict, num_layers: int, pos_embed) -> dict:
    """The port's DinoV2 state_dict -> the facebookresearch ViT keys of the
    hub SALAD backbone (fused (3D, D) qkv, `blocks.N.*`), shipping
    `pos_embed` as its position table."""
    out = {"cls_token": sd["cls_token"], "pos_embed": pos_embed,
           "patch_embed.proj.weight": sd["patch_embed.weight"],
           "patch_embed.proj.bias": sd["patch_embed.bias"],
           "norm.weight": sd["norm.weight"], "norm.bias": sd["norm.bias"]}
    for i in range(num_layers):
        t = f"blocks.{i}"
        out[f"{t}.attn.qkv.weight"] = sd[f"{t}.attn.qkv_weight"].t()
        out[f"{t}.attn.qkv.bias"] = sd[f"{t}.attn.qkv_bias"]
        out[f"{t}.attn.proj.weight"] = sd[f"{t}.attn.proj_weight"].t()
        out[f"{t}.attn.proj.bias"] = sd[f"{t}.attn.proj_bias"]
        for name in ("norm1.weight", "norm1.bias", "norm2.weight",
                     "norm2.bias", "ls1.gamma", "ls2.gamma", "mlp.fc1.weight",
                     "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"):
            out[f"{t}.{name}"] = sd[f"{t}.{name}"]
    return out


def export_salad_hub(sd: dict, num_layers: int, pos_embed) -> dict:
    """The port's DinoV2Salad state_dict -> the serizba/salad hub VPRModel
    keys: `backbone.model.*` (`export_dinov2_hub`) and `aggregator.*`, the
    SALAD MLPs on tokens as 1x1 convs, on the global token as Linears."""
    bb = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    out = {f"backbone.model.{k}": v for k, v in
           export_dinov2_hub(bb, num_layers, pos_embed).items()}
    for hub, port, conv in (("cluster_features.0", "feat_fc1", True),
                            ("cluster_features.2", "feat_fc2", True),
                            ("score.0", "score_fc1", True),
                            ("score.2", "score_fc2", True),
                            ("token_features.0", "token_fc1", False),
                            ("token_features.2", "token_fc2", False)):
        w = sd[f"salad.{port}.weight"]
        out[f"aggregator.{hub}.weight"] = w[:, :, None, None] if conv else w
        out[f"aggregator.{hub}.bias"] = sd[f"salad.{port}.bias"]
    out["aggregator.dust_bin"] = sd["salad.dustbin"]
    return out


def export_efficientnet_tv(sd: dict) -> dict:
    """The port's EfficientNetB0 state_dict -> torchvision's
    `efficientnet_b0().features` keys (Conv2dNormActivation: conv at .0,
    BatchNorm at .1)."""
    from geovpr_torch.models.efficientnet import B0_STAGES

    out = {}

    def conv_bn(t, f):
        out[f"{t}.0.weight"] = sd[f"{f}.conv.weight"]
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{t}.1.{leaf}"] = sd[f"{f}.bn.{leaf}"]

    conv_bn("features.0", "stem")
    for s, spec in enumerate(B0_STAGES):
        for i in range(spec.layers):
            t, f = f"features.{s + 1}.{i}.block", f"stage{s}_block{i}"
            idx = 0
            if spec.expand_ratio != 1:
                conv_bn(f"{t}.{idx}", f"{f}.expand")
                idx += 1
            conv_bn(f"{t}.{idx}", f"{f}.dw")
            for fc in ("fc1", "fc2"):
                for leaf in ("weight", "bias"):
                    out[f"{t}.{idx + 1}.{fc}.{leaf}"] = \
                        sd[f"{f}.se.{fc}.{leaf}"]
            conv_bn(f"{t}.{idx + 2}", f"{f}.project")
    conv_bn("features.8", "head")
    return out


def _linear_keys(sd: dict, port: str, ref: str) -> dict:
    return {f"{ref}.weight": sd[f"{port}.weight"],
            f"{ref}.bias": sd[f"{port}.bias"]}


def export_reference(recipe: str, sd: dict, hub_pos_embed=None) -> dict:
    """A `RegressionModel` state_dict -> the reference's trained-checkpoint
    layout of `recipe` (`models/convert_reference.py`'s three), each
    tensor a contiguous copy."""
    bb = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    if recipe == "swin_geopose":
        blocks = [k.split(".")[0][len("stage"):].split("_block")
                  for k in bb if "_block" in k.split(".")[0]]
        depths = [1 + max(int(b) for s, b in blocks if int(s) == stage)
                  for stage in range(1 + max(int(s) for s, _ in blocks))]
        out = {f"backbone.{k}": v
               for k, v in export_swin_hf(bb, depths).items()}
        out.update(_linear_keys(sd, "head.hidden0", "regressor.0"))
        out.update(_linear_keys(sd, "head.out", "regressor.3"))
    elif recipe == "dinov2salad_geopose":
        layers = 1 + max(int(k.split(".")[2]) for k in bb
                         if k.startswith("backbone.blocks."))
        out = {f"feature_extractor.{k}": v for k, v in
               export_salad_hub(bb, layers, hub_pos_embed).items()}
        out.update(_linear_keys(sd, "head.hidden0", "regressor.0"))
        out.update(_linear_keys(sd, "head.out", "regressor.2"))
    else:
        out = {f"backbone.{k}": v
               for k, v in export_efficientnet_tv(bb).items()}
        out.update(_linear_keys(sd, "head.out", "backbone.classifier.1"))
    return {k: v.contiguous().clone() for k, v in out.items()}


def cp_model(recipe: str):
    """The recipe's preset model as training builds it (f32 parameters),
    from seed SEED, its vectors (and the Swin tables) perturbed off their
    init, on the host."""
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.convert_reference import RECIPE_PRESETS
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel

    cfg = build_preset(RECIPE_PRESETS[recipe])
    model = RegressionModel(dataclasses.replace(
        cfg.model, image_size=cfg.data.image_size),
        dtype=getattr(torch, cfg.model.compute_dtype), train=True)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 31)
    with torch.no_grad():
        (perturb_swin_ if recipe == "swin_geopose" else perturb_cnn_)(
            model, gen)
    return model


def cp_write_assets(root: str, rng) -> dict:
    """The parity assets directory: labels_val.csv (campus-scale (lat,
    lon), headings in [0, 360)) and JPEGs under images/; each recipe's
    reference checkpoint (the Swin one in the `model_state_dict` wrapper)
    with an .npz scaler for the geopose legs; salad/dino_salad.ckpt; the
    Swin backbone alone as HF `SwinModel` keys. Returns the models they
    were exported from and the files' paths."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    size = max(cp_preset_fields("image_size").values())
    src = synthetic_val(CP_N_VAL, size, rng)
    angles = rng.uniform(0.0, 360.0, CP_N_VAL)
    with open(os.path.join(root, "labels_val.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(CP_N_VAL):
            name = f"val_{i:04d}.jpg"
            Image.fromarray(src.images[i]).save(os.path.join(img_dir, name),
                                                quality=95)
            f.write(f"{name},0,{src.targets[i, 0]},{src.targets[i, 1]},"
                    f"{angles[i]},1\n")
    models, paths = {}, {}
    gen = torch.Generator().manual_seed(SEED + 37)
    for recipe in CP_RECIPES:
        model = cp_model(recipe)
        sd = model.state_dict()
        d = os.path.join(root, recipe)
        os.makedirs(d)
        pos = None
        if recipe == "dinov2salad_geopose":
            dim = sd["backbone.backbone.cls_token"].shape[-1]
            pos = torch.randn(1, 1 + CP_HUB_GRID ** 2, dim,
                              generator=gen) * 0.02
            hub = {k[len("backbone."):]: v for k, v in sd.items()
                   if k.startswith("backbone.")}
            os.makedirs(os.path.join(root, "salad"))
            torch.save({k: v.contiguous().clone() for k, v in
                        export_salad_hub(hub, len(model.backbone.backbone
                                                  .blocks), pos).items()},
                       os.path.join(root, "salad", "dino_salad.ckpt"))
        ckpt = export_reference(recipe, sd, pos)
        paths[recipe] = os.path.join(d, "model_best.pth")
        torch.save({"epoch": 49, "model_state_dict": ckpt}
                   if recipe == "swin_geopose" else ckpt, paths[recipe])
        if recipe != "efficientnet_sincos":
            np.savez(os.path.join(d, "latlon_scaler.npz"),
                     mean=np.float32([219000.0, 143000.0]),
                     scale=np.float32([300.0, 100.0]))
        if recipe == "swin_geopose":
            paths["swin_backbone"] = os.path.join(root, "swin_base_384.pth")
            torch.save({k[len("backbone."):]: v for k, v in ckpt.items()
                        if k.startswith("backbone.")}, paths["swin_backbone"])
        models[recipe] = model
    return {"models": models, "paths": paths}


def cp_preset_fields(field: str) -> dict:
    """recipe -> its preset's `data.<field>` (image size, batch size)."""
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.convert_reference import RECIPE_PRESETS
    return {r: getattr(build_preset(RECIPE_PRESETS[r]).data, field)
            for r in CP_RECIPES}


def cp_roundtrip(assets: dict) -> None:
    """Each exported checkpoint through `convert_reference_checkpoint` and
    the bridge: bit-equal to the model it came from, but the hub's
    position table, resized from its grid."""
    from geovpr_torch.cli.convert import load_state_dict
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.convert_reference import \
        convert_reference_checkpoint

    legs = cp_legs()
    for recipe, model in assets["models"].items():
        got = state_dict_from_flax(convert_reference_checkpoint(
            recipe, load_state_dict(assets["paths"][recipe]),
            **legs[recipe].get("convert_overrides", {})))
        want = model.state_dict()
        resized = "backbone.backbone.pos_embed"
        differ = [k for k in want if k != resized and not (
            k in got and torch.equal(got[k], want[k]))]
        phase("convert_roundtrip", recipe=recipe, tensors=len(want),
              unknown=sorted(set(got) - set(want))[:5], differ=differ[:5],
              resized_pos_embed=resized in want)
        check(set(got) == set(want) and not differ,
              f"{recipe}: the exported checkpoint converts to other tensors "
              f"({differ[:5]})")
        if resized in want:
            check(got[resized].shape == want[resized].shape,
                  f"{recipe}: pos_embed {tuple(got[resized].shape)}")


def cp_overrides() -> dict:
    """parity_config.json's entries but the goldens: the .npz scalers, and
    the SALAD grid converted for the preset's image size (224 px: the
    default)."""
    size = cp_preset_fields("image_size")["dinov2salad_geopose"]
    return {"swin_geopose": {"scaler": "latlon_scaler.npz"},
            "dinov2salad_geopose": {"scaler": "latlon_scaler.npz",
                                    "convert_overrides": {"image_size": size}},
            "efficientnet_sincos": {}}


def cp_legs() -> dict:
    """The model legs as `cli.parity` merges DEFAULT_LEGS and
    parity_config.json, goldens aside."""
    from geovpr_torch.cli.parity import DEFAULT_LEGS
    return {k: {**DEFAULT_LEGS[k], **v} for k, v in cp_overrides().items()}


def cp_plain_goldens(root: str, device) -> dict:
    """Each model leg through `cli.parity`'s own leg code in this process,
    every model's blocks on the plain path (`use_kernels=False`; no
    kernel may launch): its metrics are the golden numbers, its CSV the
    plain predictions. Then the descriptor dump of the salad leg: the hub
    checkpoint converted as the leg converts it, served in bf16 through K1
    (the leg itself runs f32 torch ops)."""
    from geovpr_torch.cli import parity
    from geovpr_torch.cli.convert import load_state_dict
    from geovpr_torch.models import convert_torch as ct
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.salad import DinoV2Salad

    legs = cp_legs()
    orig = parity._build_trainer
    counters = train_counters()

    def plain_build(*a, **kw):
        trainer, cfg, data_cfg = orig(*a, **kw)
        for m in trainer.state.model.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = False
        return trainer, cfg, data_cfg

    out = {}
    parity._build_trainer = plain_build
    try:
        for name in CP_RECIPES:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = parity._run_model_leg(name, legs[name], root,
                                        os.path.join(root, "plain"), 2.0, 0,
                                        device)
            torch.cuda.synchronize()
            launched = {k: fn.launches for k, fn in counters.items()
                        if fn.launches}
            check(not launched, f"{name}: the plain path launched {launched}")
            out[name] = dict(res, seconds=time.perf_counter() - t0)
            torch.cuda.empty_cache()
    finally:
        parity._build_trainer = orig

    sd = load_state_dict(os.path.join(root, "salad", "dino_salad.ckpt"))
    size = cp_preset_fields("image_size")["dinov2salad_geopose"]
    model = DinoV2Salad(variant="base-14", image_size=size,
                        dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_flax(ct.convert_salad_hub(
        sd, num_layers=len(model.backbone.blocks), target_grid=size // 14)))
    model.to(device).eval()
    from geovpr_torch.data.transforms import normalize
    images = np.random.default_rng(SEED + 41).integers(
        0, 256, (CP_N_SALAD, size, size, 3), dtype=np.uint8)
    with torch.inference_mode():
        desc = model(normalize(torch.from_numpy(images).to(device))).pooled
    np.savez(os.path.join(root, "salad", "reference_descriptors.npz"),
             images=images, descriptors=desc.float().cpu().numpy())
    del model
    torch.cuda.empty_cache()
    return out


def cp_child(spec_path: str) -> int:
    """A child process of the [convert_parity] phase: each job is one CLI's
    `main(argv)` (`geovpr_torch.cli.<cli>`), every launch count set to 0
    just before it and read just after; one JSON line of results."""
    import importlib

    from geovpr_torch.ops._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    with open(spec_path) as f:
        spec = json.load(f)
    counters = train_counters()
    recs = []
    for job in spec["jobs"]:
        main_fn = importlib.import_module(f"geovpr_torch.cli.{job['cli']}").main
        for fn in counters.values():
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_fn(job["argv"])
        torch.cuda.synchronize()
        recs.append({"tag": job["tag"], "seconds": time.perf_counter() - t0,
                     "launches": {k: fn.launches for k, fn in
                                  counters.items() if fn.launches},
                     "last_line": out.getvalue().strip().splitlines()[-1]})
    print("[cp_child] " + json.dumps(recs), flush=True)
    return 0


def cp_run(args: list, tag: str, timeout: float = 900.0) -> str:
    """`python3 *args` from the repo's root, as a user launches it; its
    standard output. A failed child fails the phase."""
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"{tag} exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _csv_predictions(path: str, kind: str, scaler=None) -> np.ndarray:
    """A validation CSV's predictions as the head emits them: (lat, lon)
    through the scaler's transform, or each heading as (cos, sin)."""
    rows = read_csv(path)
    if kind == "angle":
        a = np.radians([float(r["predicted_angle"]) for r in rows])
        return np.stack([np.cos(a), np.sin(a)], 1)
    p = np.array([[float(r["predicted_latitude"]),
                   float(r["predicted_longitude"])] for r in rows])
    return (p - scaler[0]) / scaler[1]


def convert_parity_path(device, card: str) -> dict:
    """The [convert_parity] phase: export the seeded reference checkpoints
    and check they convert back bit-equal; `python -m
    geovpr_torch.cli.convert` on the Swin-B-384 backbone (the msgpack read
    back bit-equal); plain-path goldens here; then in a child
    `cli.train --pretrained` from that msgpack (one epoch of
    CP_TRAIN_STEPS steps) and `cli.parity` leg by leg, every leg passing,
    the kernel path's predictions against the plain path's. Returns the
    child's launch counts."""
    from geovpr_torch.cli.parity import DEFAULT_LEGS
    from geovpr_torch.cli.train import load_pretrained_backbone

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        assets = cp_write_assets(root, np.random.default_rng(SEED + 43))
        export_s = time.perf_counter() - t0
        cp_roundtrip(assets)

        msgpack = os.path.join(root, "swin_base_384.msgpack")
        t0 = time.perf_counter()
        report = json.loads(cp_run(
            ["-m", "geovpr_torch.cli.convert",
             assets["paths"]["swin_backbone"], msgpack, "--family", "swin",
             "--variant", "base-384"], "cli.convert").strip().splitlines()[-1])
        convert_s = time.perf_counter() - t0
        swin = assets["models"]["swin_geopose"]
        got = load_pretrained_backbone(msgpack)
        want = {f"backbone.{k}": v for k, v in
                swin.backbone.state_dict().items()}
        differ = [k for k in want
                  if not (k in got and torch.equal(got[k], want[k]))]
        phase("convert", family="swin", variant="base-384",
              arrays=report["arrays"], uncovered=report["uncovered"],
              bytes=os.path.getsize(msgpack), tensors=len(want),
              bit_equal=not differ and set(got) == set(want),
              seconds=convert_s, export_seconds=export_s)
        check(report["uncovered"] == [] and not differ
              and set(got) == set(want),
              f"cli.convert: the msgpack differs from the exported Swin "
              f"({differ[:5]}, uncovered {report['uncovered'][:5]})")
        del assets, swin, got, want

        goldens = cp_plain_goldens(root, device)
        legs_cfg = cp_overrides()
        for name, res in goldens.items():
            legs_cfg[name]["golden"] = {
                k: res["metrics"][k] for k in DEFAULT_LEGS[name]["golden"]}
        with open(os.path.join(root, "parity_config.json"), "w") as f:
            json.dump({"legs": legs_cfg}, f)

        with open(os.path.join(root, "labels_val.csv")) as f:
            lines = f.readlines()
        train_csv = os.path.join(root, "labels_train.csv")
        with open(train_csv, "w") as f:
            f.writelines(lines[:1 + CP_TRAIN_BATCH * CP_TRAIN_STEPS])
        jobs = [{"cli": "train", "tag": "train-pretrained", "argv": [
            "--preset", "swin_b384_gemini2", "--train-csv", train_csv,
            "--image-root", os.path.join(root, "images"), "--save-dir",
            os.path.join(root, "runs"), "--epochs", "1", "--batch-size",
            str(CP_TRAIN_BATCH), "--pretrained", msgpack, "--device",
            device.type]}]
        jobs += [{"cli": "parity", "tag": name, "argv": [
            "--assets", root, "--legs", name, "--device", device.type,
            "--out", os.path.join(root, f"report_{name}.json")]}
            for name in (*CP_RECIPES, "salad")]
        spec = os.path.join(root, "cp_jobs.json")
        with open(spec, "w") as f:
            json.dump({"jobs": jobs}, f)
        t0 = time.perf_counter()
        stdout = cp_run([os.path.abspath(__file__), "--convert-parity-child",
                         spec], "convert_parity child")
        child_s = time.perf_counter() - t0
        recs = {r["tag"]: r for line in stdout.splitlines()
                if line.startswith("[cp_child] ")
                for r in json.loads(line.split(" ", 1)[1])}
        check(set(recs) == {j["tag"] for j in jobs},
              f"convert_parity child records: {sorted(recs)}")

        train = recs["train-pretrained"]
        final = json.loads(train["last_line"])["final"]
        steps = CP_TRAIN_STEPS
        exp = {"fused_swin_attn_train_fwd": SWIN_BLOCKS * steps,
               "fused_swin_attn_bwd_all": TRAIN_K9C_BLOCKS * steps,
               "fused_swin_attn_bwd_core": TRAIN_K9B_BLOCKS * steps}
        phase("convert_parity_train", preset="swin_b384_gemini2",
              pretrained="cli.convert msgpack", batch=CP_TRAIN_BATCH,
              steps=steps, final=final, launches=train["launches"],
              expected_launches=exp, seconds=train["seconds"])
        check(train["launches"] == exp and np.isfinite(final["train_loss"]),
              f"train --pretrained: launches {train['launches']}, final "
              f"{final}")

        batches = {name: -(-CP_N_VAL // bs)
                   for name, bs in cp_preset_fields("batch_size").items()}
        per_batch = {"swin_geopose": {"fused_swin_attn_block": SWIN_BLOCKS,
                                      "fused_patch_merge": SWIN_BOUNDARIES},
                     "dinov2salad_geopose": {"fused_mhsa_block": DINO_BLOCKS},
                     "efficientnet_sincos": {}, "salad": {}}
        totals = dict(train["launches"])
        for name in (*CP_RECIPES, "salad"):
            rec = recs[name]
            with open(os.path.join(root, f"report_{name}.json")) as f:
                leg = json.load(f)["legs"][name]
            exp = {k: v * batches.get(name, 0)
                   for k, v in per_batch[name].items()}
            fields = dict(leg=name, status=leg["status"],
                          metrics=leg.get("metrics"),
                          verdicts=leg.get("verdicts"),
                          n_images=leg.get("n_images"),
                          launches=rec["launches"], expected_launches=exp,
                          seconds=rec["seconds"])
            ok = leg["status"] == "pass" and rec["launches"] == exp
            if name in goldens:
                kind = DEFAULT_LEGS[name]["kind"]
                scaler = ((np.float32([219000.0, 143000.0]),
                           np.float32([300.0, 100.0]))
                          if kind == "geopose" else None)
                a = _csv_predictions(leg["validation_csv"], kind, scaler)
                b = _csv_predictions(goldens[name]["validation_csv"], kind,
                                     scaler)
                cos = float((a * b).sum() / (np.linalg.norm(a)
                                             * np.linalg.norm(b)))
                fields.update(golden_seconds=goldens[name]["seconds"],
                              kernel_vs_plain_cosine=cos,
                              max_abs_diff=float(np.abs(a - b).max()),
                              bound=MIN_COSINE)
                ok &= cos >= MIN_COSINE and np.isfinite(a).all()
            phase("convert_parity", card=repr(card), **fields)
            check(ok, f"parity leg {name}: {fields}")
            for k, v in rec["launches"].items():
                totals[k] = totals.get(k, 0) + v
    phase("convert_parity_seconds", child=child_s,
          total=time.perf_counter() - t_phase)
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=repr(kind), count=torch.cuda.device_count(),
          nvidia_smi=repr(card), allow_tf32="False (matmul and cudnn)",
          torch=torch.__version__, cuda=torch.version.cuda)

    from geovpr_torch.cli.retrieve import build_model
    from geovpr_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library()
    phase("build", seconds=time.perf_counter() - t0)

    errs = kernel_vs_plain(device)
    errs8 = int8_kernels_vs_plain(device)

    gallery = synthetic_gallery(N_GALLERY, IMAGE_SIZE,
                                np.random.default_rng(SEED))
    images = torch.from_numpy(gallery.images[:BATCH]).to(device)

    model = build_model(VARIANT, IMAGE_SIZE, device, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        launches = slice_end_to_end(model, device, gallery, tmp)
    desc_bf16 = kernel_path_vs_plain_path(model, images)
    model_times(model, images, card, "bf16")
    breakdown(model, images, card, "bf16")
    del model

    model8 = build_model(VARIANT, IMAGE_SIZE, device, seed=SEED, int8=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches8 = slice_end_to_end(model8, device, gallery, tmp, int8=True)
    desc_int8 = kernel_path_vs_plain_path(model8, images, MIN_COSINE_INT8,
                                          "int8")
    cos = torch.nn.functional.cosine_similarity(desc_int8, desc_bf16, dim=1)
    phase("int8_vs_bf16", min_cosine=cos.min().item(),
          mean_cosine=cos.mean().item())
    model_times(model8, images, card, "int8")
    breakdown(model8, images, card, "int8")
    del model8
    kt = kernel_times(device, card)

    swin_errs = swin_kernels_vs_plain(device)
    swin_launches = swin_path(device, card)
    skt = swin_kernel_times(device, card)
    swin_part_times(device, card)

    k7_errs = k7_kernels_vs_plain(device)
    swin_kernels_vs_plain(device, attn_shapes=(),
                          merge_shapes=SWIN_T_MERGE_SHAPES)
    angle_launches = angle_path(device, card)
    k7t = k7_kernel_times(device, card)
    k7_half_times(device, card)

    fuse_launches = fuse_path(device, card)
    convnext_k3(device, card)

    k9_errs = k9_kernels_vs_plain(device)
    train_launches = train_path(device, card)
    k9t = k9_kernel_times(device, card)
    for shape in K9_SHAPES[1:]:
        t = k9_kernel_times(device, card, shape, ("K9a", "K9b") if
                            shape[1] > 512 else ("K9a", "K9b", "K9c"))
    # K9b runs at stage 3 (C = 1024) alone: its row reports that stage
    k9t["K9b"] = t["K9b"]
    k9c_part_times(device, card)
    k9a_part_times(device, card)

    k8_errs = k8_kernels_vs_plain(device)
    dino_launches = dinov2_train_path(device, card)
    k8t = k8_kernel_times(device, card)
    k8t["K8b"] = k8_kernel_times(device, card, K8_SHAPES[1], ("K8b",))["K8b"]
    k8c_part_times(device, card)

    rest_launches = {}
    for path in (dinov2_sincos_path, salad_frozen_path, swin_t_train_path,
                 cnn_train_path, parallel_path, convert_parity_path):
        for k, v in path(device, card).items():
            rest_launches[k] = rest_launches.get(k, 0) + v

    rows = []
    for name, k, src, replaces, count, err in (
            ("fused_mhsa_block", "K1", "geovpr_torch/csrc/mhsa.cu",
             "geovpr/ops/pallas_mhsa.py:904", launches["fused_mhsa_block"],
             errs[MAIN_SHAPE]),
            ("fused_mhsa_block_int8", "K2", "geovpr_torch/csrc/mhsa_int8.cu",
             "geovpr/ops/pallas_mhsa.py:554",
             launches8["fused_mhsa_block_int8"], errs8[("K2", MAIN_SHAPE)]),
            ("fused_mlp_block_int8", "K3", "geovpr_torch/csrc/mlp_int8.cu",
             "geovpr/ops/pallas_mlp.py:91",
             launches8["fused_mlp_block_int8"], errs8[("K3", MAIN_SHAPE)])):
        t = kt[k]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": count,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # K3 also serves the int8 Swin path: its launches there are added
    rows[2]["launches"] += swin_launches["int8"]["fused_mlp_block_int8"]
    for name, k, src, replaces, count, shape in (
            ("fused_swin_attn_block", "K4", "geovpr_torch/csrc/swin_attn.cu",
             "geovpr/ops/pallas_swin_block.py:1125",
             swin_launches["bf16"]["fused_swin_attn_block"], SWIN_MAIN),
            ("fused_swin_attn_block_int8", "K5",
             "geovpr_torch/csrc/swin_attn.cu",
             "geovpr/ops/pallas_swin_block.py:1159",
             swin_launches["int8"]["fused_swin_attn_block_int8"], SWIN_MAIN),
            ("fused_patch_merge", "K6", "geovpr_torch/csrc/patch_merge.cu",
             "geovpr/ops/pallas_patch_merge.py:112",
             swin_launches["bf16"]["fused_patch_merge"]
             + swin_launches["int8"]["fused_patch_merge"]
             + angle_launches["fused_patch_merge"], MERGE_MAIN)):
        t = skt[(k, shape)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": count,
                     "max_abs_err": swin_errs[(k, shape)], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # K7 at Swin-T-224 stage 0 in its raster mode, the angle path's
    rows.append({"name": "window_attention_raster", "route": "cuda",
                 "source": "geovpr_torch/csrc/window_attn.cu",
                 "replaces": "geovpr/ops/pallas_window_attention.py:182",
                 "launches": angle_launches["window_attention_raster"],
                 "max_abs_err": k7_errs[("raster", K7_RASTER_MAIN)],
                 "ms": k7t["ms"],
                 "plain_ms": k7t["plain_ms"], "bound_ms": k7t["bound_ms"],
                 "bound_by": k7t["bound_by"],
                 "library_ms": k7t["library_ms"]})
    for name, k, line, shape in (
            ("fused_swin_attn_train_fwd", "K9a", 1263, K9_MAIN),
            ("fused_swin_attn_bwd_core", "K9b", 1351, K9_SHAPES[3]),
            ("fused_swin_attn_bwd_all", "K9c", 910, K9_MAIN)):
        t = k9t[k]
        rows.append({"name": name, "route": "cuda",
                     "source": "geovpr_torch/csrc/swin_train.cu",
                     "replaces": f"geovpr/ops/pallas_swin_block.py:{line}",
                     "launches": train_launches[name],
                     "max_abs_err": k9_errs[(k, shape)], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # K8b at large-14's shape, the one path that launches it
    for name, k, line, src, shape in (
            ("fused_mhsa_train_fwd", "K8a", 1094, "mhsa", K8_MAIN),
            ("fused_mhsa_bwd_core", "K8b", 1166, "mhsa_train", K8_SHAPES[1]),
            ("fused_mhsa_bwd_all", "K8c", 1385, "mhsa_train", K8_MAIN)):
        t = k8t[k]
        rows.append({"name": name, "route": "cuda",
                     "source": f"geovpr_torch/csrc/{src}.cu",
                     "replaces": f"geovpr/ops/pallas_mhsa.py:{line}",
                     "launches": dino_launches[name],
                     "max_abs_err": k8_errs[(k, shape)], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # every kernel's launches in the fused runs and in the training runs
    # of the rest of the transformer presets too
    for row in rows:
        row["launches"] += (fuse_launches.get(row["name"], 0)
                            + rest_launches.get(row["name"], 0))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel-gloo"]:
        sys.exit(parallel_gloo_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--convert-parity-child"]:
        sys.exit(cp_child(sys.argv[2]))
    sys.exit(main())
