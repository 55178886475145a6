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
  batch;
- the 1M-row gallery (`[index_1m]`): 1,000,000 x 8448 int8 rows built
  with `DescriptorIndex.build_chunked` from seeded unit rows made on the
  card in 65,536-row chunks (the build's peak at most the index plus two
  f32 chunks), 1,024 queries searched single-shot and in 131,072-row
  blocks, bit-equal, planted near-duplicates found at rank 1;
- training from image files (`[train_disk]`): unfrozen DINOv2-B/14 + SALAD
  at full width and B=32 through `run_train` over seeded JPEGs with
  `model.remat` (K8a twice in every block, K8c once, a step; K1 in
  validation), the decoded-image cache in RAM and in memmaps, the native
  decoder (PIL where libjpeg is missing, which the line says) and
  asynchronous checkpoints: cache, decode, run, checkpoint and resume
  checks bit for bit, the remat gradient bit-equal to the kept one, the
  kernel path's gradient against the plain path's; then Swin-B-384 at
  B=16 with and without remat (peak memory, ms/step, bit-equal
  gradients);
- the int8 attention modes (`[int8_modes]`): K2 (64x257x768x12) and K5
  (the four Swin-B-384 stages at B=64) in int8 P.V and in bf16 scores
  against their plain versions, timed whole and launch by launch; the
  w8a8 Swin-T-224 heading model (window 7) in each against its plain path;
  then `cli.retrieve --int8` (DINOv2-B/14 + SALAD, the seeded gallery as
  JPEGs) and `cli.evaluate --int8` (swin_b384_gemini2, one batch of 64) in
  a child process per mode with the mode's environment variable set
  (GEOVPR_INT8_PV=1, GEOVPR_INT8_QK=0, neither): launches, CSVs, the kernel
  path against the plain path, and int8 against bf16 of the same weights,
  the three modes side by side;
- f32 serving (`[f32_serving]`), for models built with
  compute_dtype="float32": the f32 forms of K1 (64x257x768x12, whose
  attention keeps its score rows on chip, and 2x1370x768x12, the streamed
  route; each through its route and, its attention launch alone, on an
  attention sink), K4 (the
  four Swin-B-384 stages, B=64), K6 (C = 128, 256, 512) and K7's raster
  mode (the four Swin-T-224 stages, B=64) against their plain f32 versions
  with TF32 off (the branch's relative error within 1e-5), timed beside
  their plain versions, their f32 library yardsticks and their bounds at
  the CUDA cores' f32 peak; Swin-B-384 geopose, Swin-T-224 heading and
  DINOv2-B/14 + SALAD in f32, kernel path against plain path (K4 24, K6
  3; K7 12, K6 3; K1 12 launches a batch of 64); and `cli.parity` in a
  child on seeded reference-layout checkpoints, swin_geopose and a
  Swin-T-224 heading leg at compute_dtype float32 and the salad leg (f32
  by itself), each passing against the plain path's goldens on the same
  weights;
- f32 training (`[f32_training]`), for a DINOv2 built with
  compute_dtype="float32": the f32 forms of K8a (K1's f32 launches,
  16x257x768x12, whole and launch by launch), K8b (16x257x1024x16 and
  16x257x768x12) and K8c
  (16x257x768x12, whole and launch by launch) against their plain f32
  versions with TF32 off (each output's relative error within 1e-5, a
  near-cancelling column sum held to twice the plain version's own error
  against f64 instead), timed beside their plain versions, their f32
  library yardsticks and their bounds; then `run_train` at full width in
  f32 on dinov2_meanpool_huber at base-14 (K8a and K8c 12 a step, K1 12 a
  validation batch) and at large-14 (24 blocks: K8a and K8b 24 a step)
  and the unfrozen DINOv2-B/14 + SALAD under remat (K8a 24, K8c
  12 a step):
  launches, finite losses, kernel against plain gradients (cosine at
  least 0.99999 a tensor), a resume and remat bit for bit, a falling loss
  on a fixed batch, the step's times beside the bf16 step's; and
  `cli.evaluate --run-dir` on the base-14 run, serving on K1.f32;
- w8a8 with an f32 stream (`[int8_f32]`), for int8 models built with
  compute_dtype="float32": the f32 forms of K3 (64x257x768, the four
  Swin-B-384 stages and ConvNeXt-B's four with the separate residual), K2
  (64x257x768x12) and K5 (the four Swin-B-384 stages, B=64), K2 and K5 at
  their main shapes also in int8 P.V and bf16 scores, against their plain
  f32 versions (the LN-quant rows and the residual epilogue checked launch
  by launch, the rest of the call under the int8 bound, the whole call
  within limits set from its readings), timed beside their
  plain versions, library yardsticks and bounds; Swin-B-384 geopose,
  Swin-T-224 heading, ConvNeXt-B and DINOv2-B/14 with mean pooling in f32
  with int8 at B=64, kernel path against plain path (K5 24 on a bf16
  stream, K3 24 on the f32 one, K6 3; K3 12, K6 3; K3 36; K2 12 on bf16,
  K3 12), each beside the bf16 w8a8 model on the same weights; then
  `run_evaluate --int8` on swin_b384_gemini2 at float32, `cli.evaluate
  --run-dir --int8` on an f32 ConvNeXt-B run and a `cli.fuse --int8`
  batch over f32 Swin-B-384 and ConvNeXt-B runs.
  `python3 chip_smoke.py --phases
  index_1m,train_disk,int8_modes,f32_serving,f32_training,int8_f32` runs
  those phases alone.

Kernels checked: K1 (bf16 ViT attention half-block), K2 and K3 (its w8a8
form and the w8a8 MLP half-block, K3 also at the four Swin-B-384 stage
widths and at ConvNeXt-B's four stages with the separate residual), K4 and K5 (the Swin window-attention half-block, bf16 and w8a8),
K6 (Swin PatchMerging), K7 (the window-7 attention core, on the raster
qkv and on pre-split windows; the window-7 half is also timed op by op),
K2 and K5 also in their two other attention modes (int8 P.V, bf16
scores), K1, K4, K6 and K7 also in their f32 forms, K8a, K8b and K8c also
in theirs (K8c.f32's eleven launches timed one by one), K2, K3 and K5 in
their f32-stream forms, and K9a, K9b and
K9c (the Swin attention half-block's training forward, core backward and
whole backward), and K8a, K8b and K8c (the same
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


def int8_block_case(b, n, d, h, device, seed=SEED, x_scale=1.0,
                    dtype=torch.bfloat16):
    """x and the folded arguments of K2 and K3 for one DINOv2 block with
    seeded random weights (vectors perturbed, so a dropped bias or scale
    shows) in `dtype` (the stream's: bf16, or f32 as a model built with
    compute_dtype="float32" has it), its static scales calibrated on x
    through the plain float path as `quantize_for_serving` does."""
    from geovpr_torch.models.dinov2 import DinoV2Block
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    gen = torch.Generator().manual_seed(seed + n)
    blk = DinoV2Block(d, h, dtype=dtype, int8_attn=True, int8_mlp=True)
    init_weights_(blk, gen)
    with torch.no_grad():
        for p in (blk.norm1.weight, blk.norm2.weight):
            p.add_(torch.randn(d, generator=gen) * 0.1)
        for p in (blk.norm1.bias, blk.norm2.bias, blk.attn.qkv_bias,
                  blk.attn.proj_bias, blk.mlp.fc1.bias, blk.mlp.fc2.bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for p in (blk.ls1.gamma, blk.ls2.gamma):
            p.copy_(torch.randn(d, generator=gen) * 0.5)
    x = (torch.randn(b, n, d, generator=gen) * x_scale).to(dtype).to(device)
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
                              path="bf16", stats=None) -> torch.Tensor:
    """Phase 5 (bf16) / 9 (int8): whole-model descriptors, kernel path vs
    plain path; returns the kernel path's descriptors (and puts the least
    cosine into `stats`, a dict, where one is given)."""
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
    if stats is not None:
        stats["min_cosine"] = cos.min().item()
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


def bounds(kind: str, b, n, d, h, residual=False,
           mode: str = "int8_scores", width: int = 2) -> dict:
    """The least time the card could take for one call at these shapes:
    the larger of bytes (each input read once, each output written once;
    `width` bytes a value of the stream: x, out and K3's residual, 2 in
    bf16, 4 in f32) over 3.35 TB/s and operations over the peak rate of
    their type (K2 in its attention `mode`: the products q.k^T and P.V in
    int8 or bf16 as the mode forms them)."""
    m, dh = b * n, d // h
    att = 2 * b * h * n * n * dh         # one of q.k^T, P.V
    io = 2 * m * d * width               # x in, out out
    if kind == "K1":
        ops_t = (2 * m * d * 4 * d + 2 * att) / PEAK_BF16
        nbytes = io + 4 * d * d * 2 + (2 * d + 3 * d + 2 * d) * 4
    elif kind == "K2":
        att8 = {"int8_scores": 1, "int8_pv": 2, "bf16_scores": 0}[mode]
        ops_t = ((2 * m * d * 4 * d + att8 * att) / PEAK_INT8
                 + (2 - att8) * att / PEAK_BF16)
        nbytes = io + 4 * d * d + (2 * d + 6 * d + 3 * d) * 4
    else:
        hid = 4 * d
        ops_t = 4 * m * d * hid / PEAK_INT8
        nbytes = io + (m * d * width if residual else 0) + 2 * d * hid + (
            2 * d + 2 * hid + 3 * d) * 4
    bytes_t = nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3)


def library_k1(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, h):
    """K1's yardstick (timed only here, never called by the port):
    F.layer_norm -> torch.matmul -> F.scaled_dot_product_attention ->
    torch.matmul + epilogue, all in x's dtype (bf16, or f32 with TF32
    off)."""
    import torch.nn.functional as F
    b, n, d = x.shape
    dt = x.dtype
    hx = F.layer_norm(x.float(), (d,), ln_scale, ln_bias, 1e-6).to(dt)
    qkv = (torch.matmul(hx, wqkv) + bqkv).to(dt)
    q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        b, n, d)
    return ((torch.matmul(o, wo) + bo) * gamma + x).to(dt)


def part_bound(ops, peak, nbytes) -> dict:
    """The least time of one launch: `ops` operations at `peak` against
    `nbytes` at 3.35 TB/s."""
    ops_t, bytes_t = ops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3,
                ops=ops)


def k1_part_bounds(part: str, b, n, d, h, gamma=True, peak=PEAK_BF16,
                   width=2) -> dict:
    """The least time of one of K1's four launches at (B, N, D, H), B N
    rows attending in groups of N: bytes (each input read once, each
    output written once; `width` bytes a value of the stream, the
    matrices and the buffers, 4 a vector's) over 3.35 TB/s against
    operations at their peak (the products at `peak`, bf16 by default;
    LayerNorm's ~8 f32 operations an element). K4's launches are the same
    with B windows of N tokens and no gamma."""
    m, w = b * n, width
    if part == "layernorm":      # x -> LN(x); scale and bias
        return part_bound(8 * m * d, PEAK_F32, 2 * m * d * w + 2 * d * 4)
    if part == "qkv_gemm":       # LN(x), Wqkv, bqkv -> qkv
        return part_bound(2 * m * d * 3 * d, peak, m * d * w + 3 * d * d
                          * w + 3 * d * 4 + m * 3 * d * w)
    if part == "attention":      # qkv -> ctx: q k^T and P V, once each
        return part_bound(4 * b * h * n * n * (d // h), peak,
                          m * 3 * d * w + m * d * w)
    # ctx, Wo, bo, gamma, x -> out
    return part_bound(2 * m * d * d, peak, 3 * m * d * w + d * d * w + (
        2 if gamma else 1) * d * 4)


# bytes a row-column of the QKV launch's output in each attention mode:
# qk8 and a bf16 v (int8 scores), q | k | v in int8 (int8 P.V) or bf16
QKV_OUT_BYTES = {"int8_scores": 4, "int8_pv": 3, "bf16_scores": 6}


def attention_rate(mode: str) -> float:
    """The peak rate of an attention's two products, q k^T and P V, in
    `mode`: both int8 (int8 P.V), both bf16 (bf16 scores), or one of each
    (int8 scores: the pair's rate is their mix)."""
    att8 = {"int8_scores": 1, "int8_pv": 2, "bf16_scores": 0}[mode]
    return 2 / (att8 / PEAK_INT8 + (2 - att8) / PEAK_BF16)


def k2_part_bounds(part: str, b, n, d, h, mode: str = "int8_scores") -> dict:
    """The least time of one of K2's four launches at (B, N, D, H), M = B
    N rows, in the attention `mode`: bytes (each input read once, each
    output written once) over 3.35 TB/s against operations at their peak
    (the int8 products at 1,979 TOP/s, the bf16 ones at 989 TFLOP/s)."""
    m = b * n
    if part == "ln_quant":
        return ln_quant_bound(m, d)
    if part == "qkv_gemm":       # xq, Wqkv, sqkv, bqkv -> qk8, v | qkv
        return part_bound(2 * m * d * 3 * d, PEAK_INT8, m * d + 3 * d * d
                          + 6 * d * 4 + m * d * QKV_OUT_BYTES[mode])
    if part == "attention":      # qk8, v | qkv -> ctx8
        att = 2 * b * h * n * n * (d // h)
        return part_bound(2 * att, attention_rate(mode),
                          m * d * QKV_OUT_BYTES[mode] + m * d)
    # ctx8, Wo, so, bo, gamma, x -> out
    return part_bound(2 * m * d * d, PEAK_INT8, m * d + d * d + 3 * d * 4
                      + 2 * m * d * 2)


def k4_part_bounds(part: str, shape, peak=PEAK_BF16, width=2) -> dict:
    """K1's formulas for one of K4's four launches at (B, C, H, S, w,
    shift): the B S^2 / w^2 windows of N = w^2 tokens in place of K1's
    images, no gamma."""
    b, c, h, res, win, _ = shape
    return k1_part_bounds(part, b * res * res // (win * win), win * win, c,
                          h, gamma=False, peak=peak, width=width)


def ln_quant_bound(m, d) -> dict:
    """The LN-quant launch of K3 and K5: x (M, D) bf16 read, the int8 rows
    written, ~8 f32 operations an element."""
    return part_bound(8 * m * d, PEAK_F32, m * d * 2 + m * d + 2 * d * 4)


def k5_part_bounds(part: str, shape, mode: str = "int8_scores") -> dict:
    """The least time of one of K5's four launches at (B, C, H, S, w,
    shift), M = B S^2 rows, in the attention `mode`: bytes (each input read
    once, each output written once) over 3.35 TB/s against operations at
    their peak (the int8 products at 1,979 TOP/s, the bf16 ones at 989
    TFLOP/s)."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    if part == "ln_quant":
        return ln_quant_bound(m, c)
    if part == "qkv_gemm":       # xq, Wqkv, sqkv, bqkv -> qk8, v | qkv
        return part_bound(2 * m * c * 3 * c, PEAK_INT8, m * c + 3 * c * c
                          + 6 * c * 4 + m * c * QKV_OUT_BYTES[mode])
    if part == "attention":      # qk8, v | qkv, table -> ctx8
        return part_bound(4 * m * n * c, attention_rate(mode),
                          m * c * QKV_OUT_BYTES[mode] + m * c
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


def k6_part_bounds(part: str, shape, peak=PEAK_BF16, width=2) -> dict:
    """One of K6's two launches at (B, C, S): the merge-LN pass (x read
    once, LN(merged) (M2, 4C) written; ~8 f32 operations an element) and
    the GEMM (LN(merged) and W read, out written, the product at `peak`),
    `width` bytes a value (4 a vector's)."""
    b, c, res = shape
    m2, w = b * (res // 2) ** 2, width
    if part == "merge_ln":
        return part_bound(8 * m2 * 4 * c, PEAK_F32,
                          2 * m2 * 4 * c * w + 2 * 4 * c * 4)
    return part_bound(2 * m2 * 4 * c * 2 * c, peak,
                      m2 * 4 * c * w + 8 * c * c * w + m2 * 2 * c * w)


def graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Mean device time of fn() in ms, `iters` calls captured in one CUDA
    graph and replayed, so that the host's cost of launching (Python,
    ctypes, tens of microseconds a call) does not count. `stream`: the
    stream to capture on (torch's own capture stream by default)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def k2_part_times(x, k2: dict, h: int, card: str,
                  name: str = "K2") -> dict:
    """K2's four launches (LN-quant, QKV GEMM, attention, out projection)
    timed one by one on x and the half-block's folded arguments `k2` (in
    their attention mode) by `parts_split`, beside `k2_part_bounds`; the
    launches are not counted (`k2_launch_part`)."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops.quant import attn_mode

    b, n, d = x.shape
    mode = attn_mode(k2["cs"], k2["cpv"])
    with torch.inference_mode():
        bufs = mh.k2_buffers(x, mode)
        return parts_split(
            card, name, f"B{b}_N{n}_D{d}_H{h}", mh.K2_PARTS,
            lambda i: mh.k2_launch_part(i, x, **k2, num_heads=h, bufs=bufs),
            lambda part: k2_part_bounds(part, b, n, d, h, mode))


def library_k2(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
               wo_q_t, so_eff, bo, gamma, cs, num_heads, cpv=None, cpl=None,
               ln_eps=1e-6):
    """K2's yardstick: F.layer_norm -> quantize -> torch._int_mm (qkv) ->
    dequant -> F.scaled_dot_product_attention in bf16 -> quantize ->
    torch._int_mm (out projection) + epilogue, the output in x's dtype.
    The same call in every attention mode: SDPA in bf16 is the bf16-score
    mode's form and the nearest yardstick of the int8 ones (no torch call
    forms int8 P.V)."""
    import torch.nn.functional as F
    b, n, d = x.shape
    xq = torch.clamp(torch.round(F.layer_norm(
        x.float(), (d,), None, None, ln_eps) * ln_scale_q + ln_bias_q),
        -127, 127).to(torch.int8).reshape(-1, d)
    qkv = (torch._int_mm(xq, wqkv_q_t.t()) * sqkv_eff + bqkv_eff).bfloat16()
    q, k, v = (t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v)
    c8 = torch.clamp(torch.round(o.transpose(1, 2).reshape(-1, d).float()),
                     -127, 127).to(torch.int8)
    out = torch._int_mm(c8, wo_q_t.t()) * so_eff + bo
    return (out.reshape(b, n, d) * gamma + x).to(x.dtype)


def library_k3(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1, w2q_t, s2_eff,
               b2, gamma, inv_a_mid, ln_eps=1e-6, residual=None):
    """K3's yardstick: F.layer_norm + two torch._int_mm with the
    quantize / GELU / dequant steps between them (and the separate
    residual where there is one), the output in x's dtype."""
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
    return (y * gamma + res).to(x.dtype).reshape(x.shape)


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

def swin_block_case(shape, device, int8=False, seed=SEED, x_scale=1.0,
                    dtype=torch.bfloat16):
    """x and a Swin block at one stage's widths in `dtype`, seeded random
    weights with perturbed vectors and a random relative-position table (so
    that a dropped bias, scale or table shows); int8: its static scales
    calibrated on x through the plain float path."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving
    from geovpr_torch.models.swin import SwinBlock

    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + c + shift)
    blk = SwinBlock(c, h, res, win, shift, dtype=dtype, int8_attn=int8,
                    int8_mlp=int8)
    init_weights_(blk, gen)
    perturb_swin_(blk, gen)
    x = (torch.randn(b, res * res, c, generator=gen) * x_scale).to(dtype)
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


def merge_case(shape, device, seed=SEED, dtype=torch.bfloat16):
    b, c, res = shape
    gen = torch.Generator().manual_seed(seed + c)
    x = torch.randn(b, res * res, c, generator=gen).to(dtype).to(device)
    ln_s = (1 + 0.1 * torch.randn(4 * c, generator=gen)).to(device)
    ln_b = (0.1 * torch.randn(4 * c, generator=gen)).to(device)
    w = (torch.randn(4 * c, 2 * c, generator=gen) * (4 * c) ** -0.5
         ).to(dtype).to(device)
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
                       int8=False, tag=None) -> tuple[dict, np.ndarray]:
    """Phase 13 (bf16) / 16 (int8): the geopose path through run_evaluate
    (int8: calibration on the first batch, then the w8a8 model), every
    kernel's launch count set to 0 just before and read just after;
    `[geopose] path=<tag>` (by default int8 or bf16)."""
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
    phase("geopose", path=tag or ("int8" if int8 else "bf16"), wall_s=wall,
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
                                   path="bf16", stats=None):
    """Phase 14 (bf16) / 17 (int8): pooled features and predictions of the
    kernel path against the plain path on one batch; returns the kernel
    path's pooled features (and puts the least pooled-feature cosine into
    `stats`, a dict, where one is given)."""
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
    if stats is not None:
        stats["min_cosine"] = cos.min().item()
    check(cos.min().item() >= bound and cos_pred.min().item() >= bound,
          f"{path} Swin kernel vs plain path cosine {cos.min().item()}, "
          f"predictions {cos_pred.min().item()} < {bound}")
    check(bool(torch.isfinite(pooled).all()), f"{path} pooled not finite")
    return pooled


def swin_bounds(kind: str, shape, mode: str = "int8_scores",
                width: int = 2) -> dict:
    """The least time of one call of K4 / K5 at (B, C, H, S, w, shift), or
    of K6 at (B, C, S): bytes over 3.35 TB/s against operations over the
    peak of their type (the JAX cost estimate: 8 BW N C^2 + 4 BW H N^2 dh
    for the half-block; K5's attention products as its `mode` forms
    them). `width`: K5's bytes a value of the stream, x and out (2 in
    bf16, 4 in f32)."""
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
        nbytes = 2 * m * c * width + wbytes + (2 * c + 6 * c + 2 * c) * 4 + (
            (2 * win - 1) ** 2 * h * 4)
        if kind == "K4":
            ops_t = ops / PEAK_BF16
        else:
            ops_t = proj / PEAK_INT8 + 2 * att / attention_rate(mode)
    bytes_t = nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_t, bytes_t) * 1e3,
                bound_by="operations" if ops_t >= bytes_t else "bytes",
                ops_bound_ms=ops_t * 1e3, bytes_bound_ms=bytes_t * 1e3,
                ops=ops)


def library_mask(table, h, b, res, win, shift, dtype=torch.bfloat16):
    """The yardsticks' float attention mask in `dtype` (BW, H, N, N): the
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
    return mask.to(dtype)


def library_k4(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table, h, res,
               win, shift, ln_eps=1e-5):
    """K4's yardstick (timed only here, never called by the port):
    F.layer_norm -> torch.matmul -> windows (torch.roll + partition) ->
    F.scaled_dot_product_attention with bias [+ mask] as a float mask ->
    back to raster -> torch.matmul + bias + residual, all in x's dtype
    (bf16, or f32 with TF32 off)."""
    import torch.nn.functional as F

    from geovpr_torch.ops.window_attention import from_windows, to_windows
    b, l, c = x.shape
    dt = x.dtype
    hx = F.layer_norm(x.float(), (c,), ln_scale, ln_bias, ln_eps).to(dt)
    qkv = to_windows((torch.matmul(hx, wqkv) + bqkv).to(dt), res, win,
                     shift)
    bw, n, _ = qkv.shape
    q, k, v = (t.reshape(bw, n, h, c // h).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=library_mask(table, h, b, res, win, shift, dt))
    o = from_windows(o.transpose(1, 2).reshape(bw, n, c), res, win, shift)
    return (torch.matmul(o, wo) + bo + x).to(dt)


def library_k5(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
               wo_q_t, so_eff, bo, cs, table, num_heads, resolution, window,
               shift, ln_eps=1e-5, cpv=None):
    """K5's yardstick: F.layer_norm -> quantize -> torch._int_mm (qkv) ->
    dequant -> K4's windowed bf16 SDPA with the float bias/mask (q and k in
    their int8 units, scaled by cs; SDPA's own dh^-0.5 in bf16 scores) ->
    quantize -> torch._int_mm (out projection) + epilogue, the output in
    x's dtype; the same call in every attention mode, as `library_k2`."""
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
        scale=None if cs is None else float(cs))
    o = from_windows(o.transpose(1, 2).reshape(bw, n, c), resolution, win,
                     shift)
    c8 = torch.clamp(torch.round(o.reshape(-1, c).float()), -127,
                     127).to(torch.int8)
    out = torch._int_mm(c8, wo_q_t.t()) * so_eff + bo
    return (out.reshape(b, l, c) + x).to(x.dtype)


def library_k6(x, ln_scale, ln_bias, w, res, ln_eps=1e-5):
    """K6's yardstick: the 2x2 gather -> F.layer_norm -> torch.matmul, in
    x's dtype."""
    import torch.nn.functional as F

    from geovpr_torch.ops.patch_merge import merge_gather
    m = merge_gather(x, res)
    ln = F.layer_norm(m.float(), (m.shape[-1],), ln_scale, ln_bias,
                      ln_eps).to(x.dtype)
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


def k7_raster_case(shape, device, seed=SEED, dtype=torch.bfloat16):
    """K7's raster operands at (B, C, H, resolution, window, shift): the
    unfused half's qkv (B, L, 3C) drawn N(0, 1) in `dtype` and a
    relative-position table ((2w-1)^2, H) drawn at unit scale (f32), with
    the geometry: `window_attention_raster`'s arguments."""
    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + b + c + res + shift)
    qkv = torch.randn(b, res * res, 3 * c, generator=gen).to(dtype)
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


def library_k7_mask(bias, mask, bw, dtype=torch.bfloat16):
    """The float mask of K7's yardstick: bias [+ each window's shift mask]
    tiled to (BW, H, N, N) in `dtype` (window w takes mask w mod nW), built
    once, outside the timing."""
    m = bias[None] if mask is None else bias[None] + mask[:, None]
    return m.to(dtype).repeat(bw // m.shape[0], 1, 1, 1)


def interleaved_graph_ms(fns: dict, iters: int = 20, stream=None) -> dict:
    """`graph_ms` of each fn (the host's launch cost left out; captured on
    `stream`), run in turns a, b, c, c, b, a; returns the mean of each
    fn's two runs and the runs."""
    names = list(fns)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        runs[k].append(graph_ms(fns[k], iters, stream))
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


def fuse_images(root: str, rng, n_test: int = FUSE_N_TEST,
                n_gallery: int = FUSE_N_GALLERY) -> tuple:
    """The test folder of `n_test` images and the gallery of `n_gallery`
    (images and manifest): non-square JPEGs of an upsampled random 8x8
    colour field plus noise, the gallery 100 m apart."""
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
    for i in range(n_test):
        image(i).save(os.path.join(test_dir, f"t_{i:04d}.jpg"), quality=90)
    gallery_csv = os.path.join(root, "gallery.csv")
    with open(gallery_csv, "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(n_gallery):
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


def fuse_cli(argv: list, expected: dict, path: str,
             n_test: int = FUSE_N_TEST) -> tuple:
    """One `geovpr_torch.cli.fuse.main` run, every kernel's launch count set
    to 0 just before and read just after and held to `expected`; its JSON
    record and its CSVs checked: a row per test image (`n_test`) sorted by
    filename with finite values, FUSE_TOP_K matches a test image. Returns
    (record, launches)."""
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
    check(rec["num_images"] == n_test, f"fuse {path}: {rec}")
    names = [f"t_{i:04d}.jpg" for i in range(n_test)]
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


def convnext_k3_case(shape, device, seed=SEED, dtype=torch.bfloat16):
    """K3's arguments at one ConvNeXt-B stage: a block with seeded random
    weights in `dtype`, perturbed (gamma off its 1e-6 init), its static
    scales calibrated on x through the float path; returns the dwconv's
    output h (K3's x), the pre-dwconv stream x (K3's residual) and the
    folded arguments."""
    from geovpr_torch.models.convnext import LN_EPS, ConvNeXtBlock, _conv_nhwc
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    b, side, c = shape
    gen = torch.Generator().manual_seed(seed + c)
    blk = ConvNeXtBlock(c, dtype=dtype, int8_mlp=True)
    init_weights_(blk, gen)
    perturb_cnn_(blk, gen)
    x = torch.randn(b, side, side, c, generator=gen).to(dtype).to(device)
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


def k9_case(shape, device, seed=SEED, dtype=torch.bfloat16):
    """K9's operands at one stage: x at K1_X_SCALE (in `dtype`, the
    stream's), LN vectors and biases off their init, matrices at fan-in
    scale (in `dtype`), a table drawn N(0, 1) (zero at init), and an
    upstream gradient g drawn N(0, 1) (in `dtype`)."""
    b, c, h, res, win, shift = shape
    gen = torch.Generator().manual_seed(seed + c + shift)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen) * scale

    args = dict(x=r(b, res * res, c, scale=K1_X_SCALE).to(dtype),
                ln_scale=1 + r(c, scale=0.1), ln_bias=r(c, scale=0.1),
                wqkv=r(c, 3 * c, scale=c ** -0.5).to(dtype),
                bqkv=r(3 * c, scale=0.1),
                wo=r(c, c, scale=c ** -0.5).to(dtype), bo=r(c, scale=0.1),
                table=r((2 * win - 1) ** 2, h))
    g = r(b, res * res, c).to(dtype)
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
    stage 0 by default), each in turns with its plain version and its
    library yardstick (`library_k4`'s forward for K9a and its whole
    backward for K9c, each with K4's residual add, one elementwise pass;
    for K9b the backward of F.scaled_dot_product_attention alone, on the
    same windows and float mask), beside its bound, all three in CUDA
    graphs (`interleaved_graph_ms`; the autograd yardsticks captured on
    the stream their forward ran on, `library_backward`)."""
    from geovpr_torch.ops import swin_block as sb

    a, g, geom = k9_case(shape, device)
    geo = tuple(geom.values())
    fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"], a["wo"],
          a["bo"], a["table"], *geo, 1e-5)
    out = {}
    with torch.no_grad():
        _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*fa)
    ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"], qkv, ctx,
          p, g, *geo, 1e-5)
    stream = torch.cuda.Stream()
    for name in names:
        fns = k9_timing_cases(name, shape, fa, ba, g, stream)
        with torch.no_grad():
            t = interleaved_graph_ms(fns, F32_TIME_ITERS, stream)
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         runs={k: v[1] for k, v in t.items()},
                         **k9_bounds(name, shape))
        phase("kernel_time", card=repr(card), name=name,
              shape="B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
              timed="cuda_graph", **out[name])
        del fns
    return out


def k9_timing_cases(name: str, shape, fa, ba, g, stream) -> dict:
    """kernel, plain and library of K9a, K9b or K9c on the forward
    arguments `fa` and the backward arguments `ba` (the residuals of a
    forward; g the upstream gradient, K9b's da), in their dtype: the
    library yardsticks `library_k4`'s forward (K9a), the backward of
    F.scaled_dot_product_attention on the windows of qkv with the bias
    [+ mask] as a float mask (K9b) and the autograd of `library_k4` (K9c),
    the backward ones capturable on `stream` (`library_backward`)."""
    import torch.nn.functional as F

    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops.window_attention import to_windows

    geo = fa[8:12]
    if name == "K9a":
        return {"kernel": lambda: sb.fused_swin_attn_train_fwd(*fa),
                "plain": lambda: sb._train_plain_fwd(*fa),
                "library": lambda: library_k4(*fa[:8], *geo)}
    qkv, p = ba[5], ba[7]
    if name == "K9b":
        c = qkv.shape[-1] // 3
        qkv_w = to_windows(qkv, *geo[1:])
        n = qkv_w.shape[1]
        qh, kh, vh = (t.reshape(-1, n, geo[0], c // geo[0]).transpose(1, 2)
                      .contiguous().requires_grad_()
                      for t in qkv_w.split(c, dim=-1))
        mask = library_mask(fa[7], geo[0], shape[0], *geo[1:], qkv.dtype)
        g_o = torch.randn(qh.shape, device=qkv.device, dtype=qkv.dtype)
        return {"kernel": lambda: sb.fused_swin_attn_bwd_core(qkv, p, g,
                                                              *geo),
                "plain": lambda: sb.swin_attn_core_bwd_reference(
                    sb._raster_to_rows(qkv, *geo[1:]), p,
                    sb._raster_to_rows(g, *geo[1:]), geo[0]),
                "library": library_backward(
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask), (qh, kh, vh), g_o,
                    stream)}
    leaves = [t.detach().requires_grad_() for t in fa[:8]]
    return {"kernel": lambda: sb.fused_swin_attn_bwd_all(*ba),
            "plain": lambda: sb._train_plain_bwd(*ba, split=False),
            "library": library_backward(lambda: library_k4(*leaves, *geo),
                                        leaves, g, stream)}


def k9a_part_bounds(part: str, shape, peak=PEAK_BF16, w=2) -> dict:
    """The least time of one of K9a's four launches at (B, C, H, S, w,
    shift), M = B S^2 rows: its inputs read once and its outputs written
    once (`w`-byte streams: bf16, or 4 for K9a.f32, which writes no scaled
    q copy) over 3.35 TB/s, against its products at `peak` (the bf16 peak,
    or K9a.f32's f32 one) or its f32 operations (the LayerNorm) at 67
    TFLOP/s."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    if part == "layernorm":      # x, ln_scale, ln_bias -> h
        return part_bound(8 * m * c, PEAK_F32, 2 * m * c * w + 2 * c * 4)
    if part == "qkv_gemm":       # h, Wqkv, bqkv -> qkv [, the scaled q copy]
        outs = 4 if w == 2 else 3
        return part_bound(6 * m * c * c, peak,
                          (m * c + 3 * c * c + outs * m * c) * w + 3 * c * 4)
    if part == "attention":      # q [copy], k, v, table -> ctx, p
        att = 2 * bw * h * n * n * (c // h)
        return part_bound(2 * att, peak,
                          4 * m * c * w + bw * h * n * n * w
                          + (2 * win - 1) ** 2 * h * 4)
    # ctx, Wo, bo -> y
    return part_bound(2 * m * c * c, peak,
                      (2 * m * c + c * c) * w + c * 4)


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


def k9c_part_bounds(part: str, shape, peak=PEAK_BF16, w=2) -> dict:
    """The least time of one of K9c's launches (with the reduce of its
    partial sums) at (B, C, H, S, w, shift), M = B S^2 rows: its inputs
    read once and its outputs written once (`w`-byte streams: bf16, or 4
    for K9c.f32; f32 vectors and weight gradients) over 3.35 TB/s, against
    its products at `peak` (the bf16 peak, or K9c.f32's f32 one) or its f32
    operations (column sums, the LayerNorm recompute and VJP) at 67
    TFLOP/s."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    if part == "da":             # g, Wo -> da
        return part_bound(2 * m * c * c, peak, 2 * m * c * w + c * c * w)
    if part == "dwo":            # ctx, g -> dWo (f32)
        return part_bound(2 * m * c * c, peak, 2 * m * c * w + c * c * 4)
    if part == "dbo":            # g -> dbo
        return part_bound(m * c, PEAK_F32, m * c * w + c * 4)
    if part == "core":           # qkv, p, da -> dqkv, dbias
        att = 2 * bw * h * n * n * (c // h)
        return part_bound(4 * att, peak, (3 * m * c + m * c + 3 * m * c) * w
                          + bw * h * n * n * w + h * n * n * 4)
    if part == "ln_rows":        # x, ln_scale, ln_bias -> h, stats
        return part_bound(8 * m * c, PEAK_F32,
                          2 * m * c * w + 2 * c * 4 + m * 8)
    if part == "dwqkv":          # h, dqkv -> dWqkv (f32)
        return part_bound(6 * m * c * c, peak,
                          4 * m * c * w + 3 * c * c * 4)
    if part == "dbqkv":          # dqkv -> dbqkv
        return part_bound(3 * m * c, PEAK_F32, 3 * m * c * w + 3 * c * 4)
    if part == "dh":             # dqkv, Wqkv -> dh
        return part_bound(6 * m * c * c, peak,
                          4 * m * c * w + 3 * c * c * w)
    # x, dh, stats, ln_scale -> dx, dls, dlb
    return part_bound(10 * m * c, PEAK_F32,
                      3 * m * c * w + m * 8 + 3 * c * 4)


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
    alone, on the same q, k, v), beside its bound, all three in CUDA
    graphs (`interleaved_graph_ms`; the autograd yardsticks captured on
    the stream their forward ran on, `library_backward`); K8a also launch
    by launch."""
    from geovpr_torch.ops import mhsa as mh

    h = shape[3]
    a, g = k8_case(shape, device)
    fa = _k8_fwd_args(a, h)
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*fa)
    ba = _k8_bwd_args(a, res, g, h)
    d = shape[2]
    stream = torch.cuda.Stream()

    def cases(name):
        if name == "K8a":
            return {"kernel": lambda: mh.fused_mhsa_train_fwd(*fa),
                    "plain": lambda: mh.mhsa_train_fwd_reference(*fa),
                    "library": lambda: library_k1(*fa[:9])}
        if name == "K8b":
            g_o = torch.randn(shape[0], h, shape[1], d // h, device=device,
                              dtype=res[1].dtype)
            return {"kernel": lambda: mh.fused_mhsa_bwd_core(res[1], g, h),
                    "plain": lambda: mh.mhsa_attn_bwd_core_reference(
                        res[1], g, h),
                    "library": library_k8b(res[1], h, g_o, stream)}
        leaves = [t.detach().requires_grad_() for t in fa[:8]]
        return {"kernel": lambda: mh.fused_mhsa_bwd_all(*ba),
                "plain": lambda: mh.mhsa_train_bwd_reference(*ba),
                "library": library_backward(lambda: library_k1(*leaves, h),
                                            leaves, g, stream)}

    out = {}
    for name in names:
        with torch.no_grad():
            t = interleaved_graph_ms(cases(name), F32_TIME_ITERS, stream)
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         runs={k: v[1] for k, v in t.items()},
                         **k8_bounds(name, shape))
        phase("kernel_time", card=repr(card), name=name,
              shape="B{}_N{}_D{}_H{}".format(*shape), timed="cuda_graph",
              **out[name])
    if "K8a" in names:
        out["K8a"]["parts"] = k1_part_times(a["x"], a, h, card, "K8a")
    return out


def k8c_part_bounds(part: str, shape, peak=PEAK_BF16, w=2,
                    vec_peak=PEAK_F32) -> dict:
    """The least time of one of K8c's launches (with the reduce of its
    partial sums) at (B, N, D, H), M = B N rows: its inputs read once and
    its outputs written once (`w`-byte streams and matrices: bf16, or 4
    for K8c.f32; f32 vectors and weight gradients) over 3.35 TB/s, against
    its products at `peak` (the bf16 peak, or K8c.f32's f32 one) or its
    f32 operations (scaling, column sums, the LayerNorm recompute and VJP)
    at `vec_peak`."""
    b, n, d, h = shape
    m = b * n
    if part == "dy":             # g, gamma -> dy
        return part_bound(m * d, vec_peak, 2 * m * d * w + d * 4)
    if part == "dbo":            # g, gamma -> dbo
        return part_bound(2 * m * d, vec_peak, m * d * w + 2 * d * 4)
    if part == "da":             # dy, Wo -> da
        return part_bound(2 * m * d * d, peak,
                          2 * m * d * w + d * d * w)
    if part == "dwo":            # ctx, dy -> dWo (f32)
        return part_bound(2 * m * d * d, peak,
                          2 * m * d * w + d * d * 4)
    if part == "dgamma":         # ctx, Wo, bo, g -> dgamma
        return part_bound(2 * m * d * d, peak,
                          2 * m * d * w + d * d * w + 2 * d * 4)
    if part == "core":           # qkv, da -> dqkv
        return part_bound(5 * 2 * b * h * n * n * (d // h), peak,
                          7 * m * d * w)
    if part == "ln_rows":        # x, ln_scale, ln_bias -> h, stats
        return part_bound(8 * m * d, vec_peak,
                          2 * m * d * w + 2 * d * 4 + m * 8)
    if part == "dwqkv":          # h, dqkv -> dWqkv (f32)
        return part_bound(6 * m * d * d, peak,
                          4 * m * d * w + 3 * d * d * 4)
    if part == "dbqkv":          # dqkv -> dbqkv
        return part_bound(3 * m * d, vec_peak, 3 * m * d * w + 3 * d * 4)
    if part == "dh":             # dqkv, Wqkv -> dh
        return part_bound(6 * m * d * d, peak,
                          4 * m * d * w + 3 * d * d * w)
    # x, dh, stats, ln_scale, g -> dx, dls, dlb
    return part_bound(11 * m * d, vec_peak,
                      4 * m * d * w + m * 8 + 3 * d * 4)


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


def kernel_blocks(model) -> list:
    """The modules whose `use_kernels` picks the kernel or the plain path:
    the backbone's blocks, or its inner backbone's (DINOv2 + SALAD)."""
    bb = model.backbone
    return list(getattr(bb, "blocks", None)
                or getattr(getattr(bb, "backbone", None), "blocks", []))


# parameters whose gradient is zero in exact arithmetic, roundoff on any
# path: the Sinkhorn plan ignores a constant added to a whole row of the
# scores (its first row update absorbs it), which is what the dustbin and
# score_fc2's bias add
ROUNDOFF_GRADS = ("backbone.salad.dustbin", "backbone.salad.score_fc2.bias")


class SaladRelus:
    """Stands in for `torch.nn.functional` in `models/salad.py` while a
    gradient is taken: records the input of each ReLU of the SALAD head
    (the feat, score and token MLPs, in call order) in `seen`, or, given
    `masks` (one boolean tensor per ReLU), passes exactly the units marked
    there (the value x and the gradient 1) and no other."""

    def __init__(self, masks=None):
        self.seen, self.masks = [], masks

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        self.seen.append(x.detach())
        if self.masks is None:
            return torch.relu(x)
        return torch.where(self.masks[len(self.seen) - 1], x,
                           torch.zeros_like(x))


@contextlib.contextmanager
def salad_relus(relus):
    """`relus` (a SaladRelus) in place of the SALAD head's ReLUs."""
    from geovpr_torch.models import salad
    old, salad.F = salad.F, relus
    try:
        yield relus
    finally:
        salad.F = old


def train_grads_vs_plain(trainer, batch, path: str,
                         against_f32: bool = False,
                         salad_masks: bool = False) -> None:
    """`_train_grads_vs_plain` with the running statistics kept."""
    with kept_batch_stats(trainer.state.model):
        _train_grads_vs_plain(trainer, batch, path, against_f32, salad_masks)


def _train_grads_vs_plain(trainer, batch, path: str,
                          against_f32: bool = False,
                          salad_masks: bool = False) -> None:
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
    while a tensor whose gradient is wrong outright still moves it.

    `salad_masks` (DINOv2 + SALAD) takes the plain path's gradient with
    each ReLU of the SALAD head passing the units the kernel path's ReLU
    passed, and holds every tensor to the cosine of 0.999 against it (with
    `against_f32`, besides the bound above, in which the plain path keeps
    its own ReLUs). A unit whose pre-activation lies within the two
    paths' rounding of 0 passes on one path and not on the other, and a
    few such units move the token MLP's gradient by per-mille cosines:
    `chip_grads.py` read 24 of the token MLP's 16,384 units flipping
    (|x| <= 0.015), and the plain path against itself with the
    attention's f32 sums in another order reading 0.9982 on
    `salad.token_fc1.bias` unmasked and 0.99994 masked. The flips and the
    unmasked cosines are printed (`[train_grads_relu]`). The parameters
    of ROUNDOFF_GRADS are only reported."""
    st, model = trainer.state, trainer.state.model
    saved = _drop_rates(model, 0.0)
    model.train()
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)
    names = [n for n, _ in model.named_parameters()]
    compute_dtype = model.backbone.dtype

    blocks = kernel_blocks(model)

    def grads(kernels: bool, dtype=compute_dtype, relus=None):
        for m in blocks:
            m.use_kernels = kernels
        set_compute_dtype(model, dtype)
        try:
            with (salad_relus(relus) if relus is not None
                  else contextlib.nullcontext()):
                loss = trainer.objective.loss(
                    model(trainer._normalize(batch["image"])), enc,
                    batch["mask"])
                return torch.autograd.grad(loss, list(model.parameters()))
        finally:
            for m in blocks:
                m.use_kernels = True
            set_compute_dtype(model, compute_dtype)

    def cosines(a, b):
        return {n: _cosine(x, y) for n, x, y in zip(names, a, b)
                if n not in ROUNDOFF_GRADS}

    kernel_relus, plain_relus = SaladRelus(), SaladRelus()
    got = grads(True, relus=kernel_relus if salad_masks else None)
    want = grads(False, relus=plain_relus if salad_masks else None)
    cos = cosines(got, want)
    if salad_masks:
        own = cos
        masked = grads(False, relus=SaladRelus(
            [x > 0 for x in kernel_relus.seen]))
        cos = cosines(got, masked)
    roundoff = {n: (got[i].float().norm().item(),
                    want[i].float().norm().item())
                for i, n in enumerate(names) if n in ROUNDOFF_GRADS}
    if roundoff:
        ref = dict(zip(names, want))["backbone.salad.score_fc2.weight"]
        phase("train_grads_roundoff", path=path, norms=repr(roundoff),
              score_fc2_weight_grad_norm=ref.float().norm().item())
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    phase("train_grads", path=path, tensors=len(cos),
          min_cosine=worst[0][1], worst=repr(worst),
          bound="kernel-vs-f32 below" if against_f32 and not salad_masks
          else 0.999, salad_relus="the kernel path's units" if salad_masks
          else "each path its own")
    if salad_masks:
        flips = [(which, int(((a > 0) != (b > 0)).sum()), a.numel())
                 for which, a, b in zip(("feat", "score", "token"),
                                        kernel_relus.seen, plain_relus.seen)]
        low = sorted(own.items(), key=lambda kv: kv[1])[:3]
        phase("train_grads_relu", path=path, flipped_units=repr(flips),
              own_relus_min_cosine=low[0][1], own_relus_worst=repr(low))
        check(worst[0][1] >= 0.999,
              f"kernel vs plain gradient cosine below 0.999 with the SALAD "
              f"head's ReLUs passing the same units: {worst}")
    if against_f32:
        ref = grads(False, torch.float32)
        _drop_rates(model, saved)
        ek, ep, ratio = {}, {}, {}
        for n, k, p, r in zip(names, got, want, ref):
            if n in ROUNDOFF_GRADS:
                continue
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
                  (n, r, _cosine(got[names.index(n)], want[names.index(n)]),
                   _cosine(got[names.index(n)], ref[names.index(n)]),
                   _cosine(want[names.index(n)], ref[names.index(n)]))
                  for n, r in top]), bound=GRAD_F32_RATIO)
        check(rms <= GRAD_F32_RATIO,
              f"kernel path's gradient further from the f32 path than "
              f"{GRAD_F32_RATIO} x the bf16 plain path's: {rms}, {top}")
        return
    if salad_masks:
        _drop_rates(model, saved)
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
                     steps: int = 5, cfg=None, dtype=torch.bfloat16,
                     tag: str = "") -> None:
    """A fresh model of `preset` (or of the config `cfg`) in compute dtype
    `dtype`, dropout and DropPath off, `steps` steps on one fixed batch of
    16 synthetic images: the last loss is below the first. Adam's first
    step from a random init overshoots (the second loss is the largest),
    so the run needs steps enough to come back below the start: 5 for
    Swin-B-384; 12 for DINOv2-B/14, whose fifth loss still read 0.623
    against a first of 0.519 on an H100."""
    import dataclasses

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import fit_scaler
    from geovpr_torch.train.state import create_train_state
    from geovpr_torch.train.steps import make_train_step

    cfg = cfg or build_preset(preset)
    geo = isinstance(cfg, GeoposeConfig)
    size = cfg.data.image_size
    src = synthetic_val(TRAIN_BATCH, size, np.random.default_rng(SEED + 7),
                        angles=not geo)
    model = RegressionModel(dataclasses.replace(cfg.model, image_size=size),
                            dtype=dtype, train=True).to(device)
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
    phase("train_fixed_batch", preset=preset, **({"path": tag} if tag
                                                 else {}), losses=losses)
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


def cp_model(recipe: str, preset: str = ""):
    """The recipe's preset model (or `preset`'s, in the recipe's layout) as
    training builds it (f32 parameters), from seed SEED, its vectors (and
    the Swin tables) perturbed off their init, on the host."""
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.convert_reference import RECIPE_PRESETS
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel

    cfg = build_preset(preset or RECIPE_PRESETS[recipe])
    model = RegressionModel(dataclasses.replace(
        cfg.model, image_size=cfg.data.image_size),
        dtype=getattr(torch, cfg.model.compute_dtype), train=True)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 31)
    with torch.no_grad():
        (perturb_swin_ if recipe == "swin_geopose" else perturb_cnn_)(
            model, gen)
    return model


def cp_write_assets(root: str, rng, legs: dict | None = None) -> dict:
    """The parity assets directory: labels_val.csv (campus-scale (lat,
    lon), headings in [0, 360)) and JPEGs under images/; each leg's
    reference checkpoint (the Swin ones in the `model_state_dict` wrapper)
    with an .npz scaler for the geopose legs; salad/dino_salad.ckpt; the
    Swin-B-384 backbone alone as HF `SwinModel` keys. `legs` maps a leg's
    directory to its (recipe, preset), each recipe's own by default.
    Returns the models they were exported from and the files' paths, by
    leg."""
    from PIL import Image

    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.convert_reference import RECIPE_PRESETS

    legs = legs or {r: (r, RECIPE_PRESETS[r]) for r in CP_RECIPES}
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    size = max(build_preset(p).data.image_size for _, p in legs.values())
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
    for name, (recipe, preset) in legs.items():
        model = cp_model(recipe, preset)
        sd = model.state_dict()
        d = os.path.join(root, name)
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
        paths[name] = os.path.join(d, "model_best.pth")
        torch.save({"epoch": 49, "model_state_dict": ckpt}
                   if recipe == "swin_geopose" else ckpt, paths[name])
        if recipe != "efficientnet_sincos":
            np.savez(os.path.join(d, "latlon_scaler.npz"),
                     mean=np.float32([219000.0, 143000.0]),
                     scale=np.float32([300.0, 100.0]))
        if name == "swin_geopose":
            paths["swin_backbone"] = os.path.join(root, "swin_base_384.pth")
            torch.save({k[len("backbone."):]: v for k, v in ckpt.items()
                        if k.startswith("backbone.")}, paths["swin_backbone"])
        models[name] = model
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
    """Each model leg through `cli.parity`'s own leg code in this process
    on the plain path (`cp_plain_legs`): its metrics are the golden
    numbers, its CSV the plain predictions. Then the descriptor dump of the
    salad leg, served in bf16 through K1 (the leg itself runs in f32)."""
    legs = cp_legs()
    out = cp_plain_legs(root, device, {k: legs[k] for k in CP_RECIPES})
    cp_salad_dump(root, device, torch.bfloat16, True)
    return out


def cp_plain_legs(root: str, device, legs: dict) -> dict:
    """Each model leg of `legs` (name -> the leg as `cli.parity` merges
    it) through `cli.parity`'s own leg code in this process, every model's
    blocks on the plain path (`use_kernels=False`; no kernel may launch):
    its report, with the seconds it took."""
    from geovpr_torch.cli import parity

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
        for name in legs:
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
    return out


def cp_salad_dump(root: str, device, dtype, use_kernels: bool) -> None:
    """The salad leg's reference_descriptors.npz: CP_N_SALAD seeded images
    and their descriptors from the hub checkpoint, converted as the leg
    converts it, served in `dtype` on the kernel path or the plain path."""
    from geovpr_torch.cli.convert import load_state_dict
    from geovpr_torch.models import convert_torch as ct
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.salad import DinoV2Salad

    sd = load_state_dict(os.path.join(root, "salad", "dino_salad.ckpt"))
    size = cp_preset_fields("image_size")["dinov2salad_geopose"]
    model = DinoV2Salad(variant="base-14", image_size=size, dtype=dtype,
                        use_kernels=use_kernels)
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
                     "efficientnet_sincos": {},
                     "salad": {"fused_mhsa_block": DINO_BLOCKS}}
        batches["salad"] = 1        # CP_N_SALAD images, one forward
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
            # the salad leg runs in f32: its launches are the f32 forms'
            for k, v in rec["launches"].items():
                k = f"{k}.f32" if name == "salad" else k
                totals[k] = totals.get(k, 0) + v
    phase("convert_parity_seconds", child=child_s,
          total=time.perf_counter() - t_phase)
    return totals


# ------------------------------------------------------ index_1m --
# The blocked exact index at the first benchmark's size: 1,000,000 x 8448
# int8 rows built with `build_chunked` from seeded unit rows made on the
# card in chunks (one f32 chunk is 2.2 GB; the whole f32 gallery would be
# 33.8 GB), then 1,024 queries searched single-shot and in row blocks.
INDEX_ROWS, INDEX_DIM, INDEX_CHUNK = 1_000_000, 8448, 65536
INDEX_QUERIES, INDEX_K, INDEX_BLOCK = 1024, 10, 131072
INDEX_PLANTED = (17, 65535, 65536, 262_143, 500_000, 917_503, 999_999)
INDEX_REPEATS = 3


def index_1m_path(device, card: str) -> None:
    """`DescriptorIndex(quantize=True).build_chunked` over INDEX_ROWS
    seeded unit rows made on the card chunk by chunk (each normalised in
    place, the rows of INDEX_PLANTED kept aside), the build's peak memory
    above what was allocated before it at most the index plus two f32
    chunks; then INDEX_QUERIES queries (the first near-duplicates of the
    planted rows, the rest seeded unit rows), k = INDEX_K, searched
    single-shot and with db_block = INDEX_BLOCK (full blocks and a narrow
    tail): indices equal, scores bit-equal (int32 sums times the same
    scales), each planted row found at rank 1. Build seconds, search ms
    and q/s of each mode (host clock around synchronised searches)."""
    from geovpr_torch.retrieval.index import DescriptorIndex

    n, d, chunk = INDEX_ROWS, INDEX_DIM, INDEX_CHUNK
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    planted = {}

    def unit_rows(rows: int) -> torch.Tensor:
        x = torch.randn(rows, d, generator=gen, device=device)
        return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))

    def chunks():
        for start in range(0, n, chunk):
            c = unit_rows(min(chunk, n - start))
            for r in INDEX_PLANTED:
                if start <= r < start + c.shape[0]:
                    planted[r] = c[r - start].clone()
            yield c
            del c

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = DescriptorIndex(dim=d, device=device, quantize=True)
    index.build_chunked(chunks(), total=n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    index_bytes = (index._db.numel() * index._db.element_size()
                   + index._db_scale.numel() * 4)
    limit = index_bytes + 2 * chunk * d * 4
    phase("index_1m_build", card=repr(card), rows=n, dim=d, chunk=chunk,
          build_s=build_s, rows_per_s=n / build_s, index_bytes=index_bytes,
          peak_bytes=peak, limit_bytes=limit,
          f32_gallery_bytes=n * d * 4)
    check(index.size == n and index._db.shape == (n, d)
          and index._db.dtype == torch.int8,
          f"index_1m: built {tuple(index._db.shape)} {index._db.dtype}")
    check(peak <= limit, f"index_1m: the build's peak {peak} B is above "
          f"the index plus two f32 chunks ({limit} B)")

    q = unit_rows(INDEX_QUERIES)
    rows = sorted(planted)
    qgen = torch.Generator(device=device).manual_seed(SEED + 20)
    near = torch.stack([planted[r] for r in rows]) + 0.01 * torch.randn(
        len(rows), d, generator=qgen, device=device) / d ** 0.5
    q[:len(rows)] = near / torch.linalg.vector_norm(near, dim=1,
                                                    keepdim=True)
    results, times = {}, {}
    for mode, block in (("single_shot", 0), ("blocked", INDEX_BLOCK)):
        index.db_block = block
        results[mode] = index.search(q, INDEX_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INDEX_REPEATS):
            index.search(q, INDEX_K)
        torch.cuda.synchronize()
        times[mode] = (time.perf_counter() - t0) / INDEX_REPEATS * 1e3
    (s0, i0), (s1, i1) = results["single_shot"], results["blocked"]
    same_idx = torch.equal(i0, i1)
    same_scores = torch.equal(s0, s1)
    top1 = i1[:len(rows), 0].tolist()
    blocks = -(-n // INDEX_BLOCK)
    for mode, ms in times.items():
        phase("index_1m_search", card=repr(card), mode=mode,
              db_block=INDEX_BLOCK if mode == "blocked" else 0,
              blocks=blocks if mode == "blocked" else 1,
              tail_rows=n - (blocks - 1) * INDEX_BLOCK
              if mode == "blocked" else n,
              queries=INDEX_QUERIES, k=INDEX_K, ms=ms,
              queries_per_s=INDEX_QUERIES / ms * 1e3)
    phase("index_1m", indices_equal=same_idx, scores_bit_equal=same_scores,
          planted=rows, planted_top1=top1,
          planted_top1_scores=s1[:len(rows), 0].tolist())
    check(same_idx and same_scores,
          "index_1m: the blocked search differs from the single-shot one")
    check(top1 == rows, f"index_1m: planted rows {rows} found as {top1}")
    del index, q, near, results, s0, s1, i0, i1
    torch.cuda.empty_cache()


# ---------------------------------------------------- train_disk --
# Training from image files: unfrozen DINOv2-B/14 + SALAD
# (dinov2salad_frozen_mlp with model.freeze_backbone=False and
# optim.backbone_lr_scale=0.1, no preset asks for it) at 224 px and the
# preset's B=32 with remat, the decoded-image cache and asynchronous
# checkpoints, over seeded JPEGs on disk; then Swin-B-384 with and without
# remat.
DISK_IMAGES, DISK_VAL, DISK_EPOCHS = 64, 32, 2
DISK_SIZES = ((480, 360), (360, 480), (320, 320))
REMAT_SWIN_BATCH = 16
REMAT_STEPS = 3


def disk_images(root: str, n: int, rng) -> tuple:
    """n seeded JPEGs (non-square, an upsampled random colour field plus
    noise) and their (lat, lon) targets."""
    from PIL import Image

    paths = []
    for i in range(n):
        w, h = DISK_SIZES[i % len(DISK_SIZES)]
        base = Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(
            np.uint8)).resize((w, h), Image.BILINEAR)
        arr = np.asarray(base, np.float32) + rng.normal(0, 20, (h, w, 3))
        paths.append(os.path.join(root, f"d_{i:04d}.jpg"))
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            paths[-1], quality=90)
    targets = np.stack([219000.0 + rng.normal(0, 300.0, n),
                        143000.0 + rng.normal(0, 100.0, n)], 1)
    return paths, targets.astype(np.float32)


def native_decoder_probe() -> str:
    """"native", or "pil" where the native decoder cannot be built here:
    then `decoder="native"` must raise that error (`[native_decoder]`)."""
    from geovpr_torch.data.decoder import (NativeDecoderUnavailable,
                                           libjpeg_version)
    from geovpr_torch.data.pipeline import ImageFolderSource

    have = {p: os.path.exists(p) for p in (
        "/usr/include/jpeglib.h", "/usr/include/x86_64-linux-gnu/jpeglib.h")}
    try:
        version = libjpeg_version()
    except NativeDecoderUnavailable as e:
        reason = str(e).splitlines()[0]
        try:
            ImageFolderSource(paths=[], targets=np.zeros((0, 2)),
                              decoder="native")
            raised = False
        except NativeDecoderUnavailable:
            raised = True
        phase("native_decoder", state="unavailable", reason=repr(reason),
              headers=have, source_raises=raised,
              disk_path_decoder="pil (the native decoder cannot be built "
              "here)")
        check(raised, "decoder='native' did not raise where the native "
              "decoder cannot be built")
        return "pil"
    phase("native_decoder", state="available", libjpeg_version=version,
          headers=have)
    return "native"


def _disk_cfg(decoder: str, cache: str, remat: bool = True,
              async_ckpt: bool = True):
    import dataclasses

    from geovpr_torch.cli.presets import build_preset
    cfg = build_preset("dinov2salad_frozen_mlp")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, freeze_backbone=False,
                                       remat=remat),
        data=dataclasses.replace(cfg.data, decoder=decoder,
                                 cache_decoded=cache),
        optim=dataclasses.replace(cfg.optim, backbone_lr_scale=0.1),
        train=dataclasses.replace(cfg.train, async_checkpoint=async_ckpt))


def _remat_grads_equal(trainer, batch, tag: str) -> None:
    """The gradient of every parameter with the blocks recomputed and with
    them kept, at the same state and batch, the step's dropout generator
    seeded alike: bit-equal. The model's remat flags are put back."""
    from geovpr_torch.models.layers import set_rng
    from geovpr_torch.train.steps import step_generators

    st, model = trainer.state, trainer.state.model
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)
    flags = [m for m in model.modules() if hasattr(m, "remat")]
    saved = [m.remat for m in flags]
    out = {}
    for remat in (True, False):
        for m in flags:
            m.remat = remat
        model.train()
        set_rng(model, step_generators(st.seed, st.step,
                                       batch["image"].device)[1])
        try:
            loss = trainer.objective.loss(
                model(trainer._normalize(batch["image"])), enc,
                batch["mask"])
            out[remat] = (loss.detach(), torch.autograd.grad(
                loss, list(model.parameters()), allow_unused=True))
        finally:
            set_rng(model, None)
    for m, remat in zip(flags, saved):
        m.remat = remat
    names = [n for n, _ in model.named_parameters()]
    differ = [n for n, a, b in zip(names, out[True][1], out[False][1])
              if (a is None) != (b is None)
              or (a is not None and not torch.equal(a, b))]
    same_loss = torch.equal(out[True][0], out[False][0])
    phase("remat_grads", path=tag, tensors=len(names), loss_equal=same_loss,
          tensors_differ=len(differ), differ=repr(differ[:5]))
    check(same_loss and not differ,
          f"{tag}: remat gradient not bit-equal to no remat: {differ[:5]}")


def _copy_checkpoint(src: str, run_dir: str) -> str:
    import shutil
    os.makedirs(run_dir)
    shutil.copytree(src, os.path.join(run_dir, "checkpoint_0"))
    return run_dir


def train_disk_path(device, card: str) -> dict:
    """Unfrozen DINOv2-B/14 + SALAD at full width through `run_train` from
    DISK_IMAGES seeded JPEGs (DISK_VAL of them the validation source), the
    preset's B=32, DISK_EPOCHS epochs of 2 steps, with `model.remat`,
    `data.decoder="native"` (PIL where the native decoder cannot be built
    here, `[native_decoder]`), `data.cache_decoded` and asynchronous
    checkpoints: once with the cache in RAM, once in `.npy` memmaps.
    Launches a step: K8a in every block twice (the forward and the remat
    recompute), K8c in every block; K1 in every block of a validation
    batch. Checks: finite losses; the launch counts; the kernel path's
    gradient against the plain path's per tensor (cosine >= 0.999 on
    every tensor, the SALAD head's ReLUs passing the same units on both
    paths; the two SALAD parameters whose gradient is zero in exact
    arithmetic are only reported), and within GRAD_F32_RATIO of the bf16
    plain path's distance from the f32 one; the remat gradient bit-equal to the one without remat;
    each cache holding, after the run, the bytes a fresh decode gives (so
    epoch 1 read epoch 0's decodes), the decoder's images equal across two
    decodes and across the two runs; the two runs equal step for step;
    every checkpoint of the run also written synchronously at the same
    moment and equal to the asynchronous one tensor for tensor, and a
    resume from each (epoch 1 again) bit-equal. Then one Swin-B-384 step at
    B=16 with remat and without (`[remat_step]`: peak memory, ms/step)
    and their gradients bit-equal with DropPath on. Returns the launch
    counts of the runs and of the Swin steps."""
    from geovpr_torch.cli.train import run_train
    from geovpr_torch.data.decoder import decode_files
    from geovpr_torch.data.pipeline import CachedImageSource, ImageFolderSource
    from geovpr_torch.train import loop as loop_mod

    decoder = native_decoder_probe()
    t_phase = time.perf_counter()
    total = {}
    base = _disk_cfg(decoder, "")
    size, batch = base.data.image_size, base.data.batch_size
    blocks = _dino_blocks(base)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "img")
        os.makedirs(img_dir)
        paths, targets = disk_images(img_dir, DISK_IMAGES,
                                     np.random.default_rng(SEED + 21))

        def source(idx, cache_path=""):
            inner = ImageFolderSource(
                paths=[paths[i] for i in idx], targets=targets[idx],
                image_size=size, num_threads=8, decoder=decoder)
            return CachedImageSource(inner, cache_path=cache_path)

        if decoder == "native":
            a = decode_files(paths, size, size, threads=8)
            b = decode_files(paths, size, size, threads=3)
            decoded, same_decode = a[0], (np.array_equal(a[0], b[0])
                                          and a[1].all() and b[1].all())
        else:
            a = source(np.arange(DISK_IMAGES)).inner.get_batch(
                np.arange(DISK_IMAGES))["image"]
            b = source(np.arange(DISK_IMAGES)).inner.get_batch(
                np.arange(DISK_IMAGES))["image"]
            decoded, same_decode = a, np.array_equal(a, b)
        phase("decode_repeat", decoder=decoder, images=DISK_IMAGES,
              equal=same_decode)
        check(same_decode, f"{decoder} decodes differ between two runs")

        runs, caches = {}, {}
        save = loop_mod.save_checkpoint
        sync_dirs = []

        def save_both(path, state, epoch, *a, **kw):
            """The loop's save (asynchronous), and a synchronous one of the
            same state at the same moment beside it."""
            save(path, state, epoch, *a, **kw)
            twin = f"{path}.sync"
            save(twin, state, epoch, *a, **{
                k: v for k, v in kw.items()
                if k not in ("async_save", "on_saved")})
            sync_dirs.append(twin)

        for mode in ("ram", "memmap"):
            cache = "ram" if mode == "ram" else os.path.join(tmp, "cache")
            cfg = _disk_cfg(decoder, cache)
            train_src = source(np.arange(DISK_IMAGES),
                               "" if mode == "ram" else f"{cache}.train.npy")
            val_src = source(np.arange(DISK_VAL),
                             "" if mode == "ram" else f"{cache}.val.npy")
            tag = f"dinov2salad-unfrozen-{mode}"
            if mode == "ram":
                loop_mod.save_checkpoint = save_both
            try:
                trainer, launches = train_run(
                    cfg, train_src, val_src, device,
                    os.path.join(tmp, mode), DISK_EPOCHS,
                    {"fused_mhsa_train_fwd": (2 * blocks, 0),
                     "fused_mhsa_bwd_all": (blocks, 0),
                     "fused_mhsa_block": (0, blocks)}, tag)
            finally:
                loop_mod.save_checkpoint = save
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            check(not trainer._frozen_phase and set(trainer.state.opt.mu)
                  == set(dict(trainer.state.model.named_parameters())),
                  f"{tag}: the backbone is not trained")
            cached = all(np.array_equal(s._cache, decoded[:len(s)])
                         and s._have.all() for s in (train_src, val_src))
            on_disk = mode == "ram" or (
                np.array_equal(np.load(f"{cache}.train.npy"), decoded)
                and np.array_equal(np.load(f"{cache}.val.npy"),
                                   decoded[:DISK_VAL]))
            phase("train_disk_cache", path=tag, decoder=decoder,
                  cache=cache if mode == "memmap" else "ram",
                  equal_to_fresh_decode=cached, memmap_files_equal=on_disk)
            check(cached and on_disk, f"{tag}: the cache differs from a "
                  f"fresh decode")
            runs[mode] = trainer
            caches[mode] = train_src._cache
        ram, mm = runs["ram"], runs["memmap"]
        same_runs = (ram.step_losses == mm.step_losses
                     and np.array_equal(caches["ram"], caches["memmap"]))
        phase("train_disk_runs", ram=ram.step_losses, memmap=mm.step_losses,
              equal=same_runs)
        check(same_runs, "train_disk: the RAM and memmap runs differ")

        differ, compared = [], 0
        for twin in sync_dirs:
            a_dir = twin[:-len(".sync")]
            a = torch.load(os.path.join(a_dir, "state.pt"),
                           map_location="cpu", weights_only=True)
            b = torch.load(os.path.join(twin, "state.pt"),
                           map_location="cpu", weights_only=True)
            compared += _tensors_equal(a, b, os.path.basename(a_dir), differ)
        resumed = {}
        for kind, src in (("async", "checkpoint_0"),
                          ("sync", "checkpoint_0.sync")):
            rdir = _copy_checkpoint(os.path.join(ram.run_dir, src),
                                    os.path.join(tmp, f"resume_{kind}"))
            cfg = _disk_cfg(decoder, "ram")
            resumed[kind] = run_train(
                cfg, source(np.arange(DISK_IMAGES)),
                source(np.arange(DISK_VAL)), save_dir=tmp, device=device,
                epochs=DISK_EPOCHS, resume=rdir)
        last = f"checkpoint_{DISK_EPOCHS - 1}"
        rd = [_tensors_equal(*(torch.load(
            os.path.join(r.run_dir, last, "state.pt"), map_location="cpu",
            weights_only=True) for r in (resumed["async"], resumed["sync"])),
            last, differ)]
        unbroken = {e: v for e, v in ram.step_losses.items() if e > 0}
        same = (not differ and resumed["async"].step_losses
                == resumed["sync"].step_losses == unbroken)
        phase("train_disk_resume", async_dirs=len(sync_dirs),
              tensors=compared + rd[0], differ=repr(differ[:5]),
              resumed_async=resumed["async"].step_losses,
              resumed_sync=resumed["sync"].step_losses, unbroken=unbroken,
              equal=same)
        check(sync_dirs and same, "train_disk: the asynchronous checkpoint "
              f"or its resume differs from the synchronous one: "
              f"{differ[:5]}")
        tb = next(iter(_train_batches(source(np.arange(DISK_IMAGES)),
                                      device, batch)))
        train_grads_vs_plain(ram, tb, "dinov2salad-unfrozen",
                             against_f32=True, salad_masks=True)
        _remat_grads_equal(ram, tb, "dinov2salad-unfrozen")
        train_times(ram, tb, card, "dinov2salad-unfrozen-remat",
                    phase_name="remat")
        del ram, mm, runs, resumed, caches, trainer
        torch.cuda.empty_cache()
    for k, v in remat_swin_steps(device, card).items():
        total[k] = total.get(k, 0) + v
    phase("train_disk_seconds", seconds=time.perf_counter() - t_phase)
    return total


def remat_swin_steps(device, card: str) -> dict:
    """Swin-B-384 (swin_b384_gemini2 at full width, DropPath 0.1 as its
    training build, B=16) from a seeded init: REMAT_STEPS steps without
    remat and with it on one synthetic batch, peak memory and ms/step
    each (the step's launch counts set to 0 just before the remat steps
    and read just after: K9a in every block twice, K9c / K9b once); the
    peak with remat below the one without; and one batch's gradients with
    and without remat bit-equal (DropPath on, the step's generator).
    Returns the remat steps' launch counts."""
    import dataclasses
    import shutil

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import fit_scaler
    from geovpr_torch.train.loop import Trainer
    from geovpr_torch.train.state import create_train_state

    cfg = build_preset("swin_b384_gemini2")
    size, b = cfg.data.image_size, REMAT_SWIN_BATCH
    src = synthetic_val(b, size, np.random.default_rng(SEED + 22))
    batch = {"image": torch.from_numpy(src.images).to(device),
             "target": torch.from_numpy(src.targets).to(device),
             "mask": torch.ones(b, dtype=torch.bool, device=device)}
    model = RegressionModel(dataclasses.replace(cfg.model, image_size=size),
                            dtype=torch.bfloat16, train=True).to(device)
    trainer = Trainer(model=model, objective=objective_for(cfg),
                      optim_cfg=cfg.optim, train_cfg=cfg.train,
                      data_cfg=cfg.data, device=device,
                      run_dir=tempfile.mkdtemp())
    trainer.state = create_train_state(model, cfg.optim, seed=SEED,
                                       scaler=fit_scaler(src.targets))
    counters = train_counters()
    out, launches = {}, {}
    for remat in (False, True):
        model.backbone.remat = remat
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS):
            trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REMAT_STEPS * 1e3
        counts = {k: fn.launches // REMAT_STEPS for k, fn in counters.items()
                  if fn.launches}
        if remat:
            launches = {k: fn.launches for k, fn in counters.items()}
        out[remat] = (torch.cuda.max_memory_allocated(), ms)
        phase("remat_step", card=repr(card), path="swin_b384_gemini2",
              batch=b, remat=remat, peak_mem_bytes=out[remat][0],
              ms_per_step=ms, launches_per_step=counts)
    saved = (out[False][0] - out[True][0]) / max(out[False][0], 1)
    phase("remat_trade", path="swin_b384_gemini2", card=repr(card),
          peak_saved_share=saved,
          time_ratio=out[True][1] / out[False][1])
    check(out[True][0] < out[False][0],
          f"remat did not lower Swin-B-384's peak memory: {out}")
    _remat_grads_equal(trainer, batch, "swin_b384_gemini2")
    shutil.rmtree(trainer.run_dir, ignore_errors=True)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ the int8 attention modes --
#
# The two int8 attention modes besides the default (int8 q.k^T scores, bf16
# P.V), chosen by the environment variables the JAX package reads:
# GEOVPR_INT8_PV=1 (int8 P.V) and GEOVPR_INT8_QK=0 (bf16 scores).

INT8_MODE_ENV = {"int8_scores": {}, "int8_pv": {"GEOVPR_INT8_PV": "1"},
                 "bf16_scores": {"GEOVPR_INT8_QK": "0"}}
INT8_MODE_FLAGS = {"int8_scores": (True, False), "int8_pv": (True, True),
                   "bf16_scores": (False, False)}
OTHER_INT8_MODES = ("int8_pv", "bf16_scores")
# the evaluate child's validation images: one B=64 batch of Swin-B-384
MODES_N_VAL = SWIN_BATCH


@contextlib.contextmanager
def int8_mode(mode: str):
    """The int8 folds of the blocks built inside build in `mode`
    (`geovpr_torch.ops.quant.INT8_QK_SCORES`, `INT8_PV`, read when a block
    folds), restored after."""
    from geovpr_torch.ops import quant
    saved = quant.INT8_QK_SCORES, quant.INT8_PV
    quant.INT8_QK_SCORES, quant.INT8_PV = INT8_MODE_FLAGS[mode]
    try:
        yield
    finally:
        quant.INT8_QK_SCORES, quant.INT8_PV = saved


def mode_kernels(device, card: str, mode: str) -> dict:
    """K2 at the main shape and K5 at the four Swin-B-384 stages (B=64) in
    `mode`, each against its plain version under the int8 bound
    (`[kernel] name=K2.<mode>`), then timed in turns with its plain version
    and its library yardstick beside its bound (`[kernel_time]`), and its
    four launches one by one in CUDA graphs (`[kernel_time]
    name=K2.<mode>.<part>`). Returns errors and times by kernel."""
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops.mhsa import (fused_mhsa_block_int8,
                                       mhsa_block_int8_reference)

    out = {}
    b, n, d, h = MAIN_SHAPE
    name = f"K2.{mode}"
    with int8_mode(mode):
        x, k2, _ = int8_block_case(b, n, d, h, device)
    with torch.inference_mode():
        got = fused_mhsa_block_int8(x, **k2, num_heads=h)
        torch.cuda.synchronize()
        want = mhsa_block_int8_reference(x, **k2, num_heads=h)
        e = int8_errors(got, want, (k2["so_eff"] * k2["gamma"]).abs().max()
                        .item())
        tag = "B{}_N{}_D{}_H{}".format(*MAIN_SHAPE)
        phase("kernel", name=name, shape=tag, **e, max_share=INT8_MAX_SHARE)
        check(int8_within_bound(e), f"{name} error outside its bound: {e}")
        t = interleaved_ms({
            "kernel": lambda: fused_mhsa_block_int8(x, **k2, num_heads=h),
            "plain": lambda: mhsa_block_int8_reference(x, **k2, num_heads=h),
            "library": lambda: library_k2(x, **k2, num_heads=h)}, iters=10)
        out["K2"] = dict(max_abs_err=e["max_abs_err"], ms=t["kernel"][0],
                         plain_ms=t["plain"][0], library_ms=t["library"][0],
                         runs={k: v[1] for k, v in t.items()},
                         **bounds("K2", b, n, d, h, mode=mode))
        phase("kernel_time", card=repr(card), name=name, shape=tag,
              **out["K2"])
    k2_part_times(x, k2, h, card, name)
    del x, k2, got, want

    name = f"K5.{mode}"
    for shape in SWIN_ATTN_SHAPES:
        tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
        with int8_mode(mode):
            x, blk = swin_block_case(shape, device, int8=True)
        kw = k5_kwargs(blk)
        with torch.inference_mode():
            got = sb.fused_swin_attn_block_int8(x, **kw)
            torch.cuda.synchronize()
            want = sb.swin_attn_block_int8_reference(x, **kw)
            e = int8_errors(got, want, kw["so_eff"].abs().max().item())
            phase("kernel", name=name, shape=tag, **e,
                  max_share=INT8_MAX_SHARE)
            check(int8_within_bound(e),
                  f"{name} error outside its bound at {shape}: {e}")
            del got, want
            t = interleaved_ms({
                "kernel": lambda: sb.fused_swin_attn_block_int8(x, **kw),
                "plain": lambda: sb.swin_attn_block_int8_reference(x, **kw),
                "library": lambda: library_k5(x, **kw)}, iters=3)
            out[("K5", shape)] = dict(
                max_abs_err=e["max_abs_err"], ms=t["kernel"][0],
                plain_ms=t["plain"][0], library_ms=t["library"][0],
                runs={k: v[1] for k, v in t.items()},
                **swin_bounds("K5", shape, mode))
            phase("kernel_time", card=repr(card), name=name, shape=tag,
                  **out[("K5", shape)])
            bufs = sb.k5_buffers(x, mode)
            parts_split(card, name, tag, sb.K5_PARTS,
                        lambda i: sb.k5_launch_part(i, x, **kw, bufs=bufs),
                        lambda part: k5_part_bounds(part, shape, mode))
        del x, blk, kw, bufs
        torch.cuda.empty_cache()
    return out


def mode_window7_head(device, mode: str) -> None:
    """The w8a8 Swin-T-224 heading model (window 7: the attention halves
    in torch ops in `mode`, K3 in every MLP half, K6 at the boundaries),
    calibrated on a batch of 64: its kernel path against its plain path
    (`[swin_model] path=swin-t-int8.<mode>`) and its pooled features
    against the bf16 model's (`[window7_int8_vs_bf16]`)."""
    from geovpr_torch.cli.evaluate import build_model, calibrate_int8
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.data.transforms import normalize

    cfg = build_preset(ANGLE_PRESET)
    source = synthetic_val(ANGLE_BATCH, cfg.data.image_size,
                           np.random.default_rng(SEED), angles=True)
    images = torch.from_numpy(source.images).to(device)
    model, _ = angle_model(device, ANGLE_PRESET)
    state = model.state_dict()
    with int8_mode(mode):
        model8, _ = build_model(cfg, "cpu", seed=SEED, int8=True)
        model8.load_state_dict(state, strict=False)
        model8 = model8.to(device)
        calibrate_int8(model8, source, ANGLE_BATCH, device)
    folded = [m._k5 for m in model8.backbone.blocks if hasattr(m, "_k5")]
    check(bool(folded) and all(
        (f["cs"] is None) == (mode == "bf16_scores")
        and (f["cpv"] is None) == (mode != "int8_pv") for f in folded),
        f"window-7 blocks not folded in {mode}")
    pooled8 = swin_kernel_path_vs_plain_path(
        model8, images, MIN_COSINE_INT8, f"swin-t-int8.{mode}")
    with torch.inference_mode():
        pooled = model.backbone(normalize(images)).pooled.float()
    cos = torch.nn.functional.cosine_similarity(pooled8, pooled, dim=1)
    phase("window7_int8_vs_bf16", mode=mode, min_cosine=cos.min().item(),
          mean_cosine=cos.mean().item())
    del model, model8
    torch.cuda.empty_cache()


def modes_files(root: str) -> dict:
    """The CLI children's inputs under root: the [slice] gallery (N_GALLERY
    JPEGs at 224, positions 100 m apart) and its first N_QUERY images as
    the queries, and MODES_N_VAL geopose validation JPEGs at 384; returns
    the manifests' paths."""
    from PIL import Image

    gallery = synthetic_gallery(N_GALLERY, IMAGE_SIZE,
                                np.random.default_rng(SEED))
    img = os.path.join(root, "img")
    os.makedirs(img, exist_ok=True)
    out = {}
    for name, n, prefix in (("gallery", N_GALLERY, "g"),
                            ("query", N_QUERY, "q")):
        path = out[name] = os.path.join(root, f"{name}.csv")
        with open(path, "w") as f:
            f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
            for i in range(n):
                fname = f"{prefix}_{i:04d}.jpg"
                Image.fromarray(gallery.images[i]).save(
                    os.path.join(img, fname), quality=95)
                lat, lon = gallery.targets[i]
                f.write(f"{fname},0,{lat},{lon},0.0,1\n")
    out["val"] = par_images(root, "val", MODES_N_VAL, 384,
                            np.random.default_rng(SEED))
    out["image_root"] = img
    return out


def _captured(module, fn_name: str, store: dict):
    """Wrap `module.fn_name` so that the model it is called with lands in
    `store["model"]`; returns the original."""
    orig = getattr(module, fn_name)

    def wrapper(model, *a, **k):
        store["model"] = model
        return orig(model, *a, **k)

    setattr(module, fn_name, wrapper)
    return orig


def modes_retrieve(files: dict, out_dir: str, device, mode: str) -> dict:
    """`python -m geovpr_torch.cli.retrieve --int8` (DINOv2-B/14 + SALAD at
    224, the seeded gallery) through its `main`, every launch count set to
    0 just before and read just after: K2 and K3 12 a batch, the matches
    CSV; then the int8 model's kernel path against its plain path and its
    descriptors against the bf16 model's of the same seed."""
    import geovpr_torch.cli.retrieve as cli
    from geovpr_torch.data.transforms import normalize

    store = {}
    orig = _captured(cli, "run_retrieval", store)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--gallery-csv", files["gallery"], "--query-csv",
                      files["query"], "--image-root", files["image_root"],
                      "--out-dir", out_dir, "--batch-size", str(BATCH),
                      "--top-k", str(TOP_K), "--variant", VARIANT,
                      "--image-size", str(IMAGE_SIZE), "--int8",
                      "--device", device.type])
        torch.cuda.synchronize()
    finally:
        cli.run_retrieval = orig
    launches = {k: fn.launches for k, fn in counters.items()}
    model = store["model"]
    n_batches = -(-N_GALLERY // BATCH) + -(-N_QUERY // BATCH)
    per = len(model.backbone.blocks) * n_batches
    want = {"fused_mhsa_block": 0, "fused_mhsa_block_int8": per,
            "fused_mlp_block_int8": per}
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(launches == want, f"retrieve {mode}: launches {launches}, "
          f"expected {want}")
    rows = read_csv(rec["matches_csv"])
    top1 = {r["query_filename"]: r["match_filename"] for r in rows
            if r["rank"] == "1"}
    check(len(rows) == N_QUERY * TOP_K and all(
        top1[f"q_{i:04d}.jpg"] == f"g_{i:04d}.jpg" for i in range(N_QUERY)),
        f"retrieve {mode}: matches CSV")
    images = torch.from_numpy(synthetic_gallery(
        BATCH, IMAGE_SIZE, np.random.default_rng(SEED)).images).to(device)
    stats = {}
    got = kernel_path_vs_plain_path(model, images, MIN_COSINE_INT8,
                                    f"retrieve-int8.{mode}", stats)
    bf16 = cli.build_model(VARIANT, IMAGE_SIZE, device)
    bf16.load_state_dict(model.state_dict(), strict=False)
    with torch.inference_mode():
        ref = bf16(normalize(images)).pooled.float()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
    del model, bf16
    torch.cuda.empty_cache()
    return dict(launches=launches, recall_at_1=rec["recall@1"],
                csv_rows=len(rows), kernel_vs_plain_min=stats["min_cosine"],
                int8_vs_bf16_min=cos.min().item(),
                int8_vs_bf16_mean=cos.mean().item())


def modes_evaluate(files: dict, out_dir: str, device, mode: str) -> dict:
    """`python -m geovpr_torch.cli.evaluate --int8` on swin_b384_gemini2
    (Swin-B-384 + MLP head) through its `main`, every launch count set to
    0 just before and read just after: K5 and K3 24 a batch, K6 3, the
    validation CSV; then the int8 model's kernel path against its plain
    path and its pooled features against the bf16 model's of the same
    seed."""
    import geovpr_torch.cli.evaluate as cli
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.data.transforms import normalize

    store = {}
    orig = _captured(cli, "run_evaluate", store)
    counters = {**kernel_counters(), **swin_counters()}
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--preset", SWIN_PRESET, "--val-csv", files["val"],
                      "--image-root", files["image_root"],
                      "--out-dir", out_dir, "--batch-size", str(SWIN_BATCH),
                      "--int8", "--device", device.type])
        torch.cuda.synchronize()
    finally:
        cli.run_evaluate = orig
    launches = {k: fn.launches for k, fn in counters.items()}
    model = store["model"]
    n_batches = -(-MODES_N_VAL // SWIN_BATCH)
    want = dict.fromkeys(counters, 0)
    want.update(fused_swin_attn_block_int8=SWIN_BLOCKS * n_batches,
                fused_mlp_block_int8=SWIN_BLOCKS * n_batches,
                fused_patch_merge=SWIN_BOUNDARIES * n_batches)
    check(launches == want, f"evaluate {mode}: launches {launches}, "
          f"expected {want}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = read_csv(rec["validation_csv"])
    check(len(rows) == MODES_N_VAL and all(np.isfinite(v) for v in
                                           rec["metrics"].values()),
          f"evaluate {mode}: {len(rows)} CSV rows, {rec['metrics']}")
    source = synthetic_val(SWIN_BATCH, 384, np.random.default_rng(SEED))
    images = torch.from_numpy(source.images).to(device)
    stats = {}
    got = swin_kernel_path_vs_plain_path(model, images, MIN_COSINE_INT8,
                                         f"swin-int8.{mode}", stats)
    bf16, _ = cli.build_model(build_preset(SWIN_PRESET), device)
    bf16.load_state_dict(model.state_dict(), strict=False)
    with torch.inference_mode():
        ref = bf16.backbone(normalize(images)).pooled.float()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
    del model, bf16
    torch.cuda.empty_cache()
    return dict(launches=launches, csv_rows=len(rows),
                kernel_vs_plain_min=stats["min_cosine"],
                int8_vs_bf16_min=cos.min().item(),
                int8_vs_bf16_mean=cos.mean().item())


def modes_record(spec: dict, device) -> dict:
    """What a child of the [int8_modes] phase reports: the mode flags the
    environment gave it, then `modes_retrieve` and `modes_evaluate`."""
    from geovpr_torch.ops import quant

    mode = spec["mode"]
    flags = (quant.INT8_QK_SCORES, quant.INT8_PV)
    check(flags == INT8_MODE_FLAGS[mode],
          f"{mode}: the environment gave the flags {flags}")
    return {"mode": mode, "flags": list(flags),
            "retrieve": modes_retrieve(spec["files"], os.path.join(
                spec["out"], "retrieve"), device, mode),
            "evaluate": modes_evaluate(spec["files"], os.path.join(
                spec["out"], "evaluate"), device, mode)}


def modes_child(spec_path: str) -> int:
    """A child of the [int8_modes] phase, started with the mode's
    environment variable set: `modes_record` on the card, one
    `[modes_child]` JSON line."""
    from geovpr_torch.ops._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    with open(spec_path) as f:
        spec = json.load(f)
    rec = modes_record(spec, torch.device("cuda"))
    print("[modes_child] " + json.dumps(rec), flush=True)
    return 0


def modes_run_child(spec_path: str, env: dict) -> dict:
    """Run this script as a child with `--modes-child spec_path` and the
    mode's environment variables `env` (and neither of the two where `env`
    does not set it); pass its model lines on and return its record. A
    failed child fails the phase."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--modes-child",
         spec_path], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**{k: v for k, v in os.environ.items()
                if k not in ("GEOVPR_INT8_QK", "GEOVPR_INT8_PV")}, **env})
    for line in proc.stdout.splitlines():
        if line.startswith(("[model]", "[swin_model]")):
            print(line, flush=True)
    check(proc.returncode == 0, f"int8 modes child {spec_path} exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("[modes_child] ")][-1]


def int8_modes_path(device, card: str) -> dict:
    """The [int8_modes] phase: for int8 P.V and bf16 scores, K2 and K5
    against their plain versions and timed (`mode_kernels`) and the w8a8
    window-7 Swin-T-224 head (`mode_window7_head`); then, in each of the
    three modes, a child process with the mode's environment variable set
    runs `cli.retrieve --int8` and `cli.evaluate --int8` (`modes_child`),
    and the int8-against-bf16 cosines of the three modes are printed side
    by side (`[int8_modes]`). Returns, for the kernels line, each new
    mode's errors, times and launches."""
    out = {}
    for mode in OTHER_INT8_MODES:
        out[mode] = mode_kernels(device, card, mode)
        mode_window7_head(device, mode)
    with tempfile.TemporaryDirectory() as root:
        files = modes_files(root)
        recs = {}
        for mode, env in INT8_MODE_ENV.items():
            spec = os.path.join(root, f"{mode}.json")
            with open(spec, "w") as f:
                json.dump({"mode": mode, "files": files,
                           "out": os.path.join(root, mode)}, f)
            recs[mode] = modes_run_child(spec, env)
    for path in ("retrieve", "evaluate"):
        phase("int8_modes", path=path, env=repr(
            {m: INT8_MODE_ENV[m] for m in recs}), **{
            f"{m}_{k}": v for m, r in recs.items()
            for k, v in r[path].items() if k != "launches"})
    for mode in OTHER_INT8_MODES:
        out[mode]["launches"] = {
            "K2": recs[mode]["retrieve"]["launches"]["fused_mhsa_block_int8"],
            "K5": recs[mode]["evaluate"]["launches"][
                "fused_swin_attn_block_int8"]}
    return out


# ---------------------------------------------------------- f32_serving --
# The f32 forms of the serving kernels (`csrc/f32_serving.cu`), which a
# model built with compute_dtype="float32" runs (`cli.parity`'s legs): K1
# at DINOv2-B/14's shape, K4 at the four Swin-B-384 stages and K6 at its
# three boundaries, K7's raster mode at the four Swin-T-224 stages (B=64),
# each against its plain f32 version with TF32 off. The error is the
# branch's: |(kernel - x) - (plain - x)| / |plain - x| in the 2-norm (x the
# residual of K1 and K4; K6 and K7 have none), within F32_BRANCH_REL; the
# plain version with TF32 on (a single-pass TF32 product) is measured
# beside it. Then the three models
# in f32, kernel path against plain path (cosine per row at least
# F32_MIN_COSINE), and `cli.parity` in a child on seeded reference-layout
# checkpoints. The bound's f32 peak is the CUDA cores': 2 x F32_LANES x the
# SM clock `nvidia-smi` reports as the card's maximum.
F32_BRANCH_REL = 1e-5
F32_MIN_COSINE = 0.99999
# K1.f32 at DINOv2-B/14's shape, whose attention keeps its score rows on
# chip, and at a long sequence (518 px), which takes the streamed route
# (`mhsa.k1_f32_attention_route`)
F32_K1_SHAPES = (MAIN_SHAPE, (2, 1370, 768, 12))
# the attention-sink case: the sink key's index, and its and the queries'
# common component (the first head dim), so that every row's score of the
# sink, 10 x 96 / 8 = 120 (+- 1), exceeds its other scores (~ N(0, 1.6))
# by more than e^x's f32 range (88.7)
F32_SINK_KEY = 200
F32_SINK_Q, F32_SINK_K = 10.0, 96.0
F32_LANES = 132 * 128            # the H100 SXM's FFMA lanes
F32_TIME_ITERS = 10
# launches a batch of each checked shape on the main paths: K1 a DINOv2-B/14
# layer, K4 a Swin-B-384 block of the stage (2, 2, 18, 2), K6 a boundary,
# K7 a Swin-T-224 block of the stage (2, 2, 6, 2)
F32_PER_BATCH = {("K1", MAIN_SHAPE): 12,
                 **{("K4", s): n for s, n in zip(SWIN_ATTN_SHAPES,
                                                 (2, 2, 18, 2))},
                 **{("K6", s): 1 for s in SWIN_MERGE_SHAPES},
                 **{("K7", s): n for s, n in zip(K7_RASTER_SHAPES,
                                                 SWIN_T_DEPTHS)}}
# the [f32_serving] parity legs: directory -> (recipe, preset); the salad
# hub checkpoint comes with dinov2salad_geopose's
F32_SWIN_T_LEG = "swin_t_angle"
F32_ASSET_LEGS = {"swin_geopose": ("swin_geopose", SWIN_PRESET),
                  "dinov2salad_geopose": ("dinov2salad_geopose",
                                          "dinov2salad_frozen_mlp"),
                  F32_SWIN_T_LEG: ("swin_geopose", ANGLE_PRESET)}


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def f32_peak(sm_mhz: float) -> float:
    """The card's f32 rate outside the tensor cores: one FFMA (two
    operations) a lane a clock."""
    return 2 * F32_LANES * sm_mhz * 1e6


def f32_bounds(kind: str, shape, peak: float) -> dict:
    """The least time of one f32 call: operations at `peak` (JAX's
    CostEstimate formulas, `pallas_mhsa.py:1083-1086`,
    `pallas_swin_block.py:1096-1099`, `pallas_patch_merge.py:160-161`,
    `pallas_window_attention.py:173-174`) against the bytes (each input
    read once, each output written once, 4 bytes a value) at 3.35 TB/s.
    K1 at (B, N, D, H); K4 and K7 (raster) at (B, C, H, S, w, shift); K6
    at (B, C, S)."""
    if kind == "K6":
        b, c, res = shape
        m2 = b * (res // 2) ** 2
        ops = 2 * m2 * 4 * c * 2 * c
        values = b * res * res * c + m2 * 2 * c + 8 * c * c + 8 * c
    elif kind == "K1":
        b, n, d, h = shape
        ops = 2 * b * n * d * 4 * d + 4 * b * h * n * n * (d // h)
        values = 2 * b * n * d + 4 * d * d + 7 * d
    else:
        b, c, h, res, win, _ = shape
        m, n = b * res * res, win * win
        att = 4 * (m // n) * h * n * n * (c // h)
        table = (2 * win - 1) ** 2 * h
        if kind == "K4":
            ops = 8 * m * c * c + att
            values = 2 * m * c + 4 * c * c + 6 * c + table
        else:
            ops = att
            values = 4 * m * c + table
    return dict(part_bound(ops, peak, 4 * values), bytes=4 * values)


# each f32 form's launch-by-launch bounds: the bf16 formulas at the f32
# peak, 4 bytes a value
F32_PART_BOUNDS = {
    "K1": lambda part, s, peak: k1_part_bounds(part, *s, peak=peak,
                                               width=4),
    "K4": lambda part, s, peak: k4_part_bounds(part, s, peak, 4),
    "K6": lambda part, s, peak: k6_part_bounds(part, s, peak, 4)}


def f32_k1_case(shape, device, seed=SEED):
    """K1's arguments in f32 at (B, N, D, H), drawn as `block_inputs`
    draws them (x at K1_X_SCALE), never rounded to bf16."""
    b, n, d, h = shape
    gen = torch.Generator().manual_seed(seed + n)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(device)

    return (r(b, n, d, scale=K1_X_SCALE), r(d, scale=0.1) + 1,
            r(d, scale=0.1), r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
            r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, scale=0.5), h)


def f32_branch_error(got, want, x=None) -> dict:
    """The f32 check's measure: the branch's relative error in the 2-norm
    (the branch is out - x where the kernel adds a residual x), and the
    largest |kernel - plain|, in f64."""
    g, w = got.double(), want.double()
    base = w if x is None else w - x.double()
    return dict(finite=bool(torch.isfinite(got).all()),
                branch_rel_err=((g - w).norm() / base.norm()).item(),
                max_abs_err=(g - w).abs().max().item(),
                bound=F32_BRANCH_REL)


def f32_cases(device, k1=F32_K1_SHAPES, k4=SWIN_ATTN_SHAPES,
              k6=SWIN_MERGE_SHAPES, k7=K7_RASTER_SHAPES):
    """(kind, shape, kernel, plain, library, args, residual, parts) for each
    checked shape, built one at a time: the f32 wrappers, their plain
    versions, their library yardsticks (f32 torch ops; K7's SDPA on the
    windows gathered outside the call), and the launch-by-launch entry."""
    import torch.nn.functional as F

    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import patch_merge as pm
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops import window_attention as wa

    for shape in k1:
        args = f32_k1_case(shape, device)
        got, bufs = mh._check(*args), f32_bufs(args[0], "K1")
        yield ("K1", shape, mh.fused_mhsa_block, mh.mhsa_block_reference,
               library_k1, args, args[0],
               (mh.K1_PARTS, lambda i, a=args, g=got, b=bufs:
                mh.k1_launch_part(i, a[0], g, a[-1], 1e-6, b)))
        del args, got, bufs
    for shape in k4:
        x, blk = swin_block_case(shape, device, x_scale=K1_X_SCALE,
                                 dtype=torch.float32)
        args, bufs = k4_args(x, blk), f32_bufs(x, "K4")
        yield ("K4", shape, sb.fused_swin_attn_block,
               sb.swin_attn_block_reference, library_k4, args, x,
               (sb.K4_PARTS, lambda i, a=args, b=bufs: sb.k4_launch_part(
                   i, *a, bufs=b)))
        del x, blk, args, bufs
    for shape in k6:
        args = merge_case(shape, device, dtype=torch.float32)
        bufs = f32_bufs(args[0], "K6")
        yield ("K6", shape, pm.fused_patch_merge, pm.patch_merge_reference,
               library_k6, args, None,
               (pm.K6_PARTS, lambda i, a=args, b=bufs: pm.k6_launch_part(
                   i, *a, bufs=b)))
        del args, bufs
    for shape in k7:
        args = k7_raster_case(shape, device, dtype=torch.float32)
        qkv, table, h, res, win, shift = args
        q, k, v = (t.contiguous() for t in
                   wa._windows_qkv(qkv, res, win, shift, h))
        mask = library_k7_mask(
            wa.relative_position_bias(table, win).contiguous(),
            wa.shift_mask(res, win, shift, device), q.shape[0],
            torch.float32)
        yield ("K7", shape, wa.window_attention_raster,
               wa.window_attention_raster_reference,
               lambda *_, q=q, k=k, v=v, m=mask:
               F.scaled_dot_product_attention(q, k, v, attn_mask=m),
               args, None, None)
        del args, qkv, q, k, v, mask
        torch.cuda.empty_cache()


def f32_sink_qkv(shape, device, seed=SEED):
    """K1.f32's qkv (B, N, 3D) at (B, N, D, H) with an attention sink:
    q, k, v drawn N(0, 1), then every query's first head dim set to
    F32_SINK_Q and the sink key's (F32_SINK_KEY, or the last key) to
    F32_SINK_K in every head, so that its score exceeds each row's others
    by more than 88.7: a softmax whose max is not the row's own overflows
    e^x there."""
    b, n, d, h = shape
    gen = torch.Generator().manual_seed(seed + 3 * n)
    qkv = torch.randn(b, n, 3 * d, generator=gen)
    heads = qkv.view(b, n, 3, h, d // h)
    heads[:, :, 0, :, 0] = F32_SINK_Q
    heads[:, min(F32_SINK_KEY, n - 1), 1, :, 0] = F32_SINK_K
    return qkv.to(device)


def k1_attention_reference(qkv, h: int):
    """The plain f32 attention of K1's launch 2: ctx (B, N, D) =
    softmax(q k^T dh^-0.5) v on the heads of qkv (B, N, 3D)."""
    from geovpr_torch.ops import mhsa as mh
    b, n, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (mh._heads(t, h) for t in qkv.split(d, dim=-1))
    p = torch.softmax(mh._mm(q, k.transpose(-1, -2)) * (d // h) ** -0.5, -1)
    return mh._unheads(mh._mm(p, v)).reshape(b, n, d)


def f32_k1_sink_check(args, shape, tag: str) -> dict:
    """K1.f32's attention launch alone (`k1_launch_part`) on
    `f32_sink_qkv` against `k1_attention_reference`, within
    F32_BRANCH_REL (`[kernel] name=K1.f32.attention_sink`)."""
    from geovpr_torch.ops import mhsa as mh
    x, h = args[0], args[-1]
    qkv = f32_sink_qkv(shape, x.device)
    bufs = (qkv, torch.empty_like(x), torch.empty_like(x))
    with torch.inference_mode():
        mh.k1_launch_part(2, x, mh._check(*args), h, 1e-6, bufs)
        torch.cuda.synchronize()
        e = f32_branch_error(bufs[1], k1_attention_reference(qkv, h))
    phase("kernel", name="K1.f32.attention_sink", shape=tag,
          route=mh.k1_f32_attention_route(shape[1]), **e)
    check(e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL,
          f"K1.f32's attention outside its bound on a sink at {shape}: {e}")
    return e


def f32_bufs(x, kind: str) -> tuple:
    """The buffers K1's, K4's or K6's launches run on one by one on x:
    (qkv, ctx, out), K6's (LN(merged), out)."""
    if kind == "K6":
        b, l, c = x.shape
        return x.new_empty(b, l // 4, 4 * c), x.new_empty(b, l // 4, 2 * c)
    b, n, d = x.shape
    return (x.new_empty(b, n, 3 * d), x.new_empty(b, n, d),
            x.new_empty(b, n, d))


def f32_kernels_vs_plain(device, card: str | None = None, **shapes) -> dict:
    """Part 1 of [f32_serving]: each f32 kernel against its plain version
    (`[kernel] name=K1.f32` ..., `f32_branch_error` within F32_BRANCH_REL);
    with `card`, each also timed in CUDA graphs in turns with its plain
    version and its library yardstick beside its bound (`[kernel_time]`)
    and K1's, K4's and K6's launches one by one (`[kernel_split]`).
    `shapes` (k1=, k4=, k6=, k7=) narrows the shapes, as chip_faults.py
    does. K1 also through the attention route its N names
    (`K1_F32_ROUTE_LAUNCHES`) and on an attention sink
    (`f32_k1_sink_check`). Returns each shape's error and times."""
    from geovpr_torch.ops import mhsa as mh

    peak = f32_peak(max_sm_clock_mhz()) if card else None
    out = {}
    for kind, shape, kernel, plain, library, args, x, parts in f32_cases(
            device, **shapes):
        tag = "_".join(map(str, shape))
        route = mh.k1_f32_attention_route(shape[1]) if kind == "K1" else None
        with torch.inference_mode():
            before = kernel.launches
            routed = mh.K1_F32_ROUTE_LAUNCHES.get(route, 0)
            got = kernel(*args)
            torch.cuda.synchronize()
            check(kernel.launches == before + 1,
                  f"{kind}.f32 did not launch at {shape}")
            check(route is None or
                  mh.K1_F32_ROUTE_LAUNCHES[route] == routed + 1,
                  f"K1.f32's attention did not take its {route} route at "
                  f"{shape}")
            want = plain(*args)
            e = f32_branch_error(got, want, x)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                e["tf32_plain_branch_rel_err"] = f32_branch_error(
                    plain(*args), want, x)["branch_rel_err"]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            del got, want
        phase("kernel", name=f"{kind}.f32", shape=tag, route=route, **e)
        check(e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL,
              f"{kind}.f32 error outside its bound at {shape}: {e}")
        if kind == "K1":
            f32_k1_sink_check(args, shape, tag)
        row = dict(max_abs_err=e["max_abs_err"],
                   branch_rel_err=e["branch_rel_err"])
        if card:
            with torch.inference_mode():
                t = interleaved_graph_ms({
                    "kernel": lambda: kernel(*args),
                    "plain": lambda: plain(*args),
                    "library": lambda: library(*args)}, F32_TIME_ITERS)
            row.update(ms=t["kernel"][0], plain_ms=t["plain"][0],
                       library_ms=t["library"][0],
                       runs={k: v[1] for k, v in t.items()},
                       **f32_bounds(kind, shape, peak))
            phase("kernel_time", card=repr(card), name=f"{kind}.f32",
                  shape=tag, timed="cuda_graph", peak_f32=peak,
                  launches_per_batch=F32_PER_BATCH.get((kind, shape)),
                  **row)
            if parts:
                with torch.inference_mode():
                    parts_split(card, f"{kind}.f32", tag, parts[0],
                                parts[1], lambda part, k=kind, s=shape:
                                F32_PART_BOUNDS[k](part, s, peak))
            torch.cuda.synchronize()
        out[(kind, shape)] = row
        del args, x, parts
    torch.cuda.empty_cache()
    return out


def f32_model_cases():
    """The [f32_serving] models: (path, preset, the launches a batch of
    SWIN_BATCH images makes)."""
    return (("swin-b-384-f32", SWIN_PRESET,
             {"fused_swin_attn_block": SWIN_BLOCKS,
              "fused_patch_merge": SWIN_BOUNDARIES}),
            ("swin-t-224-f32", ANGLE_PRESET,
             {"window_attention_raster": SWIN_T_BLOCKS,
              "fused_patch_merge": SWIN_BOUNDARIES}))


def f32_models(device) -> dict:
    """Part 2 of [f32_serving]: Swin-B-384 geopose (swin_b384_gemini2: K4,
    K6), Swin-T-224 heading (swin_t224_sincos_gemini: K7's raster mode, K6)
    and DINOv2-B/14 + SALAD (K1) built with compute_dtype="float32" from
    seed 0, on 64 seeded images: the kernel path against the plain path on
    the same weights (pooled features, predictions, descriptors: cosine at
    least F32_MIN_COSINE a row), every launch count set to 0 just before
    the kernel path and read just after (`[f32_model]`). Returns the
    launches by counter."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.salad import DinoV2Salad

    counters = {**kernel_counters(), **swin_counters()}
    totals = {}

    def run(path, want, compare):
        for fn in counters.values():
            fn.launches = 0
        compare()
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items() if fn.launches}
        phase("f32_model", path=path, batch=SWIN_BATCH, launches=got,
              expected_launches=want)
        check(got == want, f"{path}: launches {got}, expected {want}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v

    for path, preset, want in f32_model_cases():
        cfg = build_preset(preset)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32"))
        model, _ = build_model(cfg, "cpu", seed=SEED)
        perturb_swin_(model, torch.Generator().manual_seed(SEED))
        model = model.to(device)
        images = torch.from_numpy(synthetic_val(
            SWIN_BATCH, cfg.data.image_size, np.random.default_rng(SEED))
            .images).to(device)
        run(path, want, lambda: swin_kernel_path_vs_plain_path(
            model, images, F32_MIN_COSINE, path))
        del model, images
        torch.cuda.empty_cache()

    model = DinoV2Salad(variant=VARIANT, image_size=IMAGE_SIZE,
                        dtype=torch.float32)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(device).eval()
    images = torch.from_numpy(synthetic_gallery(
        BATCH, IMAGE_SIZE, np.random.default_rng(SEED)).images).to(device)
    run("dinov2-b14-salad-f32", {"fused_mhsa_block": DINO_BLOCKS},
        lambda: kernel_path_vs_plain_path(model, images, F32_MIN_COSINE,
                                          "dinov2-b14-salad-f32"))
    del model, images
    torch.cuda.empty_cache()
    return totals


def f32_parity_legs() -> dict:
    """parity_config.json's legs of [f32_serving], goldens to be filled:
    swin_geopose at compute_dtype float32; a Swin-T-224 heading leg on the
    swin_geopose recipe's layout (HF `SwinModel` + regressor.{0,3}) at
    depths 2, 2, 6, 2, at float32; the salad leg, f32 by itself."""
    from geovpr_torch.models.swin import SWIN_VARIANTS

    f32 = {"compute_dtype": "float32"}
    return {"swin_geopose": {"scaler": "latlon_scaler.npz",
                             "model_overrides": f32},
            F32_SWIN_T_LEG: {
                "recipe": "swin_geopose", "preset": ANGLE_PRESET,
                "checkpoint": "model_best.pth", "kind": "angle",
                "golden": {"maae": 0.0}, "model_overrides": f32,
                "convert_overrides": {"depths": list(
                    SWIN_VARIANTS["tiny-224"]["depths"])}},
            "salad": {"golden": {"descriptor_cosine_min": F32_MIN_COSINE}}}


def f32_parity(device, card: str) -> dict:
    """Part 3 of [f32_serving]: seeded reference-layout checkpoints of the
    legs of `f32_parity_legs` (`cp_write_assets`), their goldens from the
    plain path in f32 on the same weights (`cp_plain_legs`; the salad dump
    from the plain path in f32), then `cli.parity` leg by leg in a child
    process (`cp_child`): each leg passes by the CLI's own rule, its
    predictions (or descriptors) against the plain path's have cosine at
    least F32_MIN_COSINE, and K4 24 and K6 3 a batch (swin_geopose), K7 12
    and K6 3 (the Swin-T-224 leg), K1 12 (salad) launch
    (`[f32_parity]`). Returns the child's launches by counter."""
    from geovpr_torch.cli.parity import DEFAULT_LEGS
    from geovpr_torch.cli.presets import build_preset

    legs = f32_parity_legs()
    merged = {k: {**DEFAULT_LEGS.get(k, {}), **v} for k, v in legs.items()}
    sizes = {k: build_preset(merged[k]["preset"]).data.batch_size
             for k in ("swin_geopose", F32_SWIN_T_LEG)}
    per_batch = {"swin_geopose": {"fused_swin_attn_block": SWIN_BLOCKS,
                                  "fused_patch_merge": SWIN_BOUNDARIES},
                 F32_SWIN_T_LEG: {"window_attention_raster": SWIN_T_BLOCKS,
                                  "fused_patch_merge": SWIN_BOUNDARIES},
                 "salad": {"fused_mhsa_block": DINO_BLOCKS}}
    totals = {}
    with tempfile.TemporaryDirectory() as root:
        cp_write_assets(root, np.random.default_rng(SEED + 43),
                        F32_ASSET_LEGS)
        model_legs = ("swin_geopose", F32_SWIN_T_LEG)
        goldens = cp_plain_legs(root, device,
                                {k: merged[k] for k in model_legs})
        cp_salad_dump(root, device, torch.float32, False)
        for name in model_legs:
            legs[name]["golden"] = {k: goldens[name]["metrics"][k]
                                    for k in merged[name]["golden"]}
        with open(os.path.join(root, "parity_config.json"), "w") as f:
            json.dump({"legs": legs}, f)
        jobs = [{"cli": "parity", "tag": name, "argv": [
            "--assets", root, "--legs", name, "--device", device.type,
            "--out", os.path.join(root, f"report_{name}.json")]}
            for name in legs]
        spec = os.path.join(root, "f32_jobs.json")
        with open(spec, "w") as f:
            json.dump({"jobs": jobs}, f)
        stdout = cp_run([os.path.abspath(__file__), "--convert-parity-child",
                         spec], "f32_serving parity child")
        recs = {r["tag"]: r for line in stdout.splitlines()
                if line.startswith("[cp_child] ")
                for r in json.loads(line.split(" ", 1)[1])}
        check(set(recs) == set(legs), f"f32 parity records: {sorted(recs)}")
        for name in legs:
            rec = recs[name]
            with open(os.path.join(root, f"report_{name}.json")) as f:
                leg = json.load(f)["legs"][name]
            batches = 1 if name == "salad" else -(-CP_N_VAL // sizes[name])
            exp = {k: v * batches for k, v in per_batch[name].items()}
            fields = dict(leg=name, status=leg["status"],
                          metrics=leg.get("metrics"),
                          verdicts=leg.get("verdicts"),
                          n_images=leg.get("n_images"),
                          launches=rec["launches"], expected_launches=exp,
                          seconds=rec["seconds"], bound=F32_MIN_COSINE)
            ok = leg["status"] == "pass" and rec["launches"] == exp
            if name == "salad":
                cos = leg["metrics"]["descriptor_cosine_min"]
            else:
                kind = merged[name]["kind"]
                scaler = ((np.float32([219000.0, 143000.0]),
                           np.float32([300.0, 100.0]))
                          if kind == "geopose" else None)
                a = _csv_predictions(leg["validation_csv"], kind, scaler)
                b = _csv_predictions(goldens[name]["validation_csv"], kind,
                                     scaler)
                cos = float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                                * np.linalg.norm(b, axis=1)))
                            .min())
                fields.update(golden_seconds=goldens[name]["seconds"],
                              max_abs_diff=float(np.abs(a - b).max()))
                ok &= bool(np.isfinite(a).all())
            fields["kernel_vs_plain_min_cosine"] = cos
            phase("f32_parity", card=repr(card), **fields)
            check(ok and cos >= F32_MIN_COSINE,
                  f"f32 parity leg {name}: {fields}")
            for k, v in rec["launches"].items():
                totals[k] = totals.get(k, 0) + v
    return totals


def f32_serving_path(device, card: str) -> dict:
    """The [f32_serving] phase: the f32 kernels against their plain
    versions and timed (`f32_kernels_vs_plain`), the three models in f32
    (`f32_models`) and `cli.parity` on f32 legs (`f32_parity`). Returns,
    for the kernels line, the kernels' errors and times by (kind, shape)
    and the launches of the models and the parity child (`launches`, by
    counter)."""
    t0 = time.perf_counter()
    out = f32_kernels_vs_plain(device, card)
    launches = f32_models(device)
    for k, v in f32_parity(device, card).items():
        launches[k] = launches.get(k, 0) + v
    phase("f32_serving", launches=launches,
          seconds=time.perf_counter() - t0)
    out["launches"] = launches
    return out


# ---------------------------------------------------------- f32_training --
# The f32 forms of DINOv2's training kernels, which a DINOv2 built with
# compute_dtype="float32" trains on: K8a.f32 (K1's f32 launches, keeping
# qkv and ctx), K8b.f32 and K8c.f32 (`csrc/f32_train.cu`), each against its
# plain f32 version with TF32 off: every output's relative error in the
# 2-norm within F32_BRANCH_REL (out's as the branch out - x). A near-
# cancelling column sum (F32_COLSUM_OUTS) that misses it is held instead to
# F32_COLSUM_SLACK x the f32 plain version's own error against an f64
# evaluation. K8a at DINOv2-B/14's training shape (B=16), K8b there and at
# large-14's (D = 1024, where `bwd_all_ok` fails and the split route runs
# it), K8c at base-14's, whole and launch by launch. Then `run_train` on
# the F32_TRAIN_CASES paths.
F32_K8A_SHAPES = (K8_MAIN,)
F32_K8B_SHAPES = (K8_SHAPES[1], K8_MAIN)
F32_K8C_SHAPES = (K8_MAIN,)
F32_COLSUM_OUTS = ("dbqkv", "dbo", "dgamma", "dls", "dlb", "dbias")
F32_COLSUM_SLACK = 2.0
# f32 training at full width and depth, cut in data and epochs: (path,
# preset, variant, batch, training images, validation images, unfrozen
# SALAD backbone under model.remat). Launches a step: K8a in every block
# (twice under remat: the forward and the recompute) and K8c, or K8b where
# `bwd_all_ok` fails (large-14); K1 in every block of a validation batch.
F32_TRAIN_CASES = (
    ("dinov2-b14-f32", "dinov2_meanpool_huber", "base-14", 16, 32, 16,
     False),
    ("dinov2-l14-f32", "dinov2_meanpool_huber", "large-14", 16, 32, 16,
     False),
    ("dinov2salad-unfrozen-remat-f32", "dinov2salad_frozen_mlp", "base-14",
     32, 64, 32, True))
F32_TRAIN_EPOCHS = 2
F32_FALL_STEPS = 12
# launches a training step of each checked shape on those paths: K8a and
# K8c in each of DINOv2-B/14's 12 blocks, K8b in each of -L/14's 24 (none
# at base-14, where K8c runs)
F32_PER_STEP = {("K8a", K8_MAIN): 12, ("K8c", K8_MAIN): 12,
                ("K8b", K8_SHAPES[1]): 24, ("K8b", K8_MAIN): 0}
# a roundoff-only gradient (the key bias, ROUNDOFF_GRADS) over the norm of
# its tensor's real part (the query and value biases) or of
# score_fc2.weight's gradient, at most
F32_ROUNDOFF_REL = 1e-3


def f32_train_bounds(kind: str, shape, peak: float) -> dict:
    """The least time of one f32 K8 call at (B, N, D, H), counted as the
    bf16 rows count it (`k8_bounds`) with 4 bytes a value: operations at
    `peak` (K8a 8 M D^2 + two N x N x dh products a head; K8b the five
    such products of the core backward; K8c those and 18 M D^2 of
    products) against the bytes at 3.35 TB/s."""
    b, n, d, h = shape
    m = b * n
    att = 2 * b * h * n * n * (d // h)
    if kind == "K8a":
        ops = 8 * m * d * d + 2 * att
        values = m * d + 4 * d * d + 7 * d + 5 * m * d
    elif kind == "K8b":
        ops = 5 * att
        values = 7 * m * d
    else:
        ops = 5 * att + 18 * m * d * d
        values = 7 * m * d + 4 * d * d + 4 * d + 4 * d * d + 7 * d
    return dict(part_bound(ops, peak, 4 * values), bytes=4 * values)


def k8_f64_grads(x, ls, lb, wqkv, bqkv, wo, bo, gamma, g, h) -> dict:
    """The half-block's gradients (K8_OUTS) in f64 by autograd of its
    forward written out in f64, from the f32 inputs: the f64 evaluation
    that a near-cancelling column sum is measured against."""
    leaves = [t.detach().double().requires_grad_() for t in
              (x, ls, lb, wqkv, bqkv, wo, bo, gamma)]
    xx, s, bb, wq, bq, w_o, b_o, gm = leaves
    b, n, d = x.shape
    with torch.enable_grad():
        mu = xx.mean(-1, keepdim=True)
        var = ((xx - mu) ** 2).mean(-1, keepdim=True)
        qkv = ((xx - mu) / torch.sqrt(var + 1e-6) * s + bb) @ wq + bq
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        p = torch.softmax(q @ k.transpose(-1, -2) * (d // h) ** -0.5, -1)
        ctx = (p @ v).transpose(1, 2).reshape(b, n, d)
        out = (ctx @ w_o + b_o) * gm + xx
        grads = torch.autograd.grad(out, leaves, g.double())
    return dict(zip(K8_OUTS, grads))


def f32_train_error(name: str, tag: str, out: str, got, want,
                    ref64=None) -> dict:
    """One f32 training output against its plain version
    (`f32_branch_error`, `[kernel]`): within F32_BRANCH_REL, or, for a
    column sum of F32_COLSUM_OUTS that misses it, within F32_COLSUM_SLACK x
    the plain version's own error against `ref64()` (the f64 evaluation,
    made only then)."""
    e = f32_branch_error(got, want)
    ok = e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL
    if not ok and e["finite"] and out in F32_COLSUM_OUTS and ref64:
        r = ref64().double().reshape(got.shape)
        scale = r.norm().item() or 1.0
        e.update(kernel_vs_f64=(got.double() - r).norm().item() / scale,
                 plain_vs_f64=(want.double() - r).norm().item() / scale,
                 bound="colsum")
        ok = e["kernel_vs_f64"] <= F32_COLSUM_SLACK * e["plain_vs_f64"]
    phase("kernel", name=name, shape=tag, **e)
    check(ok, f"{name} error outside its bound at {tag}: {e}")
    return e


def f32_train_case(shape, device, seed=SEED):
    """K8's f32 operands at (B, N, D, H): K1's f32 case (`f32_k1_case`) and
    an upstream gradient g drawn N(0, 1)."""
    args = f32_k1_case(shape, device, seed)
    gen = torch.Generator().manual_seed(seed + 2 * shape[2])
    return args, torch.randn(*shape[:3], generator=gen).to(device)


def library_backward(forward, inputs, grad, stream):
    """An autograd backward as a yardstick that a CUDA graph captures: the
    backward's ops run on their forward's stream, so `forward()` (the
    output of which `inputs` are leaves) runs here once on `stream`, the
    stream `graph_ms` is then given to capture on. Returns fn() giving
    the gradients of `inputs` for the output gradient `grad`."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.enable_grad():
        out = forward()
    torch.cuda.current_stream().wait_stream(stream)
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def library_k8b(qkv, h, g_o, stream):
    """K8b's yardstick: the backward of F.scaled_dot_product_attention
    alone, in qkv's dtype, on the heads of qkv (B, N, 3D), capturable on
    `stream` (`library_backward`)."""
    import torch.nn.functional as F

    from geovpr_torch.ops import mhsa as mh
    d = qkv.shape[-1] // 3
    qh, kh, vh = (mh._heads(t, h).contiguous().requires_grad_()
                  for t in qkv.split(d, dim=-1))
    return library_backward(lambda: F.scaled_dot_product_attention(
        qh, kh, vh), (qh, kh, vh), g_o, stream)


def f32_train_times(card: str, name: str, tag: str, fns: dict, bound: dict,
                    per_step: int, stream=None) -> dict:
    """kernel, plain and library of `fns` in turns (a, b, c, c, b, a), each
    in a CUDA graph (`interleaved_graph_ms`) captured on `stream` (the
    stream a `library_backward` yardstick's forward ran on)."""
    t = interleaved_graph_ms(fns, F32_TIME_ITERS, stream)
    row = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
               library_ms=t["library"][0],
               runs={k: v[1] for k, v in t.items()}, **bound)
    phase("kernel_time", card=repr(card), name=name, shape=tag,
          timed="cuda_graph", launches_per_step=per_step, **row)
    return row


def k8c_f32_parts_vs_plain(args, g, res, h, tag: str) -> dict:
    """K8c.f32 launch by launch (`k8c_launch_part`), each launch's outputs
    against its plain part on the inputs the earlier launches left in the
    buffers (`f32_train_error`, `[kernel] name=K8c.f32.<part>.<out>`), then
    each output of the launches against the whole call's, bit for bit.
    Returns the buffers."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops.swin_block import _ln_parts
    x, ls, lb, wqkv, bqkv, wo, bo, gamma = args[:8]
    b, n, d = x.shape
    m = b * n
    ba = (x, ls, lb, wqkv, wo, bo, gamma, res[1], res[2], g, h, 1e-6)
    bufs = mh.k8c_buffers(x, h)
    gf, c2, x2 = g.reshape(m, d), res[2].reshape(m, d), x.reshape(m, d)
    xhat, rstd, h_ref = _ln_parts(x2, ls, lb, 1e-6, x.dtype)

    def cur(k):
        return bufs[k].reshape(m, -1) if bufs[k].dim() == 3 else bufs[k]

    def dy64():
        return gf.double() * gamma.double()

    def lnvjp64(which):
        dh = cur("da").double()
        return (dh * xhat.double()).sum(0) if which == "dls" else dh.sum(0)

    # part -> [(output, plain part, f64 evaluation of a column sum)]
    checks = {
        "dy": [("dy", lambda: gf * gamma, None)],
        "dbo": [("dbo", lambda: (gf * gamma).sum(0),
                 lambda: dy64().sum(0))],
        "da": [("da", lambda: mh.vit_bwd_product_reference(cur("dy"), wo),
                None)],
        "dwo": [("dwo", lambda: mh.vit_weight_grad_reference(c2, cur("dy")),
                 None)],
        "dgamma": [("dgamma", lambda: mh.vit_dgamma_reference(c2, wo, bo,
                                                              gf),
                    lambda: (gf.double() * (c2.double() @ wo.double()
                                            + bo.double())).sum(0))],
        "core": [("dqkv", lambda: mh.mhsa_attn_bwd_core_reference(
            res[1], bufs["da"], h).reshape(m, 3 * d), None)],
        "ln_rows": [("h", lambda: h_ref, None)],
        "dwqkv": [("dwqkv", lambda: mh.vit_weight_grad_reference(
            cur("h"), cur("dqkv")), None)],
        "dbqkv": [("dbqkv", lambda: cur("dqkv").sum(0),
                   lambda: cur("dqkv").double().sum(0))],
        "dh": [("da", lambda: mh.vit_bwd_product_reference(cur("dqkv"),
                                                           wqkv), None)],
        "ln_vjp": [
            (k, lambda i=i: mh.vit_ln_vjp_reference(cur("da"), xhat, rstd,
                                                    ls, gf)[i],
             None if k == "dx" else lambda k=k: lnvjp64(k))
            for i, k in enumerate(("dx", "dls", "dlb"))]}
    with torch.no_grad():
        for i, part in enumerate(mh.K8C_PARTS):
            mh.k8c_launch_part(i, *ba, bufs=bufs)
            torch.cuda.synchronize()
            for out, plain, ref64 in checks[part]:
                f32_train_error(f"K8c.f32.{part}.{out}", tag, out, cur(out),
                                plain(), ref64)
        whole = mh.fused_mhsa_bwd_all(*ba)
        torch.cuda.synchronize()
    differ = [k for k, w in zip(K8_OUTS, whole) if not torch.equal(
        bufs[k].reshape(w.shape), w)]
    phase("k8c_f32_parts", shape=tag, parts=len(mh.K8C_PARTS),
          differ_from_whole=differ)
    check(not differ, f"K8c.f32's launches one by one differ from the whole "
          f"call at {tag}: {differ}")
    return bufs


def f32_train_kernels_vs_plain(device, card: str | None = None,
                               k8a=F32_K8A_SHAPES, k8b=F32_K8B_SHAPES,
                               k8c=F32_K8C_SHAPES) -> dict:
    """Part 1 of [f32_training]: K8a.f32, K8b.f32 and K8c.f32 against
    their plain f32 versions (`f32_train_error`; K8b and K8c on the plain
    forward's residuals, so that each is checked alone), each call one
    launch; K8c.f32 also launch by launch (`k8c_f32_parts_vs_plain`). With
    `card`, each also timed in CUDA graphs in turns with its plain version
    and its f32 library yardstick (K1's torch ops, SDPA's backward, the
    autograd of K1's torch ops) beside its bound (`[kernel_time]`), and
    K8a.f32's and K8c.f32's launches one by one (`[kernel_split]
    name=K8a.f32`, `name=K8c.f32`).
    `k8a=`, `k8b=`, `k8c=` narrow the shapes, as chip_faults.py does.
    Returns each kernel's error and times by (kind, shape)."""
    from geovpr_torch.ops import mhsa as mh

    peak = f32_peak(max_sm_clock_mhz()) if card else None
    out = {}

    def launched(fn, before, kind, shape):
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{kind}.f32 did not launch at "
              f"{shape}")

    for shape in k8a:
        h, tag = shape[3], "B{}_N{}_D{}_H{}".format(*shape)
        args, _ = f32_train_case(shape, device)
        fa = (*args[:8], h, 1e-6)
        with torch.no_grad():
            before = mh.fused_mhsa_train_fwd.launches
            got = mh.fused_mhsa_train_fwd(*fa)
            launched(mh.fused_mhsa_train_fwd, before, "K8a", shape)
            want = mh.mhsa_train_fwd_reference(*fa)
        e = f32_branch_error(got[0], want[0], args[0])
        phase("kernel", name="K8a.f32.out", shape=tag, **e)
        check(e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL,
              f"K8a.f32 out error outside its bound at {tag}: {e}")
        for i, name in ((1, "qkv"), (2, "ctx")):
            f32_train_error(f"K8a.f32.{name}", tag, name, got[i], want[i])
        row = dict(max_abs_err=e["max_abs_err"])
        if card:
            with torch.no_grad():
                row.update(f32_train_times(
                    card, "K8a.f32", tag,
                    {"kernel": lambda: mh.fused_mhsa_train_fwd(*fa),
                     "plain": lambda: mh.mhsa_train_fwd_reference(*fa),
                     "library": lambda: library_k1(*fa[:9])},
                    f32_train_bounds("K8a", shape, peak),
                    F32_PER_STEP[("K8a", shape)]))
                x, got_args = args[0], mh._check(*fa[:9])
                bufs = f32_bufs(x, "K1")
                parts_split(card, "K8a.f32", tag, mh.K1_PARTS,
                            lambda i: mh.k1_launch_part(i, x, got_args, h,
                                                        1e-6, bufs),
                            lambda part: F32_PART_BOUNDS["K1"](part, shape,
                                                               peak))
                del bufs
        out[("K8a", shape)] = row
        del args, got, want

    for shape in k8b:
        h, tag = shape[3], "B{}_N{}_D{}_H{}".format(*shape)
        args, da = f32_train_case(shape, device)
        with torch.no_grad():
            qkv = mh.mhsa_train_fwd_reference(*args[:8], h, 1e-6)[1]
            before = mh.fused_mhsa_bwd_core.launches
            got = mh.fused_mhsa_bwd_core(qkv, da, h)
            launched(mh.fused_mhsa_bwd_core, before, "K8b", shape)
            want = mh.mhsa_attn_bwd_core_reference(qkv, da, h)
        e = f32_train_error("K8b.f32.dqkv", tag, "dqkv", got, want)
        row = dict(max_abs_err=e["max_abs_err"])
        if card:
            g_o = torch.randn(shape[0], h, shape[1], shape[2] // h,
                              device=device)
            stream = torch.cuda.Stream()
            with torch.no_grad():
                row.update(f32_train_times(
                    card, "K8b.f32", tag,
                    {"kernel": lambda: mh.fused_mhsa_bwd_core(qkv, da, h),
                     "plain": lambda: mh.mhsa_attn_bwd_core_reference(
                         qkv, da, h),
                     "library": library_k8b(qkv, h, g_o, stream)},
                    f32_train_bounds("K8b", shape, peak),
                    F32_PER_STEP[("K8b", shape)], stream))
        out[("K8b", shape)] = row
        del args, da, qkv, got, want
        torch.cuda.empty_cache()

    for shape in k8c:
        h, tag = shape[3], "B{}_N{}_D{}_H{}".format(*shape)
        args, g = f32_train_case(shape, device)
        x, ls, lb, wqkv, bqkv, wo, bo, gamma = args[:8]
        with torch.no_grad():
            res = mh.mhsa_train_fwd_reference(*args[:8], h, 1e-6)
            ba = (x, ls, lb, wqkv, wo, bo, gamma, res[1], res[2], g, h, 1e-6)
            before = mh.fused_mhsa_bwd_all.launches
            got = mh.fused_mhsa_bwd_all(*ba)
            launched(mh.fused_mhsa_bwd_all, before, "K8c", shape)
            want = mh.mhsa_train_bwd_reference(*ba)
        f64 = {}

        def ref64(k):
            if not f64:
                f64.update(k8_f64_grads(*args[:8], g, h))
            return f64[k]

        row = {}
        for i, name in enumerate(K8_OUTS):
            e = f32_train_error(f"K8c.f32.{name}", tag, name, got[i], want[i],
                                lambda k=name: ref64(k))
            if name == "dx":
                row["max_abs_err"] = e["max_abs_err"]
        del got, want
        bufs = k8c_f32_parts_vs_plain(args, g, res, h, tag)
        if card:
            leaves = [t.detach().requires_grad_() for t in args[:8]]
            stream = torch.cuda.Stream()
            with torch.no_grad():
                row.update(f32_train_times(
                    card, "K8c.f32", tag,
                    {"kernel": lambda: mh.fused_mhsa_bwd_all(*ba),
                     "plain": lambda: mh.mhsa_train_bwd_reference(*ba),
                     "library": library_backward(
                         lambda: library_k1(*leaves, h), leaves, g,
                         stream)},
                    f32_train_bounds("K8c", shape, peak),
                    F32_PER_STEP[("K8c", shape)], stream))
                parts_split(card, "K8c.f32", tag, mh.K8C_PARTS,
                            lambda i: mh.k8c_launch_part(i, *ba, bufs=bufs),
                            lambda part: k8c_part_bounds(
                                part, shape, peak, 4, peak))
            del leaves
        out[("K8c", shape)] = row
        del args, g, res, ba, bufs
        torch.cuda.empty_cache()
    return out


# The f32 forms of Swin's training kernels, which a window-12 Swin built
# with compute_dtype="float32" trains on: K9a.f32 (K4.f32's launches with
# the FA_TRAIN attention, `csrc/f32_serving.cu`) at the four Swin-B-384
# stages (B=16), K9b.f32 (`csrc/f32_train.cu`) at stage 3, where the split
# route runs it, and at stage 0, K9c.f32 at stages 0-2, each whole and
# launch by launch against its plain f32 version with TF32 off
# (`f32_train_error`).
F32_K9A_SHAPES = K9_SHAPES
F32_K9B_SHAPES = (K9_SHAPES[3], K9_MAIN)
F32_K9C_SHAPES = K9_SHAPES[:3]
K9_OUTS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")
# launches a training step of swin_b384_gemini2 (2 + 2 + 18 + 2 blocks) of
# each checked shape: K9a in every block, K9c in the blocks of stages 0-2,
# K9b in stage 3's (none at stage 0, where K9c runs)
F32_K9_PER_STEP = {
    **{("K9a", s): n for s, n in zip(K9_SHAPES, (2, 2, 18, 2))},
    **{("K9c", s): n for s, n in zip(K9_SHAPES[:3], (2, 2, 18))},
    ("K9b", K9_SHAPES[3]): 2, ("K9b", K9_MAIN): 0}


def f32_swin_train_bounds(kind: str, shape, peak: float) -> dict:
    """The least time of one f32 K9 call at (B, C, H, S, w, shift),
    counted as the bf16 rows count it (`k9_bounds`) with 4 bytes a value:
    operations at `peak` (K9a 8 M C^2 + two N x N x dh products a head and
    window; K9b the four such products of the core backward; K9c those and
    16 M C^2 of products) against the bytes at 3.35 TB/s (each input read
    once, each output written once: the stream, the residuals and the
    gradients 4 bytes a value, the p plane (BW, H, N, N) among them)."""
    b, c, h, res, win, _ = shape
    m, n = b * res * res, win * win
    bw = m // n
    att = 2 * bw * h * n * n * (c // h)          # one N x N x dh product
    plane = bw * h * n * n
    table = (2 * win - 1) ** 2 * h
    if kind == "K9a":
        # x, the weights, ln_scale, ln_bias, bqkv, bo, the table -> y, qkv,
        # ctx, p
        ops = 8 * m * c * c + 2 * att
        values = m * c + 4 * c * c + 6 * c + table + 5 * m * c + plane
    elif kind == "K9b":
        # qkv, p, da -> dqkv, dbias
        ops = 4 * att
        values = 7 * m * c + plane + h * n * n
    else:
        # x, qkv, ctx, g, p, the weights, ln_scale, ln_bias -> dx, dls, dlb,
        # dwqkv, dbqkv, dwo, dbo, dbias
        ops = 4 * att + 16 * m * c * c
        values = 7 * m * c + plane + 4 * c * c + 2 * c + 4 * c * c + 6 * c \
            + h * n * n
    return dict(part_bound(ops, peak, 4 * values), bytes=4 * values)


def k9_f64_grads(a: dict, g, geom: dict) -> dict:
    """The window-12 half-block's gradients (K9_OUTS; dbias that of the
    (H, N, N) bias) in f64 by autograd of its forward written out in f64
    from the f32 inputs `a` (k9_case's) and g: the f64 evaluation that a
    near-cancelling column sum is measured against."""
    from geovpr_torch.ops.window_attention import (from_windows,
                                                   relative_position_bias,
                                                   shift_mask, to_windows)
    h, res, win, shift = (geom[k] for k in ("num_heads", "resolution",
                                            "window", "shift"))
    names = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo")
    leaves = [a[k].detach().double().requires_grad_() for k in names]
    bias = relative_position_bias(a["table"].double(), win).detach()
    leaves.append(bias.requires_grad_())
    x, ls, lb, wq, bq, w_o, b_o, bb = leaves
    c = x.shape[-1]
    mask = shift_mask(res, win, shift, x.device)
    with torch.enable_grad():
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        qkv = to_windows(((x - mu) / torch.sqrt(var + 1e-5) * ls + lb) @ wq
                         + bq, res, win, shift)
        bw, n, _ = qkv.shape
        q, k, v = (t.reshape(bw, n, h, c // h).transpose(1, 2)
                   for t in qkv.split(c, dim=-1))
        s = q @ k.transpose(-1, -2) * (c // h) ** -0.5 + bb
        if mask is not None:
            s = (s.reshape(-1, mask.shape[0], h, n, n)
                 + mask.double()[None, :, None]).reshape(bw, h, n, n)
        ctx = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(bw, n, c)
        y = from_windows(ctx, res, win, shift) @ w_o + b_o
        grads = torch.autograd.grad(y, leaves, g.double())
    return dict(zip(K9_OUTS, grads))


def k9_core_f64_dbias(qkv, p, da, geom: dict):
    """K9b's dbias (H, N, N) in f64 from the f32 residuals: the sum over
    the windows of ds = p (dp - sum_j dp p), dp = da v^T, each in f64."""
    from geovpr_torch.ops import swin_block as sb
    geo = (geom["resolution"], geom["window"], geom["shift"])
    h = geom["num_heads"]
    c = da.shape[-1]
    bw, _, n, _ = p.shape
    v = sb._heads(sb._raster_to_rows(qkv, *geo)[:, 2 * c:].double()
                  .reshape(bw, n, c), h)
    dah = sb._heads(sb._raster_to_rows(da, *geo).double().reshape(bw, n, c),
                    h)
    pd = p.double()
    dp = dah @ v.transpose(-1, -2)
    return (pd * (dp - (dp * pd).sum(-1, keepdim=True))).sum(0)


def k9a_f32_parts_vs_plain(fa, tag: str) -> dict:
    """K9a.f32 launch by launch (`k9a_launch_part`), each launch's outputs
    against its plain part on what the launch before it left in the
    buffers (`f32_train_error`, `[kernel] name=K9a.f32.<part>.<out>`; the
    attention's scaled q is formed from the buffer's qkv as the kernel
    forms it), then each buffer against the whole call's, bit for bit.
    Returns the buffers."""
    from geovpr_torch.ops import swin_block as sb
    x, ls, lb, wqkv, bqkv, wo, bo, table = fa[:8]
    h, res, win, shift = fa[8:12]
    b, l, c = x.shape
    bufs = sb.k9a_buffers(x, h, win)
    qscale = torch.full((c,), (c // h) ** -0.5 * sb.LOG2E,
                        device=x.device)
    checks = {
        "layernorm": lambda: [("h", bufs["ctx"], sb.train_ln_reference(
            x.reshape(-1, c), ls, lb).reshape(b, l, c))],
        "qkv_gemm": lambda: [("qkv", bufs["qkv"], sb.train_qkv_reference(
            bufs["ctx"].reshape(-1, c), wqkv, bqkv, h)[0].reshape(b, l, -1))],
        "attention": lambda: list(zip(("ctx", "p"), (bufs["ctx"], bufs["p"]),
                                      sb.train_attention_reference(
            bufs["qkv"][..., :c] * qscale, bufs["qkv"], table, h, res, win,
            shift))),
        "out_proj": lambda: [("y", bufs["y"], sb.train_out_proj_reference(
            bufs["ctx"].reshape(-1, c), wo, bo).reshape(b, l, c))]}
    with torch.no_grad():
        for i, part in enumerate(sb.K9A_PARTS):
            sb.k9a_launch_part(i, *fa, bufs=bufs)
            torch.cuda.synchronize()
            # the plain part on the buffers the launch read (no launch
            # writes what it reads)
            for out, got, ref in checks[part]():
                f32_train_error(f"K9a.f32.{part}.{out}", tag, out, got, ref)
        whole = sb.fused_swin_attn_train_fwd(*fa)
        torch.cuda.synchronize()
    differ = [k for k, w in zip(("y", "qkv", "ctx", "p"), whole)
              if not torch.equal(bufs[k], w)]
    phase("k9a_f32_parts", shape=tag, parts=len(sb.K9A_PARTS),
          differ_from_whole=differ)
    check(not differ, f"K9a.f32's launches one by one differ from the whole "
          f"call at {tag}: {differ}")
    return bufs


def k9c_f32_parts_vs_plain(a, g, res, geom, tag: str) -> dict:
    """K9c.f32 launch by launch (`k9c_launch_part`), each launch's outputs
    against its plain part on the inputs the earlier launches left in the
    buffers (`f32_train_error`, `[kernel] name=K9c.f32.<part>.<out>`), then
    each output of the launches against the whole call's, bit for bit.
    Returns the buffers."""
    from geovpr_torch.ops import swin_block as sb
    geo = tuple(geom.values())
    x, ls, lb = a["x"], a["ln_scale"], a["ln_bias"]
    b, l, c = x.shape
    m = b * l
    ba = (x, ls, lb, a["wqkv"], a["wo"], res[1], res[2], res[3], g, *geo,
          1e-5)
    bufs = sb.k9c_buffers(x, *geo[:3])
    g2, c2 = g.reshape(m, c), res[2].reshape(m, c)
    xhat, rstd, h_ref = sb._ln_parts(x.reshape(m, c), ls, lb, 1e-5, x.dtype)

    def cur(k):
        """A buffer, the (B, L, .) ones as rows."""
        return (bufs[k].reshape(m, -1) if k in ("da", "h", "dqkv", "dx")
                else bufs[k])

    def core():
        dq, db = sb.swin_attn_core_bwd_reference(
            sb._raster_to_rows(res[1], *geo[1:]), res[3],
            sb._raster_to_rows(bufs["da"], *geo[1:]), geo[0])
        return sb._rows_to_raster(dq, *geo[1:]).reshape(m, -1), db

    def lnvjp64(which):
        dh = cur("da").double()
        return (dh * xhat.double()).sum(0) if which == "dls" else dh.sum(0)

    # part -> [(output, plain part, f64 evaluation of a column sum)]
    checks = {
        "da": [("da", lambda: sb.bwd_product_reference(g2, a["wo"]), None)],
        "dwo": [("dwo", lambda: sb.weight_grad_reference(c2, g2), None)],
        "dbo": [("dbo", lambda: g2.sum(0), lambda: g2.double().sum(0))],
        "core": [("dqkv", lambda: core()[0], None),
                 ("dbias", lambda: core()[1], lambda: k9_core_f64_dbias(
                     res[1], res[3], bufs["da"], geom))],
        "ln_rows": [("h", lambda: h_ref, None)],
        "dwqkv": [("dwqkv", lambda: sb.weight_grad_reference(
            cur("h"), cur("dqkv")), None)],
        "dbqkv": [("dbqkv", lambda: cur("dqkv").sum(0),
                   lambda: cur("dqkv").double().sum(0))],
        "dh": [("da", lambda: sb.bwd_product_reference(cur("dqkv"),
                                                       a["wqkv"]), None)],
        "ln_vjp": [
            (k, lambda i=i: sb.ln_vjp_reference(cur("da"), xhat, rstd,
                                                ls)[i],
             None if k == "dx" else lambda k=k: lnvjp64(k))
            for i, k in enumerate(("dx", "dls", "dlb"))]}
    with torch.no_grad():
        for i, part in enumerate(sb.K9C_PARTS):
            sb.k9c_launch_part(i, *ba, bufs=bufs)
            torch.cuda.synchronize()
            for out, plain, ref64 in checks[part]:
                f32_train_error(f"K9c.f32.{part}.{out}", tag, out, cur(out),
                                plain(), ref64)
        whole = sb.fused_swin_attn_bwd_all(*ba)
        torch.cuda.synchronize()
    differ = [k for k, w in zip(K9_OUTS, whole) if not torch.equal(
        bufs[k].reshape(w.shape), w)]
    phase("k9c_f32_parts", shape=tag, parts=len(sb.K9C_PARTS),
          differ_from_whole=differ)
    check(not differ, f"K9c.f32's launches one by one differ from the whole "
          f"call at {tag}: {differ}")
    return bufs


def f32_k9_kernels_vs_plain(device, card: str | None = None,
                            k9a=F32_K9A_SHAPES, k9b=F32_K9B_SHAPES,
                            k9c=F32_K9C_SHAPES) -> dict:
    """Part 1b of [f32_training]: K9a.f32, K9b.f32 and K9c.f32 against
    their plain f32 versions (`f32_train_error`: every output within
    F32_BRANCH_REL, a column sum of F32_COLSUM_OUTS within F32_COLSUM_SLACK
    x the plain version's own error against f64; K9b and K9c on the plain
    forward's residuals, so that each is checked alone), each call one
    launch, and K9a.f32 and K9c.f32 launch by launch. With `card`, each
    also timed in CUDA graphs in turns with its plain version and its f32
    library yardstick (`k9_timing_cases`) beside its bound
    (`[kernel_time]`), and, at stage 0, K9a.f32's and K9c.f32's launches
    one by one (`[kernel_split]`). `k9a=`, `k9b=`, `k9c=` narrow the
    shapes, as chip_faults.py does. Returns each kernel's error and times
    by (kind, shape)."""
    from geovpr_torch.ops import swin_block as sb

    peak = f32_peak(max_sm_clock_mhz()) if card else None
    out = {}

    def tag_of(shape):
        return "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)

    def launched(fn, before, kind, shape):
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{kind}.f32 did not launch at "
              f"{shape}")

    def case(shape):
        a, g, geom = k9_case(shape, device, dtype=torch.float32)
        fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
              a["wo"], a["bo"], a["table"], *geom.values(), 1e-5)
        return a, g, geom, fa

    def timed(kind, shape, fa, ba, g, row):
        stream = torch.cuda.Stream()
        with torch.no_grad():
            row.update(f32_train_times(
                card, f"{kind}.f32", tag_of(shape),
                k9_timing_cases(kind, shape, fa, ba, g, stream),
                f32_swin_train_bounds(kind, shape, peak),
                F32_K9_PER_STEP[(kind, shape)], stream))

    for shape in k9a:
        tag = tag_of(shape)
        a, g, geom, fa = case(shape)
        with torch.no_grad():
            before = sb.fused_swin_attn_train_fwd.launches
            got = sb.fused_swin_attn_train_fwd(*fa)
            launched(sb.fused_swin_attn_train_fwd, before, "K9a", shape)
            want = sb._train_plain_fwd(*fa)
        row = {}
        for i, name in enumerate(("y", "qkv", "ctx", "p")):
            e = f32_train_error(f"K9a.f32.{name}", tag, name, got[i],
                                want[i])
            if name == "y":
                row["max_abs_err"] = e["max_abs_err"]
        del got, want
        bufs = k9a_f32_parts_vs_plain(fa, tag)
        if card:
            timed("K9a", shape, fa, None, g, row)
            if shape == K9_MAIN:
                with torch.no_grad():
                    parts_split(card, "K9a.f32", tag, sb.K9A_PARTS,
                                lambda i: sb.k9a_launch_part(i, *fa,
                                                             bufs=bufs),
                                lambda part: k9a_part_bounds(part, shape,
                                                             peak, 4))
        out[("K9a", shape)] = row
        del a, g, fa, bufs
        torch.cuda.empty_cache()

    for shape in k9b:
        tag = tag_of(shape)
        a, g, geom, fa = case(shape)
        geo = tuple(geom.values())
        with torch.no_grad():
            _, qkv, ctx, p = sb._train_plain_fwd(*fa)
            before = sb.fused_swin_attn_bwd_core.launches
            got = sb.fused_swin_attn_bwd_core(qkv, p, g, *geo)
            launched(sb.fused_swin_attn_bwd_core, before, "K9b", shape)
            dq, db = sb.swin_attn_core_bwd_reference(
                sb._raster_to_rows(qkv, *geo[1:]), p,
                sb._raster_to_rows(g, *geo[1:]), geo[0])
            want = (sb._rows_to_raster(dq, *geo[1:]), db)
        e = f32_train_error("K9b.f32.dqkv", tag, "dqkv", got[0], want[0])
        f32_train_error("K9b.f32.dbias", tag, "dbias", got[1], want[1],
                        lambda: k9_core_f64_dbias(qkv, p, g, geom))
        row = dict(max_abs_err=e["max_abs_err"])
        del got, want, dq, db
        if card:
            ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"],
                  qkv, ctx, p, g, *geo, 1e-5)
            timed("K9b", shape, fa, ba, g, row)
            del ba
        out[("K9b", shape)] = row
        del a, g, fa, qkv, ctx, p
        torch.cuda.empty_cache()

    for shape in k9c:
        tag = tag_of(shape)
        a, g, geom, fa = case(shape)
        geo = tuple(geom.values())
        with torch.no_grad():
            res = sb._train_plain_fwd(*fa)
            ba = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"],
                  res[1], res[2], res[3], g, *geo, 1e-5)
            before = sb.fused_swin_attn_bwd_all.launches
            got = sb.fused_swin_attn_bwd_all(*ba)
            launched(sb.fused_swin_attn_bwd_all, before, "K9c", shape)
            want = sb._train_plain_bwd(*ba, split=False)
        f64 = {}

        def ref64(k):
            if not f64:
                f64.update(k9_f64_grads(a, g, geom))
            return f64[k]

        row = {}
        for i, name in enumerate(K9_OUTS):
            e = f32_train_error(f"K9c.f32.{name}", tag, name, got[i],
                                want[i], lambda k=name: ref64(k))
            if name == "dx":
                row["max_abs_err"] = e["max_abs_err"]
        del got, want
        f64.clear()
        bufs = k9c_f32_parts_vs_plain(a, g, res, geom, tag)
        if card:
            timed("K9c", shape, fa, ba, g, row)
            if shape == K9_MAIN:
                with torch.no_grad():
                    parts_split(card, "K9c.f32", tag, sb.K9C_PARTS,
                                lambda i: sb.k9c_launch_part(i, *ba,
                                                             bufs=bufs),
                                lambda part: k9c_part_bounds(part, shape,
                                                             peak, 4))
        out[("K9c", shape)] = row
        del a, g, fa, res, ba, bufs
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def k8_dtypes():
    """The stream dtypes the DINOv2 kernels were called with inside the
    block: K1's and K8a's launches (`_launch_k1`) and K8b's and K8c's
    library entries (`_train_entries`), as a set of (role, dtype)."""
    from geovpr_torch.ops import mhsa as mh
    seen = set()
    k1, entries = mh._launch_k1, mh._train_entries

    def rec_k1(x, *a, **kw):
        seen.add(("k1", x.dtype))
        return k1(x, *a, **kw)

    def rec_entries(device, dtype=torch.bfloat16):
        seen.add(("k8bc", dtype))
        return entries(device, dtype)

    mh._launch_k1, mh._train_entries = rec_k1, rec_entries
    try:
        yield seen
    finally:
        mh._launch_k1, mh._train_entries = k1, entries


def f32_train_cfg(preset: str, variant: str, batch: int, salad: bool,
                  dtype: str = "float32"):
    """The preset at `variant`, batch `batch` and compute dtype `dtype`;
    for the SALAD preset its backbone unfrozen under remat, as
    [train_disk] trains it (backbone LR x 0.1)."""
    from geovpr_torch.cli.presets import build_preset
    cfg = build_preset(preset)
    model = dict(variant=variant, compute_dtype=dtype)
    if salad:
        model.update(freeze_backbone=False, remat=True)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        data=dataclasses.replace(cfg.data, batch_size=batch))
    if salad:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, backbone_lr_scale=0.1))
    return cfg


def f32_grads_vs_plain(trainer, batch, tag: str) -> None:
    """On one batch with dropout and DropPath off, the gradient of every
    parameter on the f32 kernel path against the f32 plain path: cosine at
    least F32_MIN_COSINE a tensor (`[train_grads] dtype=float32`), the
    SALAD head's ReLUs passing on the plain path the units the kernel
    path's passed. The key bias (the middle third of each qkv_bias) and
    ROUNDOFF_GRADS have a gradient of zero in exact arithmetic: each path's
    is bounded by F32_ROUNDOFF_REL of its tensor's query and value biases'
    (of score_fc2.weight's), not compared."""
    st, model = trainer.state, trainer.state.model
    names = [n for n, _ in model.named_parameters()]
    blocks = kernel_blocks(model)
    salad = any(".salad." in n for n in names)
    enc = trainer.objective.encode_targets(batch["target"], st.scaler)

    def grads(kernels: bool, relus=None):
        for m in blocks:
            m.use_kernels = kernels
        try:
            with (salad_relus(relus) if relus is not None
                  else contextlib.nullcontext()):
                loss = trainer.objective.loss(
                    model(trainer._normalize(batch["image"])), enc,
                    batch["mask"])
                return torch.autograd.grad(loss, list(model.parameters()))
        finally:
            for m in blocks:
                m.use_kernels = True

    with kept_batch_stats(model):
        saved = _drop_rates(model, 0.0)
        model.train()
        try:
            relus = SaladRelus() if salad else None
            got = grads(True, relus)
            want = grads(False, SaladRelus([x > 0 for x in relus.seen])
                         if salad else None)
        finally:
            _drop_rates(model, saved)
    cos, roundoff = {}, {}
    by_name = dict(zip(names, zip(got, want)))
    for n, (a, b) in by_name.items():
        if n in ROUNDOFF_GRADS:
            ref = by_name["backbone.salad.score_fc2.weight"][1].norm().item()
            roundoff[n] = max(a.norm().item(), b.norm().item()) / ref
            continue
        if n.endswith("attn.qkv_bias"):
            d = a.numel() // 3
            real = torch.cat([b[:d], b[2 * d:]]).norm().item()
            roundoff[n + "[key]"] = max(a[d:2 * d].norm().item(),
                                        b[d:2 * d].norm().item()) / real
            a, b = torch.cat([a[:d], a[2 * d:]]), torch.cat([b[:d],
                                                             b[2 * d:]])
        cos[n] = _cosine(a, b)
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    top = max(roundoff.items(), key=lambda kv: kv[1])
    phase("train_grads", path=tag, dtype="float32", tensors=len(cos),
          min_cosine=worst[0][1], worst=repr(worst), bound=F32_MIN_COSINE,
          roundoff_tensors=len(roundoff), roundoff_max=repr(top),
          roundoff_bound=F32_ROUNDOFF_REL,
          salad_relus="the kernel path's units" if salad else "none")
    check(worst[0][1] >= F32_MIN_COSINE,
          f"{tag}: f32 kernel vs plain gradient cosine below "
          f"{F32_MIN_COSINE}: {worst}")
    check(top[1] <= F32_ROUNDOFF_REL,
          f"{tag}: a roundoff-only gradient is not roundoff: {top}")


def f32_vs_bf16_times(trainer, batch, card: str, tag: str) -> None:
    """The step's times (`train_times`: ms/step, device-busy ms, idle
    share, the top device ops) in f32, then with the backbone's compute
    dtype set to bf16 on the same weights and batch (the bf16 kernels),
    then f32 again: `[train_times] phase=f32 / bf16`."""
    model = trainer.state.model
    for dtype in (torch.float32, torch.bfloat16):
        set_compute_dtype(model, dtype)
        try:
            train_times(trainer, batch, card, tag,
                        phase_name=str(dtype).split(".")[-1])
        finally:
            set_compute_dtype(model, torch.float32)


@contextlib.contextmanager
def preset_as(name: str, cfg):
    """`build_preset(name)` gives `cfg` inside the block (the CLIs build
    their model from the preset)."""
    from geovpr_torch.cli import presets
    table = next(t for t in (presets.GEOPOSE_PRESETS, presets.ANGLE_PRESETS,
                             presets.RETRIEVAL_PRESETS) if name in t)
    old, table[name] = table[name], cfg
    try:
        yield
    finally:
        table[name] = old


def f32_train_paths(device, card: str) -> dict:
    """Part 2 of [f32_training]: `run_train` at full width in f32 on each
    of F32_TRAIN_CASES, from seeded random weights on synthetic images and
    targets, F32_TRAIN_EPOCHS epochs: the launches (every count set to 0
    just before and read just after), every kernel call on an f32 stream,
    finite losses and metrics, the run directory; the kernel path's
    gradient against the plain path's (`f32_grads_vs_plain`); a resumed
    run bit-equal to the unbroken one; remat bit-equal to no remat; a
    falling loss on a fixed batch; the step's times beside the same
    preset's bf16 step. On base-14 also `cli.evaluate --run-dir` on the
    run, serving on K1.f32. Returns the launches by counter."""
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    from geovpr_torch.ops.mhsa import bwd_all_ok

    total = {}
    for tag, preset, variant, batch, n_train, n_val, salad in \
            F32_TRAIN_CASES:
        t0 = time.perf_counter()
        cfg = f32_train_cfg(preset, variant, batch, salad)
        spec = DINOV2_VARIANTS[variant]
        blocks = spec["num_layers"]
        geo = isinstance(cfg, GeoposeConfig)
        rng = np.random.default_rng(SEED + 11)
        size = cfg.data.image_size
        train_src = synthetic_val(n_train, size, rng, angles=not geo)
        val_src = synthetic_val(n_val, size, rng, angles=not geo)
        bwd = ("fused_mhsa_bwd_all" if bwd_all_ok(spec["hidden_size"])
               else "fused_mhsa_bwd_core")
        with tempfile.TemporaryDirectory() as tmp:
            with k8_dtypes() as seen:
                trainer, launches = train_run(
                    cfg, train_src, val_src, device, tmp, F32_TRAIN_EPOCHS,
                    {"fused_mhsa_train_fwd": ((2 if salad else 1) * blocks,
                                              0),
                     bwd: (blocks, 0), "fused_mhsa_block": (0, blocks)}, tag)
            phase("f32_train_dtypes", path=tag, seen=sorted(map(str, seen)))
            check({dt for _, dt in seen} == {torch.float32},
                  f"{tag}: a DINOv2 kernel ran on a non-f32 stream: {seen}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            tb = next(iter(_train_batches(train_src, device, batch)))
            f32_grads_vs_plain(trainer, tb, tag)
            train_resume(cfg, train_src, val_src, device, tmp, trainer, tag)
            _remat_grads_equal(trainer, tb, tag)
            if variant == "base-14" and not salad:
                with preset_as(preset, cfg), k8_dtypes() as seen:
                    got = evaluate_run_dir(preset, trainer.run_dir, val_src,
                                           batch, blocks, device, tag)
                check(seen == {("k1", torch.float32)},
                      f"{tag}: evaluate --run-dir served on {seen}")
                total["fused_mhsa_block"] = (total.get("fused_mhsa_block", 0)
                                             + got["fused_mhsa_block"])
            f32_vs_bf16_times(trainer, tb, card, tag)
            del trainer
            torch.cuda.empty_cache()
        train_loss_falls(device, preset, F32_FALL_STEPS, cfg=cfg,
                         dtype=torch.float32, tag=tag)
        torch.cuda.empty_cache()
        phase("f32_train_case", path=tag, seconds=time.perf_counter() - t0)
    return total


# f32 Swin training at full width and depth (window 12, 24 blocks), cut in
# data and epochs: (path, preset, variant, batch, training images,
# validation images), F32_TRAIN_EPOCHS epochs of 2 steps. Launches a step:
# K9a.f32 in every block (twice under remat), K9c.f32 in the 22 blocks of
# stages 0-2, K9b.f32 in stage 3's 2; a validation batch K4.f32 in every
# block and K6.f32 at the 3 boundaries. It runs in a child process that
# leaves torch's TF32 settings at their defaults, as the CLIs do.
F32_SWIN_CASE = ("swin-b384-f32", "swin_b384_gemini2", "base-384", 16, 32,
                 16)
F32_SWIN_FALL_STEPS = 5


@contextlib.contextmanager
def k9_dtypes():
    """The stream dtypes the Swin kernels were called with inside the
    block: K9a-K9c's C entries (`swin_block._train_entries`), K4's
    (`swin_block._k4_args`) and K6's (`patch_merge._k6_args`), as a set
    of (role, dtype)."""
    from geovpr_torch.ops import patch_merge as pm
    from geovpr_torch.ops import swin_block as sb
    seen = set()
    entries, k4, k6 = sb._train_entries, sb._k4_args, pm._k6_args

    def rec_entries(device, dtype):
        seen.add(("k9", dtype))
        return entries(device, dtype)

    def rec_k4(x, *a, **kw):
        seen.add(("k4", x.dtype))
        return k4(x, *a, **kw)

    def rec_k6(x, *a, **kw):
        seen.add(("k6", x.dtype))
        return k6(x, *a, **kw)

    sb._train_entries, sb._k4_args, pm._k6_args = rec_entries, rec_k4, rec_k6
    try:
        yield seen
    finally:
        sb._train_entries, sb._k4_args, pm._k6_args = entries, k4, k6


def f32_tf32_conv_check(device) -> None:
    """The f32 Swin-B-384's patch embedding (3 -> 128 channels, 4 x 4 at
    stride 4, 384 px, B=16; seeded weights) with cuDNN's TF32 setting as
    torch leaves it, with TF32 off, and through the port's
    `layers.conv2d` with the setting as torch leaves it: the output's and
    the weight gradient's relative error in the 2-norm against f64
    (`[tf32_conv]`). The port's must be within F32_BRANCH_REL, and the
    process-wide setting must be as it was."""
    import torch.nn.functional as F

    from geovpr_torch.models.layers import conv2d

    gen = torch.Generator().manual_seed(SEED + 31)
    x = (torch.rand(16, 3, 384, 384, generator=gen) * 4 - 2).to(device)
    w = (torch.randn(128, 3, 4, 4, generator=gen) * 48 ** -0.5).to(device)
    bias = (torch.randn(128, generator=gen) * 0.1).to(device)
    g = torch.randn(16, 128, 96, 96, generator=gen).to(device)
    default = torch.backends.cudnn.allow_tf32
    w64 = w.double().requires_grad_()
    with torch.enable_grad():
        y64 = F.conv2d(x.double(), w64, bias.double(), stride=4)
        dw64 = torch.autograd.grad(y64, w64, g.double())[0]

    def errs(conv):
        wl = w.detach().requires_grad_()
        with torch.enable_grad():
            y = conv(x, wl, bias, 4)
            dw = torch.autograd.grad(y, wl, g)[0]
        return [((a.double() - r).norm() / r.norm()).item()
                for a, r in ((y, y64), (dw, dw64))]

    e_default = errs(lambda *a: F.conv2d(*a[:3], stride=a[3]))
    torch.backends.cudnn.allow_tf32 = False
    try:
        e_off = errs(lambda *a: F.conv2d(*a[:3], stride=a[3]))
    finally:
        torch.backends.cudnn.allow_tf32 = default
    e_port = errs(conv2d)
    phase("tf32_conv", allow_tf32=default, default_rel_err=e_default[0],
          default_dw_rel_err=e_default[1], off_rel_err=e_off[0],
          off_dw_rel_err=e_off[1], port_rel_err=e_port[0],
          port_dw_rel_err=e_port[1], bound=F32_BRANCH_REL,
          default_misses=max(e_default) > F32_BRANCH_REL)
    check(max(e_port) <= F32_BRANCH_REL and max(e_off) <= F32_BRANCH_REL,
          f"f32 patch embedding off f64 with TF32 off: port {e_port}, "
          f"cudnn {e_off}")
    check(torch.backends.cudnn.allow_tf32 == default,
          "the port's conv2d left cuDNN's TF32 setting changed")


def f32_remat_step(trainer, batch, tag: str, expected: dict) -> dict:
    """One training step with the blocks recomputed (`model.remat`)
    against the same step without, from the same state (the step's
    DropPath generator seeded alike): every parameter and Adam moment
    bit-equal. The remat step's launches (every count set to 0 just before,
    read just after) must be `expected`; returns them. The state is put
    back after."""
    st, model = trainer.state, trainer.state.model
    flags = [m for m in model.modules() if hasattr(m, "remat")]
    saved = [m.remat for m in flags]
    counters = train_counters()
    snap = _state_snapshot(st)
    try:
        for m in flags:
            m.remat = False
        trainer._train_step(st, batch)
        plain = _state_snapshot(st)
        _state_restore(st, snap)
        for m in flags:
            m.remat = True
        for fn in counters.values():
            fn.launches = 0
        trainer._train_step(st, batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        differ = _state_equal(st, plain)
    finally:
        for m, r in zip(flags, saved):
            m.remat = r
        _state_restore(st, snap)
    want = dict.fromkeys(counters, 0)
    want.update(expected)
    phase("remat_step_equal", path=tag, launches={
        k: v for k, v in launches.items() if v}, tensors_differ=len(differ),
        differ=repr(differ[:5]))
    check(launches == want, f"{tag}: remat step launches {launches}, "
          f"expected {want}")
    check(not differ, f"{tag}: the remat step is not bit-equal to the step "
          f"without remat: {differ[:5]}")
    return launches


def f32_swin_train_record(device, card: str) -> dict:
    """`run_train` on F32_SWIN_CASE in f32 from seeded random weights on
    synthetic images and (lat, lon) targets, F32_TRAIN_EPOCHS epochs: the
    launches (every count set to 0 just before and read just after), every
    Swin kernel call on an f32 stream, finite losses and metrics, the run
    directory; the kernel path's gradient against the plain path's
    (`f32_grads_vs_plain`); a resumed run bit-equal to the unbroken one;
    remat's gradient and one remat step bit-equal to no remat
    (`f32_remat_step`); `cli.evaluate --run-dir` serving the run on K4.f32
    and K6.f32; the step's times and peak memory beside the same weights'
    bf16 step; a falling loss on a fixed batch. Returns the launches by
    counter."""
    from geovpr_torch.models.swin import SWIN_VARIANTS

    tag, preset, variant, batch, n_train, n_val = F32_SWIN_CASE
    t0 = time.perf_counter()
    cfg = f32_train_cfg(preset, variant, batch, False)
    spec = SWIN_VARIANTS[variant]
    blocks, merges = sum(spec["depths"]), len(spec["depths"]) - 1
    k9c = sum(d for d, h in zip(spec["depths"], spec["num_heads"])
              if 32 * h <= 512)
    rng = np.random.default_rng(SEED + 13)
    size = cfg.data.image_size
    train_src = synthetic_val(n_train, size, rng)
    val_src = synthetic_val(n_val, size, rng)
    with tempfile.TemporaryDirectory() as tmp:
        with k9_dtypes() as seen:
            trainer, launches = train_run(
                cfg, train_src, val_src, device, tmp, F32_TRAIN_EPOCHS,
                {"fused_swin_attn_train_fwd": (blocks, 0),
                 "fused_swin_attn_bwd_all": (k9c, 0),
                 "fused_swin_attn_bwd_core": (blocks - k9c, 0),
                 "fused_swin_attn_block": (0, blocks),
                 "fused_patch_merge": (0, merges)}, tag)
        phase("f32_train_dtypes", path=tag, seen=sorted(map(str, seen)))
        check({dt for _, dt in seen} == {torch.float32},
              f"{tag}: a Swin kernel ran on a non-f32 stream: {seen}")
        tb = next(iter(_train_batches(train_src, device, batch)))
        f32_grads_vs_plain(trainer, tb, tag)
        train_resume(cfg, train_src, val_src, device, tmp, trainer, tag)
        _remat_grads_equal(trainer, tb, tag)
        for k, v in f32_remat_step(trainer, tb, tag, {
                "fused_swin_attn_train_fwd": 2 * blocks,
                "fused_swin_attn_bwd_all": k9c,
                "fused_swin_attn_bwd_core": blocks - k9c}).items():
            launches[k] += v
        with preset_as(preset, cfg), k9_dtypes() as seen:
            got = evaluate_run_dir(
                preset, trainer.run_dir, val_src, batch, blocks, device, tag,
                per_batch={"fused_swin_attn_block": blocks,
                           "fused_patch_merge": merges})
        check(seen == {("k4", torch.float32), ("k6", torch.float32)},
              f"{tag}: evaluate --run-dir served on {seen}")
        for k, v in got.items():
            launches[k] += v
        f32_vs_bf16_times(trainer, tb, card, tag)
        del trainer
        torch.cuda.empty_cache()
    train_loss_falls(device, preset, F32_SWIN_FALL_STEPS, cfg=cfg,
                     dtype=torch.float32, tag=tag)
    phase("f32_train_case", path=tag, seconds=time.perf_counter() - t0)
    return launches


def f32_swin_child(spec_path: str) -> int:
    """The f32 Swin training child of [f32_training]: cuDNN's and the
    matmuls' TF32 settings left as torch sets them (a CLI sets neither),
    `f32_tf32_conv_check`, then `f32_swin_train_record`; one
    `[f32_swin_child]` JSON line with the launches."""
    from geovpr_torch.ops._build import load_library

    load_library()
    with open(spec_path) as f:
        spec = json.load(f)
    device = torch.device("cuda")
    phase("f32_swin_child", allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
          allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    f32_tf32_conv_check(device)
    launches = f32_swin_train_record(device, spec["card"])
    print("[f32_swin_child] " + json.dumps({"launches": launches}),
          flush=True)
    return 0


def f32_swin_train_path(device, card: str) -> dict:
    """Part 3 of [f32_training]: `f32_swin_child` in a child process
    (`python3 chip_smoke.py --f32-swin-child SPEC`), its phase lines passed
    on; a failed child fails the phase. Returns its launches."""
    with tempfile.TemporaryDirectory() as root:
        spec = os.path.join(root, "spec.json")
        with open(spec, "w") as f:
            json.dump({"card": card}, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--f32-swin-child",
             spec], capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in proc.stdout.splitlines():
        if line.startswith("[") and not line.startswith("[f32_swin_child] {"):
            print(line, flush=True)
    check(proc.returncode == 0, f"the f32 Swin training child exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [json.loads(line.split(" ", 1)[1])
            for line in proc.stdout.splitlines()
            if line.startswith("[f32_swin_child] {")][-1]["launches"]


def f32_training_path(device, card: str) -> dict:
    """The [f32_training] phase: the f32 training kernels against their
    plain versions and timed (`f32_train_kernels_vs_plain`,
    `f32_k9_kernels_vs_plain`), then f32 DINOv2 training through
    `run_train` (`f32_train_paths`) and f32 Swin training in a child
    (`f32_swin_train_path`). Returns, for the kernels line, the kernels'
    errors and times by (kind, shape) and the paths' launches
    (`launches`, by counter)."""
    t0 = time.perf_counter()
    out = f32_train_kernels_vs_plain(device, card)
    out.update(f32_k9_kernels_vs_plain(device, card))
    launches = f32_train_paths(device, card)
    for k, v in f32_swin_train_path(device, card).items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    phase("f32_training", launches=out["launches"],
          seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------- int8_f32 --
# w8a8 serving with an f32 stream: a model built with
# compute_dtype="float32" and int8, as `cli.evaluate --int8` and `cli.fuse
# --int8` build it from an f32 configuration or run directory. The f32
# forms of K2, K3 and K5 (`csrc/hopper_gemm_s8.cuh`'s LN-quant pass and
# residual epilogues in the stream's type) against their plain f32
# versions: K3 at DINOv2-B/14's rows, at the four Swin-B-384 stages and at
# ConvNeXt-B's four stages with the separate residual; K2 at the main
# shape; K5 at the four Swin-B-384 stages; K2 and K5 (stage 0) also in int8
# P.V and bf16 scores. A call is held in four checks
# (`int8_f32_launch_checks`):
# - its LN-quant launch alone: the int8 rows against `ln_quant_reference`,
#   within one step in at most INT8_F32_LN_SHARE of them;
# - the rest of the half-block, the call's output against the plain
#   version fed the kernel's own int8 rows, under `int8_within_bound`. Fed
#   the plain rows instead, the call misses that bound at Swin-B-384's
#   stages 2 and 3 (1.0% to 1.8% of the outputs off by more than 1e-3,
#   measured on an H100): an f32 LayerNorm sums 24-bit values, whose sum
#   rounds otherwise in another order (bf16's 8-bit ones mostly sum
#   exactly), and the rare int8 row value it flips (under 1e-6 of them)
#   moves a token's q, k and v and with them a window of contexts. The two
#   bf16 spacings stay in the bound although the output is f32: one
#   flipped int8 context value moves an output by up to 127 dequant steps
#   (a full-scale weight), and a row may hold a few such flips; the
#   spacings are what the bf16 form's check allows the same flips;
# - its out projection (K3's fc2) alone on the kernel's own int8 input
#   against `int8_resid_reference` in f32: the branch's relative error
#   within F32_BRANCH_REL;
# and the whole call against the plain version on the same x: its largest
# error and its share of elements off by more than 1e-3 within the limits
# of INT8_F32_CALL_LIMITS, about twice the largest of each kernel's
# readings at these shapes on an H100 (K3: 0.0332 and 0.067 %; K2: 0.0122
# and 0.184 %; K5: 0.0394 and 1.49 %, the same in every run), so that a
# fault in the f32 pieces that the three parts' looser bounds let through
# fails here. The limits hold at these shapes only: one flipped row of a
# 98-row call (K3 at 2 x 49 x 1024) moves 0.44 % of its outputs. Then each is timed in CUDA
# graphs beside its library yardstick, with its bound at 4 bytes a value
# of the stream, and its plain version beside them by CUDA events (the
# plain K2 and K5 copy a host constant in the call, which a graph cannot
# capture). Then the four int8 model families at full width in f32,
# calibrated on a batch of 64, the kernel path against the plain path, and
# the entry points (`run_evaluate --int8`, `cli.evaluate --run-dir --int8`,
# `cli.fuse --int8`) on f32 configurations and run directories.
INT8_F32_TIME_ITERS = 5
# the share of int8 LN-quant values one step off (readings <= 9.3e-7)
INT8_F32_LN_SHARE = 1e-4
# the whole call against the plain version: (largest error, share of
# elements off by more than INT8_ABS_TOL) by kernel
INT8_F32_CALL_LIMITS = {"K3": (0.07, 2e-3), "K2": (0.025, 4e-3),
                        "K5": (0.08, 0.03)}
# the models: (path, preset, {counter: launches a batch of 64}, {(kernel,
# stream dtype): launches a batch}); the blocks hand K2 and K5 a bf16
# stream (`layers.int8_kernel_route`) and K3 the f32 one
INT8_F32_MODELS = (
    ("swin-b-384", SWIN_PRESET,
     {"fused_swin_attn_block_int8": SWIN_BLOCKS,
      "fused_mlp_block_int8": SWIN_BLOCKS,
      "fused_patch_merge": SWIN_BOUNDARIES},
     {("K5", torch.bfloat16): SWIN_BLOCKS,
      ("K3", torch.float32): SWIN_BLOCKS}),
    ("swin-t-224", ANGLE_PRESET,
     {"fused_mlp_block_int8": SWIN_T_BLOCKS,
      "fused_patch_merge": SWIN_BOUNDARIES},
     {("K3", torch.float32): SWIN_T_BLOCKS}),
    ("convnext-b", CNN_PRESETS[1],
     {"fused_mlp_block_int8": CONVNEXT_BLOCKS},
     {("K3", torch.float32): CONVNEXT_BLOCKS}),
    ("dinov2-b14-meanpool", "dinov2_meanpool_huber",
     {"fused_mhsa_block_int8": DINO_BLOCKS,
      "fused_mlp_block_int8": DINO_BLOCKS},
     {("K2", torch.bfloat16): DINO_BLOCKS,
      ("K3", torch.float32): DINO_BLOCKS}))
INT8_F32_N_FUSE = 64
# the attention modes in the order [int8_f32] checks them, the default first
ATTN_MODE_ORDER = ("int8_scores", "int8_pv", "bf16_scores")


@contextlib.contextmanager
def int8_stream_dtypes():
    """The stream dtypes K2, K3 and K5 are launched on inside the block,
    counted by (kernel, dtype): each wrapper's type check
    (`check_int8_kernel_args` with the kernel's rule) is recorded."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import mlp_int8 as mi
    from geovpr_torch.ops import swin_block as sb

    seen: dict = {}
    saved = {m: m.check_int8_kernel_args for m in (mh, mi, sb)}

    def wrap(fn):
        def rec(x, mats, vecs, dtype_error, extra=()):
            key = (dtype_error.__name__[:2].upper(), x.dtype)
            seen[key] = seen.get(key, 0) + 1
            return fn(x, mats, vecs, dtype_error, extra)
        return rec

    for m, fn in saved.items():
        m.check_int8_kernel_args = wrap(fn)
    try:
        yield seen
    finally:
        for m, fn in saved.items():
            m.check_int8_kernel_args = fn


def int8_rows_errors(got, want) -> dict:
    """An int8 launch's output against its plain part: the largest step
    and the share of values off."""
    d = (got.int() - want.int()).abs()
    return dict(int8_max_step=d.max().item(),
                int8_off_share=(d > 0).float().mean().item())


def int8_f32_launch_checks(kind: str, x, a: dict, got, eps: float,
                           residual=None, limits=None) -> dict:
    """The checks of one f32 call of K2, K3 or K5 (`kind`) on x with the
    folded arguments `a` (K5's: `k5_kwargs`), whose output was `got`: its
    LN-quant launch alone (`int8_rows_errors`), the rest of the half-block
    fed the kernel's int8 rows (`int8_errors` of got against it), its out
    projection alone on the kernel's own int8 input (`f32_branch_error`),
    the whole call against the plain version (`call`: its largest error
    and share over INT8_ABS_TOL, beside `limits`, (max, share), where they
    are given: INT8_F32_CALL_LIMITS hold at [int8_f32]'s shapes, where the
    rare flipped row averages out; a call of a few rows, as the card tests
    make, moves about 1 % of its outputs by one such row). The launches
    run alone count no launch."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import mlp_int8 as mi
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops.quant import (attn_mode, int8_resid_reference,
                                        ln_quant_reference,
                                        qkv_part_reference)

    d = x.shape[-1]
    m = x.numel() // d
    r = (x if residual is None else residual).reshape(m, d)
    plain = {"K2": mh.mhsa_block_int8_reference,
             "K3": mi.mlp_block_int8_reference,
             "K5": sb.swin_attn_block_int8_reference}[kind]
    err = (got.double() - plain(
        x, **a, ln_eps=eps, **({} if residual is None
                               else {"residual": residual})).double()).abs()
    call = dict(max_abs_err=err.max().item(),
                share_over_1e3=(err > INT8_ABS_TOL).float().mean().item(),
                **({} if limits is None else dict(max_limit=limits[0],
                                                  share_limit=limits[1])))
    del err
    if kind == "K3":
        bufs = mi.k3_buffers(x, a["w1q_t"].shape[0])
        for i in range(len(mi.K3_PARTS)):
            mi.k3_launch_part(i, x, **a, ln_eps=eps, residual=residual,
                              bufs=bufs)
        torch.cuda.synchronize()
        xq, mid, out = bufs[0], bufs[1], bufs[2]
        rest = int8_resid_reference(mi.mlp_fc1_int8_reference(
            xq, a["w1q_t"], a["s1_eff"], a["b1"], a["inv_a_mid"]),
            a["w2q_t"], a["s2_eff"], a["b2"], r, a["gamma"])
        w, s, b, gamma = a["w2q_t"], a["s2_eff"], a["b2"], a["gamma"]
        step = (a["s2_eff"] * a["gamma"]).abs().max().item()
    else:
        mode = attn_mode(a["cs"], a["cpv"])
        if kind == "K2":
            bufs = mh.k2_buffers(x, mode)
            h = a["num_heads"]

            def launch(i):
                mh.k2_launch_part(i, x, **a, ln_eps=eps, bufs=bufs)

            def attention(qk, v):
                return mh.vit_attention8_reference(qk, v, h, x.shape[1],
                                                   a["cs"], a["cpv"],
                                                   a["cpl"])
            gamma = a["gamma"]
        else:
            bufs = sb.k5_buffers(x, mode)
            h = a["num_heads"]

            def launch(i):
                sb.k5_launch_part(i, x, **a, ln_eps=eps, bufs=bufs)

            def attention(qk, v):
                return sb.swin_attention8_reference(
                    qk, v, a["table"], h, a["resolution"], a["window"],
                    a["shift"], a["cs"], a["cpv"])
            gamma = None
        launch(0)
        torch.cuda.synchronize()
        xq = bufs[2].clone()
        for i in range(1, 4):
            launch(i)
        torch.cuda.synchronize()
        mid, out = bufs[2], bufs[3]
        qk, v = qkv_part_reference(xq, a["wqkv_q_t"], a["sqkv_eff"],
                                   a["bqkv_eff"], mode,
                                   (d // h) ** -0.5 * mh.LOG2E)
        w, s, b = a["wo_q_t"], a["so_eff"], a["bo"]
        rest = int8_resid_reference(attention(qk, v), w, s, b, r, gamma)
        del qk, v
        step = (s * (1.0 if gamma is None else gamma)).abs().max().item()
    return dict(
        ln_quant=int8_rows_errors(xq, ln_quant_reference(
            x, a["ln_scale_q"], a["ln_bias_q"], eps)),
        rest=int8_errors(got.reshape(m, d), rest, step),
        epilogue=f32_branch_error(out.reshape(m, d), int8_resid_reference(
            mid, w, s, b, r, gamma), r),
        call=call)


def int8_f32_within_bound(c: dict) -> bool:
    """`int8_f32_launch_checks`'s checks hold (the whole call's where it
    was given limits)."""
    lq, ep, call = c["ln_quant"], c["epilogue"], c["call"]
    return (lq["int8_max_step"] <= 1
            and lq["int8_off_share"] <= INT8_F32_LN_SHARE
            and int8_within_bound(c["rest"]) and ep["finite"]
            and ep["branch_rel_err"] <= F32_BRANCH_REL
            and call["max_abs_err"] <= call.get("max_limit", float("inf"))
            and call["share_over_1e3"] <= call.get("share_limit", 1.0))


def int8_f32_cases(device, k3=True, k2=True, k5=True):
    """(kind, tag, mode, args, eps, plain, library, bound) for each checked
    case of [int8_f32], built one at a time on f32 streams: `args` the
    wrapper's keyword arguments but eps (x, the folded arguments, K3's
    residual, K2's num_heads, K5's geometry)."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import mlp_int8 as mi
    from geovpr_torch.ops import swin_block as sb

    f32 = torch.float32
    if k3:
        b, n, d, h = MAIN_SHAPE
        x, _, a = int8_block_case(b, n, d, h, device, dtype=f32)
        yield ("K3", "B{}_N{}_D{}".format(b, n, d), None, dict(x=x, **a),
               1e-6, mi.mlp_block_int8_reference, library_k3,
               bounds("K3", b, n, d, h, width=4))
        del x, a
        for shape in SWIN_ATTN_SHAPES:
            b, c, h, res, win, shift = shape
            x, blk = swin_block_case(shape, device, int8=True, dtype=f32)
            yield ("K3", "swin_B{}_C{}_S{}".format(b, c, res), None,
                   dict(x=x, **blk._folded_args(blk._k3)), 1e-5,
                   mi.mlp_block_int8_reference, library_k3,
                   bounds("K3", b, res * res, c, 1, width=4))
            del x, blk
        for shape in CONVNEXT_K3_SHAPES:
            b, side, c = shape
            h2, x, a = convnext_k3_case(shape, device, dtype=f32)
            eps = a.pop("ln_eps")
            yield ("K3", "convnext_B{}_S{}_C{}".format(*shape), None,
                   dict(x=h2, **a, residual=x), eps,
                   mi.mlp_block_int8_reference, library_k3,
                   bounds("K3", b, side * side, c, 1, residual=True,
                          width=4))
            del h2, x, a
    if k2:
        b, n, d, h = MAIN_SHAPE
        for mode in ATTN_MODE_ORDER:
            with int8_mode(mode):
                x, a, _ = int8_block_case(b, n, d, h, device, dtype=f32)
            yield ("K2", "B{}_N{}_D{}_H{}".format(*MAIN_SHAPE), mode,
                   dict(x=x, **a, num_heads=h), 1e-6,
                   mh.mhsa_block_int8_reference, library_k2,
                   bounds("K2", b, n, d, h, mode=mode, width=4))
            del x, a
    if k5:
        for shape in SWIN_ATTN_SHAPES:
            for mode in (ATTN_MODE_ORDER if shape == SWIN_MAIN
                         else ATTN_MODE_ORDER[:1]):
                with int8_mode(mode):
                    x, blk = swin_block_case(shape, device, int8=True,
                                             dtype=f32)
                yield ("K5", "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape),
                       mode, dict(x=x, **k5_kwargs(blk)), 1e-5,
                       sb.swin_attn_block_int8_reference, library_k5,
                       swin_bounds("K5", shape, mode, width=4))
                del x, blk
                torch.cuda.empty_cache()


def int8_f32_kernels_vs_plain(device, card: str | None = None,
                              **which) -> dict:
    """Part 1 of [int8_f32]: each case of `int8_f32_cases` (`which`: k3=,
    k2=, k5= to narrow them) launched once on its f32 stream, held by
    `int8_f32_launch_checks` (`[kernel] name=K3.f32` ...), then, with
    `card`, timed in CUDA graphs in turns with its library yardstick
    beside its bound and its plain version (`[kernel_time]`). Returns each
    case's error and times by (kind, tag, mode)."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import mlp_int8 as mi
    from geovpr_torch.ops import swin_block as sb

    wrappers = {"K2": mh.fused_mhsa_block_int8,
                "K3": mi.fused_mlp_block_int8,
                "K5": sb.fused_swin_attn_block_int8}
    out = {}
    for kind, tag, mode, args, eps, plain, library, bnd in int8_f32_cases(
            device, **which):
        name = f"{kind}.f32" + (f".{mode}" if mode and mode != "int8_scores"
                                else "")
        kernel = wrappers[kind]
        a = {k: v for k, v in args.items() if k not in ("x", "residual")}
        with torch.inference_mode():
            before = kernel.launches
            got = kernel(**args, ln_eps=eps)
            torch.cuda.synchronize()
            check(kernel.launches == before + 1 and got.dtype == torch.float32,
                  f"{name} did not launch on f32 at {tag}")
            c = int8_f32_launch_checks(kind, args["x"], a, got, eps,
                                       args.get("residual"),
                                       INT8_F32_CALL_LIMITS[kind])
            del got
        phase("kernel", name=name, shape=tag, max_share=INT8_MAX_SHARE,
              ln_share_limit=INT8_F32_LN_SHARE,
              **{f"{k}_{m}": v for k, r in c.items() for m, v in r.items()})
        check(int8_f32_within_bound(c),
              f"{name} outside its bounds at {tag}: {c}")
        row = dict(max_abs_err=c["call"]["max_abs_err"])
        if card:
            with torch.inference_mode():
                t = interleaved_graph_ms({
                    "kernel": lambda: kernel(**args, ln_eps=eps),
                    "library": lambda: library(**args, ln_eps=eps)},
                    INT8_F32_TIME_ITERS)
                t.update(interleaved_ms({
                    "plain": lambda: plain(**args, ln_eps=eps)},
                    INT8_F32_TIME_ITERS))
            row.update(ms=t["kernel"][0], plain_ms=t["plain"][0],
                       library_ms=t["library"][0],
                       runs={k: v[1] for k, v in t.items()}, **bnd)
            phase("kernel_time", card=repr(card), name=name, shape=tag,
                  timed="cuda_graph", plain_timed="cuda_events", **row)
        out[(kind, tag, mode)] = row
        del args, a
        torch.cuda.empty_cache()
    return out


def int8_f32_model(preset: str, device, dtype: str, state=None):
    """The preset's w8a8 RegressionModel at full width with compute_dtype
    `dtype`, from seed 0 perturbed as `perturb_swin_` (Swin, DINOv2) or
    `perturb_cnn_` (ConvNeXt), or with the float weights `state`; not yet
    calibrated. Returns (model, cfg)."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset

    cfg = build_preset(preset)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dtype))
    model, _ = build_model(cfg, "cpu", seed=SEED, int8=True)
    if state is None:
        perturb = (perturb_cnn_ if cfg.model.family == "convnext"
                   else perturb_swin_)
        perturb(model, torch.Generator().manual_seed(SEED))
    else:
        model.load_state_dict(state, strict=False)
    return model.to(device), cfg


def int8_f32_models(device) -> dict:
    """Part 2 of [int8_f32]: each of INT8_F32_MODELS in f32 with int8,
    calibrated on a batch of 64 seeded images (`calibrate_int8`): every
    launch count set to 0 just before the kernel path and read just after
    (and the stream dtypes each int8 kernel took), then the plain path
    (which keeps f32 where the kernel path rounds at K2 and K5, as JAX's
    XLA route does): pooled features and predictions at cosine at least
    MIN_COSINE_INT8 a row; the bf16 w8a8 model on the same weights and
    images beside it (`[int8_f32_model]`). Returns the launches by
    counter."""
    from geovpr_torch.cli.evaluate import calibrate_int8
    from geovpr_torch.data.transforms import normalize

    counters = {**kernel_counters(), **swin_counters()}
    totals: dict = {}
    for path, preset, want, want_dtypes in INT8_F32_MODELS:
        model, cfg = int8_f32_model(preset, device, "float32")
        source = synthetic_val(SWIN_BATCH, cfg.data.image_size,
                               np.random.default_rng(SEED))
        images = normalize(torch.from_numpy(source.images).to(device))
        calibrate_int8(model, source, SWIN_BATCH, device)
        mods = [m for m in model.modules() if hasattr(m, "use_kernels")]

        def forward(m):
            feats = m.pooled_features(images)
            return feats.float(), m.head_only(feats).float()

        with torch.inference_mode():
            for fn in counters.values():
                fn.launches = 0
            with int8_stream_dtypes() as seen:
                pooled, preds = forward(model)
                torch.cuda.synchronize()
            got = {k: fn.launches for k, fn in counters.items()
                   if fn.launches}
            for m in mods:
                m.use_kernels = False
            try:
                pooled_p, preds_p = forward(model)
            finally:
                for m in mods:
                    m.use_kernels = True
        cos = torch.nn.functional.cosine_similarity(pooled, pooled_p, dim=1)
        cos_pred = torch.nn.functional.cosine_similarity(preds, preds_p,
                                                         dim=1)
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
        model16, _ = int8_f32_model(preset, device, "bfloat16", state)
        calibrate_int8(model16, source, SWIN_BATCH, device)
        with torch.inference_mode():
            pooled16, _ = forward(model16)
        cos16 = torch.nn.functional.cosine_similarity(pooled, pooled16,
                                                      dim=1)
        dtypes = {f"{k}.{str(t)[6:]}": v for (k, t), v in seen.items()}
        phase("int8_f32_model", path=path, batch=SWIN_BATCH,
              pooled_min_cosine=cos.min().item(),
              pred_min_cosine=cos_pred.min().item(), bound=MIN_COSINE_INT8,
              vs_bf16_int8_min_cosine=cos16.min().item(),
              vs_bf16_int8_mean_cosine=cos16.mean().item(),
              launches=got, expected_launches=want, stream_dtypes=dtypes)
        check(got == want and seen == want_dtypes,
              f"{path}: launches {got} on {seen}, expected {want} on "
              f"{want_dtypes}")
        check(bool(torch.isfinite(pooled).all() and torch.isfinite(
            preds).all()), f"{path}: f32 int8 outputs not finite")
        check(cos.min().item() >= MIN_COSINE_INT8
              and cos_pred.min().item() >= MIN_COSINE_INT8,
              f"{path}: kernel vs plain path cosine {cos.min().item()}, "
              f"predictions {cos_pred.min().item()}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        del model16, state, images
        torch.cuda.empty_cache()
    return totals


def int8_f32_entry_points(device, card: str) -> dict:
    """Part 3 of [int8_f32]: the entry points on f32 configurations and
    run directories, every launch count set to 0 just before each and read
    just after, and the stream dtypes of K2, K3 and K5: `run_evaluate(...,
    int8=True)` on swin_b384_gemini2 at compute_dtype float32 (one batch of
    64); `cli.evaluate --run-dir <run> --int8` on an f32 ConvNeXt-B angle
    run directory written with the port's `save_checkpoint`
    (convnext_direct_maae); one `cli.fuse.main --int8` batch over f32
    Swin-B-384 geopose and ConvNeXt-B angle run directories: the CSVs,
    finite metrics, launches (`[geopose]`, `[evaluate_run_dir]`,
    `[fuse]`). Returns the launches by counter."""
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.objectives.scaler import scaler_from_arrays

    totals: dict = {}

    def add(launches, seen, want_dtypes, path):
        phase("int8_f32_dtypes", path=path, stream_dtypes={
            f"{k}.{str(t)[6:]}": v for (k, t), v in seen.items()})
        check(seen == want_dtypes, f"{path}: int8 kernels on {seen}, "
              f"expected {want_dtypes}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    f32 = {p: dataclasses.replace(c, model=dataclasses.replace(
        c.model, compute_dtype="float32")) for p, c in (
        (p, build_preset(p)) for p in (SWIN_PRESET, CNN_PRESETS[1]))}
    swin_dtypes = {("K5", torch.bfloat16): SWIN_BLOCKS,
                   ("K3", torch.float32): SWIN_BLOCKS}
    conv_dtypes = {("K3", torch.float32): CONVNEXT_BLOCKS}
    with tempfile.TemporaryDirectory() as root:
        model, cfg = int8_f32_model(SWIN_PRESET, device, "float32")
        source = synthetic_val(SWIN_BATCH, cfg.data.image_size,
                               np.random.default_rng(SEED + 1))
        scaler = scaler_from_arrays(source.targets.mean(0),
                                    source.targets.std(0)).to(device)
        with int8_stream_dtypes() as seen:
            launches, _ = geopose_end_to_end(
                model, scaler, device, source, os.path.join(root, "eval"),
                int8=True, tag="int8-f32")
        add(launches, seen, swin_dtypes, "run_evaluate")
        del model
        torch.cuda.empty_cache()

        with preset_as(SWIN_PRESET, f32[SWIN_PRESET]), \
                preset_as(CNN_PRESETS[1], f32[CNN_PRESETS[1]]):
            runs = {p: fuse_run_dir(root, p) for p in f32}
            conv_cfg = f32[CNN_PRESETS[1]]
            val = synthetic_val(SWIN_BATCH, conv_cfg.data.image_size,
                                np.random.default_rng(SEED + 2), angles=True)
            with int8_stream_dtypes() as seen:
                launches = evaluate_run_dir(
                    CNN_PRESETS[1], runs[CNN_PRESETS[1]], val, SWIN_BATCH,
                    0, device, "convnext-b-int8-f32",
                    per_batch={"fused_mlp_block_int8": CONVNEXT_BLOCKS},
                    extra=("--int8",))
            add(launches, seen, conv_dtypes, "evaluate_run_dir")

            test_dir, _, _ = fuse_images(os.path.join(root, "fuse"),
                                         np.random.default_rng(SEED),
                                         INT8_F32_N_FUSE, 0)
            argv = ["--test-dir", test_dir, "--device", str(device),
                    "--batch-size", str(INT8_F32_N_FUSE),
                    "--int8", "--geopose-preset", SWIN_PRESET,
                    "--geopose-run", runs[SWIN_PRESET], "--angle-preset",
                    CNN_PRESETS[1], "--angle-run", runs[CNN_PRESETS[1]],
                    "--out-dir", os.path.join(root, "fuse_out")]
            with int8_stream_dtypes() as seen:
                _, launches = fuse_cli(argv, {
                    "fused_swin_attn_block_int8": SWIN_BLOCKS,
                    "fused_mlp_block_int8": SWIN_BLOCKS + CONVNEXT_BLOCKS,
                    "fused_patch_merge": SWIN_BOUNDARIES}, "fuse-int8-f32",
                    INT8_F32_N_FUSE)
            add(launches, seen, {
                ("K5", torch.bfloat16): SWIN_BLOCKS,
                ("K3", torch.float32): SWIN_BLOCKS + CONVNEXT_BLOCKS},
                "fuse")
    return totals


def int8_f32_path(device, card: str) -> dict:
    """The [int8_f32] phase: the f32 forms of K2, K3 and K5 against their
    plain versions and timed (`int8_f32_kernels_vs_plain`), the four model
    families in f32 with int8 (`int8_f32_models`) and the entry points
    (`int8_f32_entry_points`). Returns, for the kernels line, the cases'
    errors and times and the launches (`launches`, by counter; the launches
    on an f32 stream by kernel, `f32_launches`)."""
    t0 = time.perf_counter()
    out = int8_f32_kernels_vs_plain(device, card)
    launches = int8_f32_models(device)
    for k, v in int8_f32_entry_points(device, card).items():
        launches[k] = launches.get(k, 0) + v
    phase("int8_f32", launches=launches, seconds=time.perf_counter() - t0)
    out["launches"] = launches
    return out


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
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        """`[phase_seconds]` of the stage that ends here."""
        now = time.perf_counter()
        phase("phase_seconds", name=name, seconds=now - last[0])
        last[0] = now

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
    lap("dinov2_serving")

    swin_errs = swin_kernels_vs_plain(device)
    swin_launches = swin_path(device, card)
    skt = swin_kernel_times(device, card)
    swin_part_times(device, card)
    lap("swin_serving")

    k7_errs = k7_kernels_vs_plain(device)
    swin_kernels_vs_plain(device, attn_shapes=(),
                          merge_shapes=SWIN_T_MERGE_SHAPES)
    angle_launches = angle_path(device, card)
    k7t = k7_kernel_times(device, card)
    k7_half_times(device, card)
    lap("angle_serving")

    fuse_launches = fuse_path(device, card)
    convnext_k3(device, card)
    lap("fuse")

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
    lap("swin_train")

    k8_errs = k8_kernels_vs_plain(device)
    dino_launches = dinov2_train_path(device, card)
    k8t = k8_kernel_times(device, card)
    k8t["K8b"] = k8_kernel_times(device, card, K8_SHAPES[1], ("K8b",))["K8b"]
    k8c_part_times(device, card)
    lap("dinov2_train")

    rest_launches = {}
    index_1m_path(device, card)
    lap("index_1m")
    for path in (dinov2_sincos_path, salad_frozen_path, swin_t_train_path,
                 cnn_train_path, parallel_path, convert_parity_path,
                 train_disk_path):
        for k, v in path(device, card).items():
            rest_launches[k] = rest_launches.get(k, 0) + v
        lap(path.__name__)

    modes = int8_modes_path(device, card)
    lap("int8_modes")
    f32s = f32_serving_path(device, card)
    lap("f32_serving")
    f32t = f32_training_path(device, card)
    lap("f32_training")
    i8f = int8_f32_path(device, card)
    lap("int8_f32")

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
    # K2 and K5 in their two other attention modes: errors and times at the
    # main shapes (K5 at stage 0), launches in the CLI children's runs
    for mode, mt in modes.items():
        for name, k, src, replaces, t in (
                ("fused_mhsa_block_int8", "K2",
                 "geovpr_torch/csrc/mhsa_int8.cu",
                 "geovpr/ops/pallas_mhsa.py:554", mt["K2"]),
                ("fused_swin_attn_block_int8", "K5",
                 "geovpr_torch/csrc/swin_attn.cu",
                 "geovpr/ops/pallas_swin_block.py:1159",
                 mt[("K5", SWIN_MAIN)])):
            rows.append({"name": f"{name}.{mode}", "route": "cuda",
                         "source": src, "replaces": replaces,
                         "launches": mt["launches"][k],
                         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                         "plain_ms": t["plain_ms"],
                         "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"],
                         "library_ms": t["library_ms"]})
    # the f32 forms of K1, K4, K6 and K7 (csrc/f32_serving.cu) at the main
    # shapes, launches in [f32_serving]'s models and parity child and in
    # [convert_parity]'s salad leg
    for name, k, replaces, shape in (
            ("fused_mhsa_block", "K1", "geovpr/ops/pallas_mhsa.py:904",
             MAIN_SHAPE),
            ("fused_swin_attn_block", "K4",
             "geovpr/ops/pallas_swin_block.py:1125", SWIN_MAIN),
            ("fused_patch_merge", "K6", "geovpr/ops/pallas_patch_merge.py:112",
             MERGE_MAIN),
            ("window_attention_raster", "K7",
             "geovpr/ops/pallas_window_attention.py:182", K7_RASTER_MAIN)):
        t = f32s[(k, shape)]
        rows.append({"name": f"{name}.f32", "route": "cuda",
                     "source": "geovpr_torch/csrc/f32_serving.cu",
                     "replaces": replaces,
                     "launches": f32s["launches"].get(name, 0)
                     + f32t["launches"].get(name, 0)
                     + rest_launches.get(f"{name}.f32", 0),
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the f32 forms of K8a (K1's f32 launches), K8b and K8c
    # (csrc/f32_train.cu) at DINOv2-B/14's training shape (K8b at
    # -L/14's, the one path that launches it), launches in [f32_training]'s
    # paths
    for name, k, line, src, shape in (
            ("fused_mhsa_train_fwd", "K8a", 1094, "f32_serving", K8_MAIN),
            ("fused_mhsa_bwd_core", "K8b", 1166, "f32_train", K8_SHAPES[1]),
            ("fused_mhsa_bwd_all", "K8c", 1385, "f32_train", K8_MAIN)):
        t = f32t[(k, shape)]
        rows.append({"name": f"{name}.f32", "route": "cuda",
                     "source": f"geovpr_torch/csrc/{src}.cu",
                     "replaces": f"geovpr/ops/pallas_mhsa.py:{line}",
                     "launches": f32t["launches"].get(name, 0),
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the f32 forms of K9a (K4.f32's launches with the training attention,
    # csrc/f32_serving.cu), K9b and K9c (csrc/f32_train.cu) at Swin-B-384's
    # stage 0 (K9b at stage 3, the one path that launches it), launches in
    # [f32_training]'s Swin child
    for name, k, line, src, shape in (
            ("fused_swin_attn_train_fwd", "K9a", 1263, "f32_serving",
             K9_MAIN),
            ("fused_swin_attn_bwd_core", "K9b", 1351, "f32_train",
             K9_SHAPES[3]),
            ("fused_swin_attn_bwd_all", "K9c", 910, "f32_train", K9_MAIN)):
        t = f32t[(k, shape)]
        rows.append({"name": f"{name}.f32", "route": "cuda",
                     "source": f"geovpr_torch/csrc/{src}.cu",
                     "replaces": f"geovpr/ops/pallas_swin_block.py:{line}",
                     "launches": f32t["launches"].get(name, 0),
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the f32 forms of K3, K2 and K5 (csrc/hopper_gemm_s8.cuh's LN-quant
    # pass and residual epilogues in the stream's type) at the main shapes
    # in the default mode; launches on an f32 stream in [int8_f32]'s models
    # and entry points, where K3 takes the f32 stream and K2 and K5 a bf16
    # one (the blocks cast around them, as JAX's do: their f32 forms have
    # no launch there, and their bf16 launches go to the bf16 rows, as
    # [int8_f32]'s K6 launches, all on f32 streams, go to K6.f32's)
    for name, k, src, replaces, tag in (
            ("fused_mlp_block_int8", "K3", "mlp_int8", "pallas_mlp.py:91",
             "B{}_N{}_D{}".format(*MAIN_SHAPE[:3])),
            ("fused_mhsa_block_int8", "K2", "mhsa_int8", "pallas_mhsa.py:554",
             "B{}_N{}_D{}_H{}".format(*MAIN_SHAPE)),
            ("fused_swin_attn_block_int8", "K5", "swin_attn",
             "pallas_swin_block.py:1159",
             "B{}_C{}_H{}_S{}_w{}_shift{}".format(*SWIN_MAIN))):
        t = i8f[(k, tag, None if k == "K3" else "int8_scores")]
        rows.append({"name": f"{name}.f32", "route": "cuda",
                     "source": f"geovpr_torch/csrc/{src}.cu",
                     "replaces": f"geovpr/ops/{replaces}",
                     "launches": i8f["launches"].get(name, 0)
                     if k == "K3" else 0,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    for row in rows:
        if row["name"] in ("fused_mhsa_block_int8",
                           "fused_swin_attn_block_int8"):
            row["launches"] += i8f["launches"].get(row["name"], 0)
        elif row["name"] == "fused_patch_merge.f32":
            row["launches"] += i8f["launches"].get("fused_patch_merge", 0)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"index_1m": index_1m_path, "train_disk": train_disk_path,
          "int8_modes": int8_modes_path, "f32_serving": f32_serving_path,
          "f32_training": f32_training_path, "int8_f32": int8_f32_path}


def run_phases(names: list) -> int:
    """Build the kernels and run only the named phases of PHASES
    (`python3 chip_smoke.py --phases index_1m,train_disk`); the last line
    is `[phases] ok=True`."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from geovpr_torch.ops._build import load_library

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    load_library()
    phase("build", seconds=time.perf_counter() - t0)
    for name in names:
        t0 = time.perf_counter()
        PHASES[name](device, card)
        phase("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    phase("phases", ok=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phases"]:
        sys.exit(run_phases(sys.argv[2].split(",")))
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel-gloo"]:
        sys.exit(parallel_gloo_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--convert-parity-child"]:
        sys.exit(cp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--modes-child"]:
        sys.exit(modes_child(sys.argv[2]))
    if sys.argv[1:2] == ["--f32-swin-child"]:
        sys.exit(f32_swin_child(sys.argv[2]))
    sys.exit(main())
