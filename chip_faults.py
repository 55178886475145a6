"""Planted-fault check of the kernel bounds in chip_smoke.py.

    python3 chip_faults.py

For each planted fault it copies `geovpr_torch/` into a temporary
directory, breaks one line of a kernel source there (K2's attention
without its key mask, or skipping the last key tile, which at N = 257
holds one key; K3 with b2 dropped from its fc2 epilogue; the int8 TMA + wgmma GEMM
of K3 and K5 never multiplying the last k tile of a tile, caught through
K3, whose fc2 has the hidden width as K; K4's window attention without
the shift mask, without the relative-position bias, or loading the wrapped
quarters of a shifted window from their unwrapped origin; K5's int8-score
window attention without the shift mask, or loading its wrapped quarters
from their unwrapped origin; K7 (its raster mode, the serving path's)
counting the pad keys past N (their bias columns 0 instead of -inf),
without the shift mask, or reading (and writing) the wrapped tokens of a
window row from its unwrapped origin, clamped into the image; K6's merge-LN pass with x10
and x01 swapped in the concat order, or reading x01 from the token below
instead of the token to the right;
K9a's attention without the shift mask, or its QKV GEMM writing the
scaled q copy unscaled; the core backward (K9b, and K9c's launch 3)
without the sum of dp * p in the softmax backward, or loading the wrapped
quarters of a shifted window from their unwrapped origin; K9c with dbias
taken from one CTA's partial sum only, its
weight-gradient GEMM dropping the last chunk of rows, or da reading Wo
with the wrong major-ness (g Wo for g Wo^T); K8a
(K1's attention) without the mask of the keys past N; K1's TMA + wgmma
GEMM (so K8a's) never multiplying the last k tile of a tile; K8b's core
without the sum of dp * p, or without the mask of the keys past N on the
one-key tail tile of N = 257; K8c with dWqkv taken from one CTA's partial
sum only, its dWqkv product skipping the 16-row tail of M = 16 x 257 =
64 x 64 + 16, or its dgamma GY epilogue summing one warpgroup's rows
only; the f32 forms (`csrc/f32_serving.cu`): K1's attention with the
score columns past N = 257 set to 0 instead of -inf, its streamed route
(N = 1370) without the mask of the keys past N, its attention dropping
the ragged tail's key (at N = 257 the one key of the last stage) or
taking each row's max over the first key tile only (an attention sink
past it overflows e^x), K4 without the shift mask (in the raster window
attention that K7's f32 raster mode shares), K6 with x10 and x01 swapped,
K7 counting the pad keys past N = 49, K9a's training attention without the
shift mask or storing p before its normalisation; `csrc/f32_train.cu`:
K8b's softmax rows without the mask of the keys past N, or its core
dropping the ragged tail's keys (at N = 257 the one key past the last
whole 32), K8c with one row chunk left out of dWqkv's
partial sums, K9b's core without the sum of dp * p, K9c with dbias summed
from one window's ds only; `csrc/f32_gemm.cuh`: the f32 GEMM's ring never
multiplying its last k stage, caught through K8c's products, and its
128 x 128 tiles never loading the last k tile of A (zeros in its place),
caught through K1.f32's QKV GEMM at M = 64 x 257),
builds that copy and runs the chip_smoke.py check of that kernel
(`int8_kernels_vs_plain` for K2/K3 and the int8 GEMM,
`swin_kernels_vs_plain` for K4/K5/K6,
`k7_kernels_vs_plain` for K7, `k9_kernels_vs_plain` for K9a-K9c,
`k8_kernels_vs_plain` for K1's GEMM and K8a-K8c, `f32_kernels_vs_plain`
for the f32 serving forms, `f32_train_kernels_vs_plain` and
`f32_k9_kernels_vs_plain` for the f32 training forms) against it at one
shape. Arguments, where given, pick
the faults whose names start with them (`python3 chip_faults.py K8`,
`python3 chip_faults.py f32`). It prints the check's error line for
the faulty kernel and whether the check rejected it, and exits non-zero
if a planted fault passes. Needs one CUDA card; the checkout itself is
never modified.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent

_INT8 = ("cs.KERNEL_SHAPES = ({shape!r},); cs.MAIN_SHAPE = {shape!r}; "
         "cs.int8_kernels_vs_plain(dev)")
_SWIN = ("cs.swin_kernels_vs_plain(dev, attn_shapes={attn!r}, "
         "merge_shapes={merge!r})")
_STAGE0 = (16, 128, 4, 96, 12, 6)    # Swin-B-384 stage 0, shifted, B=16
_K7 = "cs.k7_kernels_vs_plain(dev, shapes=(), raster_shapes={shapes!r})"
_K7_STAGE0 = (16, 96, 3, 56, 7, 3)   # Swin-T-224 stage 0, shifted, B=16
_K9 = "cs.k9_kernels_vs_plain(dev, shapes=({shape!r},))"
_K8 = "cs.k8_kernels_vs_plain(dev, shapes=((16, 257, 768, 12),))"
_F32 = ("cs.f32_kernels_vs_plain(dev, k1={k1!r}, k4={k4!r}, k6={k6!r}, "
        "k7={k7!r})")
_F32T = "cs.f32_train_kernels_vs_plain(dev, k8a=(), k8b={k8b!r}, k8c={k8c!r})"
_F32K9 = ("cs.f32_k9_kernels_vs_plain(dev, k9a={k9a!r}, k9b={k9b!r}, "
          "k9c={k9c!r})")
_STAGE3 = (16, 1024, 32, 12, 12, 0)  # Swin-B-384 stage 3, B=16

# name -> (source file, [(original text, faulty text)], check to run)
FAULTS = {
    "K2 key mask removed": ("mhsa_int8.cu", [
        ("p[j][e] = key < N", "p[j][e] = true")],
        _INT8.format(shape=(2, 1370, 768, 12))),
    "K2 attention skips the one-key tail tile": ("mhsa_int8.cu", [
        ("const int tiles = (N + A8_KEYS - 1) / A8_KEYS;",
         "const int tiles = N / A8_KEYS;")],
        _INT8.format(shape=(64, 257, 768, 12))),
    "K3 b2 dropped": ("hopper_gemm_s8.cuh", [
        ("float v0 = (float)a0 * sc.x + bb.x;",
         "float v0 = (float)a0 * sc.x;"),
        ("float v1 = (float)a1 * sc.y + bb.y;",
         "float v1 = (float)a1 * sc.y;")],
        _INT8.format(shape=(64, 257, 768, 12))),
    "int8 GEMM's last k tile never multiplied (K3's fc2)": (
        "hopper_gemm_s8.cuh", [
            ("for (int kk = 0; kk < HS_BK / 32; ++kk)",
             "for (int kk = 0; kk < (kt + 1 < ktiles ? HS_BK / 32 : 0); "
             "++kk)")],
        _INT8.format(shape=(64, 257, 768, 12))),
    "K4 shift mask dropped": ("swin_attn.cu", [
        ("if (kMasked && ((box[i][hi] ^ bk[j][c]) & wrap))",
         "if (false)")],
        _SWIN.format(attn=(_STAGE0,), merge=())),
    "K4 relative-position bias dropped": ("swin_attn.cu", [
        ("tab[pos[i][hi] - pk[j][c]]", "0.f")],
        _SWIN.format(attn=(_STAGE0,), merge=())),
    "K4 wrapped quarters loaded unwrapped": ("swin_attn.cu", [
        ("from = sw_box_origin<W>(wx, wy, box, S, shift);",
         "from = sw_box_origin<W>(wx, wy, box, 1 << 30, shift);")],
        _SWIN.format(attn=(_STAGE0,), merge=())),
    "K5 shift mask dropped": ("swin_attn.cu", [
        ("if (kMasked && ((box[i][hi] ^ kbox[j][c]) & wrap))",
         "if (false)")],
        _SWIN.format(attn=(_STAGE0,), merge=())),
    "K5 wrapped quarters loaded unwrapped": ("swin_attn.cu", [
        ("at = sw_box_origin<W>(wx, wy, box, S, shift);",
         "at = sw_box_origin<W>(wx, wy, box, 1 << 30, shift);")],
        _SWIN.format(attn=(_STAGE0,), merge=())),
    "K7 pad keys counted": ("window_attn.cu", [
        ("k >= N ? -INFINITY", "k >= N ? 0.f")],
        _K7.format(shapes=(_K7_STAGE0,))),
    "K7 shift mask dropped": ("window_attn.cu", [
        ("x[c] = (rq[hi] ^ rk[c]) & wrap ? __fadd_rn(x[c], kMaskL2)",
         "x[c] = false ? __fadd_rn(x[c], kMaskL2)")],
        _K7.format(shapes=(_K7_STAGE0,))),
    "K7 wrapped window row read from its unwrapped origin": (
        "window_attn.cu", [
            ("return o >= S ? o - S : o;", "return o >= S ? S - 1 : o;")],
        _K7.format(shapes=(_K7_STAGE0,))),
    "K6 x10 and x01 swapped": ("patch_merge.cu", [
        ("quad == 1 ? r10 : quad == 2 ? r01",
         "quad == 1 ? r01 : quad == 2 ? r10")],
        _SWIN.format(attn=(), merge=((16, 128, 96),))),
    "K6 x01 read at offset S": ("patch_merge.cu", [
        ("r01 = x + (base + 1) * C;", "r01 = x + (base + S) * C;")],
        _SWIN.format(attn=(), merge=((16, 128, 96),))),
    "K9a shift mask dropped": ("swin_train.cu", [
        ("if (kMasked && masked) v = __fadd_rn(v, kMaskL2T);",
         "if (false) v = __fadd_rn(v, kMaskL2T);")],
        _K9.format(shape=_STAGE0)),
    "K9a scaled q copy written unscaled": ("hopper_gemm.cuh", [
        ("(kEpi == HG_EPI_QKV2 && round == 1);",
         "(kEpi == HG_EPI_QKV2 && round == 2);")],
        _K9.format(shape=_STAGE0)),
    "K9b sum of dp * p dropped": ("swin_train.cu", [
        ("ds[e] = pv[e] * (dp[e] - (e >= 2 ? sub1 : sub0));",
         "ds[e] = pv[e] * dp[e];")],
        _K9.format(shape=_STAGE0)),
    "K9b wrapped quarters loaded unwrapped": ("swin_train.cu", [
        ("src = sw_box_origin<TR_W>(wx, wy, box, S, shift);",
         "src = sw_box_origin<TR_W>(wx, wy, box, 1 << 30, shift);")],
        _K9.format(shape=_STAGE0)),
    "K9c dbias from one CTA's partial": ("swin_train.cu", [
        ("reduce(st, part, G, (size_t)H * TR_N * TR_N, dbias)",
         "reduce(st, part, 1, (size_t)H * TR_N * TR_N, dbias)")],
        _K9.format(shape=_STAGE0)),
    "K9c weight-gradient GEMM drops its last chunk of rows": (
        "hopper_gemm.cuh", [
            ("const int items = tiles * ((K + kchunk - 1) / kchunk);",
             "const int items = tiles * max(1, (K - 1) / kchunk);")],
        _K9.format(shape=_STAGE0)),
    "K9c da reads Wo with the wrong major-ness": ("swin_train.cu", [
        ("launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wo),",
         "launch_gemm<HG_EPI_NONE, false>(ta, static_cast<const bf16*>(wo),"),
        ("(e = allow_gemm_smem<HG_EPI_NONE, true>()) != cudaSuccess ||",
         "(e = allow_gemm_smem<HG_EPI_NONE, true>()) != cudaSuccess ||\n"
         "      (e = allow_gemm_smem<HG_EPI_NONE, false>()) != cudaSuccess ||")],
        _K9.format(shape=_STAGE0)),
    "K8a key mask past N dropped": ("mhsa.cu", [
        ("s[e] = key < N ? s[e] * scale : -INFINITY;",
         "s[e] = s[e] * scale;"),
        ("if (key + c < N) {", "if (true) {")], _K8),
    "K1 GEMM's last k tile never multiplied": ("hopper_gemm.cuh", [
        ("for (int kk = 0; kk < HG_BK / 16; ++kk) {",
         "for (int kk = 0; kk < (kt + 1 < ktiles ? HG_BK / 16 : 0); ++kk) {")],
        _K8),
    "K8b sum of dp * p dropped": ("mhsa_train.cu", [
        ("ds[c] = p[c] * (dp[e + c] - (half ? sub1 : sub0)) * scale;",
         "ds[c] = p[c] * dp[e + c] * scale;")], _K8),
    "K8b key mask dropped on the one-key tail tile": ("mhsa_train.cu", [
        ("const bool in = kFull || 8 * (i >> 1) + 2 * t + (i & 1) < cols;",
         "const bool in = true;"),
        ("if (kFull || 8 * (i >> 1) + 2 * t + (i & 1) < cols)\n        l =",
         "if (true)\n        l ="),
        ("if (!kFull && 8 * j + 2 * t + (e & 1) >= cols) continue;", ""),
        ("p[c] = key + c < cols", "p[c] = true")],
        _K8),
    "K8c dWqkv from one CTA's partial": ("mhsa_train.cu", [
        ("reduce(st, pt, S1, (size_t)D * 3 * D,",
         "reduce(st, pt, 1, (size_t)D * 3 * D,")], _K8),
    "K8c dWqkv skips the 16-row tail of M": ("mhsa_train.cu", [
        ("ta, dqkvb, M, 3 * D, ep, nullptr, D, st, c1)",
         "ta, dqkvb, M / 64 * 64, 3 * D, ep, nullptr, D, st, c1)")], _K8),
    "K8c dgamma's GY epilogue sums one warpgroup's rows only": (
        "hopper_gemm.cuh", [
            ("for (int r = 0; r < 64 && row0 + r < M; ++r)",
             "for (int r = 0; r < 64 && row0 + r < M && wg == 0; ++r)")],
        _K8),
    "f32 K1 key mask past N dropped": ("f32_serving.cu", [
        ("S[r * lds + N + p - r * (lds - N)] = -INFINITY;",
         "S[r * lds + N + p - r * (lds - N)] = 0.f;")],
        _F32.format(k1=((16, 257, 768, 12),), k4=(), k6=(), k7=())),
    "f32 K1 streamed route's key mask past N dropped": ("f32_serving.cu", [
        ("s[r] = key < a.N ? __fmul_rn(s[r], a.scale) : -INFINITY;",
         "s[r] = __fmul_rn(s[r], a.scale);")],
        _F32.format(k1=((2, 1370, 768, 12),), k4=(), k6=(), k7=())),
    "f32 K1 attention's ragged tail key dropped": ("f32_serving.cu", [
        ("      for (int c = 0; c < nk; ++c) {",
         "      for (int c = 0; c < nk - 1; ++c) {")],
        _F32.format(k1=((16, 257, 768, 12),), k4=(), k6=(), k7=())),
    "f32 K1 attention's row max over one key tile only": ("f32_serving.cu", [
        ("          for (int c = lane; c < nv; c += 32)\n#pragma unroll\n"
         "            for (int i = 0; i < 8; ++i) {\n"
         "              const float4 v = f32_ld4(S + roff[i] + 4 * c);\n"
         "              m[i] =",
         "          for (int c = lane; c < min(nv, FV_KT / 4); c += 32)\n"
         "#pragma unroll\n"
         "            for (int i = 0; i < 8; ++i) {\n"
         "              const float4 v = f32_ld4(S + roff[i] + 4 * c);\n"
         "              m[i] =")],
        _F32.format(k1=((16, 257, 768, 12),), k4=(), k6=(), k7=())),
    "f32 GEMM's wide tiles never load their last k tile": ("f32_gemm.cuh", [
        ("      ra = a_in ? f32_ld4(a_src + k0) : zero;",
         "      ra = a_in && kt + 2 < ktiles ? f32_ld4(a_src + k0) : zero;")],
        _F32.format(k1=((64, 257, 768, 12),), k4=(), k6=(), k7=())),
    "f32 K4 shift mask dropped": ("f32_serving.cu", [
        ("if (a.shift && qlab[r] != klab) x = __fadd_rn(x, kMaskL2);",
         "if (false) x = __fadd_rn(x, kMaskL2);")],
        _F32.format(k1=(), k4=(_STAGE0,), k6=(), k7=())),
    "f32 K6 x10 and x01 swapped": ("f32_serving.cu", [
        ("quad == 1 ? p10 : quad == 2 ? p01",
         "quad == 1 ? p01 : quad == 2 ? p10")],
        _F32.format(k1=(), k4=(), k6=((16, 128, 96),), k7=())),
    "f32 K7 pad keys counted": ("f32_serving.cu", [
        ("s[r] = kin ? x : -INFINITY;", "s[r] = kin ? x : 0.f;")],
        _F32.format(k1=(), k4=(), k6=(), k7=(_K7_STAGE0,))),
    "f32 K8b key mask past N dropped": ("f32_train.cu", [
        ("  if (key0 + 3 < N) return v;", "  return v;")],
        _F32T.format(k8b=((16, 257, 768, 12),), k8c=())),
    "f32 K8b core's tail key dropped": ("f32_train.cu", [
        ("const int c0 = 32 * whole, tail = nk - c0;",
         "const int c0 = 32 * whole, tail = 0;")],
        _F32T.format(k8b=((16, 257, 768, 12),), k8c=())),
    "f32 GEMM ring's last k stage never multiplied": ("f32_gemm.cuh", [
        ("  for (int kt = 0; kt < ktiles; ++kt) {\n    const int s = kt % "
         "GB_STAGES;",
         "  for (int kt = 0; kt < ktiles - 1; ++kt) {\n    const int s = kt % "
         "GB_STAGES;")],
        _F32T.format(k8b=(), k8c=((16, 257, 768, 12),))),
    "f32 K8c dWqkv leaves one row chunk out of its partials": (
        "f32_train.cu", [
            ("reduce(st, pt, S1, (size_t)D * 3 * D,",
             "reduce(st, pt, S1 - 1, (size_t)D * 3 * D,")],
        _F32T.format(k8b=(), k8c=((16, 257, 768, 12),))),
    "f32 K9a shift mask dropped": ("f32_serving.cu", [
        ("if (a.shift && qlab[r] != klab) x = __fadd_rn(x, kMaskL2);",
         "if (a.shift && qlab[r] != klab && kMode != FA_TRAIN)\n"
         "                  x = __fadd_rn(x, kMaskL2);")],
        _F32K9.format(k9a=(_STAGE0,), k9b=(), k9c=())),
    "f32 K9a stores p unnormalised": ("f32_serving.cu", [
        ("r) * a.N + key] = p[r];",
         "r) * a.N + key] = exp2f(fminf(s[r], 100.f));")],
        _F32K9.format(k9a=(_STAGE0,), k9b=(), k9c=())),
    "f32 K9b sum of dp * p dropped": ("f32_train.cu", [
        ("    sub = f32_warp_sum(sub);\n", "    sub = 0.f;\n")],
        _F32K9.format(k9a=(), k9b=(_STAGE3,), k9c=())),
    "f32 K9c dbias from one CTA's partial": ("f32_train.cu", [
        ("return f32_colsum(st, part, bw, hnn, part + (size_t)bw * hnn, dbias);",
         "return f32_colsum(st, part, 1, hnn, part + (size_t)bw * hnn, dbias);")],
        _F32K9.format(k9a=(), k9b=(), k9c=(_STAGE0,))),
}

_RUN = """
import sys
sys.path[:0] = [{tmp!r}, {repo!r}]
import torch
import geovpr_torch
assert geovpr_torch.__file__.startswith({tmp!r}), geovpr_torch.__file__
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
try:
    {call}
except cs.SmokeFailure as e:
    print("REJECTED:", str(e)[:160])
else:
    print("PASSED")
"""


def main(argv=None) -> int:
    picks = sys.argv[1:] if argv is None else argv
    passed = []
    for name, (src, edits, call) in FAULTS.items():
        if picks and not name.startswith(tuple(picks)):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            pkg = Path(tmp) / "geovpr_torch"
            shutil.copytree(REPO / "geovpr_torch", pkg, ignore=
                            shutil.ignore_patterns("_build", "__pycache__"))
            path = pkg / "csrc" / src
            text = path.read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: {old!r} not found once in "
                                     f"{src}")
                text = text.replace(old, new)
            path.write_text(text)
            proc = subprocess.run(
                [sys.executable, "-c", _RUN.format(tmp=tmp, repo=str(REPO),
                                                   call=call)],
                cwd=tmp, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[kernel]") or ln.startswith(
                     ("REJECTED", "PASSED"))]
        print(f"== {name}: {call}")
        print("\n".join(lines) if lines else proc.stderr[-2000:], flush=True)
        if proc.returncode != 0 or not lines or lines[-1] == "PASSED":
            passed.append(name)
    if passed:
        print("not rejected:", passed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
