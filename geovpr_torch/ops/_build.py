"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Every ``geovpr_torch/csrc/*.cu`` is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library name carries a hash of the sources
and the flags, so a stale library is never loaded. Nothing is compiled at
import: `load_library` runs on the first CUDA launch, or when a caller (the
chip smoke script) asks for the build up front.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    """The translation units; the `*.cuh` headers they include are hashed
    by `library_path` too."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgeovpr_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        print("[geovpr_torch build] " + shlex.join(cmd), file=sys.stderr)
        objs.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, proc in zip(_sources(), procs):
        log = proc.communicate()[0]
        if log.strip():
            print(log.rstrip(), file=sys.stderr)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit code {proc.returncode})")
    tmp = out.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            print(link.stdout + link.stderr, file=sys.stderr)
            failed.append(f"link (exit code {link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    os.replace(tmp, out)
    print(f"[geovpr_torch build] {out.name} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # K1 (mhsa.cu): 11 pointers, B N D H, eps, stream; _parts also
        # takes the first and last of its four launches
        "geovpr_mhsa_block_bf16": [vp] * 11 + [ci] * 4 + [cf, vp],
        "geovpr_mhsa_block_parts": [vp] * 11 + [ci] * 4 + [cf, ci, ci, vp],
        # K2 (mhsa_int8.cu): 14 pointers, B N D H, eps, cs2, mode, qscale,
        # cpv, cpl, the stream's form (f32 0 or 1), the first and last of
        # its four launches, stream
        "geovpr_mhsa_int8_parts": [vp] * 14 + [ci] * 4 + [cf, cf, ci, cf, cf,
                                                         cf, ci, ci, ci, vp],
        # K3 (mlp_int8.cu): 14 pointers, M D HID, inv_a_mid, eps, the
        # stream's form, the first and last of its three launches, stream
        "geovpr_mlp_int8_parts": [vp] * 14 + [ci] * 3 + [cf, cf, ci, ci, ci,
                                                        vp],
        # K4 (swin_attn.cu): 11 pointers, B S C H win shift, eps, qscale,
        # stream; _parts also takes the first and last of its four launches
        "geovpr_swin_attn_bf16": [vp] * 11 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_attn_parts": [vp] * 11 + [ci] * 6 + [cf, cf, ci, ci, vp],
        # K5 (swin_attn.cu): 14 pointers, B S C H win shift, eps, cs2, mode,
        # qscale, cpv, the stream's form, the first and last of its four
        # launches, stream
        "geovpr_swin_attn_int8_parts": [vp] * 14 + [ci] * 6 + [cf, cf, ci, cf,
                                                              cf, ci, ci, ci,
                                                              vp],
        # K6 (patch_merge.cu): 6 pointers, B S C, eps, stream; _parts also
        # takes the first and last of its two launches
        "geovpr_patch_merge": [vp] * 6 + [ci] * 3 + [cf, vp],
        "geovpr_patch_merge_parts": [vp] * 6 + [ci] * 3 + [cf, ci, ci, vp],
        # K7 (window_attn.cu): split mode, 6 pointers, BW H N nW, qscale,
        # stream; raster mode, 3 pointers, B S C H W shift, qscale, stream
        "geovpr_window_attention": [vp] * 6 + [ci] * 4 + [cf, vp],
        "geovpr_window_attention_raster": [vp] * 3 + [ci] * 6 + [cf, vp],
        # the f32 forms of K1, K4, K6 and K7 (f32_serving.cu): the bf16
        # entries' arguments
        "geovpr_mhsa_block_f32": [vp] * 11 + [ci] * 4 + [cf, vp],
        "geovpr_mhsa_f32_parts": [vp] * 11 + [ci] * 4 + [cf, ci, ci, vp],
        "geovpr_swin_attn_f32": [vp] * 11 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_attn_f32_parts": [vp] * 11 + [ci] * 6 + [cf, cf, ci, ci,
                                                             vp],
        "geovpr_patch_merge_f32": [vp] * 6 + [ci] * 3 + [cf, vp],
        "geovpr_patch_merge_f32_parts": [vp] * 6 + [ci] * 3 + [cf, ci, ci,
                                                               vp],
        "geovpr_window_attention_f32": [vp] * 6 + [ci] * 4 + [cf, vp],
        "geovpr_window_attention_raster_f32": [vp] * 3 + [ci] * 6 + [cf, vp],
        # K9a/K9b/K9c (swin_train.cu): pointers, B S C H win shift, floats,
        # stream; the _parts entries also take the first and last of their
        # launches
        "geovpr_swin_train_fwd": [vp] * 13 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_train_fwd_parts": [vp] * 13 + [ci] * 6 + [cf, cf, ci,
                                                              ci, vp],
        "geovpr_swin_train_bwd_core": [vp] * 6 + [ci] * 6 + [cf, vp],
        "geovpr_swin_train_bwd_all": [vp] * 22 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_train_bwd_all_parts": [vp] * 22 + [ci] * 6 + [cf, cf, ci,
                                                                  ci, vp],
        "geovpr_swin_train_scratch_floats": [ci] * 5,
        # the f32 forms of K9a (f32_serving.cu: the bf16 entry's arguments
        # without the scaled q copy), K9b and K9c (f32_train.cu: the bf16
        # entries' arguments)
        "geovpr_swin_f32_train_fwd": [vp] * 12 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_f32_train_fwd_parts": [vp] * 12 + [ci] * 6 + [cf, cf,
                                                                  ci, ci,
                                                                  vp],
        "geovpr_swin_f32_bwd_core": [vp] * 6 + [ci] * 6 + [cf, vp],
        "geovpr_swin_f32_bwd_all": [vp] * 22 + [ci] * 6 + [cf, cf, vp],
        "geovpr_swin_f32_bwd_all_parts": [vp] * 22 + [ci] * 6 + [cf, cf, ci,
                                                                ci, vp],
        "geovpr_swin_f32_scratch_floats": [ci] * 5,
        # K8b/K8c (mhsa_train.cu; K8a is K1): pointers, B N D H, floats,
        # stream; K8c's _parts also takes the first and last of its launches
        "geovpr_vit_train_bwd_core": [vp] * 4 + [ci] * 4 + [cf, vp],
        "geovpr_vit_train_bwd_all": [vp] * 25 + [ci] * 4 + [cf, cf, vp],
        "geovpr_vit_train_bwd_all_parts": [vp] * 25 + [ci] * 4 + [cf, cf, ci,
                                                                 ci, vp],
        "geovpr_vit_train_scratch_floats": [ci] * 3,
        "geovpr_vit_core_scratch_elems": [ci] * 3,
        # the f32 forms of K8b and K8c (f32_train.cu): the bf16 entries'
        # arguments
        "geovpr_vit_f32_bwd_core": [vp] * 4 + [ci] * 4 + [cf, vp],
        "geovpr_vit_f32_bwd_all": [vp] * 25 + [ci] * 4 + [cf, cf, vp],
        "geovpr_vit_f32_bwd_all_parts": [vp] * 25 + [ci] * 4 + [cf, cf, ci,
                                                               ci, vp],
        "geovpr_vit_f32_scratch_floats": [ci] * 3,
        "geovpr_vit_f32_core_scratch_floats": [ci] * 3,
        "geovpr_swin_train_init": [],
        "geovpr_vit_train_init": [],
        "geovpr_mhsa_max_dim": [],
        "geovpr_mhsa_init": [],
        "geovpr_mhsa_int8_init": [],
        "geovpr_mlp_int8_init": [],
        "geovpr_swin_init": [],
        "geovpr_patch_merge_init": [],
        "geovpr_window_attention_init": [],
        "geovpr_f32_serving_init": [],
        "geovpr_mhsa_f32_rows_max_n": [],
        "geovpr_f32_train_init": [],
        "geovpr_f32_swin_train_init": [],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    # the entries that return a size, not a cudaError_t
    lib.geovpr_swin_train_scratch_floats.restype = ctypes.c_longlong
    lib.geovpr_vit_train_scratch_floats.restype = ctypes.c_longlong
    lib.geovpr_vit_core_scratch_elems.restype = ctypes.c_longlong
    lib.geovpr_vit_f32_scratch_floats.restype = ctypes.c_longlong
    lib.geovpr_vit_f32_core_scratch_floats.restype = ctypes.c_longlong
    lib.geovpr_swin_f32_scratch_floats.restype = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if no library for the current sources exists) and load."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


@functools.lru_cache(maxsize=None)
def library_on(device_index: int, init: str) -> ctypes.CDLL:
    """The loaded library after its C function `init` (a kernel's
    shared-memory set-up) has run once on CUDA device `device_index`."""
    import torch

    lib = load_library()
    with torch.cuda.device(device_index):
        rc = getattr(lib, init)()
    if rc != 0:
        raise RuntimeError(f"{init} failed: CUDA error {rc}")
    return lib
