"""Native JPEG batch decoder of the port: libjpeg decode and bilinear
resize on a C++ thread pool (the counterpart of `geovpr.data.decoder`).

The C++ source is the port's own copy, `geovpr_torch/csrc/jpeg_decoder.cpp`
(byte for byte `native/decoder.cpp`; a test holds the two equal). It is
built at first use with the flags of `native/Makefile`

    g++ -O3 -march=native -fPIC -std=c++17 -Wall jpeg_decoder.cpp \
        -o geovpr_torch/_build/libgeovpr_jpeg_<hash>.so -shared -ljpeg -lpthread

(`$CXX` replaces g++), the name carrying a hash of the source and the
flags, so that a stale library is never loaded, and loaded with ctypes.
It needs a C++ compiler, libjpeg's header `jpeglib.h` and `libjpeg.so`.

Unlike the JAX package, which decodes with PIL when the library cannot be
built (`geovpr/data/decoder.py:99-101`), this raises
`NativeDecoderUnavailable`, naming what is missing: asking for the native
decoder never silently decodes with something else. A file libjpeg
rejects (not a JPEG, or corrupt) is a zeroed frame with ok False, as in
JAX; `ImageFolderSource` decodes such a file with PIL, as JAX's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "jpeg_decoder.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: "NativeDecoderUnavailable | None" = None


class NativeDecoderUnavailable(RuntimeError):
    """The native decoder cannot be built or loaded on this machine."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgeovpr_jpeg_{h.hexdigest()[:16]}.so"


def _missing(log: str) -> str:
    """What a failed build lacked, from the compiler's output."""
    if "jpeglib.h" in log:
        return "libjpeg's header jpeglib.h (install libjpeg's development files)"
    if "-ljpeg" in log:
        return "libjpeg (libjpeg.so) for the linker"
    return "a working build"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise NativeDecoderUnavailable(
            f"the native JPEG decoder needs a C++ compiler: {cxx!r} was not "
            f"found (set CXX, or use decoder='pil')")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeDecoderUnavailable(
            f"building the native JPEG decoder failed ({shlex.join(cmd)}): "
            f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        log = (proc.stdout + proc.stderr).strip()
        raise NativeDecoderUnavailable(
            f"the native JPEG decoder could not be built: it needs "
            f"{_missing(log)}; {shlex.join(cmd)} exited with "
            f"{proc.returncode}:\n{log[-2000:]}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build the decoder (if no library for the current source exists) and
    load it. Raises NativeDecoderUnavailable, and the same error on every
    later call, where it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeDecoderUnavailable(
                    f"the native JPEG decoder {path} could not be loaded "
                    f"(libjpeg.so missing at run time?): {e}") from e
        except NativeDecoderUnavailable as e:
            _error = e
            raise
        fn = lib.geovpr_decode_batch_ex
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),   # blob
            ctypes.POINTER(ctypes.c_int64),   # offsets
            ctypes.c_int,                     # n
            ctypes.c_int, ctypes.c_int,       # out_h, out_w
            ctypes.c_int,                     # resize_short (0 = square)
            ctypes.POINTER(ctypes.c_uint8),   # out
            ctypes.POINTER(ctypes.c_uint8),   # ok
            ctypes.c_int,                     # threads
        ]
        lib.geovpr_decoder_version.restype = ctypes.c_int
        _lib = lib
        return lib


def libjpeg_version() -> int:
    """JPEG_LIB_VERSION of the libjpeg the decoder was built against."""
    return load_library().geovpr_decoder_version()


def decode_batch(jpeg_buffers: Sequence[bytes], out_h: int, out_w: int,
                 threads: int = 8,
                 resize_short: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Decode and resize a batch of JPEG byte strings: (images (N, out_h,
    out_w, 3) uint8, ok (N,) bool), a failed decode a zeroed frame with ok
    False. `resize_short` > 0 resizes each image's short side to it
    (aspect kept) and crops the centre (out_h, out_w), EfficientNet's eval
    transform Resize(256) + CenterCrop(224)."""
    lib = load_library()
    n = len(jpeg_buffers)
    offsets = np.zeros(n + 1, np.int64)
    for i, buf in enumerate(jpeg_buffers):
        offsets[i + 1] = offsets[i] + len(buf)
    blob = np.frombuffer(b"".join(jpeg_buffers), np.uint8)
    if blob.size == 0:
        blob = np.zeros(1, np.uint8)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.geovpr_decode_batch_ex(
        blob.ctypes.data_as(u8),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, out_h, out_w, resize_short, out.ctypes.data_as(u8),
        ok.ctypes.data_as(u8), threads)
    return out, ok.astype(bool)


def decode_files(paths: Sequence[str], out_h: int, out_w: int,
                 threads: int = 8,
                 resize_short: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read and decode a batch of image files (an unreadable file is a
    failed decode)."""
    bufs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                bufs.append(f.read())
        except OSError:
            bufs.append(b"")
    return decode_batch(bufs, out_h, out_w, threads, resize_short)
