"""Planted-fault check of the K2/K3 bounds in chip_smoke.py.

    python3 chip_faults.py

For each planted fault it copies `geovpr_torch/` into a temporary
directory, breaks one line of a kernel source there (K2 without its key
mask; K3 with b2 dropped from its epilogue), builds that copy and runs
chip_smoke.py's K2/K3 check (`int8_kernels_vs_plain`) against it at one
shape. It prints the check's error line for the faulty kernel and whether
the check rejected it, and exits non-zero if a planted fault passes. Needs
one CUDA card; the checkout itself is never modified.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent

# name -> (source file, [(original text, faulty text)], shape checked)
FAULTS = {
    "K2 key mask removed": ("mhsa_int8.cu", [
        ("const float p0 = key < N ?", "const float p0 = true ?"),
        ("const float p1 = key + 1 < N ?", "const float p1 = true ?")],
        (2, 1370, 768, 12)),
    "K3 b2 dropped": ("mlp_int8.cu", [
        ("* s2[col] + b2[col];", "* s2[col];"),
        ("* s2[col + 1] + b2[col + 1];", "* s2[col + 1];")],
        (64, 257, 768, 12)),
}

_RUN = """
import sys
sys.path[:0] = [{tmp!r}, {repo!r}]
import torch
import geovpr_torch
assert geovpr_torch.__file__.startswith({tmp!r}), geovpr_torch.__file__
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.KERNEL_SHAPES = ({shape!r},)
cs.MAIN_SHAPE = {shape!r}
try:
    cs.int8_kernels_vs_plain(torch.device("cuda"))
except cs.SmokeFailure as e:
    print("REJECTED:", str(e)[:160])
else:
    print("PASSED")
"""


def main() -> int:
    passed = []
    for name, (src, edits, shape) in FAULTS.items():
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
                                                   shape=shape)],
                cwd=tmp, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[kernel]") or ln.startswith(
                     ("REJECTED", "PASSED"))]
        print(f"== {name} at {shape}")
        print("\n".join(lines) if lines else proc.stderr[-2000:], flush=True)
        if proc.returncode != 0 or not lines or lines[-1] == "PASSED":
            passed.append(name)
    if passed:
        print("not rejected:", passed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
