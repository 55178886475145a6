"""K3 and K5 times and the w8a8 models' img/s of several checkouts, in
turns, on one CUDA card.

    python3 chip_versus.py CHECKOUT [CHECKOUT ...]

Each argument (`.` for this checkout, or an unpacked `git archive` of an
earlier commit in a gitignored directory) runs in a process of its own,
with its own `geovpr_torch` and `chip_smoke.py` first on the path, builds
its own kernels and prints `[versus]` lines: the CUDA-event ms of K3 at
DINOv2-B/14's 64x257x768 (hidden 3,072) and at the widths of the four
Swin-B-384 stages at B=64 (rows B S^2, D = C, hidden 4C), of K5 at the
four stages, and the ms per B=64 batch and img/s of the w8a8 DINOv2-B/14
+ SALAD descriptors (224 px) and the w8a8 Swin-B-384 geopose model (384
px), each calibrated on its first batch. Inputs and weights are
chip_smoke.py's, from seed 0. Name the checkouts in turns (`OLD . . OLD`)
to compare two on one card. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
ITERS = 10


def run(label: str) -> None:
    """In the child: this process's checkout's kernels and models."""
    import numpy as np

    import chip_smoke as cs
    from geovpr_torch.cli.retrieve import build_model
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.models.quantize import quantize_for_serving
    from geovpr_torch.ops._build import load_library
    from geovpr_torch.ops.mlp_int8 import fused_mlp_block_int8
    from geovpr_torch.ops.swin_block import fused_swin_attn_block_int8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    load_library()

    def line(name, shape, ms, **more):
        cs.phase("versus", checkout=label, card=repr(card), name=name,
                 shape=shape, ms=ms, **more)

    with torch.inference_mode():
        b, n, d, h = cs.MAIN_SHAPE
        x, _, k3 = cs.int8_block_case(b, n, d, h, dev)
        line("K3", f"B{b}_N{n}_D{d}",
             cs.cuda_ms(lambda: fused_mlp_block_int8(x, **k3), ITERS))
        for shape in cs.SWIN_ATTN_SHAPES:
            tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
            x, blk = cs.swin_block_case(shape, dev, int8=True)
            kw = cs.k5_kwargs(blk)
            k3 = blk._folded_args(blk._k3)
            line("K5", tag, cs.cuda_ms(
                lambda: fused_swin_attn_block_int8(x, **kw), ITERS))
            line("K3", tag, cs.cuda_ms(
                lambda: fused_mlp_block_int8(x, **k3, ln_eps=1e-5), ITERS))
            del x, blk, kw, k3

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


def _child(checkout: Path, label: str) -> None:
    code = (f"import sys; sys.path[:0] = [{str(checkout)!r}]\n"
            f"import geovpr_torch\n"
            f"assert geovpr_torch.__file__.startswith({str(checkout)!r})\n"
            f"import importlib.util as u\n"
            f"spec = u.spec_from_file_location('chip_versus_run', "
            f"{str(REPO / 'chip_versus.py')!r})\n"
            f"mod = u.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            f"mod.run({label!r})\n")
    subprocess.run([sys.executable, "-c", code], cwd=checkout, check=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[3], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_versus: no CUDA device is available", file=sys.stderr)
        return 1
    for i, arg in enumerate(argv):
        checkout = Path(arg).resolve()
        _child(checkout, f"{i}:{arg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
