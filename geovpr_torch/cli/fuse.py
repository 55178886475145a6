"""Fused final-submission export of the port (the counterpart of
`geovpr.cli.fuse`, the same flags and checks, and `--device`).

    python -m geovpr_torch.cli.fuse \\
        --geopose-preset swin_b384_gemini2 --geopose-run runs/training_g \\
        --angle-preset efficientnet_sincos_gemini --angle-run runs/train_a \\
        --gallery-csv labels_train.csv --image-root dataset/images \\
        [--salad-variables salad.msgpack] [--save-index g.npz | \\
         --load-index g.npz] [--int8] [--device cuda] \\
        --test-dir dataset/test --out-dir final_csvs

One decode feeds one forward per batch on the device
(`geovpr_torch.pipeline.fused.FusedPipeline`): the test images are decoded
at the largest head size and each head gets its bilinear resize on the
device. Where the angle head's eval transform is Resize(256) +
CenterCrop(224) (`eval_resize_to`), the decode also emits that view of the
original aspect (`DualGeometrySource`) and the angle head reads it as it
is. Any component may be left out; the run directories are the port
trainer's (`geovpr_torch.cli.train`) for any preset it trains, the CNNs
included (an EfficientNet run is served on its own BatchNorm running
statistics, as `geovpr/cli/fuse.py:35-36` carries `batch_stats`), read by
`cli.common.load_trained`; `--salad-variables` a flax msgpack
of DinoV2Salad variables (`python -m geovpr_torch.cli.convert --family
dinov2_salad`).
Writes `test_predictions_sorted.csv`, `test_pred.csv` and
`retrieval_matches.csv` and prints JAX's JSON record last.

`--int8` serves w8a8 every component whose family has a w8a8 path (Swin
at both windows, DINOv2 + SALAD, ConvNeXt), each calibrated on the first
test batch at its own eval geometry, SALAD on the first gallery batch (the
first test batch with `--load-index`), and the gallery index in int8;
EfficientNet has none and stays bf16 with a note. `--approx` is accepted
and searched exactly, as `cli.retrieve` does. `--device` defaults to cuda
and fails when no card is present; pass `--device cpu` to run on the CPU.

`--multihost` (one process per card, as `cli.train`'s flag) shards each
fused batch and the gallery extraction over the ranks and gathers the
outputs, builds (or loads) the index sharded over them, and rank 0 writes
the CSVs and prints (`geovpr/cli/fuse.py:105-114`, `:214-222`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from geovpr_torch.cli.common import (add_distributed_args, start_mesh,
                                     stop_mesh)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--geopose-preset", default="")
    p.add_argument("--geopose-run", default="")
    p.add_argument("--angle-preset", default="")
    p.add_argument("--angle-run", default="")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--test-dir", required=True)
    p.add_argument("--out-dir", default="final_csvs")
    p.add_argument("--batch-size", type=int, default=0,
                   help="fused batch size (default: the largest component "
                        "preset's batch size, 64 for retrieval)")
    p.add_argument("--gallery-csv", default="",
                   help="manifest of gallery images to index; enables the "
                        "retrieval component (requires --image-root)")
    p.add_argument("--save-index", default="",
                   help="persist the built gallery index (+ filenames) to "
                        "this .npz")
    p.add_argument("--load-index", default="",
                   help="enable the retrieval component from a previously "
                        "saved index (either package's) instead of "
                        "--gallery-csv")
    p.add_argument("--image-root", default="",
                   help="image root for --gallery-csv rows")
    p.add_argument("--salad-variables", default="",
                   help="flax msgpack of DinoV2Salad variables (python "
                        "-m geovpr_torch.cli.convert --family "
                        "dinov2_salad); random init if omitted")
    p.add_argument("--salad-variant", default="base-14")
    p.add_argument("--salad-image-size", type=int, default=224)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--approx", type=float, default=0.0,
                   help="accepted for parity with geovpr.cli.fuse; the "
                        "port's search stays exact")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 serving path for every component whose "
                        "family has one (swin, dinov2, dinov2_salad, "
                        "convnext; EfficientNet stays bf16 with a note), "
                        "static scales calibrated on the first test / "
                        "gallery batch")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (default) fails without a card")
    add_distributed_args(p)
    return p.parse_args(argv)


def build_pipeline(args: argparse.Namespace, mesh=None, device=None):
    """The checks, then every component restored (and calibrated under
    `--int8`), the gallery indexed: (pipeline, test-image source, stream
    size), ready for `pipe.export(source, args.out_dir)`. With a `mesh`
    (every rank calls this) the batches and the index are sharded;
    `device` overrides `args.device` (a rank's own card)."""
    geo = bool(args.geopose_preset and args.geopose_run)
    ang = bool(args.angle_preset and args.angle_run)
    retr = bool(args.gallery_csv or args.load_index)
    if bool(args.geopose_preset) != bool(args.geopose_run) or \
            bool(args.angle_preset) != bool(args.angle_run):
        raise SystemExit("--geopose-preset/--geopose-run (and the angle "
                         "pair) must be given together")
    if args.gallery_csv and not args.image_root:
        raise SystemExit("--gallery-csv requires --image-root")
    if not geo and not ang and not retr:
        raise SystemExit("need at least one component: geopose "
                         "(--geopose-preset/--geopose-run), angle "
                         "(--angle-preset/--angle-run), or retrieval "
                         "(--gallery-csv)")
    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "run on the CPU")
    from geovpr_torch.parallel.mesh import is_writer
    say = print if is_writer(mesh) else (lambda *a, **k: None)

    from geovpr_torch.cli.common import load_trained
    from geovpr_torch.cli.evaluate import calibrate_int8
    from geovpr_torch.data.manifest import list_test_images, load_manifest
    from geovpr_torch.data.pipeline import (DualGeometrySource,
                                            ImageFolderSource)
    from geovpr_torch.models.registry import supports_int8
    from geovpr_torch.pipeline.fused import FusedPipeline

    if is_writer(mesh):
        os.makedirs(args.out_dir, exist_ok=True)
    names = list_test_images(args.test_dir)
    paths = [os.path.join(args.test_dir, n) for n in names]
    zeros = np.zeros((len(names), 1), np.float32)

    pipe = FusedPipeline(top_k=args.top_k, device=device, mesh=mesh)
    sizes, batch_sizes = [], []

    def restore(preset, run_dir, component):
        """The restored model, scaler and config, w8a8 and calibrated on
        the first test batch at the component's eval geometry under
        `--int8` where the family has a w8a8 path."""
        from geovpr_torch.cli.presets import build_preset
        family = build_preset(preset).model.family
        int8 = args.int8 and supports_int8(family)
        if args.int8 and not int8:
            say(f"note: --int8 skipped for the {component} component "
                  f"(family {family!r} has no int8 path)")
        model, scaler, cfg = load_trained(preset, run_dir, args.checkpoint,
                                          device=device, int8=int8)
        if int8:
            calibrate_int8(model, ImageFolderSource(
                paths=paths, targets=zeros, image_size=cfg.data.image_size,
                filenames=names, resize_to=cfg.data.eval_resize_to),
                cfg.data.batch_size, device)
        return model, scaler, cfg

    if geo:
        pipe.geopose_model, pipe.geopose_scaler, cfg = restore(
            args.geopose_preset, args.geopose_run, "geopose")
        pipe.geopose_size = cfg.data.image_size
        sizes.append(cfg.data.image_size)
        batch_sizes.append(cfg.data.batch_size)

    if ang:
        from geovpr_torch.cli.presets import objective_for
        pipe.angle_model, _, cfg = restore(args.angle_preset, args.angle_run,
                                           "angle")
        pipe.angle_codec = getattr(objective_for(cfg), "codec", None)
        pipe.angle_size = cfg.data.image_size
        pipe.angle_resize_to = cfg.data.eval_resize_to
        sizes.append(max(cfg.data.image_size, cfg.data.eval_resize_to))
        batch_sizes.append(cfg.data.batch_size)

    if retr:
        from geovpr_torch.cli.retrieve import build_model as build_salad
        from geovpr_torch.cli.retrieve import extract_descriptors
        from geovpr_torch.retrieval.index import (DescriptorIndex, load_index,
                                                  save_index)

        if not args.salad_variables:
            say("WARNING: no --salad-variables given; using random init "
                  "(descriptors will not be meaningful)")
        model = build_salad(args.salad_variant, args.salad_image_size,
                            device, args.salad_variables, int8=args.int8)
        if args.load_index:
            g_source = ImageFolderSource(
                paths=paths, targets=zeros,
                image_size=args.salad_image_size, filenames=names)
        else:
            gallery = load_manifest(args.gallery_csv, args.image_root)
            g_source = ImageFolderSource(
                paths=gallery.paths(),
                targets=np.asarray(gallery.latlon, np.float32),
                image_size=args.salad_image_size,
                filenames=gallery.filenames)
        g_batch = args.batch_size or 64
        if args.int8:
            # the gallery's images, or (serving a saved index) the test
            # images themselves: the same camera domain
            calibrate_int8(model, g_source, g_batch, device)
        pipe.descriptor_model = model
        pipe.descriptor_size = args.salad_image_size
        if args.load_index:
            pipe.index, meta = load_index(args.load_index, device, mesh)
            pipe.gallery_filenames = (
                list(meta["filenames"]) if "filenames" in meta else
                [f"row_{i}" for i in range(pipe.index.size)])
        else:
            g_desc = extract_descriptors(model, g_source, g_batch, device,
                                         mesh)
            pipe.index = DescriptorIndex(dim=g_desc.shape[-1], device=device,
                                         quantize=args.int8,
                                         mesh=mesh).build(g_desc)
            pipe.gallery_filenames = gallery.filenames
            if args.save_index:
                save_index(pipe.index, args.save_index,
                           filenames=gallery.filenames,
                           latlon=np.asarray(gallery.latlon, np.float32))
        if args.approx:
            say(f"NOTE: --approx {args.approx} ignored; the search is "
                "exact", file=sys.stderr)
        sizes.append(args.salad_image_size)
        batch_sizes.append(64)

    pipe.batch_size = args.batch_size or max(batch_sizes)
    stream_size = max(sizes)

    if ang and pipe.angle_resize_to:
        # the angle head's eval transform keeps the original aspect: one
        # decode emits that view beside the square stream, and the head
        # is not resized again on the device
        source = DualGeometrySource(
            paths=paths, targets=zeros, stream_size=stream_size,
            alt_size=pipe.angle_size, alt_resize_to=pipe.angle_resize_to,
            filenames=names)
        pipe.angle_size = 0
        pipe.angle_resize_to = 0
    else:
        source = ImageFolderSource(paths=paths, targets=zeros,
                                   image_size=stream_size, filenames=names)
    return pipe, source, stream_size


def main(argv=None):
    from geovpr_torch.parallel.mesh import is_writer

    args = parse_args(argv)
    mesh, device = start_mesh(args, args.device)
    pipe, source, stream_size = build_pipeline(args, mesh, device)
    written = pipe.export(source, args.out_dir)
    outputs = {"num_images": len(source), "stream_size": stream_size,
               **{f"{k}_csv": v for k, v in written.items()}}
    if is_writer(mesh):
        print(json.dumps(outputs))
    stop_mesh(mesh)


if __name__ == "__main__":
    main()
