"""Descriptor-retrieval entry point of the port (the counterpart of
`geovpr.cli.retrieve`, same flags).

    python -m geovpr_torch.cli.retrieve \
        --gallery-csv labels_train.csv --query-csv labels_val.csv \
        --image-root dataset/images --out-dir out \
        [--variables salad.msgpack] [--top-k 5] [--positive-radius 25] \
        [--save-index gallery.npz | --load-index gallery.npz] [--int8]
        [--device cuda] [--multihost ...]

Extracts DINOv2+SALAD descriptors (bf16) for gallery and queries, builds a
device-resident bf16 index, searches cosine top-k, reports proximity
Recall@k and writes `retrieval_matches.csv`. `--int8` serves the w8a8 path
instead: the model's static activation scales are calibrated on the first
gallery batch (else the first query batch), after normalisation, every
block runs kernels K2 and K3, and the gallery index is int8 with per-row
scales. `--variables` reads the flax msgpack `geovpr.cli.retrieve` reads
(`python -m geovpr_torch.cli.convert --family dinov2_salad` writes one);
without it the model is a seeded random init. `--device` defaults to cuda
and fails when no card is present; pass `--device cpu` to run on the CPU.

`--multihost` (one process per card, as `cli.train`'s flag) shards each
extraction batch over the ranks and gathers the descriptors in source
order on every rank (a batch that does not divide the ranks runs whole on
each, as JAX's), builds the index sharded over the ranks, searches the
replicated queries, and rank 0 writes the CSV and prints.
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


def extract_descriptors(model, source, batch_size: int,
                        device, mesh=None) -> np.ndarray:
    """Batched descriptor extraction over an image source, forward only;
    with a mesh each rank runs its rows of a batch and every rank gets all
    descriptors (`geovpr/cli/retrieve.py:34-52`: a batch size the ranks do
    not divide runs whole on every rank)."""
    from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.parallel.mesh import gather_rows

    if mesh is not None and batch_size % mesh.size != 0:
        mesh = None
    out = None
    with torch.inference_mode():
        for batch in prefetch_to_device(iterate_batches(source, batch_size),
                                        device, mesh=mesh):
            idx = batch["_indices"]
            desc = model(normalize(batch["image"])).pooled.float()
            if mesh is not None:
                desc = gather_rows(desc, mesh)
            desc = desc.cpu()
            if out is None:
                out = np.zeros((len(source), desc.shape[-1]), np.float32)
            out[idx] = desc[:len(idx)].numpy()
    return out


def calibrate_int8(model, source, batch_size: int, device) -> dict:
    """Calibrate an int8 model's static scales on the first batch of
    `source`, normalised as the model sees it; returns the quant tree."""
    from geovpr_torch.data.pipeline import iterate_batches
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.models.quantize import quantize_for_serving

    batch = next(iter(iterate_batches(source, batch_size)))
    images = normalize(torch.from_numpy(batch["image"]).to(device))
    return quantize_for_serving(model, [images])


def run_retrieval(model, gallery_source, query_source, *, batch_size: int,
                  top_k: int, positive_radius: float, out_dir: str, device,
                  loaded_index=None, save_index_path: str = "",
                  int8: bool = False, mesh=None) -> dict:
    """The retrieve main path on in-memory or disk sources: extract gallery
    descriptors (or take `loaded_index` = (index, meta) from `load_index`),
    build the index, extract and search the queries, compute proximity
    Recall@k and write `retrieval_matches.csv` into `out_dir`. Sources carry
    latlon as `targets` and names as `filenames`. `int8`: the model (built
    with `build_model(..., int8=True)`) is first calibrated on the first
    gallery batch (the first query batch when the index is loaded), and the
    gallery index is int8. With a `mesh` every rank calls this: the
    extraction is sharded, the index too, and rank 0 writes."""
    from geovpr_torch.parallel.mesh import barrier, is_writer
    from geovpr_torch.retrieval.index import (
        DescriptorIndex, recall_at_k_radius, save_index,
        write_retrieval_matches_csv)

    if is_writer(mesh):
        os.makedirs(out_dir, exist_ok=True)
    if int8:
        calibrate_int8(model, gallery_source if loaded_index is None
                       else query_source, batch_size, device)
    if loaded_index is not None:
        index, meta = loaded_index
        gallery_filenames = (list(meta["filenames"]) if "filenames" in meta
                             else [f"row_{i}" for i in range(index.size)])
        gallery_latlon = meta.get("latlon")
    else:
        g_desc = extract_descriptors(model, gallery_source, batch_size,
                                     device, mesh)
        index = DescriptorIndex(dim=g_desc.shape[-1], device=device,
                                quantize=int8, mesh=mesh).build(g_desc)
        gallery_filenames = gallery_source.filenames
        gallery_latlon = np.asarray(gallery_source.targets, np.float32)
        if save_index_path:
            save_index(index, save_index_path, filenames=gallery_filenames,
                       latlon=gallery_latlon)

    q_desc = extract_descriptors(model, query_source, batch_size, device,
                                 mesh)
    scores, nbrs = index.search(q_desc, k=top_k)
    scores, nbrs = scores.cpu().numpy(), nbrs.cpu().numpy()

    recalls = {}
    if gallery_latlon is not None:
        q_latlon = np.asarray(query_source.targets, np.float32)
        recalls = {
            f"recall@{k}": float(recall_at_k_radius(
                nbrs, q_latlon, gallery_latlon, positive_radius, k))
            for k in (1, min(5, top_k), top_k)
        }
    path = os.path.join(out_dir, "retrieval_matches.csv")
    if is_writer(mesh):
        write_retrieval_matches_csv(path, query_source.filenames,
                                    gallery_filenames, nbrs, scores)
    barrier(mesh)
    out = {"gallery_size": index.size,
           "num_queries": len(query_source),
           **recalls, "matches_csv": path}
    if save_index_path:
        out["saved_index"] = save_index_path
    return out


def build_model(variant: str, image_size: int, device, variables: str = "",
                seed: int = 0, int8: bool = False):
    """DinoV2Salad in bf16 on `device`, from flax msgpack variables or a
    random init seeded with `seed`; `int8` builds the w8a8 serving model
    (`int8_attn` and `int8_mlp`), to be calibrated before use."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.salad import DinoV2Salad

    model = DinoV2Salad(variant=variant, image_size=image_size,
                        dtype=torch.bfloat16, int8_attn=int8, int8_mlp=int8)
    if variables:
        from geovpr_torch.models.convert_jax import (load_flax_msgpack,
                                                     state_dict_from_flax)
        # an int8 model's quant buffers may be absent (flax variables hold
        # params only); they are filled by calibration
        res = model.load_state_dict(state_dict_from_flax(
            load_flax_msgpack(variables)), strict=False)
        params = {n for n, _ in model.named_parameters()}
        bad = [k for k in res.missing_keys if k in params or not int8]
        if bad or res.unexpected_keys:
            raise RuntimeError(f"{variables}: missing {bad}, unexpected "
                               f"{res.unexpected_keys}")
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gallery-csv", default="",
                   help="gallery manifest (required unless --load-index)")
    p.add_argument("--query-csv", required=True)
    p.add_argument("--save-index", default="",
                   help="persist the built gallery index (+ filenames and "
                        "latlon metadata) to this .npz")
    p.add_argument("--load-index", default="",
                   help="serve from a previously saved index (either "
                        "package's) instead of extracting gallery descriptors")
    p.add_argument("--image-root", required=True)
    p.add_argument("--out-dir", default="retrieval_out")
    p.add_argument("--variables", default="",
                   help="flax msgpack of DinoV2Salad variables (python "
                        "-m geovpr_torch.cli.convert --family "
                        "dinov2_salad); random init if omitted")
    p.add_argument("--variant", default="base-14",
                   help="DINOv2 variant (base-14 | small-14 | large-14)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--positive-radius", type=float, default=25.0)
    p.add_argument("--approx", type=float, default=0.0,
                   help="accepted for parity with geovpr.cli.retrieve; the "
                        "port's search stays exact (torch.topk has no "
                        "approximate counterpart of lax.approx_max_k)")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 serving path: static activation scales "
                        "calibrated on the first gallery batch, kernels K2 "
                        "and K3 in every block, int8 gallery index")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (default) fails without a card")
    add_distributed_args(p)
    args = p.parse_args(argv)

    if not args.gallery_csv and not args.load_index:
        p.error("either --gallery-csv or --load-index is required")
    mesh, device = start_mesh(args, args.device)
    _retrieve(args, mesh, device)
    stop_mesh(mesh)


def _retrieve(args, mesh, device) -> None:
    from geovpr_torch.parallel.mesh import is_writer

    from geovpr_torch.data.manifest import load_manifest
    from geovpr_torch.data.pipeline import ImageFolderSource
    from geovpr_torch.retrieval.index import load_index

    if args.approx and is_writer(mesh):
        print(f"NOTE: --approx {args.approx} ignored; the search is exact",
              file=sys.stderr)
    if not args.variables and is_writer(mesh):
        print("WARNING: no --variables given; using random init "
              "(descriptors will not be meaningful)")
    model = build_model(args.variant, args.image_size, device,
                        args.variables, int8=args.int8)

    def source(path):
        m = load_manifest(path, args.image_root)
        return ImageFolderSource(paths=m.paths(),
                                 targets=np.asarray(m.latlon, np.float32),
                                 image_size=args.image_size,
                                 filenames=m.filenames)

    out = run_retrieval(
        model, source(args.gallery_csv) if not args.load_index else None,
        source(args.query_csv), batch_size=args.batch_size,
        top_k=args.top_k, positive_radius=args.positive_radius,
        out_dir=args.out_dir, device=device,
        loaded_index=(load_index(args.load_index, device, mesh)
                      if args.load_index else None),
        save_index_path=args.save_index, int8=args.int8, mesh=mesh)
    if is_writer(mesh):
        print(json.dumps(out))


if __name__ == "__main__":
    main()
