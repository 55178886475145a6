"""Evaluation / prediction-export entry point of the port, geopose and
angle presets (the counterpart of `geovpr.cli.evaluate`, the same flags
and `--variables` beside `--run-dir`/`--checkpoint`).

    python -m geovpr_torch.cli.evaluate --preset swin_b384_gemini2 \
        --val-csv labels_val.csv --image-root images \
        [--run-dir runs/training_... [--checkpoint best|latest|<name>] |
         --variables model.msgpack] [--out-dir out] [--test-dir test] \
        [--submission-csv preds.csv] [--int8] [--batch-size 64] \
        [--device cuda]

Computes the preset's metric suite on the val split (geopose: MSE, RMSE,
MAE, per-axis MAE and the competition loss on (lat, lon); angle: MAAE and
the mean squared circular error on `manifest.angle`), writes
`validation_predictions.csv`, with `--test-dir` the sorted test CSV
(`test_predictions_sorted.csv`, or `test_pred.csv` for angles), with
`--submission-csv` the geopose submission file, and prints the same JSON as
the JAX CLI. `--run-dir` reads a run directory that
`geovpr_torch.cli.train` wrote: the parameters (an EfficientNet run's
BatchNorm running statistics with them, as `geovpr/cli/common.py:33`
carries `batch_stats`) and the scaler of its `best/` checkpoint, of the
newest `checkpoint_{epoch}/` with `--checkpoint latest`, or of the named
one; `--out-dir` defaults to the run directory there, as in JAX.
`--variables` is a flax `msgpack_serialize` file of
{"params": <RegressionModel params>, "scaler": {"mean": (2,), "scale":
(2,)}} for geopose, {"params"} or {"params", "batch_stats"} (EfficientNet)
for angles. At most one of the two may be given; without either the model
is a seeded random init (and the identity scaler). `--int8` calibrates the static activation scales on the first val
batch (as `Trainer.enable_int8_serving` does) and serves the w8a8 model.

Kernels on each path: Swin at window 12 runs K4 in every block (K5 and K3
with `--int8`), Swin-T at window 7 runs K7 inside every block's attention
half, both run K6 at every stage boundary; DINOv2 runs K1 (K2 and K3 with
`--int8`); EfficientNet-B0 and ConvNeXt run on cuDNN convolutions and have
no kernel of their own. `--int8` serves window-7 Swin (torch int8
attention ops and K3) and ConvNeXt (K3); EfficientNet has no int8 path.
`--device` defaults to cuda and fails when no card is present; pass
`--device cpu` to run on the CPU. `--multihost` (one process per card, as
`cli.train`'s flag) shards each batch over the ranks, as JAX's CLI scores
over `create_mesh()` (`geovpr/cli/common.py:32`): the eval sums are
all-reduced, the predictions gathered, and rank 0 writes and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from geovpr_torch.cli.common import (add_distributed_args, start_mesh,
                                     stop_mesh)


def build_model(cfg, device, variables: str = "", seed: int = 0,
                int8: bool = False, run_dir: str = "",
                checkpoint: str = "best"):
    """The preset's `RegressionModel` in its compute dtype on `device`, in
    eval mode, and for a geopose preset its target scaler (None for an
    angle preset): from a flax msgpack, from `checkpoint` of a run
    directory the port's trainer wrote (its running statistics too), or a
    random init seeded with `seed` (and the identity scaler).
    `int8` builds the w8a8 serving model, to be calibrated before use."""
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import (identity_scaler,
                                                scaler_from_arrays)

    geo = isinstance(cfg, GeoposeConfig)
    mcfg = dataclasses.replace(cfg.model, image_size=cfg.data.image_size)
    model = RegressionModel(mcfg, dtype=getattr(torch, mcfg.compute_dtype),
                            int8=int8)
    scaler = identity_scaler(mcfg.out_dim) if geo else None
    if variables or run_dir:
        if run_dir:
            from geovpr_torch.train.checkpoint import load_run_checkpoint
            state, saved_scaler = load_run_checkpoint(run_dir, checkpoint)
            source = os.path.join(run_dir, checkpoint)
        else:
            from geovpr_torch.models.convert_jax import (
                load_flax_msgpack, state_dict_from_flax)
            tree = load_flax_msgpack(variables)
            state, source = state_dict_from_flax(tree), variables
            saved_scaler = (scaler_from_arrays(tree["scaler"]["mean"],
                                               tree["scaler"]["scale"])
                            if geo else None)
        res = model.load_state_dict(state, strict=False)
        params = {n for n, _ in model.named_parameters()}
        bad = [k for k in res.missing_keys if k in params or not int8]
        if bad or res.unexpected_keys:
            raise RuntimeError(f"{source}: missing {bad}, unexpected "
                               f"{res.unexpected_keys}")
        if geo:
            scaler = saved_scaler
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval(), None if scaler is None else \
        scaler.to(device)


def calibrate_int8(model, source, batch_size: int, device) -> dict:
    """Static scales from the first batch of `source`, normalised as the
    model sees it (`Trainer.enable_int8_serving`); returns the quant tree."""
    from geovpr_torch.data.pipeline import iterate_batches
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.models.quantize import quantize_for_serving

    batch = next(iter(iterate_batches(source, batch_size)))
    images = normalize(torch.from_numpy(batch["image"]).to(device))
    return quantize_for_serving(model, [images])


def evaluate_and_predict(model, scaler, source, batch_size: int, device,
                         objective=None, mesh=None) -> tuple[dict, np.ndarray]:
    """Metrics and per-row decoded predictions in one pass
    (`Trainer.evaluate_and_predict`): eval sums accumulated on the device,
    summarised on the host; predictions in source order, (N, 2) (lat, lon)
    for geopose (the default objective), (N,) degrees for angles. With a
    mesh each rank scores its rows: the sums are all-reduced and the
    predictions gathered."""
    from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
    from geovpr_torch.data.transforms import normalize
    from geovpr_torch.objectives.workloads import GeoposeObjective
    from geovpr_torch.parallel.mesh import gather_rows
    from geovpr_torch.serve.eval import (add_sums, eval_sums, reduce_sums,
                                         summarize_eval)

    if len(source) == 0:
        raise ValueError("predict on an empty source — check the CSV / "
                         "image root")
    objective = objective or GeoposeObjective()
    sums, out = None, None
    with torch.inference_mode():
        for batch in prefetch_to_device(iterate_batches(source, batch_size),
                                        device, mesh=mesh):
            idx = batch["_indices"]
            preds = model(normalize(batch["image"]))
            decoded = objective.decode_predictions(preds, scaler)
            sums = add_sums(sums, eval_sums(decoded, batch["target"],
                                            batch["mask"]))
            if mesh is not None:
                decoded = gather_rows(decoded, mesh)
            if out is None:
                out = np.zeros((len(source),) + tuple(decoded.shape[1:]),
                               np.float32)
            out[idx] = decoded[:len(idx)].cpu().numpy()
    return summarize_eval(reduce_sums(sums, mesh)), out


def run_evaluate(model, scaler, source, *, batch_size: int, out_dir: str,
                 device, int8: bool = False, test_source=None,
                 submission_csv: str = "",
                 objective=None, mesh=None) -> tuple[dict, np.ndarray]:
    """The serving path on in-memory or disk sources (targets as `targets`,
    names as `filenames`): geopose with the default objective ((lat, lon)
    targets), angles with an angle objective (`cli.presets.objective_for`;
    degree targets). With `int8` (a model built with `int8=True`) calibrate
    on the first batch of `source` first; then metrics and predictions over
    `source`, `validation_predictions.csv` in `out_dir`, and with
    `test_source` / `submission_csv` the test and submission CSVs. Returns
    the CLI's JSON record and the val predictions. With a `mesh` every rank
    calls this and rank 0 writes."""
    from geovpr_torch.objectives.workloads import GeoposeObjective
    from geovpr_torch.parallel.mesh import barrier, is_writer
    from geovpr_torch.pipeline import export

    objective = objective or GeoposeObjective()
    geo = isinstance(objective, GeoposeObjective)
    if submission_csv and not geo:
        raise SystemExit("--submission-csv is a geopose export "
                         "(ID,latitude,longitude); this preset is an angle "
                         "workload")
    write = is_writer(mesh)
    if write:
        os.makedirs(out_dir, exist_ok=True)
    if int8:
        calibrate_int8(model, source, batch_size, device)
    metrics, preds = evaluate_and_predict(model, scaler, source, batch_size,
                                          device, objective, mesh)
    val_csv = os.path.join(out_dir, "validation_predictions.csv")
    write_val = (export.write_geopose_validation_csv if geo
                 else export.write_angle_validation_csv)
    if write:
        write_val(val_csv, source.filenames,
                  np.asarray(source.targets, np.float32), preds)
    outputs = {"metrics": metrics, "validation_csv": val_csv}
    if submission_csv:
        sub = (submission_csv if os.path.isabs(submission_csv)
               else os.path.join(out_dir, submission_csv))
        if write:
            export.write_geopose_preds_csv(sub, source.filenames, preds)
        outputs["submission_csv"] = sub
    if test_source is not None:
        _, test_preds = evaluate_and_predict(model, scaler, test_source,
                                             batch_size, device, objective,
                                             mesh)
        if geo:
            path = os.path.join(out_dir, "test_predictions_sorted.csv")
            if write:
                export.write_geopose_test_csv(path, test_source.filenames,
                                              test_preds)
        else:
            path = os.path.join(out_dir, "test_pred.csv")
            if write:
                export.write_angle_test_csv(path, test_source.filenames,
                                            test_preds)
        outputs["test_csv"] = path
    barrier(mesh)
    return outputs, preds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", required=True)
    p.add_argument("--run-dir", default="",
                   help="run directory of geovpr_torch.cli.train to score")
    p.add_argument("--checkpoint", default="best",
                   help="'best', 'latest', or a checkpoint dir name under "
                        "--run-dir")
    p.add_argument("--variables", default="",
                   help="flax msgpack of {params, scaler} (geopose) or "
                        "{params[, batch_stats]} (angle); random init if "
                        "neither this nor --run-dir is given")
    p.add_argument("--val-csv", required=True)
    p.add_argument("--image-root", required=True)
    p.add_argument("--test-dir", default="")
    p.add_argument("--out-dir", default="",
                   help="default: --run-dir, else evaluate_out")
    p.add_argument("--submission-csv", default="",
                   help="also write the submission-format preds.csv "
                        "(ID,latitude,longitude; ID parsed from filename "
                        "digits, sorted numerically) from the val "
                        "predictions")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 serving path: static activation scales "
                        "calibrated on the first val batch")
    p.add_argument("--batch-size", type=int, default=0,
                   help="eval batch size (default: the preset's)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (default) fails without a card")
    add_distributed_args(p)
    args = p.parse_args(argv)
    if args.variables and args.run_dir:
        p.error("give at most one of --variables and --run-dir")
    mesh, device = start_mesh(args, args.device)
    _evaluate(args, mesh, device)
    stop_mesh(mesh)


def _evaluate(args, mesh, device) -> None:
    from geovpr_torch.parallel.mesh import is_writer

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.data.manifest import list_test_images, load_manifest
    from geovpr_torch.data.pipeline import ImageFolderSource
    from geovpr_torch.models.registry import check_int8_serving

    cfg = build_preset(args.preset)
    geo = isinstance(cfg, GeoposeConfig)
    if args.int8:
        try:
            check_int8_serving(cfg.model)
        except ValueError as e:
            raise SystemExit(f"--int8: {e}") from None
    if not (args.variables or args.run_dir) and is_writer(mesh):
        print("WARNING: neither --variables nor --run-dir given; using "
              "random init (predictions will not be meaningful)",
              file=sys.stderr)
    model, scaler = build_model(cfg, device, args.variables, int8=args.int8,
                                run_dir=args.run_dir,
                                checkpoint=args.checkpoint)
    data = cfg.data

    def make_source(paths, targets, names):
        return ImageFolderSource(paths=paths, targets=np.asarray(targets),
                                 image_size=data.image_size, filenames=names,
                                 resize_to=data.eval_resize_to)

    manifest = load_manifest(args.val_csv, args.image_root)
    val_source = make_source(manifest.paths(),
                             manifest.latlon if geo else manifest.angle,
                             manifest.filenames)
    test_source = None
    if args.test_dir:
        names = list_test_images(args.test_dir)
        test_source = make_source(
            [os.path.join(args.test_dir, n) for n in names],
            np.zeros((len(names), 2 if geo else 1), np.float32), names)
    outputs, _ = run_evaluate(
        model, scaler, val_source,
        batch_size=args.batch_size or data.batch_size,
        out_dir=args.out_dir or args.run_dir or "evaluate_out",
        device=device, int8=args.int8,
        test_source=test_source, submission_csv=args.submission_csv,
        objective=objective_for(cfg), mesh=mesh)
    if is_writer(mesh):
        print(json.dumps(outputs))


if __name__ == "__main__":
    main()
