"""Shared CLI plumbing of the port: preset and run directory -> the
restored serving model (the counterpart of `geovpr.cli.common`)."""

from __future__ import annotations


def load_trained(preset: str, run_dir: str, checkpoint: str = "best", *,
                 device="cuda", int8: bool = False):
    """The preset's `RegressionModel` on `device` with the parameters of
    `checkpoint` under a run directory that `geovpr_torch.cli.train` wrote
    ('best', 'latest' or a checkpoint directory's name; an EfficientNet
    run's BatchNorm running statistics come with them, the counterpart of
    `geovpr/cli/common.py:33`), in eval mode, its target scaler (None for
    an angle preset) and the preset's config: (model, scaler, cfg). `int8`
    builds the w8a8 serving model, to be calibrated before use. Exits
    where there is no such checkpoint.

    JAX's loader retries with the unfrozen optimizer template when a
    freeze -> unfreeze run's checkpoint does not match the frozen one
    (`geovpr/cli/common.py:43-60`). The port's loader reads only the
    parameters, so a checkpoint written after the unfreeze loads as any
    other, with no retry (the trainer's `restore_latest`, which restores
    the optimizer too, retries). Orbax run directories of the JAX package
    are not read here."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.cli.presets import build_preset

    cfg = build_preset(preset)
    model, scaler = build_model(cfg, device, int8=int8, run_dir=run_dir,
                                checkpoint=checkpoint)
    return model, scaler, cfg


def add_distributed_args(p) -> None:
    """The multi-process flags of `geovpr.cli.train` (`:52-70`), on every
    CLI of the port."""
    p.add_argument("--multihost", action="store_true",
                   help="one process per card: init_process_group (from "
                        "torchrun's environment, or --coordinator, "
                        "--num-processes, --process-id), this rank on "
                        "cuda:{local rank} (or --device cpu, over gloo), "
                        "and a data mesh over every rank")
    p.add_argument("--coordinator", default="",
                   help="with --multihost: the rendezvous host:port (or an "
                        "init method such as file:///path)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)


def start_mesh(args, device):
    """(mesh, device) for a CLI run: with `--multihost` the process group
    is initialized and the mesh covers every rank along `data`, the device
    becoming this rank's card; else (None, device), the single-process
    path. Exits where `--device cuda` finds no card."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "run on the CPU")
    if not args.multihost:
        return None, device
    from geovpr_torch.parallel import create_mesh, initialize_distributed
    device = initialize_distributed(
        coordinator_address=args.coordinator or None,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=device)
    return create_mesh(), device


def stop_mesh(mesh) -> None:
    """Tear the process group down at the end of a `--multihost` run."""
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
