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
