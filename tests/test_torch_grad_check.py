"""chip_smoke.py's training-gradient check of the unfrozen DINOv2 + SALAD
(`train_grads_vs_plain(salad_masks=True)`), on the CPU at a tiny width.

On a CPU tensor every kernel wrapper runs its plain version, so the
"kernel" route is the plain one and the check must pass with no ReLU
unit flipped. With a fault planted on the CLS row of the training
forward's output (what K8a returns), the check must trip even though the
plain path's SALAD ReLUs are made to pass the kernel path's units. And
`SaladRelus` with masks passes exactly the marked units, value and
gradient.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.data.transforms import normalize
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.objectives.scaler import fit_scaler
from geovpr_torch.ops import mhsa as mh
from geovpr_torch.train.state import create_train_state

B, SIZE = 4, 56


@pytest.fixture
def trainer_and_batch(monkeypatch):
    monkeypatch.setitem(tdino.DINOV2_VARIANTS, "tiny-test",
                        dict(hidden_size=64, num_layers=2, num_heads=2))
    cfg = build_preset("dinov2salad_frozen_mlp")
    model = RegressionModel(dataclasses.replace(
        cfg.model, variant="tiny-test", image_size=SIZE,
        freeze_backbone=False), dtype=torch.bfloat16, train=True)
    rng = np.random.default_rng(0)
    targets = (rng.normal(size=(B, 2)) * [300, 100]
               + [219000, 143000]).astype(np.float32)
    state = create_train_state(model, cfg.optim, seed=0,
                               scaler=fit_scaler(targets))
    trainer = types.SimpleNamespace(
        state=state, objective=objective_for(cfg),
        _normalize=lambda x: normalize(x, cfg.data.mean, cfg.data.std))
    batch = {"image": torch.from_numpy(
        rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)),
        "target": torch.from_numpy(targets),
        "mask": torch.ones(B, dtype=torch.bool)}
    return trainer, batch


def test_salad_gradient_check_passes_on_the_plain_route(trainer_and_batch,
                                                        capsys):
    cs.train_grads_vs_plain(*trainer_and_batch, "tiny", against_f32=True,
                            salad_masks=True)
    out = capsys.readouterr().out
    assert "[train_grads] path=tiny tensors=" in out
    assert ("flipped_units=[('feat', 0, 32768), ('score', 0, 32768), "
            "('token', 0, 2048)]") in out


def test_salad_gradient_check_catches_a_cls_row_fault(trainer_and_batch,
                                                      monkeypatch):
    forward = mh.fused_mhsa_train_fwd

    def cls_row_off(x, *args, **kwargs):
        out, qkv, ctx = forward(x, *args, **kwargs)
        out = out.clone()
        out[:, 0] = out[:, 0] * 1.02
        return out, qkv, ctx

    monkeypatch.setattr(mh, "fused_mhsa_train_fwd", cls_row_off)
    with pytest.raises(cs.SmokeFailure, match="ReLUs passing the same"):
        cs.train_grads_vs_plain(*trainer_and_batch, "tiny",
                                against_f32=True, salad_masks=True)


def test_salad_relus_pass_exactly_the_marked_units():
    x = torch.tensor([-0.5, -1e-3, 1e-3, 0.5], requires_grad=True)
    mask = torch.tensor([True, False, True, False])
    relus = cs.SaladRelus([mask])
    y = relus.relu(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y.detach(), torch.tensor([-0.5, 0.0, 1e-3, 0.0]))
    assert torch.equal(g, mask.float())
    assert torch.equal(relus.seen[0], x.detach())
    free = cs.SaladRelus()
    assert torch.equal(free.relu(x), torch.relu(x))
