"""The port's DINOv2 training step against the JAX package's
`make_train_step`, parameter for parameter, for the two DINOv2 training
presets.

A tiny DINOv2 (2 layers, D = 64, 2 heads, 28 px at patch 14: 5 tokens)
with each preset's own head, pooling, loss and AdamW: `dinov2_meanpool_huber`
(f32 mean over all tokens, CLS included, MLP head, Huber, AdamW with weight
decay 0.01) and `dinov2_cls_direct_maae` (CLS, linear head, the direct
MAAE loss). Dropout 0, no augmentation, f32 on both sides. JAX runs its XLA
path (no Pallas on the CPU), the port its training path
(`fused_mhsa_block_train`: K8a/K8c's plain route on the CPU). The same
initial parameters go to both through the weight bridge; after each of
three steps the loss must agree within rtol 1e-5, and every parameter
element within the tolerances of `tests/test_torch_train_step.py`: rtol
1e-5 and atol 1e-7 plus 2 % of its tensor's largest update, but for at
most 1e-5 of all elements, which must stay within the size of the updates
taken (2 lr each); the key bias, whose gradient is roundoff in both
packages, only within its bounded update. Also: the DropPath route of a
training block (a rate above 0) against JAX's XLA route, the weight bridge
of an f32 DINOv2 training tree, `--pretrained` on a DINOv2 backbone, and
the families `build_backbone(train=True)` builds.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.dinov2 as jdino
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.core.config import ModelConfig
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.models.registry import build_backbone
from geovpr_torch.objectives.scaler import identity_scaler, scaler_from_arrays
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step

VARIANT = dict(hidden_size=64, num_layers=2, num_heads=2)
PRESETS = ("dinov2_meanpool_huber", "dinov2_cls_direct_maae")
B, SIZE, STEPS = 4, 28, 3
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR = 1e-3


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    """The tiny variant in both packages, and one torch thread for these
    small shapes (the test workers share the cores)."""
    monkeypatch.setitem(jdino.DINOV2_VARIANTS, "tiny-test", VARIANT)
    monkeypatch.setitem(tdino.DINOV2_VARIANTS, "tiny-test", VARIANT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset):
    """The preset on the tiny variant, head dropout 0, no augmentation, lr
    raised to 1e-3 so that three steps move the parameters well past f32
    roundoff."""
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(preset)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           head_dropout=0.0,
                                           compute_dtype="float32",
                                           image_size=SIZE),
            data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=B,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR)))
    return out


def _batches(geo: bool, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        target = ((rng.normal(size=(B, 2)) * [300, 100] + [219000, 143000])
                  if geo else rng.uniform(0, 360, size=B))
        out.append(dict(image=rng.integers(0, 256, (B, SIZE, SIZE, 3))
                        .astype(np.uint8), target=target.astype(np.float32),
                        mask=np.ones(B, bool)))
    return out


def _np_params(jparams):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}


def _assert_params_close(got: dict, want: dict, before: dict, what: str,
                         steps: int):
    outliers, total = 0, 0
    for k, w in want.items():
        g = got[k].detach().numpy()
        b = before[k]
        if k.endswith("attn.qkv_bias"):
            c = w.shape[0] // 3
            assert np.abs(g[c:2 * c] - b[c:2 * c]).max() <= steps * LR * 1.01
            g, w, b = (np.concatenate([a[:c], a[2 * c:]]) for a in (g, w, b))
        err = np.abs(g - w)
        tol = RTOL * np.abs(w) + ATOL + UPDATE_SHARE * np.abs(w - b).max()
        assert err.max() <= 2 * LR * steps, f"{what}: {k} off by {err.max()}"
        outliers += int((err > tol).sum())
        total += err.size
    assert outliers <= OUTLIER_SHARE * total, \
        f"{what}: {outliers} of {total} elements outside the tolerance"


@pytest.mark.parametrize("preset", PRESETS)
def test_three_steps_match_jax(preset):
    jcfg, tcfg = _cfgs(preset)
    geo = preset == "dinov2_meanpool_huber"
    batches = _batches(geo)
    targets = np.concatenate([b["target"] for b in batches])
    jscaler = j_fit_scaler(jnp.asarray(targets)) if geo else None
    jstate = j_create_state(JModel(config=jcfg.model, dtype=jnp.float32),
                            j_build_optimizer(jcfg.optim),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), scaler=jscaler,
                            out_dim=jcfg.model.out_dim)
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize))

    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tstate = TrainState(step=0, model=model,
                        opt=build_optimizer(model, tcfg.optim),
                        scaler=(scaler_from_arrays(*jstate.scaler) if geo
                                else identity_scaler(1)), seed=0)
    tstep = make_train_step(objective_for(tcfg))
    for i, batch in enumerate(batches):
        before = _np_params(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL, abs=1e-6)
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_params_close(dict(tstate.model.state_dict()),
                             _np_params(jstate.params), before,
                             f"{preset} step {i + 1}", i + 1)
    assert tstate.step == int(jstate.step) == STEPS


DROP_RATE, DROP_KEEP = 0.25, (True, False, True, True)


class _JaxFixedDropPath(fnn.Module):
    """JAX's DropPath (`geovpr.models.layers.DropPath`) with its draw
    replaced by the fixed per-sample mask DROP_KEEP."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        mask = jnp.asarray(DROP_KEEP).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / keep, jnp.zeros_like(x))


def _torch_fixed_drop_path(self, x):
    """The port's `DropPath.forward` with the same fixed mask."""
    if self.rate == 0.0 or not self.training:
        return x
    keep = 1.0 - self.rate
    mask = torch.tensor(DROP_KEEP).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def test_drop_path_route_matches_jax(monkeypatch):
    """A tiny DINOv2 in training mode with DropPath rate 0.25 takes JAX's
    XLA route in every block (`mhsa_attention_unfused`, LayerScale,
    DropPath and the residual; never `fused_mhsa_block_train`), and its
    output and the gradient of every parameter equal `jax.grad` of JAX's
    DinoV2 in training mode (which runs that route on the CPU) on the same
    DropPath draw, f32 on both sides: rtol 1e-4, atol 1e-5 times the
    tensor's largest element."""
    from geovpr_torch.models import layers as tlayers

    monkeypatch.setattr(jdino, "DropPath", _JaxFixedDropPath)
    monkeypatch.setattr(tlayers.DropPath, "forward", _torch_fixed_drop_path)
    calls = []
    unfused = tdino.mhsa_attention_unfused
    monkeypatch.setattr(tdino, "mhsa_attention_unfused",
                        lambda *a: calls.append(1) or unfused(*a))
    monkeypatch.setattr(tdino, "fused_mhsa_block_train", None)

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (len(DROP_KEEP), SIZE, SIZE, 3)).astype(np.float32)
    w = rng.normal(size=(len(DROP_KEEP), (SIZE // 14) ** 2 + 1,
                         VARIANT["hidden_size"])).astype(np.float32)
    jm = jdino.DinoV2(**VARIANT, image_size=SIZE, drop_path_rate=DROP_RATE,
                      dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

    def jloss(p):
        o = jm.apply({"params": p}, jnp.asarray(x), deterministic=False)
        t = jnp.concatenate([o.cls[:, None], o.tokens], axis=1)
        return (t * w).sum(), t

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tm = tdino.DinoV2(**VARIANT, image_size=SIZE, drop_path_rate=DROP_RATE,
                      dtype=torch.float32, param_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.train()
    o = tm(torch.from_numpy(x))
    tout = torch.cat([o.cls[:, None], o.tokens], dim=1)
    (tout * torch.from_numpy(w)).sum().backward()
    assert len(calls) == VARIANT["num_layers"]

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(got[k].grad.numpy(), v, rtol=1e-4,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_weight_bridge_of_a_training_tree():
    """An f32 JAX DINOv2 training tree through `state_dict_from_flax` into
    the port's training model and back out of its state_dict: every tensor
    f32 and equal bit for bit, the fused (D, 3D) qkv weight's column
    blocks JAX's query, key and value kernels."""
    jcfg, tcfg = _cfgs("dinov2_meanpool_huber")
    params = jax.tree_util.tree_map(np.asarray, JModel(
        config=jcfg.model, dtype=jnp.float32).init(
            jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    sd = state_dict_from_flax(params)
    model = RegressionModel(tcfg.model, dtype=torch.bfloat16, train=True)
    model.load_state_dict(sd)
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
    attn = params["backbone"]["block1"]["attn"]
    d = VARIANT["hidden_size"]
    qkv = got["backbone.blocks.1.attn.qkv_weight"].numpy()
    for i, name in enumerate(("query", "key", "value")):
        np.testing.assert_array_equal(qkv[:, i * d:(i + 1) * d],
                                      attn[name]["kernel"])


def test_pretrained_dinov2_backbone_overlay(tmp_path):
    """`--pretrained` on a DINOv2 backbone: a flax msgpack of backbone
    variables laid over the port's init takes every backbone tensor (CLS
    token, position embeddings, patch embed, blocks, final norm) from the
    file and keeps the head's init."""
    from flax.serialization import msgpack_serialize

    from geovpr_torch.cli.train import load_pretrained_backbone
    from geovpr_torch.train.state import _merge_pretrained

    jcfg, tcfg = _cfgs("dinov2_meanpool_huber")
    params = jax.tree_util.tree_map(np.asarray, JModel(
        config=jcfg.model, dtype=jnp.float32).init(
            jax.random.PRNGKey(5), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    path = tmp_path / "backbone.msgpack"
    path.write_bytes(msgpack_serialize({"params": params["backbone"]}))
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    init = model.state_dict()
    merged = _merge_pretrained(init, load_pretrained_backbone(str(path)))
    want = state_dict_from_flax(params)
    assert {k for k in merged if k.startswith("backbone.")} == {
        k for k in want if k.startswith("backbone.")}
    for k, v in merged.items():
        ref = want[k] if k.startswith("backbone.") else init[k]
        assert torch.equal(v, ref), k


def test_check_training_gates():
    """DINOv2, Swin at either window, DINOv2 + SALAD with its backbone
    frozen or unfrozen (tests/test_torch_salad_train.py), and the CNNs
    (EfficientNet-B0, ConvNeXt) build for training, their parameters in
    f32 whatever the compute dtype; an unknown family is an error."""
    for family, variant, frozen in (
            ("dinov2", "large-14", False), ("swin", "base-384", False),
            ("swin", "tiny-224", False), ("dinov2_salad", "base-14", True),
            ("dinov2_salad", "base-14", False), ("efficientnet", "b0", False),
            ("convnext", "base-224", False)):
        model = build_backbone(
            ModelConfig(family=family, variant=variant,
                        freeze_backbone=frozen),
            torch.bfloat16, device="meta", train=True)
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="unknown model family"):
        build_backbone(ModelConfig(family="resnet", variant="50"),
                       device="meta", train=True)
