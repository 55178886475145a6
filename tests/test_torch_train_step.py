"""The port's training step against the JAX package's `make_train_step`,
parameter for parameter.

A tiny window-12-style Swin (window 4, N = 16, shifted blocks in stage 0,
head dim 32) with the preset's MLP head, Huber loss and AdamW with weight
decay; dropout and DropPath rates 0, no augmentation, f32 on both sides.
JAX runs its XLA path (no Pallas on the CPU), the port its training path
(`fused_swin_attn_train`, plain route on the CPU). The same initial
parameters go to both through the weight bridge; after each of three steps
the loss must agree within rtol 1e-5, and every parameter element within
rtol 1e-5 and atol 1e-7 plus 2 % of its tensor's largest update, but for
at most 1e-5 of all elements, which must stay within the size of the
updates taken (2 lr each). Adam divides each gradient by its own root
mean square: an element whose gradient is near zero, where the two
packages' f32 sums differ in the last bits, moves its parameter by a
different fraction of the learning rate (one element of 600,590 here).
Both take JAX's fitted scaler: the targets sit near 2e5, where f32 rounds
the mean to 1/64 and two summation orders of the same fit move the
encoded targets by ~5e-5 (`tests/test_torch_train_optim.py` holds the fit
itself to JAX's). Also: a padded-tail batch gives the update of its bare
valid rows; and the Adam-state bridge, where JAX runs two steps, its
state is carried over, and both take the third.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.swin as jswin
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.models import swin as tswin
from geovpr_torch.models.convert_jax import (optimizer_state_from_flax,
                                             state_dict_from_flax)
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.objectives.scaler import scaler_from_arrays
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores, and torch's thread pool oversubscribed by them runs the
    tiny ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANT = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=4,
               image_size=32, drop_path_rate=0.0)
B, SIZE, STEPS = 4, 32, 3
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR = 1e-3


def _cfgs():
    """The preset swin_b384_gemini2 on the tiny variant, head dropout 0,
    lr raised to 1e-3 so that three steps move the parameters well past
    f32 roundoff."""
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build("swin_b384_gemini2")
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           head_dropout=0.0,
                                           compute_dtype="float32"),
            data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=B,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR)))
    return out


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(image=rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(
                     np.uint8),
                 target=(rng.normal(size=(B, 2)) * [300, 100]
                         + [219000, 143000]).astype(np.float32),
                 mask=np.ones(B, bool)) for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jswin.SWIN_VARIANTS, "tiny-test", VARIANT)
        mp.setitem(tswin.SWIN_VARIANTS, "tiny-test", VARIANT)
        jcfg, tcfg = _cfgs()
        batches = _batches()
        targets = np.concatenate([b["target"] for b in batches])
        jmodel = JModel(config=dataclasses.replace(jcfg.model,
                                                   image_size=SIZE),
                        dtype=jnp.float32)
        jstate = j_create_state(jmodel, j_build_optimizer(jcfg.optim),
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3)),
                                scaler=j_fit_scaler(jnp.asarray(targets)))
        jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                          normalize_fn=j_normalize))
        yield dict(jcfg=jcfg, tcfg=tcfg, batches=batches, targets=targets,
                   jstate=jstate, jstep=jstep)


def _port_state(s, params):
    tcfg = s["tcfg"]
    model = RegressionModel(dataclasses.replace(tcfg.model, image_size=SIZE),
                            dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_flax(params))
    return TrainState(step=0, model=model,
                      opt=build_optimizer(model, tcfg.optim),
                      scaler=scaler_from_arrays(*s["jstate"].scaler),
                      seed=0)


def _np_params(jparams):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}


def _assert_params_close(got: dict, want: dict, before: dict, what: str,
                         steps: int):
    """Every element within rtol/atol + UPDATE_SHARE of its tensor's
    largest update, except at most OUTLIER_SHARE of all elements, which
    stay within the size of `steps` updates (2 lr each)."""
    outliers, total = 0, 0
    for k, w in want.items():
        g = got[k].detach().numpy()
        b = before[k]
        if k.endswith("attn.qkv_bias"):
            # the key bias adds one constant to every score of a row, which
            # the softmax removes: its gradient is zero in exact arithmetic
            # and roundoff in both packages, which Adam scales to +-lr with
            # independent signs. Its update is bounded; q and v are compared.
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


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_three_steps_match_jax(setup):
    s = setup
    tstate = _port_state(s, jax.tree_util.tree_map(np.asarray,
                                                   s["jstate"].params))
    tstep = make_train_step(objective_for(s["tcfg"]))
    jstate = s["jstate"]
    for i, batch in enumerate(s["batches"]):
        before = _np_params(jstate.params)
        jstate, jm = s["jstep"](jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        tm = tstep(tstate, _tbatch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL, abs=1e-6)
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_params_close(dict(tstate.model.state_dict()),
                             _np_params(jstate.params), before,
                             f"step {i + 1}", i + 1)
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.opt.count == STEPS


def test_padded_tail_matches_bare_rows(setup):
    """Three valid rows padded to four (the padded row repeats the last,
    as `iterate_batches` pads) give the update of the three rows alone."""
    s = setup
    params = jax.tree_util.tree_map(np.asarray, s["jstate"].params)
    b = s["batches"][0]
    bare = {k: v[:3] for k, v in b.items()}
    padded = {k: np.concatenate([v[:3], v[2:3]]) for k, v in b.items()}
    padded["mask"] = np.array([True, True, True, False])
    got = []
    for batch in (bare, padded):
        st = _port_state(s, params)
        m = make_train_step(objective_for(s["tcfg"]))(st, _tbatch(batch))
        got.append((float(m["loss"]), st.model.state_dict()))
    assert got[0][0] == pytest.approx(got[1][0], rel=1e-6)
    for k, v in got[0][1].items():
        np.testing.assert_allclose(v.numpy(), got[1][1][k].numpy(),
                                   rtol=2e-5, atol=2e-7, err_msg=k)


def test_adam_state_bridge(setup):
    """JAX takes two steps; its parameters and optax state (mu, nu,
    count, lr_scale) go to the port; both take the third step."""
    s = setup
    jstate = s["jstate"]
    for batch in s["batches"][:2]:
        jstate, _ = s["jstep"](jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tstate = _port_state(s, jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    opt = optimizer_state_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state))
    assert opt["count"] == 2 and opt["lr_scale"] == 1.0
    assert set(opt["mu"]) == set(tstate.opt.mu)
    tstate.opt.load_state_dict(opt)
    tstate.step = 2
    before = _np_params(jstate.params)
    batch = s["batches"][2]
    jstate, jm = s["jstep"](jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tm = make_train_step(objective_for(s["tcfg"]))(tstate, _tbatch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    _assert_params_close(dict(tstate.model.state_dict()),
                         _np_params(jstate.params), before, "step 3", 3)


def test_pretrained_backbone_overlay(setup, tmp_path):
    """`--pretrained`: a flax msgpack of backbone variables (the file
    `geovpr.cli.train --pretrained` reads) laid over the port's init: the
    backbone takes the file's values, the head keeps its init; a key or
    shape the model lacks is an error."""
    from flax.serialization import msgpack_serialize

    from geovpr_torch.cli.train import load_pretrained_backbone
    from geovpr_torch.train.state import _merge_pretrained

    s = setup
    params = jax.tree_util.tree_map(np.asarray, s["jstate"].params)
    path = tmp_path / "backbone.msgpack"
    path.write_bytes(msgpack_serialize({"params": params["backbone"]}))
    pre = load_pretrained_backbone(str(path))
    model = RegressionModel(dataclasses.replace(s["tcfg"].model,
                                                image_size=SIZE),
                            dtype=torch.float32, train=True)
    init = model.state_dict()
    merged = _merge_pretrained(init, pre)
    want = state_dict_from_flax(params)
    for k, v in merged.items():
        ref = want[k] if k.startswith("backbone.") else init[k]
        assert torch.equal(v.float(), ref.float()), k
    with pytest.raises(ValueError, match="not in the model"):
        _merge_pretrained(init, {"backbone.nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        _merge_pretrained(init, {"head.out.bias": torch.zeros(3)})
