"""The port's data-parallel training step (`make_train_step(mesh=...)`,
BatchNorm's global statistics, `Trainer(mesh=...)`, `cli.train
--multihost`) at world 2 on the CPU over gloo, against world 1 on the same
global batch and against JAX's `make_train_step` on a (2,) data mesh.

Two models, f32 on both sides, two steps on global batches of 5 rows, which
both packages pad to 6 (row 0 repeated, masked: it enters BatchNorm's
statistics and not the loss):
- a tiny DINOv2 regression (`dinov2_meanpool_huber`: 2 layers, D = 64,
  28 px), JAX's init carried across by `convert_jax`;
- a tiny EfficientNet-B0 (`efficientnet_sincos_gemini` on B0's first two
  stages, 32 px; 10 BatchNorms), its BatchNorms perturbed and two JAX steps
  taken first, parameters, statistics and Adam state carried across, as
  `tests/test_torch_cnn_train.py` starts (a random EfficientNet at flax's
  init is chaotic in f32).
Head dropout and stochastic depth are off in these, JAX's threefry and
torch's generators never drawing the same numbers.
World 1 is the port without a mesh on the padded 6-row batch. Tolerances
as `tests/test_torch_cnn_train.py`: each element within rtol 1e-5 + atol
1e-7 + 2 % of its tensor's largest update, but for at most 1e-5 of all
elements, which stay within the updates taken (2 lr a step; a running
statistic twice its largest update); losses within rtol 1e-5; the
BatchNorm bias that a training-mode BatchNorm follows (`project.bn.bias`,
a roundoff gradient) only within its bounded update. Measured: world 2
against world 1 no element outside the tolerance, the ranks bit-equal.

Also: random draws on (geo_heavy augmentation, head dropout and DropPath
0.1) at world 2 against world 1, the draws taken over the global batch; a
NaN in one rank's rows skips the step on both; `Trainer.fit` at world 2
writes one `metrics.jsonl` and one checkpoint set and resumes at world 1;
`cli.train.main --multihost` over two ranks against the single-process CLI.
"""

import dataclasses
import json
import os
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

import geovpr.models.dinov2 as jdino
import geovpr.models.efficientnet as jeff
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.pipeline import prefetch_to_device as j_prefetch
from geovpr.data.transforms import normalize as j_normalize
from geovpr.parallel import create_mesh as j_create_mesh
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli import presets as tpresets
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.cli.train import main as train_main
from geovpr_torch.cli.train import run_train
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.data.transforms import build_augment
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models import efficientnet as teff
from geovpr_torch.models.convert_jax import (optimizer_state_from_flax,
                                             state_dict_from_flax)
from geovpr_torch.train.steps import make_train_step
from torch_parallel_ranks import _state, run_ranks

WORLD, B, STEPS, LR = 2, 5, 2, 1e-3
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
ROUNDOFF_GRAD = "project.bn.bias"
STAT = ("running_mean", "running_var")
DINO = dict(hidden_size=64, num_layers=2, num_heads=2)
DINO_SIZE, EFF_SIZE = 28, 32
J_STAGES = tuple(jeff.B0_STAGES[:2])
T_STAGES = tuple(teff.B0_STAGES[:2])
VARIANTS = {"dinov2": {"tiny-test": DINO}, "b0_stages": T_STAGES}


class _JaxNoDropPath(fnn.Module):
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture(autouse=True, scope="module")
def _tiny_models():
    """The tiny variants in both packages (the ranks register their own),
    JAX's stochastic depth off, one torch thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdino.DINOV2_VARIANTS, "tiny-test", DINO)
        mp.setitem(tdino.DINOV2_VARIANTS, "tiny-test", DINO)
        mp.setattr(jeff, "B0_STAGES", J_STAGES)
        mp.setattr(teff, "B0_STAGES", T_STAGES)
        mp.setattr(jeff, "DropPath", _JaxNoDropPath)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


def _cfgs(preset, size, variant=None, **data):
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(preset)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, head_dropout=0.0, compute_dtype="float32",
                image_size=size, variant=variant or cfg.model.variant),
            data=dataclasses.replace(cfg.data, image_size=size,
                                     batch_size=B,
                                     **(data or {"augment": "none"})),
            optim=dataclasses.replace(cfg.optim, lr=LR)))
    return out


def _batches(size, angle, seed, n=STEPS, b=B):
    rng = np.random.default_rng(seed)
    return [dict(image=rng.integers(0, 256, (b, size, size, 3))
                 .astype(np.uint8),
                 target=(rng.uniform(0, 360, size=b) if angle
                         else rng.normal(size=(b, 2))).astype(np.float32),
                 mask=np.ones(b, bool)) for _ in range(n)]


def _padded(batch, multiple=WORLD):
    """The batch as the mesh pads it: row 0 repeated, masked."""
    n = batch["image"].shape[0]
    pad = -n % multiple
    out = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)])
           for k, v in batch.items()}
    out["mask"] = np.arange(n + pad) < n
    return out


def _perturb_bn(params):
    def one(path, v):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        key = jax.random.PRNGKey(zlib.crc32(name.encode()))
        if name.endswith("bn/scale"):
            return v * jax.random.uniform(key, v.shape, minval=0.3,
                                          maxval=0.8)
        if name.endswith("bn/bias"):
            return v + 0.2 * jax.random.normal(key, v.shape)
        return v
    return jax.tree_util.tree_map_with_path(one, params)


def _variables(jstate):
    v = {"params": jstate.params}
    if jstate.batch_stats:
        v["batch_stats"] = jstate.batch_stats
    return v


def _np_state(variables) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}


def _jax_case(preset, size, angle, has_stats, warmup):
    """JAX's start state (warmed up where asked), then its steps on the
    (2,) data mesh: (start state, [(loss, state dict after)])."""
    jcfg, tcfg = _cfgs(preset, size, "tiny-test" if not has_stats else None)
    jstate = j_create_state(JModel(config=jcfg.model, dtype=jnp.float32),
                            j_build_optimizer(jcfg.optim),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)),
                            out_dim=jcfg.model.out_dim)
    step = j_make_train_step(j_objective_for(jcfg), normalize_fn=j_normalize,
                             has_batch_stats=has_stats)
    if has_stats:
        jstate = jstate.replace(params=_perturb_bn(jstate.params))
        local = jax.jit(step)
        for batch in _batches(size, angle, seed=9, b=8)[:warmup]:
            jstate, _ = local(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    mesh = j_create_mesh((WORLD,), devices=jax.devices()[:WORLD])
    start = jstate
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    sharded = jax.jit(step)
    after = []
    for batch in j_prefetch(iter(_batches(size, angle, seed=1)), mesh):
        batch.pop("_indices", None)
        jstate, m = sharded(jstate, batch)
        after.append((float(m["loss"]), _np_state(_variables(jstate))))
    return tcfg, start, after


def _port_start(start) -> dict:
    return dict(state_dict=state_dict_from_flax(jax.tree_util.tree_map(
                    np.asarray, _variables(start))),
                opt_state=optimizer_state_from_flax(jax.tree_util.tree_map(
                    np.asarray, start.opt_state)),
                step=int(start.step))


def _world1(tcfg, start, batches, drop=None, augment=None):
    """The port without a mesh on the padded global batches: losses and the
    state dict after each step."""
    state = _state(tcfg, **start, drop=drop)
    step = make_train_step(objective_for(tcfg),
                           augment_fn=build_augment(augment) if augment
                           else None)
    out = []
    for batch in batches:
        m = step(state, {k: torch.from_numpy(v)
                         for k, v in _padded(batch).items()})
        out.append((float(m["loss"]), float(m["skipped"]),
                    {k: v.clone() for k, v in
                     state.model.state_dict().items()}))
    return out, state


def _image_dir(root, n=5, size=40):
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    rng = np.random.default_rng(3)
    csv = os.path.join(root, "labels.csv")
    with open(csv, "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3)).astype(
                np.uint8)).save(os.path.join(root, "img", f"p{i}.png"))
            f.write(f"p{i}.png,0,{219000 + i * 50.0},{143000 - i},0,1\n")
    return csv


def _cli_preset():
    """dinov2_meanpool_huber on the tiny DINOv2 in f32 (its augmentation
    and head dropout on)."""
    cfg = tpresets.GEOPOSE_PRESETS["dinov2_meanpool_huber"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                       compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=DINO_SIZE,
                                 batch_size=4),
        train=dataclasses.replace(cfg.train, epochs=1))


def _fit_source(n=7):
    rng = np.random.default_rng(5)
    return ArraySource(
        rng.integers(0, 256, (n, DINO_SIZE, DINO_SIZE, 3)).astype(np.uint8),
        (rng.normal(size=(n, 2)) * [300, 100] + [219000, 143000]).astype(
            np.float32), [f"{i}.jpg" for i in range(n)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    dino = _jax_case("dinov2_meanpool_huber", DINO_SIZE, False, False, 0)
    eff = _jax_case("efficientnet_sincos_gemini", EFF_SIZE, True, True, 2)
    nan_batch = _batches(DINO_SIZE, False, seed=4, n=1)[0]
    nan_batch["image"] = nan_batch["image"].astype(np.float32)
    nan_batch["image"][4, 3, 3, 1] = np.nan          # rank 1's rows: 3-5
    _, rand_cfg = _cfgs("dinov2_meanpool_huber", DINO_SIZE, "tiny-test",
                        augment="geo_heavy")
    rand_cfg = dataclasses.replace(rand_cfg, model=dataclasses.replace(
        rand_cfg.model, head_dropout=0.1))
    fit_cfg = dataclasses.replace(_cli_preset(), train=dataclasses.replace(
        _cli_preset().train, epochs=2))
    cases = [(name, "dp_steps", dict(
        cfg=tcfg, variants=VARIANTS, **_port_start(start),
        batches=_batches(size, angle, seed=1), drop=0.0))
        for name, (tcfg, start, _), size, angle in (
            ("dino", dino, DINO_SIZE, False),
            ("eff", eff, EFF_SIZE, True))]
    cases += [("random", "dp_steps", dict(
                  cfg=rand_cfg, variants=VARIANTS, **_port_start(dino[1]),
                  batches=_batches(DINO_SIZE, False, seed=2), drop=0.1,
                  augment="geo_heavy")),
              ("nan", "dp_steps", dict(
                  cfg=dino[0], variants=VARIANTS, **_port_start(dino[1]),
                  batches=[nan_batch])),
              ("fit", "fit_run", dict(cfg=fit_cfg, variants=VARIANTS,
                                      source=_fit_source(), epochs=1))]
    ranks = run_ranks(cases, WORLD, tmp / "job")
    return dict(dino=dino, eff=eff, nan_batch=nan_batch, rand_cfg=rand_cfg,
                fit_cfg=fit_cfg, ranks=ranks, tmp=tmp)


def _assert_close(got: dict, want: dict, before: dict, what: str,
                  steps: int):
    """Every element within RTOL/ATOL + UPDATE_SHARE of its tensor's
    largest update, at most OUTLIER_SHARE of them outside, each within
    the updates taken; the roundoff-gradient bias within its bound."""
    outliers, total = 0, 0
    for k, w in want.items():
        g = np.asarray(got[k])
        b = np.asarray(before[k])
        if k.endswith(ROUNDOFF_GRAD):
            assert np.abs(g - b).max() <= steps * LR * 1.03, k
            continue
        if k.endswith("attn.qkv_bias"):
            # the key bias: a roundoff gradient in both packages
            c = w.shape[0] // 3
            assert np.abs(g[c:2 * c] - b[c:2 * c]).max() <= \
                steps * LR * 1.03, k
            g, w, b = (np.concatenate([a[:c], a[2 * c:]]) for a in (g, w, b))
        err = np.abs(g - w)
        step = np.abs(w - b).max()
        tol = RTOL * np.abs(w) + ATOL + UPDATE_SHARE * step
        limit = 2 * step + ATOL if k.endswith(STAT) else 2 * LR * steps
        assert err.max() <= limit, f"{what}: {k} off by {err.max()}"
        outliers += int((err > tol).sum())
        total += err.size
    assert outliers <= OUTLIER_SHARE * total, \
        f"{what}: {outliers} of {total} elements outside the tolerance"


def _np(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _assert_ranks_equal(ranks, label):
    first = ranks[0][label]
    for res in ranks[1:]:
        got = res[label]
        assert got["losses"] == first["losses"]
        for key in ("params", "mu", "nu"):
            for k, v in first[key].items():
                assert torch.equal(got[key][k], v), (label, key, k)


@pytest.mark.parametrize("model", ["dino", "eff"])
def test_world2_matches_world1_and_jax(run, model):
    """Two steps at world 2: the ranks bit-equal, and losses, parameters,
    moments and running statistics against the port at world 1 on the
    padded global batch and against JAX on its (2,) data mesh."""
    tcfg, start, jax_after = run[model]
    ranks = run["ranks"]
    _assert_ranks_equal(ranks, model)
    got = ranks[0][model]
    angle = model == "eff"
    size = EFF_SIZE if angle else DINO_SIZE
    one, state1 = _world1(tcfg, _port_start(start),
                          _batches(size, angle, seed=1), drop=0.0)
    before = _np_state(_variables(start))
    for i, (loss1, skipped1, _) in enumerate(one):
        assert got["losses"][i] == pytest.approx(loss1, rel=RTOL, abs=1e-6)
        assert got["losses"][i] == pytest.approx(jax_after[i][0], rel=RTOL,
                                                 abs=1e-6)
        assert got["skipped"][i] == skipped1 == 0.0
    _assert_close(_np(got["params"]), _np(one[-1][2]), before,
                  f"{model} world 2 vs 1", STEPS)
    _assert_close(_np(got["params"]), jax_after[-1][1], before,
                  f"{model} world 2 vs JAX", STEPS)
    opt1 = state1.opt.state_dict()
    for key in ("mu", "nu"):
        for k, v in opt1[key].items():
            if k.endswith(ROUNDOFF_GRAD) or k.endswith("attn.qkv_bias"):
                continue          # moments of a roundoff gradient
            np.testing.assert_allclose(got[key][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-9 + 1e-3 * float(
                                           v.abs().max()), err_msg=k)
    assert got["count"] == state1.opt.count == start.step + STEPS
    if angle:      # every running statistic moved, as at world 1
        stats = [k for k in got["params"] if k.endswith(STAT)]
        assert len(stats) == 2 * 10
        for k in stats:
            assert not torch.equal(got["params"][k],
                                   torch.from_numpy(before[k])), k


def test_random_draws_cover_the_global_batch(run):
    """geo_heavy, head dropout and DropPath 0.1: world 2 takes the draws
    of world 1 on the same global batch (each rank its rows), so the
    steps agree within the tolerance."""
    tcfg = run["rand_cfg"]
    start = _port_start(run["dino"][1])
    _assert_ranks_equal(run["ranks"], "random")
    got = run["ranks"][0]["random"]
    one, _ = _world1(tcfg, start, _batches(DINO_SIZE, False, seed=2),
                     drop=0.1, augment="geo_heavy")
    for i, (loss1, _, _) in enumerate(one):
        assert got["losses"][i] == pytest.approx(loss1, rel=RTOL, abs=1e-6)
    _assert_close(_np(got["params"]), _np(one[-1][2]),
                  _np(start["state_dict"]), "random world 2 vs 1", STEPS)
    # the draws matter: without them (rate 0, no augmentation) the step
    # ends elsewhere
    plain, _ = _world1(run["dino"][0], start,
                       _batches(DINO_SIZE, False, seed=2))
    assert abs(plain[0][0] - got["losses"][0]) > 1e-4


def test_nan_on_one_rank_skips_the_step_on_both(run):
    start = _port_start(run["dino"][1])["state_dict"]
    for res in run["ranks"]:
        got = res["nan"]
        assert got["skipped"] == [1.0] and got["losses"] == [0.0]
        assert got["count"] == 1 and got["step"] == 1
        for k, v in start.items():
            assert torch.equal(got["params"][k], v), k


def test_fit_at_world2_writes_one_run_and_resumes_at_world1(run, tmp_path):
    ranks = run["ranks"]
    a, b = (r["fit"] for r in ranks)
    assert a["run_dir"] == b["run_dir"]
    assert a["step_losses"] == b["step_losses"]
    runs = os.path.dirname(a["run_dir"])
    assert os.listdir(runs) == [os.path.basename(a["run_dir"])]
    files = sorted(os.listdir(a["run_dir"]))
    assert files == ["best", "checkpoint_0", "metrics.jsonl"]
    with open(os.path.join(a["run_dir"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [0] and recs == a["history"]
    # world 1 from the same start takes the same two steps
    cfg, src = run["fit_cfg"], _fit_source()
    one = run_train(cfg, src, src, save_dir=str(tmp_path / "one"),
                    device="cpu", epochs=1)
    np.testing.assert_allclose(a["step_losses"][0], one.step_losses[0],
                               rtol=RTOL)
    resumed = run_train(cfg, src, src, save_dir=str(tmp_path / "unused"),
                        device="cpu", resume=a["run_dir"])
    assert [r["epoch"] for r in resumed.history] == [1]
    assert resumed.state.step == 4 and resumed.state.opt.count == 4
    with open(os.path.join(a["run_dir"], "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


def test_multihost_cli_matches_the_single_process_cli(run, tmp_path):
    """`cli.train.main --multihost --coordinator file://... --num-processes
    2 --process-id r --device cpu` on two ranks: rank 0 prints the run's
    record, rank 1 nothing; its epoch loss and validation match the
    single-process CLI on the same folder."""
    csv = _image_dir(str(tmp_path))
    common = ["--preset", "dinov2_meanpool_huber", "--train-csv", csv,
              "--val-csv", csv, "--image-root", str(tmp_path / "img"),
              "--device", "cpu", "--epochs", "1"]
    ranks = run_ranks([("cli_train", dict(
        world=WORLD, variants=VARIANTS,
        presets={"dinov2_meanpool_huber": _cli_preset()},
        argv=common + ["--save-dir", str(tmp_path / "multi")]))],
        WORLD, tmp_path / "cli", init=False)
    out0, out1 = (r["cli_train"] for r in ranks)
    assert out1.strip() == ""
    multi = json.loads(out0.strip().splitlines()[-1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tpresets.GEOPOSE_PRESETS, "dinov2_meanpool_huber",
                   _cli_preset())
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_main(common + ["--save-dir", str(tmp_path / "single")])
    single = json.loads(buf.getvalue().strip().splitlines()[-1])
    for k in ("train_loss", "val_mse", "val_mae"):
        assert multi["final"][k] == pytest.approx(single["final"][k],
                                                  rel=1e-5), k
