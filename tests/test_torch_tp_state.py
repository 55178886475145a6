"""The port's tensor-parallel rules (`geovpr_torch.parallel.sharding_rules`)
against `geovpr.parallel.sharding_rules`, the split optimizer state at
(2, 2) over four gloo ranks, the cross-mesh restore, and
`dryrun_multichip`'s phases.

- Rules: each family's flax tree (tiny DINOv2, window-4 Swin, DINOv2 +
  SALAD, EfficientNet-B0, a narrow ConvNeXt, each under its
  `RegressionModel` head) gets random leaves; for each model coordinate
  the tree of JAX's shards (each leaf cut by `_guarded_spec` on a (2, 2)
  mesh) goes through the weight bridge beside the whole tree. The port's
  `shard_params` must give, for every parameter, exactly the bridged
  shard: its split dimension and its three q | k | v blocks land where
  JAX's split does, and what it replicates JAX replicates.
- At (2, 2) one step of a tiny DINOv2: each model rank keeps half of each
  split moment (fc1's rows, each third of `qkv_weight`'s columns), the
  whole state equals the port's single-process step (within
  `tests/test_torch_dp_train.py`'s tolerance: the `data` all-reduce sums
  in another order; measured: every element inside) and is bit-equal
  across the four ranks.
- JAX's cross-mesh restore (`tests/test_sharding.py:196-240`): a
  checkpoint saved at (4,) restores at (2, 2), each rank keeping its part
  of the moments, and in one process, the values equal.
- `dryrun_multichip` (`__graft_entry__.py:35-275`): phase 1 (a (2 x 2)
  TinyDino sin/cos step, fc1's moments split over `model`), phase 2 (the
  hybrid mesh), phase 4 (the fused pipeline sharded over the batch with
  the sharded int8 search over 67 rows, equal to the unsharded run:
  outputs within rtol 2e-4 as JAX's check, indices exactly). Phase 3 is
  an XLA compile-only check of the flagship forward; the port compiles
  nothing ahead of time, so it has no counterpart.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import geovpr.models.convnext as jconv
import geovpr.models.dinov2 as jdino
import geovpr.models.swin as jswin
from geovpr.core.config import ModelConfig as JModelConfig
from geovpr.parallel import create_mesh as j_create_mesh
from geovpr.parallel.sharding_rules import _guarded_spec as j_guarded_spec
from geovpr.train.model import RegressionModel as JModel
from geovpr_torch.cli.presets import objective_for
from geovpr_torch.core.config import GeoposeConfig, ModelConfig, OptimConfig
from geovpr_torch.models import convnext as tconv
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models import swin as tswin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.layers import init_weights_
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.parallel import sharding_rules as rules
from geovpr_torch.train.checkpoint import restore_checkpoint
from geovpr_torch.train.steps import make_train_step
from test_torch_dp_train import _assert_close
from torch_parallel_ranks import _state, run_ranks

WORLD = 4
DINO = dict(hidden_size=64, num_layers=2, num_heads=4)
SWIN = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 4), window_size=4,
            image_size=32)
CONV = dict(depths=(1, 1), dims=(32, 64))
VARIANTS = {"dinov2": {"tiny-dryrun": DINO}}
FAMILIES = {"dinov2": ("tiny-dryrun", "mlp", 28),
            "swin": ("tiny-tp", "mlp", 32),
            "dinov2_salad": ("tiny-dryrun", "mlp", 28),
            "efficientnet": ("b0", "sincos_linear", 32),
            "convnext": ("tiny-tp", "linear", 32)}
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _tiny_models():
    with pytest.MonkeyPatch.context() as mp:
        for reg, name, v in (
                (jdino.DINOV2_VARIANTS, "tiny-dryrun", DINO),
                (tdino.DINOV2_VARIANTS, "tiny-dryrun", DINO),
                (jswin.SWIN_VARIANTS, "tiny-tp", SWIN),
                (tswin.SWIN_VARIANTS, "tiny-tp", SWIN),
                (jconv.CONVNEXT_VARIANTS, "tiny-tp", CONV),
                (tconv.CONVNEXT_VARIANTS, "tiny-tp", CONV)):
            mp.setitem(reg, name, v)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


def _stub_mesh(tp, index):
    """The two things the rules read of a mesh."""
    return types.SimpleNamespace(
        shape={"data": 2, "model": tp},
        axis_size=lambda axis: {"data": 2, "model": tp}[axis],
        index=lambda axis: index if axis == "model" else 0)


def _model_cfg(family):
    variant, head, size = FAMILIES[family]
    return dict(family=family, variant=variant, head=head, out_dim=2,
                image_size=size, freeze_backbone=family == "dinov2_salad")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_spec_lands_on_jax_split(family):
    kw = _model_cfg(family)
    jmodel = JModel(config=JModelConfig(**kw), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, kw["image_size"],
                                          kw["image_size"], 3))))["params"]
    rng = np.random.default_rng(0)
    whole = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    jmesh = j_create_mesh((2, 2), ("data", "model"),
                          devices=jax.devices()[:4])
    specs = jax.tree_util.tree_map_with_path(
        lambda path, leaf: j_guarded_spec(path, leaf, jmesh, "model"), whole)
    assert any(s != P() for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P)))
    port = RegressionModel(ModelConfig(**kw), dtype=torch.float32,
                           train=True)
    t_whole = state_dict_from_flax({"params": whole})
    names = {n for n, _ in port.named_parameters()}
    assert names <= set(t_whole)
    for m in range(2):
        def cut(leaf, spec):
            for axis, name in enumerate(spec):
                if name == "model":
                    return np.split(leaf, 2, axis=axis)[m]
            return leaf
        t_part = state_dict_from_flax({"params": jax.tree_util.tree_map(
            cut, whole, specs, is_leaf=lambda x: isinstance(x, np.ndarray))})
        shards = rules.shard_params(_stub_mesh(2, m), port)
        assert shards, family
        for n in names:
            want = t_part[n]
            got = (shards[n].take(t_whole[n]) if n in shards
                   else t_whole[n])
            assert torch.equal(got, want), (family, n, m)


def test_divisibility_guard():
    """A split that does not divide the model axis replicates, in both
    packages (`tests/test_sharding.py::test_indivisible_dims_replicate`)."""
    jmesh = j_create_mesh((2, 4), ("data", "model"))

    class K:
        def __init__(self, key):
            self.key = key

    path = (K("attn"), K("query"), K("kernel"))
    assert j_guarded_spec(path, jnp.zeros((6, 6)), jmesh, "model") == P()
    stub = _stub_mesh(4, 0)
    assert rules._guarded_spec("blocks.0.attn.qkv_weight",
                               torch.zeros(6, 18), stub, "model") is None
    assert rules._guarded_spec("blocks.0.attn.qkv_weight",
                               torch.zeros(8, 24), stub, "model") == 1
    assert rules._guarded_spec("blocks.0.mlp.fc1.weight",
                               torch.zeros(6, 8), stub, "model") is None
    assert rules.param_spec("blocks.0.mlp.fc1.bias", torch.zeros(8)) is None
    assert rules.param_spec("norm.weight", torch.zeros(8)) is None
    assert rules.param_spec("blocks.0.attn.proj_weight",
                            torch.zeros(8, 8)) == 0
    assert rules.param_spec("blocks.0.mlp.fc2.weight",
                            torch.zeros(8, 32)) == 1


def _dino_cfg():
    return GeoposeConfig(
        model=ModelConfig(family="dinov2", variant="tiny-dryrun",
                          head="mlp", out_dim=2, pooling="mean",
                          head_dropout=0.0, image_size=28,
                          compute_dtype="float32"),
        optim=OptimConfig(lr=LR, weight_decay=0.01))


def _init(cfg):
    model = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    init_weights_(model, torch.Generator().manual_seed(3))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _batches(n=2, b=5):
    rng = np.random.default_rng(6)
    return [dict(image=rng.integers(0, 256, (b, 28, 28, 3)).astype(np.uint8),
                 target=rng.normal(size=(b, 2)).astype(np.float32),
                 mask=np.ones(b, bool)) for _ in range(n)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = _dino_cfg()
    gallery = np.random.default_rng(3).normal(size=(67, 4 * 16 + 16))
    gallery = (gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
               ).astype(np.float32)
    return run_ranks(
        [("tp", "dp_steps", dict(cfg=cfg, variants=VARIANTS,
                                 state_dict=_init(cfg), batches=_batches(),
                                 mesh_shape=(2, 2))),
         ("ckpt", "tp_checkpoints", dict(cfg=cfg, variants=VARIANTS,
                                         state_dict=_init(cfg),
                                         batches=_batches(1, 4))),
         ("dryrun", "dryrun_phases", dict(variants=VARIANTS,
                                          gallery=gallery))],
        WORLD, tmp_path_factory.mktemp("tp"))


def test_each_model_rank_holds_half_of_each_split_moment(ranks):
    fc1 = "backbone.blocks.0.mlp.fc1.weight"
    qkv = "backbone.blocks.1.attn.qkv_weight"
    for r, res in enumerate(ranks):
        got = res["tp"]
        m = r % 2                                 # (2, 2) row-major
        assert got["shards"][fc1] == (0, 1, 2, m)
        assert got["shards"][qkv] == (1, 3, 2, m)
        assert tuple(got["local_mu"][fc1].shape) == (128, 64)
        assert tuple(got["local_mu"][qkv].shape) == (64, 96)
        for n, (dim, groups, parts, index) in got["shards"].items():
            sh = rules.Shard(dim, groups, parts, index)
            assert torch.equal(got["local_mu"][n], sh.take(got["mu"][n]))
        d = 64
        whole = got["mu"][qkv]
        third = [whole[:, i * d:(i + 1) * d] for i in range(3)]
        want = torch.cat([t[:, m * d // 2:(m + 1) * d // 2] for t in third],
                         dim=1)
        assert torch.equal(got["local_mu"][qkv], want)
        # what is not split is whole on every rank
        assert "backbone.blocks.0.mlp.fc1.bias" not in got["shards"]


def test_tp_step_equals_world1(ranks):
    cfg = _dino_cfg()
    first = ranks[0]["tp"]
    for res in ranks[1:]:
        for key in ("params", "mu", "nu"):
            for k, v in first[key].items():
                assert torch.equal(res["tp"][key][k], v), (key, k)
    init = _init(cfg)
    state = _state(cfg, init)
    step = make_train_step(objective_for(cfg))
    for b in _batches():
        n = b["image"].shape[0]
        padded = {k: np.concatenate([v, v[:1]]) for k, v in b.items()}
        padded["mask"] = np.arange(n + 1) < n
        step(state, {k: torch.from_numpy(v) for k, v in padded.items()})
    _assert_close({k: v.numpy() for k, v in first["params"].items()},
                  {k: v.numpy() for k, v in state.model.state_dict().items()},
                  {k: v.numpy() for k, v in init.items()}, "(2, 2) vs 1", 2)


def test_checkpoint_saved_at_4_restores_at_2x2_and_world1(ranks):
    cfg = _dino_cfg()
    saved = ranks[0]["ckpt"]["saved"]
    for r, res in enumerate(ranks):
        got = res["ckpt"]
        assert got["epoch"] == 0
        for key in ("params", "mu", "nu"):
            for k, v in saved[key].items():
                assert torch.equal(got["restored"][key][k], v), (r, key, k)
        fc1 = "backbone.blocks.0.mlp.fc1.weight"
        assert got["shards"][fc1] == (0, 1, 2, r % 2)
        for n, (dim, groups, parts, index) in got["shards"].items():
            sh = rules.Shard(dim, groups, parts, index)
            assert torch.equal(got["local_mu"][n], sh.take(saved["mu"][n]))
    one = _state(cfg, {k: v * 0 for k, v in _init(cfg).items()})
    one, epoch = restore_checkpoint(ranks[0]["ckpt"]["path"], one)
    assert epoch == 0 and one.step == saved["step"]
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    opt = one.opt.state_dict()
    for k, v in opt["mu"].items():
        assert torch.equal(v, saved["mu"][k]), k


def test_dryrun_multichip_phases(ranks):
    for res in ranks:
        got = res["dryrun"]
        p1 = got["phase1"]
        assert np.isfinite(p1["loss"]) and p1["step"] == 1
        assert p1["fc1_local"] == (128, 64) and p1["fc1_whole"] == (256, 64)
        p2 = got["phase2"]
        assert p2["shape"] == {"data": 2, "model": 2}
        assert np.isfinite(p2["loss"]) and p2["step"] == 1
        mesh, ref = got["phase4"]["mesh"], got["phase4"]["ref"]
        for key in ("latlon", "angle"):
            np.testing.assert_allclose(mesh[key], ref[key], rtol=2e-4,
                                       atol=2e-4, err_msg=key)
        np.testing.assert_array_equal(mesh["retrieval_indices"],
                                      ref["retrieval_indices"])
        assert np.isfinite(mesh["latlon"]).all()
        assert mesh["latlon"].shape == (11, 2)
