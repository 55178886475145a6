"""Rank processes for the port's multi-process tests, on the CPU over gloo.

A test writes a job (the world size, the cases to run and their inputs)
and `run_ranks` starts one process per rank with this file as its script;
the ranks meet through a `file://` rendezvous in the test's temporary
directory (no TCP port, so several test workers can run jobs at once),
run every case of the job in one process group, and each saves its
results for the test to read. This module imports neither jax nor the JAX
package, so a rank starts in a second or two; with `block` a job also
makes `jax`, `flax`, `optax`, `orbax` and `geovpr` unimportable first.

    python tests/torch_parallel_ranks.py JOB_FILE RANK
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCK = ("jax", "jaxlib", "flax", "optax", "orbax", "geovpr")


def run_ranks(cases: list, world: int, tmp: Path, *, init: bool = True,
              block: bool = False, timeout: float = 240.0) -> list:
    """Run `cases` ([(case name, kwargs)] or [(label, case name,
    kwargs)], functions of this module) on `world` ranks, in order in one
    process group; returns each rank's {label (the case name by default):
    result}. A rank that fails fails the job, with its output in the
    message."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"cases": cases, "world": world, "init": init,
                     "block": block, "dir": str(tmp)}, f)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(job), str(r)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited with "
                               f"{p.returncode}:\n{out[-4000:]}")
    import torch
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _child(job_path: str, rank: int) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if job["block"]:
        for name in BLOCK:
            sys.modules[name] = None
    import torch

    torch.set_num_threads(1)
    if job["init"]:
        from geovpr_torch.parallel import initialize_distributed
        initialize_distributed(
            f"file://{job['dir']}/rdzv", job["world"], rank, device="cpu",
            timeout_s=120.0)
    results = {}
    for case in job["cases"]:
        label, name, kwargs = case if len(case) == 3 else (case[0], *case)
        results[label] = globals()[name](rank=rank, tmp=job["dir"], **kwargs)
    if job["block"]:
        results["leaked"] = sorted(
            m for m, mod in sys.modules.items()
            if mod is not None and m.split(".")[0] in BLOCK)
    torch.save(results, os.path.join(job["dir"], f"rank{rank}.pt"))
    if job["init"]:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


# ------------------------------------------------------------------ cases --

def mesh_layouts(rank, tmp):
    """create_mesh and create_hybrid_mesh on every rank: the rank ids in
    the mesh, this rank's coordinates, and each axis group's members (an
    all-gather of the ranks over the group); the ValueErrors."""
    import torch
    import torch.distributed as dist

    from geovpr_torch.parallel import create_hybrid_mesh, create_mesh
    from geovpr_torch.parallel.mesh import all_gather_cat

    def describe(mesh):
        groups = {}
        for axis in mesh.axis_names:
            got = all_gather_cat(torch.tensor([rank]), mesh, axis)
            groups[axis] = got.tolist()
        return {"devices": mesh.devices.tolist(), "shape": dict(mesh.shape),
                "coords": dict(mesh.coords), "groups": groups}

    out = {"default": describe(create_mesh()),
           "dp_tp": describe(create_mesh((2, 2), ("data", "model"))),
           "hybrid_one_host": describe(create_hybrid_mesh(
               (1, 2), (2, 1), ("data", "model"))),
           "hybrid_two_hosts": describe(create_hybrid_mesh(
               (1, 2), (2, 1), ("data", "model"), local_size=2))}
    errors = {}
    for name, fn in (
            ("shape", lambda: create_mesh((3,))),
            ("rank", lambda: create_mesh((2, 2), ("data",))),
            ("hybrid_rank", lambda: create_hybrid_mesh((2, 2), (2,),
                                                       ("data", "model"))),
            ("hybrid_cover", lambda: create_hybrid_mesh(
                (2, 2), (4, 1), ("data", "model"))),
            ("hybrid_host", lambda: create_hybrid_mesh(
                (2, 1), (1, 2), ("data", "model"), local_size=1))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["world"] = dist.get_world_size()
    return out


def shard_batch_rows(rank, tmp, batch):
    """This rank's rows of `batch` by `shard_batch` over a data mesh, and
    over (2, 2): the data coordinate's rows on both model ranks."""
    from geovpr_torch.parallel import create_mesh, shard_batch
    out = {}
    for name, mesh in (("data", create_mesh()),
                       ("dp_tp", create_mesh((2, 2), ("data", "model")))):
        got = shard_batch(mesh, batch)
        out[name] = {k: (v.numpy() if hasattr(v, "numpy") else v)
                     for k, v in got.items()}
    return out


def sharded_search(rank, tmp, gallery, queries, configs):
    """The sharded index over a data mesh for each config (quantize, k,
    query_chunk): every rank's (scores, indices); and `save_index` of a
    bf16 and an int8 index into the job directory."""
    import torch

    from geovpr_torch.parallel import create_mesh
    from geovpr_torch.retrieval.index import (DescriptorIndex, load_index,
                                              save_index)

    mesh = create_mesh()
    out = {}
    for name, cfg in configs.items():
        index = DescriptorIndex(dim=gallery.shape[1], quantize=cfg["quantize"],
                                mesh=mesh, query_chunk=cfg["chunk"]
                                ).build(torch.from_numpy(gallery))
        s, i = index.search(queries, k=cfg["k"])
        out[name] = (s.numpy(), i.numpy(), index._db.shape[0])
    for quantize in (False, True):
        index = DescriptorIndex(dim=gallery.shape[1], quantize=quantize,
                                mesh=mesh).build(torch.from_numpy(gallery))
        path = os.path.join(tmp, f"index_{int(quantize)}.npz")
        save_index(index, path, filenames=[f"g{j}" for j in
                                           range(len(gallery))])
        loaded, _ = load_index(path, mesh=mesh)
        s, i = loaded.search(queries, k=5)
        out[f"reloaded_{int(quantize)}"] = (s.numpy(), i.numpy())
    return out


def blocked_search(rank, tmp, gallery, queries, configs):
    """The sharded index built with `build_chunked` (chunks of `chunk`
    rows) and searched block by block (`db_block`) for each config
    (quantize, k, db_block, chunk): every rank's (scores, indices, shard
    rows)."""
    import torch

    from geovpr_torch.parallel import create_mesh
    from geovpr_torch.retrieval.index import DescriptorIndex

    mesh = create_mesh()
    out = {}
    for name, cfg in configs.items():
        index = DescriptorIndex(dim=gallery.shape[1], quantize=cfg["quantize"],
                                mesh=mesh, db_block=cfg["db_block"])
        chunks = (torch.from_numpy(gallery[a:a + cfg["chunk"]])
                  for a in range(0, len(gallery), cfg["chunk"]))
        index.build_chunked(chunks, total=len(gallery))
        s, i = index.search(queries, k=cfg["k"])
        out[name] = (s.numpy(), i.numpy(), index._db.shape[0])
    return out


def retrieve_and_score(rank, tmp, images, latlon):
    """`run_retrieval --int8` over a data mesh (calibration, the sharded
    extraction and index, the CSV from rank 0) on a small-14 DINOv2 +
    SALAD at 28 px, and `evaluate_and_predict` of the same descriptors'
    first two dimensions as a (lat, lon) head over the mesh: the record,
    the CSV's text and the metrics and predictions."""
    import torch

    from geovpr_torch.cli.evaluate import evaluate_and_predict
    from geovpr_torch.cli.retrieve import build_model, run_retrieval
    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.objectives.scaler import identity_scaler
    from geovpr_torch.parallel import create_mesh

    mesh = create_mesh()
    src = ArraySource(images, latlon, [f"g{i}.jpg" for i in
                                       range(len(images))])
    model = build_model("small-14", 28, "cpu", seed=0, int8=True)
    out_dir = os.path.join(tmp, "retrieval")
    rec = run_retrieval(model, src, src, batch_size=4, top_k=3,
                        positive_radius=150.0, out_dir=out_dir,
                        device="cpu", int8=True, mesh=mesh)
    with open(rec["matches_csv"]) as f:
        csv_text = f.read()

    class Head(torch.nn.Module):
        def forward(self, x):
            return model(x).pooled.float()[:, :2] * 100.0

    metrics, preds = evaluate_and_predict(Head(), identity_scaler(2), src, 3,
                                          "cpu",
                                          mesh=mesh)
    return {"record": rec, "csv": csv_text, "metrics": metrics,
            "preds": preds}


def _register(variants: dict) -> None:
    """Registry entries the parent registered for its tiny models."""
    from geovpr_torch.models import convnext, dinov2, efficientnet, swin
    for table, entries in variants.items():
        if table == "b0_stages":
            efficientnet.B0_STAGES = entries
            continue
        reg = {"dinov2": dinov2.DINOV2_VARIANTS, "swin": swin.SWIN_VARIANTS,
               "convnext": convnext.CONVNEXT_VARIANTS}[table]
        reg.update(entries)


def _state(cfg, state_dict, opt_state=None, step=0, drop=None):
    import torch

    from geovpr_torch.models.layers import DropPath, Dropout
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import identity_scaler
    from geovpr_torch.train.state import TrainState, build_optimizer

    model = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    model.load_state_dict(state_dict)
    if drop is not None:
        for m in model.modules():
            if isinstance(m, (DropPath, Dropout)):
                m.rate = drop
    opt = build_optimizer(model, cfg.optim)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    return TrainState(step=step, model=model, opt=opt,
                      scaler=identity_scaler(cfg.model.out_dim), seed=0)


def _snapshot(state) -> dict:
    opt = state.opt.state_dict()
    return {"params": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
            "mu": opt["mu"], "nu": opt["nu"], "count": opt["count"],
            "step": state.step}


def _run_steps(mesh, cfg, state, batches, augment=None) -> tuple:
    from geovpr_torch.cli.presets import objective_for
    from geovpr_torch.data.pipeline import prefetch_to_device
    from geovpr_torch.data.transforms import build_augment
    from geovpr_torch.train.steps import make_train_step

    step_fn = make_train_step(
        objective_for(cfg), mesh=mesh,
        augment_fn=build_augment(augment) if augment else None)
    losses, skipped = [], []
    for batch in batches:
        m = step_fn(state, next(prefetch_to_device([batch], "cpu",
                                                   mesh=mesh)))
        losses.append(float(m["loss"]))
        skipped.append(float(m["skipped"]))
    return losses, skipped


def dp_steps(rank, tmp, cfg, variants, state_dict, batches, opt_state=None,
             step=0, drop=None, augment=None, mesh_shape=None):
    """Data-parallel steps (a `model` axis too with `mesh_shape`) from the
    given state on the global batches (each padded to the data shards by
    `prefetch_to_device`): the losses and skip flags, and the state after
    the last step."""
    from geovpr_torch.parallel import create_mesh
    from geovpr_torch.parallel.sharding_rules import shard_state

    _register(variants)
    mesh = (create_mesh() if mesh_shape is None
            else create_mesh(mesh_shape, ("data", "model")))
    state = _state(cfg, state_dict, opt_state, step, drop)
    if "model" in mesh.shape:
        shard_state(mesh, state)
    losses, skipped = _run_steps(mesh, cfg, state, batches, augment)
    out = _snapshot(state)
    out.update(losses=losses, skipped=skipped,
               local_mu={n: t.clone() for n, t in state.opt.mu.items()},
               shards={n: (sh.dim, sh.groups, sh.parts, sh.index)
                       for n, sh in state.opt.shards.items()})
    return out


def fit_run(rank, tmp, cfg, variants, source, epochs):
    """`run_train` at this world size into tmp/runs: the history and run
    directory."""
    from geovpr_torch.cli.train import run_train
    from geovpr_torch.parallel import create_mesh

    _register(variants)
    trainer = run_train(cfg, source, source, save_dir=os.path.join(tmp,
                                                                   "runs"),
                        device="cpu", epochs=epochs, mesh=create_mesh())
    return {"history": trainer.history, "run_dir": trainer.run_dir,
            "step_losses": trainer.step_losses,
            "final": _snapshot(trainer.state)}


def cli_train(rank, tmp, world, variants, presets, argv):
    """`geovpr_torch.cli.train.main` with --multihost over a file
    rendezvous (this process's group is the CLI's own); its stdout."""
    import contextlib
    import io

    from geovpr_torch.cli import presets as port_presets
    from geovpr_torch.cli.train import main

    _register(variants)
    port_presets.GEOPOSE_PRESETS.update(presets)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--multihost", "--coordinator",
                     f"file://{tmp}/cli_rdzv", "--num-processes",
                     str(world), "--process-id", str(rank)])
    return buf.getvalue()


def tp_checkpoints(rank, tmp, cfg, variants, state_dict, batches):
    """Steps at (4,) saved by `save_checkpoint`, restored into a fresh
    state sharded at (2, 2): the state saved, the whole state restored and
    the moments each rank keeps."""
    from geovpr_torch.parallel import create_mesh
    from geovpr_torch.parallel.sharding_rules import shard_state
    from geovpr_torch.train.checkpoint import (restore_checkpoint,
                                               save_checkpoint)

    _register(variants)
    mesh4 = create_mesh()
    state = _state(cfg, state_dict)
    _run_steps(mesh4, cfg, state, batches)
    path = os.path.join(tmp, "ckpt_4")
    save_checkpoint(path, state, epoch=0, mesh=mesh4)
    mesh22 = create_mesh((2, 2), ("data", "model"))
    fresh = _state(cfg, {k: v * 0 for k, v in state_dict.items()})
    shard_state(mesh22, fresh)
    restored, epoch = restore_checkpoint(path, fresh)
    return {"saved": _snapshot(state), "epoch": epoch, "path": path,
            "restored": _snapshot(restored),
            "local_mu": {n: t.clone() for n, t in restored.opt.mu.items()},
            "shards": {n: (sh.dim, sh.groups, sh.parts, sh.index)
                       for n, sh in restored.opt.shards.items()}}


def _tiny_dino_sincos(variants):
    """`dryrun_multichip`'s TinyDino (`__graft_entry__.py:69-78`): a
    2-layer D = 64, 4-head DINOv2 at 28 px, its CLS through dropout 0.1 to
    a sin/cos head; AdamW lr 1e-3 with the global-norm clip at 1."""
    from geovpr_torch.core.config import AngleConfig, ModelConfig, OptimConfig

    _register(variants)
    return AngleConfig(
        model=ModelConfig(family="dinov2", variant="tiny-dryrun",
                          head="sincos_linear", out_dim=2, pooling="cls",
                          head_dropout=0.1, image_size=28,
                          compute_dtype="float32"),
        optim=OptimConfig(lr=1e-3, grad_clip_norm=1.0))


def _dryrun_step(mesh, cfg, dp, seed):
    import numpy as np
    import torch

    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.parallel.sharding_rules import shard_state

    model = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    init_weights_(model, torch.Generator().manual_seed(seed))
    state = _state(cfg, model.state_dict())
    shard_state(mesh, state)
    batch = {"image": np.random.default_rng(seed).integers(
                 0, 255, (dp * 4, 28, 28, 3)).astype(np.uint8),
             "target": np.linspace(0, 350, dp * 4, dtype=np.float32),
             "mask": np.ones(dp * 4, bool)}
    losses, _ = _run_steps(mesh, cfg, state, [batch])
    name = "backbone.blocks.0.mlp.fc1.weight"
    return {"loss": losses[0], "step": state.step,
            "fc1_local": tuple(state.opt.mu[name].shape),
            "fc1_whole": tuple(state.model.get_parameter(name).shape),
            "fc1_shard": state.opt.shards.get(name)}


def dryrun_phases(rank, tmp, variants, gallery):
    """`dryrun_multichip`'s phases 1, 2 and 4 (`__graft_entry__.py:35-275`)
    on this world: a (dp x tp) TinyDino sin/cos step with fc1 split over
    `model`; the same on the hybrid mesh; the fused three-head pipeline
    sharded over the batch with the sharded int8 index, beside the same
    pipeline with no mesh (which runs no collective) on this rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch import nn

    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.salad import DinoV2Salad
    from geovpr_torch.objectives.angle_codec import SinCosCodec
    from geovpr_torch.parallel import create_hybrid_mesh, create_mesh
    from geovpr_torch.pipeline.fused import FusedPipeline
    from geovpr_torch.retrieval.index import DescriptorIndex

    world = dist.get_world_size()
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    cfg = _tiny_dino_sincos(variants)
    out = {"phase1": _dryrun_step(create_mesh((dp, tp), ("data", "model")),
                                  cfg, dp, 0)}
    hmesh = create_hybrid_mesh((world // (2 * tp), tp), (2, 1),
                               ("data", "model"))
    out["phase2"] = _dryrun_step(hmesh, cfg, hmesh.shape["data"], 1)
    out["phase2"]["shape"] = dict(hmesh.shape)

    class TinyHead(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(3, 16)
            self.out = nn.Linear(16, 2)

        def forward(self, x):
            return self.out(torch.relu(self.fc1(x.mean(dim=(1, 2)))))

    gen = torch.Generator().manual_seed(7)
    desc = DinoV2Salad(variant="tiny-dryrun", image_size=28, num_clusters=4,
                       cluster_dim=16, token_dim=16)
    geo, ang = TinyHead(), TinyHead()
    for m in (desc, geo, ang):
        init_weights_(m, gen)
        m.eval()
    assert gallery.shape[1] == desc.descriptor_dim
    imgs = np.random.default_rng(4).integers(
        0, 256, (dp * 4 + 3, 32, 32, 3)).astype(np.uint8)
    src = ArraySource(images=imgs,
                      targets=np.zeros((imgs.shape[0], 2), np.float32))
    mesh = create_mesh((dp, tp), ("data", "model"))
    results = {}
    for name, m in (("mesh", mesh), ("ref", None)):
        index = DescriptorIndex(dim=gallery.shape[1], quantize=True,
                                mesh=m).build(torch.from_numpy(gallery))
        pipe = FusedPipeline(
            geopose_model=geo, angle_model=ang,
            angle_codec=SinCosCodec(order="cos_sin"), descriptor_model=desc,
            geopose_size=28, angle_size=28, angle_resize_to=32,
            descriptor_size=28, index=index, top_k=3, batch_size=dp * 4,
            device="cpu", mesh=m)
        results[name] = pipe.run(src)
    out["phase4"] = results
    return out


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
