"""Data parallelism in the port (``handnet_tpu_torch/parallel/``) on the CPU:
DDP steps against JAX's mesh step and against the port's whole-batch step,
``shard_batch`` against JAX's, the mesh server, and ``train_a2j`` under
``torch.distributed.run``.

One world of 4 gloo ranks, spawned once for the module with a ``file://``
rendezvous under ``tmp_path`` (no TCP port: several test processes share the
machine), runs every DDP step on its shard of a global batch of 8 and saves
what the tests read. A fifth process computes the whole-batch steps and
JAX's ``A2JTrainer(mesh=create_mesh(4))`` step. They start with the module
and run while this process runs the server's and the CLI's tests; the
world's tests come last. Every spawned
process runs one torch thread; every world has a timeout on its
collectives and on its join, so a hung collective fails the test.

The DDP steps are held against the whole-batch steps in float64: the
parameters and batches in float64 and every ``.float()`` of the port
(BatchNorm's statistics, the losses, the metrics) widened to float64 for
those steps. There the two agree to about 1e-13; in float32 the rounding of
another batching, amplified through the backbones' BatchNorms, reaches 3%
in A2J's first conv's gradient and 1e-3 in FCOS's (JAX's own mesh step
against its one-device step: 2%, tests/test_parallel.py), which would hide
a wrong normalizer of a few percent. The A2J step against JAX's runs in
float32, JAX's dtype, to tests/test_parallel.py's tolerances.

JAX is imported inside the tests only: the ranks import this module to find
their entry point, and they import torch alone.
"""

import concurrent.futures
import contextlib
import datetime
import hashlib
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.models import fcos as pfcos
from handnet_tpu_torch.nn.resnet import BatchNorm2d, SyncBatchNorm2d, make_norm
from handnet_tpu_torch.parallel import mesh as pmesh
from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer, RCNNTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_BATCH, SEED = 4, 8, 3
COLLECTIVE_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 180

# tests/test_parallel.py's A2J step (32^2 crops, 3 joints, float32, AdamW
# 1e-3) with test_torch_port_train_a2j.py's 32-wide heads (each DDP step
# moves every gradient through gloo);
# in float64, SGD, whose update is linear in the gradient (AdamW's first
# step divides each gradient by its own size, so where the gradient is
# rounding noise the update is too)
A2J_CFG = dict(crop_h=32, crop_w=32, num_joints=3, head_features=32)
A2J_TRAIN = dict(bf16=False, lr=1e-3)
A2J_TRAIN_SGD = dict(bf16=False, lr=1e-3, optimizer="sgd")
# tests/test_torch_port_train.py's FCOS; the R-CNN of test_torch_port_rcnn.py
FCOS_CFG = dict(image_h=64, image_w=96, fpn_channels=64, num_convs=2, ext=True)
FCOS_TRAIN = dict(lr=0.01, weight_decay=1e-4, optimizer="sgd", warmup_epochs=1, bf16=False)
RCNN_CFG = dict(num_classes=3, image_h=64, image_w=96)
RCNN_TRAIN = dict(lr=1e-3, optimizer="sgd", bf16=False)
# boxes per image: ranks 0-3 hold images (0, 1), (2, 3), ...: their
# foreground counts differ, and rank 3 has none
BOXES_PER_IMAGE = (3, 2, 2, 1, 1, 0, 0, 0)
# a DDP step against the whole-batch step, both in float64 (measured: about
# 1e-13): losses to 1e-10 relative, each gradient and each updated tensor
# to 1e-8 of its largest magnitude, or of 1e-9 of the model's largest where
# the tensor's is smaller (the conv biases before a BatchNorm, whose
# gradient is rounding noise, and which start at 0)
LOSS_RTOL, GRAD_TOL, PARAM_TOL, FLOOR = 1e-10, 1e-8, 1e-8, 1e-9


@contextlib.contextmanager
def _float64():
    """Parameters built in float64 and every ``Tensor.float()`` a float64
    cast, for the steps inside (module docstring)."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", lambda self, *a, **k: self.double()):
            yield
    finally:
        torch.set_default_dtype(default)


def _wide(tree):
    """A batch's float32 arrays in float64."""
    if isinstance(tree, dict):
        return {k: _wide(v) for k, v in tree.items()}
    return tree.astype(np.float64) if tree.dtype == np.float32 else tree


def _a2j_batch():
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(GLOBAL_BATCH, 32, 32, 1)).astype(np.float32),
            "jt_uvd": rng.uniform(0, 32, size=(GLOBAL_BATCH, 3, 3)).astype(np.float32)}


def _detect_batch(box_info=True):
    """Frames and padded targets (8 slots) with :data:`BOXES_PER_IMAGE`
    boxes, labels 1-2 and box_info in the data source's layout."""
    rng = np.random.default_rng(1)
    h, w, m = 64, 96, 8
    boxes = np.zeros((GLOBAL_BATCH, m, 4), np.float32)
    labels = np.zeros((GLOBAL_BATCH, m), np.int32)
    valid = np.zeros((GLOBAL_BATCH, m), bool)
    info = np.full((GLOBAL_BATCH, m, 5), -1.0, np.float32)
    info[..., 4] = 0.0
    for i, n in enumerate(BOXES_PER_IMAGE):
        for j in range(n):
            bw, bh = rng.uniform(0.15, 0.7) * w, rng.uniform(0.15, 0.7) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, j] = rng.integers(1, 3)
            valid[i, j] = True
            info[i, j] = [rng.integers(0, 5), rng.integers(0, 2), rng.uniform(0, 1),
                          rng.uniform(-1, 1), rng.uniform(-1, 1)]
    targets = {"boxes": boxes, "labels": labels, "valid": valid}
    if box_info:
        targets["box_info"] = info
    return {"image": rng.normal(size=(GLOBAL_BATCH, h, w, 3)).astype(np.float32),
            "targets": targets}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _local(batch, mesh):
    """The rank's shard of the global batch (the whole batch without a mesh)."""
    if mesh is None:
        return _tensors(batch)
    (local,) = pmesh.shard_batch(mesh, batch)
    return local


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _digest(model) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run_steps(trainer, batches, mesh):
    """A train step on each of ``batches`` (on its shard under a mesh) from
    the trainer's seeded init. Returns the metrics of each step, the
    gradients of the last step as the optimizer received them, the state
    dict after and its digest."""
    state = trainer.init_state(SEED)
    grads = {}
    step = state.optimizer.step

    def capture(*a, **k):
        grads.update({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
        return step(*a, **k)

    state.optimizer.step = capture
    metrics = []
    for batch in batches:
        state, m = trainer.train_step(state, _local(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": grads, "digest": _digest(state.model),
            "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()}}


def _a2j_case(mesh, wide=True):
    trainer = A2JTrainer(pconfig.A2JConfig(**A2J_CFG),
                         pconfig.TrainConfig(**(A2J_TRAIN_SGD if wide else A2J_TRAIN)),
                         mesh=mesh, steps_per_epoch=10, device="cpu")
    if not wide:
        return _run_steps(trainer, [_a2j_batch()], mesh)
    with _float64():
        return _run_steps(trainer, [_wide(_a2j_batch())], mesh)


def _fcos_case(mesh, norm, steps=1):
    trainer = FCOSTrainer(pconfig.FCOSConfig(**FCOS_CFG), pconfig.TrainConfig(**FCOS_TRAIN),
                          mesh=mesh, steps_per_epoch=2, milestones_epochs=(1,),
                          backbone_norm=norm, device="cpu")
    batches = [_detect_batch(), _detect_batch(box_info=False)][:steps]
    with _float64():
        return _run_steps(trainer, [_wide(b) for b in batches], mesh)


def _rcnn_case(mesh):
    trainer = RCNNTrainer(pconfig.FCOSConfig(**RCNN_CFG), pconfig.TrainConfig(**RCNN_TRAIN),
                          mesh=mesh, backbone_norm="batch", num_proposals=16, device="cpu")
    with _float64():
        return _run_steps(trainer, [_wide(_detect_batch())], mesh)


# every case of the world, by name: (function, args); the whole-batch
# reference of each is the same call without a mesh
CASES = {
    "a2j_f32": (_a2j_case, (False,)),   # against JAX's mesh step
    "a2j": (_a2j_case, ()),
    # a second step without box_info: the loss leaves the extension heads
    # out, and DDP's reducer, which waits for every parameter, must finish it
    "fcos_frozen": (_fcos_case, ("frozen", 2)),
    "fcos_batch": (_fcos_case, ("batch",)),
    "rcnn": (_rcnn_case, ()),
}


def _norm_case(mesh):
    """A ``BatchNorm2d`` and a ``SyncBatchNorm2d`` (their mesh set as a
    trainer sets it) in training mode on the rank's shard of a seeded
    ``[8, 4, 5, 5]`` batch, or on the whole of it without a mesh: the
    outputs, the gradient of their weighted sum and the running
    statistics."""
    rng = np.random.default_rng(2)
    x = _local(rng.normal(2.0, 3.0, size=(8, 4, 5, 5)).astype(np.float32), mesh)
    weight = _local(rng.normal(size=(8, 4, 5, 5)).astype(np.float32), mesh)
    out = {}
    for norm in (BatchNorm2d(4), SyncBatchNorm2d(4))[:1 if mesh is None else 2]:
        norm.mesh = mesh
        xi = x.clone().requires_grad_(True)
        y = norm.train()(xi)
        (y * weight).sum().backward()
        out[type(norm).__name__] = (y.detach(), xi.grad, norm.running_mean.clone(),
                                    norm.running_var.clone())
    return out


# the whole-batch step each rank computes after the world's steps, and the
# DDP step it holds against it (the control against fcos_batch's)
REFERENCES = {0: ("a2j",), 1: ("fcos_frozen",), 2: ("fcos_batch", "fcos_unsynced"),
              3: ("rcnn",)}


def _step_errors(got, want):
    """What keeps a DDP step from matching the whole-batch step to the
    module's tolerances: a list of (what, error, bound), empty when it
    matches."""
    bad = []
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in w:
            bound = LOSS_RTOL * max(abs(w[k]), 1e-6)
            if not abs(g[k] - w[k]) <= bound:
                bad.append((f"loss {k}", abs(g[k] - w[k]), bound))
    for part, tol in (("grads", GRAD_TOL), ("state", PARAM_TOL)):
        top = max(float(w.abs().max()) for w in want[part].values() if w.is_floating_point())
        for k, w in want[part].items():
            if not w.is_floating_point():
                if not torch.equal(got[part][k], w):
                    bad.append((f"{part} {k}", 1.0, 0.0))
                continue
            err = float((got[part][k] - w).abs().max())
            bound = tol * max(float(w.abs().max()), FLOOR * top)
            if not err <= bound:
                bad.append((f"{part} {k}", err, bound))
    return bad


def _world_rank(rank, init_file, out_dir):
    """One rank of the module's world: every case of :data:`CASES`, the
    norms, the FCOS batch-norm step with the loss's normalizer left local
    (the control), and ``all_reduce_sum``. Then, outside the world, the
    whole-batch steps of :data:`REFERENCES`, against which it holds its own
    DDP steps (every rank ends a step with the same gradients and state).
    It saves the metrics, digests and mismatches; rank 0 also saves
    ``a2j_f32``'s state for the JAX process."""
    torch.set_num_threads(1)
    mesh = pmesh.init_data_parallel(
        rank=rank, world_size=WORLD, init_method=f"file://{init_file}", device="cpu",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    kept, out = {}, {}
    try:
        for name, (fn, args) in CASES.items():
            kept[name] = fn(mesh, *args)
            if name == "a2j_f32" and rank == 0:
                torch.save(kept[name]["state"], os.path.join(out_dir, "a2j_f32.tmp"))
                os.replace(os.path.join(out_dir, "a2j_f32.tmp"),
                           os.path.join(out_dir, "a2j_f32.pt"))
            out[name] = {"metrics": kept[name]["metrics"], "digest": kept[name]["digest"]}
            if name not in REFERENCES[rank]:
                del kept[name]
        out["norms"] = _norm_case(mesh)
        with mock.patch.object(pfcos, "all_reduce_sum", lambda x, mesh: x):
            unsynced = _fcos_case(mesh, "batch")
        out["fcos_unsynced"] = {"metrics": unsynced["metrics"], "digest": unsynced["digest"]}
        if "fcos_unsynced" in REFERENCES[rank]:
            kept["fcos_unsynced"] = unsynced
        del unsynced
        x = torch.full((3,), float(rank + 1), requires_grad=True)
        total = pmesh.all_reduce_sum(x, mesh)
        (total * (rank + 1)).sum().backward()
        out["all_reduce"] = (total.detach(), x.grad)
    finally:
        dist.destroy_process_group()
    whole = {}
    for name in REFERENCES[rank]:
        if name != "fcos_unsynced":
            fn, args = CASES[name]
            whole[name] = fn(None, *args)
            out["whole_" + name] = whole[name]["metrics"]
    for name in REFERENCES[rank]:
        out["errors_" + name] = _step_errors(kept[name], whole.get(name, whole.get("fcos_batch")))
    if rank == 0:
        out["whole_norms"] = _norm_case(None)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_a2j_mesh_step(port_init):
    """JAX's ``A2JTrainer(mesh=create_mesh(4))`` step on the global batch,
    from the port's init converted with ``convert_a2j``: (loss, params,
    batch_stats) after it."""
    import jax
    import jax.numpy as jnp

    from handnet_tpu import config as jconfig
    from handnet_tpu.convert.torch_weights import convert_a2j
    from handnet_tpu.parallel.mesh import create_mesh, shard_batch
    from handnet_tpu.train import trainer as jtrainer
    from torch_port_fixtures import fast_compile

    jmesh = create_mesh(WORLD)
    trainer = jtrainer.A2JTrainer(jconfig.A2JConfig(**A2J_CFG), jconfig.TrainConfig(**A2J_TRAIN),
                                  mesh=jmesh, steps_per_epoch=10)
    variables = convert_a2j({k: v.numpy() for k, v in port_init.items()})
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                   variables["batch_stats"]),
                                opt_state=trainer.tx.init(params), tx=trainer.tx)
    batch = shard_batch(jmesh, {k: jnp.asarray(v) for k, v in _a2j_batch().items()})
    step = fast_compile(None, state, batch, jitted=trainer._train_step)
    after, metrics = step(state, batch)
    tree = jax.tree_util.tree_map(np.asarray, {"params": after.params,
                                               "batch_stats": after.batch_stats})
    return float(metrics["total_loss"]), tree


def _jax_process(out_dir):
    """JAX's mesh step (:func:`_jax_a2j_mesh_step`) in a process of its own,
    held against rank 0's ``a2j_f32`` step once that rank has saved it, by
    tests/test_parallel.py's rules: saves JAX's loss, the running
    statistics' largest difference in units of ``1e-5 (1 + |value|)``, and
    per parameter leaf the largest difference and the share of elements
    within 1e-5."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from handnet_tpu_torch.convert.from_flax import a2j_variables_from_state_dict

    trainer = A2JTrainer(pconfig.A2JConfig(**A2J_CFG), pconfig.TrainConfig(**A2J_TRAIN),
                         steps_per_epoch=10, device="cpu")
    loss, want = _jax_a2j_mesh_step(trainer.init_state(SEED).model.state_dict())
    path = os.path.join(out_dir, "a2j_f32.pt")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("rank 0 saved no a2j_f32 step")
        time.sleep(0.5)
    state = torch.load(path, weights_only=True)
    os.remove(path)
    got = a2j_variables_from_state_dict(state)

    def leaves(t, prefix=()):
        for k, v in t.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])

    def diffs(part, scaled=False):
        g, w = dict(leaves(got[part])), dict(leaves(want[part]))
        assert g.keys() == w.keys(), part
        return {k: np.abs(np.asarray(g[k], np.float64) - w[k])
                / ((1.0 + np.abs(w[k])) if scaled else 1.0) for k in w}

    stats = diffs("batch_stats", scaled=True)
    params = diffs("params")
    torch.save({"loss": loss, "stats": max(float(d.max()) for d in stats.values()) / 1e-5,
                "params": {k: (float(d.max()), float(np.mean(d < 1e-5)))
                           for k, d in params.items()}},
               os.path.join(out_dir, "jax.pt"))


@pytest.fixture(scope="module", autouse=True)
def world_processes(tmp_path_factory):
    """The world's 4 ranks and the JAX process, spawned as the module
    starts: they run while this process runs the server's and the CLI's
    tests."""
    tmp = tmp_path_factory.mktemp("ddp")
    os.environ["OMP_NUM_THREADS"] = "1"   # the ranks' OpenMP, read at their start
    ctx = mp.start_processes(_world_rank, args=(str(tmp / "init"), str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    reference = mp.get_context("spawn").Process(target=_jax_process, args=(str(tmp),))
    reference.start()
    yield ctx, reference, tmp
    for p in ctx.processes + [reference]:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def world(world_processes):
    """What the 4 ranks and the JAX process saved."""
    ctx, reference, tmp = world_processes
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        assert time.monotonic() < deadline, "the DDP world did not finish in time"
    reference.join(max(deadline - time.monotonic(), 1.0))
    assert reference.exitcode == 0, "the JAX process failed or did not finish in time"
    return {"ranks": [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
            "jax": torch.load(tmp / "jax.pt", weights_only=False)}


def test_shard_batch_matches_jax():
    """Rank r's block of ``shard_batch`` is the shard JAX's ``shard_batch``
    puts on device r of ``create_mesh(4)``; a batch that does not divide
    raises; a one-process mesh gets one block per device."""
    import jax.numpy as jnp

    from handnet_tpu.parallel.mesh import create_mesh, shard_batch

    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sharded = shard_batch(create_mesh(WORLD), {"x": jnp.asarray(x)})["x"]
    jax_blocks = {s.device.id: np.asarray(s.data) for s in sharded.addressable_shards}
    for r in range(WORLD):
        mesh = pmesh.DataMesh((torch.device("cpu"),), rank=r, world_size=WORLD)
        (got,) = pmesh.shard_batch(mesh, {"x": x, "y": [torch.from_numpy(x)]})
        assert np.array_equal(got["x"].numpy(), jax_blocks[r])
        assert torch.equal(got["y"][0], got["x"])
    two = pmesh.shard_batch(pmesh.create_mesh(2, device="cpu"), x)
    assert [b.shape for b in two] == [(4, 3), (4, 3)]
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(mesh, x[:6])


def test_mesh_refusals(monkeypatch):
    """Nothing falls back: a trainer's mesh must be a rank of a process
    group (``create_mesh``'s one-process meshes serve), NCCL drives one card
    per rank, ``init_data_parallel`` outside ``torchrun`` needs its rank and
    world size, and ``create_mesh`` raises where the cards are missing."""
    one_process = pmesh.create_mesh(2, device="cpu")
    assert (one_process.size, one_process.world_size, one_process.group) == (2, 1, None)
    for cls in (A2JTrainer, FCOSTrainer, RCNNTrainer):
        with pytest.raises(ValueError, match="process group"):
            cls(mesh=one_process, device="cpu")
        with pytest.raises(TypeError, match="DataMesh"):
            cls(mesh=object(), device="cpu")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert pmesh.torchrun_mesh("cpu") is None
    with pytest.raises(ValueError, match="RANK"):
        pmesh.init_data_parallel(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.init_data_parallel("nccl", rank=0, world_size=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cards asked for"):
        pmesh.create_mesh(1)
    with pytest.raises(RuntimeError, match="no card"):
        pmesh.init_data_parallel(rank=0, world_size=1)


# ---------------------------------------------------------------------------
# the server


def _serve_cfg(module):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=48, crop_w=48),
        fcos=module.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=2,
                               ext=False, score_thresh=0.0),
        pipeline=module.PipelineConfig(crop_size=48))


SERVE_HW = (60, 80)


def _serve(server, frames):
    server.start()
    try:
        for i, f in enumerate(frames):
            server.submit(0, i, *f)
        return dict((fid, out) for _, fid, out in (server.get(timeout=300) for _ in frames))
    finally:
        server.stop()


def test_mesh_server_matches_the_one_device_server_and_jax():
    """``PipelineServer(mesh=create_mesh(2, device="cpu"))``: each bucket (2
    and 4) split into 2 blocks, one per replica, equals the mesh-less
    server's forward of each block bit for bit (its served frames to 1e-6),
    and JAX's ``PipelineServer(mesh=create_mesh(2))`` (boxes
    exactly, scores to 1e-5, joints to 1e-3 px, the tolerances of
    test_torch_port_serve.py's mesh-less comparison); a bucket that does not divide raises, as does an
    artifact server with a mesh."""
    import jax
    import jax.numpy as jnp

    from handnet_tpu import config as jconfig
    from handnet_tpu.apps.serve import PipelineServer as JaxServer
    from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
    from handnet_tpu.parallel.mesh import create_mesh as jax_mesh
    from handnet_tpu_torch.apps.serve import PipelineServer
    from handnet_tpu_torch.graphs import MeshGraphs
    from handnet_tpu_torch.models.pipeline import HandNetPipeline

    cfg = _serve_cfg(pconfig)
    # test_torch_port_serve.py's weights and frames, on which every frame
    # takes the found path
    weights = HandNetPipeline(cfg, device="cpu", seed=2).state_dict()
    frames = []
    for i in range(6):
        rng = np.random.default_rng(800 + i)
        frames.append((rng.uniform(size=SERVE_HW + (3,)).astype(np.float32),
                       rng.uniform(0.3, 1.0, size=SERVE_HW).astype(np.float32)))
    kw = dict(frame_hw=SERVE_HW, dtype=torch.float32, batch_size=4, batch_buckets=(2, 4))
    plain = PipelineServer(cfg, device="cpu", state_dict=weights, **kw)
    meshed = PipelineServer(cfg, mesh=pmesh.create_mesh(2, device="cpu"), state_dict=weights,
                            **kw)
    assert isinstance(meshed.graphs, MeshGraphs) and len(meshed.replicas) == 2
    got, want = _serve(meshed, frames), _serve(plain, frames)
    assert sum(meshed.bucket_dispatches.values()) >= 2
    for fid in range(len(frames)):
        for key in want[fid]:
            np.testing.assert_allclose(got[fid][key], want[fid][key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{fid} {key}")
    # bit for bit where the one-device forward runs each block: a CPU
    # convolution's bits depend on its batch (a block of 1 frame and a
    # batch of 2 differ at the last bits), the served values above to 1e-6
    wire = [(np.clip(f[0] * 255.0, 0, 255).astype(np.uint8),
             np.clip(f[1] * 1000.0, 0, 65535).astype(np.uint16)) for f in frames[:4]]
    images = torch.from_numpy(np.stack([w_[0] for w_ in wire]))
    depth = torch.from_numpy(np.stack([w_[1] for w_ in wire]))
    for bucket in (2, 4):
        out = meshed.graphs.run(bucket, images[:bucket], depth[:bucket])
        half = bucket // 2
        blocks = [plain.graphs.run(half, images[i:i + half], depth[i:i + half])
                  for i in (0, half)]
        for key, value in out.items():
            assert torch.equal(value, torch.cat([b_[key] for b_ in blocks])), (bucket, key)

    sd = {k: v.numpy() for k, v in weights.items()}
    flax_vars = {part: conv({k[len(part) + 1:]: v for k, v in sd.items()
                             if k.startswith(part + ".")})
                 for part, conv in (("detector", convert_fcos), ("a2j", convert_a2j))}
    ref = JaxServer(_serve_cfg(jconfig), batch_size=4, frame_hw=SERVE_HW, mesh=jax_mesh(2),
                    variables=jax.tree_util.tree_map(jnp.asarray, flax_vars),
                    dtype=jnp.float32)
    jax_out = _serve(ref, frames)
    for fid in range(len(frames)):
        p, j = got[fid], jax_out[fid]
        assert p["found"] and j["found"]
        assert np.array_equal(p["boxes"], np.asarray(j["boxes"]))
        np.testing.assert_allclose(p["scores"], j["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p["joints_uvd"], j["joints_uvd"], rtol=1e-4, atol=1e-3)

    with pytest.raises(ValueError, match="divide over mesh size 2"):
        PipelineServer(cfg, mesh=pmesh.create_mesh(2, device="cpu"), frame_hw=SERVE_HW,
                       batch_size=4, batch_buckets=(1, 4))
    with pytest.raises(ValueError, match="single-device"):
        PipelineServer.from_artifact("unused", mesh=pmesh.create_mesh(2, device="cpu"))


# ---------------------------------------------------------------------------
# train_a2j under torch.distributed.run


def _train_a2j_rank(out_dir, argv):
    """One rank of ``train_a2j.main(argv)`` launched by
    ``torch.distributed.run``: records the dexycb ids of the samples it
    trained on, the files it wrote, its final state's digest and the
    result's losses into ``out_dir/rank{RANK}.pt``."""
    torch.set_num_threads(1)
    from handnet_tpu_torch.apps import train_a2j

    rank = int(os.environ["RANK"])
    ids, writes, evaluating = [], [], [False]
    to_device, evaluate = train_a2j.to_device, train_a2j.evaluate
    save, savez = torch.save, np.savez

    def record_to_device(batch, device, rgbd=False):
        if not evaluating[0]:
            ids.append(batch["dexycb_id"][:, 0].copy())
        return to_device(batch, device, rgbd)

    def record_evaluate(*a, **k):
        evaluating[0] = True
        try:
            return evaluate(*a, **k)
        finally:
            evaluating[0] = False

    def record(fn):
        def wrapped(obj_or_path, *a, **k):
            path = a[0] if fn is save else obj_or_path
            writes.append(os.path.basename(str(path)))
            return fn(obj_or_path, *a, **k)
        return wrapped

    with mock.patch.object(train_a2j, "to_device", record_to_device), \
            mock.patch.object(train_a2j, "evaluate", record_evaluate), \
            mock.patch.object(torch, "save", record(save)), \
            mock.patch.object(np, "savez", record(savez)):
        res = train_a2j.main(argv)
    save({"ids": np.concatenate(ids), "writes": writes, "digest": _digest(res["state"].model),
          "losses": [e["losses"] for e in res["epochs"]], "evals": len(res["evals"])},
         os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module", autouse=True)
def torchrun_a2j(tmp_path_factory):
    """``train_a2j`` under ``torch.distributed.run``, started as the module
    starts (it runs beside the world): the launcher's process and the
    directory it writes to."""
    tmp = tmp_path_factory.mktemp("torchrun")
    (tmp / "run").mkdir()
    argv = ["--data-dir", str(tmp / "tree"), "--synthetic", "1", "--device", "cpu",
            "--crop", "48", "--batch", "4", "--epochs", "1", "--no-bf16", "--workers", "1",
            "--eval-every", "1", "--output", str(tmp / "a2j")]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests")])}
    with open(tmp / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node", "2", os.path.abspath(__file__),
                                 str(tmp / "run"), *argv],
                                env=env, cwd=str(tmp), stdout=log, stderr=subprocess.STDOUT)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(tmp / "a2j", ignore_errors=True)   # A2J's checkpoint: 0.5 GB


def test_train_a2j_under_torchrun(torchrun_a2j):
    """``train_a2j`` launched by ``python -m torch.distributed.run
    --standalone --nproc-per-node 2`` (``--device cpu``: gloo; a synthetic
    tree of 4 samples, crop 48, global batch 4, one epoch, one worker): the ranks'
    shards are disjoint and cover the epoch, both end with the same state
    and losses, rank 0 alone wrote the checkpoint, ``params.npz`` and the
    eval sweep, and JAX's A2J applies that ``params.npz`` as the port's
    A2J applies the checkpoint."""
    proc, tmp_path = torchrun_a2j
    try:
        proc.wait(timeout=JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, (tmp_path / "log.txt").read_text()[-4000:]
    out = tmp_path / "run"
    r0, r1 = (torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert not set(r0["ids"]) & set(r1["ids"])
    assert len(r0["ids"]) == len(r1["ids"]) > 0
    res_file = tmp_path / "a2j" / "a2j_test_metrics" / "s0_test_0.txt"
    epoch_ids = {int(line.split(",")[0]) for line in res_file.read_text().splitlines() if line}
    assert set(r0["ids"]) | set(r1["ids"]) == epoch_ids
    assert r0["digest"] == r1["digest"]
    assert r0["losses"] == r1["losses"]
    assert (r0["evals"], r1["evals"]) == (1, 0)
    assert r1["writes"] == []
    assert {"0.pt.tmp", "params.npz", "batch_stats.npz"} <= set(r0["writes"])

    import jax
    import jax.numpy as jnp

    from handnet_tpu import config as jconfig
    from handnet_tpu.models.a2j import A2JSystem as JaxA2J
    from handnet_tpu.train.checkpoints import load_params_npz
    from handnet_tpu_torch.models.a2j import A2JSystem
    from torch_port_fixtures import fast_compile

    params = load_params_npz(str(tmp_path / "a2j" / "params.npz"))
    stats = load_params_npz(str(tmp_path / "a2j" / "batch_stats.npz"))
    x = np.random.default_rng(5).uniform(0.3, 1.2, size=(2, 48, 48, 1)).astype(np.float32)
    jmodel = JaxA2J(jconfig.A2JConfig(crop_h=48, crop_w=48), norm="batch")
    variables, image = {"params": params, "batch_stats": stats}, jnp.asarray(x)
    want = fast_compile(lambda v, im: jmodel.module.apply(v, im, train=False),
                        variables, image)(variables, image)
    port = A2JSystem(pconfig.A2JConfig(crop_h=48, crop_w=48), norm="batch")
    port.load_state_dict(torch.load(tmp_path / "a2j" / "checkpoints" / "0.pt",
                                    weights_only=True)["model"])
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    for key in ("cls", "reg", "depth"):
        w = np.asarray(want[key])
        assert _rel(got[key].numpy(), w) <= 1e-4, key


# ---------------------------------------------------------------------------
# the world's DDP steps


def _rank_of(name):
    return next(r for r, names in REFERENCES.items() if name in names)


def test_every_rank_ends_with_the_same_state_and_losses(world):
    """After each case every rank holds the same parameters and buffers
    (digests equal) and reports the same, global, losses."""
    for name in list(CASES) + ["fcos_unsynced"]:
        assert len({r[name]["digest"] for r in world["ranks"]}) == 1, name
        for r in world["ranks"][1:]:
            assert r[name]["metrics"] == world["ranks"][0][name]["metrics"], name


def test_all_reduce_sum_and_its_gradient(world):
    """``all_reduce_sum`` sums over the 4 ranks (1 + 2 + 3 + 4), and its
    gradient is the ranks' summed upstream gradients (sum of rank + 1)."""
    for total, grad in (r["all_reduce"] for r in world["ranks"]):
        assert torch.equal(total, torch.full((3,), 10.0))
        assert torch.equal(grad, torch.full((3,), 10.0))


def test_a2j_ddp_step_matches_jax_mesh_step(world):
    """The 4-rank A2J step against JAX's ``A2JTrainer(mesh=create_mesh(4))``
    step from the same init and batch: the loss to rtol 1e-4, the running
    statistics to 1e-5 (relative and absolute), the parameters by tests/test_parallel.py's rule (an
    AdamW step can flip where a gradient is near 0: at most 2.5 lr apart,
    and more than 80% of the elements within 1e-5). The heads' conv biases
    before a BatchNorm, whose gradient is 0 in exact arithmetic (the norm
    takes their shift out) and rounding noise here, hold the first half
    only: AdamW moves nearly every element of them by about lr, either
    way."""
    jax_side = world["jax"]
    got = world["ranks"][0]["a2j_f32"]["metrics"][0]["total_loss"]
    assert abs(got - jax_side["loss"]) <= 1e-4 * abs(jax_side["loss"])
    assert jax_side["stats"] <= 1.0
    for k, (largest, share) in jax_side["params"].items():
        assert largest <= 2.5 * A2J_TRAIN["lr"], k
        if not (k[-1] == "bias" and k[-2].startswith("conv")):
            assert share > 0.8, (k, share)


def test_a2j_ddp_gradients_match_the_whole_batch_step(world):
    """The A2J gradients DDP averaged (global BatchNorm statistics, the
    losses' means over equal shards) against the port's one-process step on
    the whole batch, in float64: the loss, each gradient and the updated
    state to the module's tolerances."""
    rank = world["ranks"][_rank_of("a2j")]
    assert rank["errors_a2j"] == []
    assert rank["whole_a2j"][0].keys() == rank["a2j"]["metrics"][0].keys()


@pytest.mark.parametrize("case", ["fcos_frozen", "fcos_batch", "rcnn"])
def test_detector_ddp_step_matches_the_whole_batch_step(world, case):
    """FCOS (the frozen backbone for two steps, the second without box_info,
    whose extension heads get no gradient; the batch-norm backbone) and the
    R-CNN (batch-norm backbone, dropout): the DDP step on a batch whose
    ranks' foreground counts differ, one rank with none, equals the
    one-process step on the whole batch, in float64, to the module's
    tolerances (tests/test_torch_port_train.py and test_torch_port_rcnn.py
    hold that step against JAX's)."""
    rank = world["ranks"][_rank_of(case)]
    assert rank["errors_" + case] == []
    assert len(rank["whole_" + case]) == len(rank[case]["metrics"])


def test_batch_sync_is_batch_under_a_mesh(world):
    """Under the mesh ``SyncBatchNorm2d`` (``make_norm("batch_sync")``) is
    ``BatchNorm2d``, bit for bit, and both take the whole batch's
    statistics: the outputs, the input gradient and the running statistics
    of each rank's shard equal the whole-batch norm's rows to 1e-6 of
    scale. Without a mesh it raises in training (a trainer given
    ``"batch_sync"`` and no mesh too) and normalizes by its running
    statistics in eval mode."""
    whole = world["ranks"][0]["whole_norms"]["BatchNorm2d"]
    for r, rank in enumerate(world["ranks"]):
        got = rank["norms"]
        for a, b in zip(got["BatchNorm2d"], got["SyncBatchNorm2d"]):
            assert torch.equal(a, b)
        rows = slice(2 * r, 2 * r + 2)
        for a, b in zip(got["BatchNorm2d"], (whole[0][rows], whole[1][rows], *whole[2:])):
            assert _rel(a, b) <= 1e-6
    assert make_norm("batch_sync") is SyncBatchNorm2d
    with pytest.raises(ValueError, match="data mesh"):
        FCOSTrainer(backbone_norm="batch_sync", device="cpu")
    norm = SyncBatchNorm2d(4).train()
    with pytest.raises(ValueError, match="data mesh"):
        norm(torch.zeros(2, 4, 3, 3))
    x = torch.randn(2, 4, 3, 3)
    assert torch.equal(norm.eval()(x), BatchNorm2d(4).eval()(x))


def test_unsynchronized_normalizer_fails_the_comparison(world):
    """The control: the same world with ``fcos_loss``'s foreground count
    left local must not match the whole-batch step, so the batch tests the
    normalizer's sum: its losses miss by more than 1e-3 relative."""
    rank = world["ranks"][_rank_of("fcos_unsynced")]
    losses = [(what, err, bound) for what, err, bound in rank["errors_fcos_unsynced"]
              if what.startswith("loss")]
    assert losses and max(err / max(bound / LOSS_RTOL, 1e-6) for _, err, bound in losses) > 1e-3


if __name__ == "__main__":
    _train_a2j_rank(sys.argv[1], sys.argv[2:])
