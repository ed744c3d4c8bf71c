"""The port's A2J training path (``A2JTrainer``, ``a2j_loss``, the eval step,
the A2J checkpoints) against the JAX package's, on the CPU.

The JAX variables come from the port's seeded init through ``convert_a2j``
(no flax ``init``), and the JAX steps are jitted. On the CPU the eval
step's decode is K1's plain version (the kernel runs only on a card, where
chip_smoke.py's ``[train_a2j]`` phase holds it). Inputs come from numpy
seeds; everything runs on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j
from handnet_tpu.models import a2j as ja2j
from handnet_tpu.train import checkpoints as jckpt
from handnet_tpu.train import trainer as jtrainer
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 a2j_variables_from_state_dict)
from handnet_tpu_torch.models import a2j as pa2j
from handnet_tpu_torch.nn.resnet import (BatchNorm2d, FrozenBatchNorm2d, GroupNorm,
                                         SyncBatchNorm2d)
from handnet_tpu_torch.train import checkpoints as pckpt
from handnet_tpu_torch.train.trainer import A2JTrainer
from torch_port_fixtures import assert_close, leaves_equal


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small forwards: one intra-op thread keeps them from crowding the
    other test processes, some of which time their own runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


# tests/test_parallel.py's A2J, with 32-wide towers; AdamW with a step
# decay that crosses its first boundary at the second step
SMALL = dict(crop_h=32, crop_w=32, num_joints=3, head_features=32)
TRAIN = dict(lr=1e-3, weight_decay=1e-4, optimizer="adamw", lr_step=1, lr_gamma=0.2)
STEPS_PER_EPOCH, BATCH, SEED = 1, 4, 3
LOSS_KEYS = ["classification", "regression", "total_loss"]
TRAIN_SEEDS = (10, 11)


def _batch(seed, batch=BATCH):
    """Depth crops in metres and UVD targets in crop pixels and metres, in
    the ranges of ``build_a2j_sample``'s."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0.3, 1.2, size=(batch, 32, 32, 1)).astype(np.float32)
    jt = np.concatenate([rng.uniform(0, 32, size=(batch, 3, 2)),
                         rng.uniform(0.3, 1.2, size=(batch, 3, 1))], axis=-1)
    return image, jt.astype(np.float32)


def _port_batch(image, jt):
    return {"image": _t(image), "jt_uvd": _t(jt)}


def _jax_batch(image, jt):
    return {"image": jnp.asarray(image), "jt_uvd": jnp.asarray(jt)}


def _port_trainer(bf16=False):
    return A2JTrainer(pconfig.A2JConfig(**SMALL), pconfig.TrainConfig(**TRAIN, bf16=bf16),
                      steps_per_epoch=STEPS_PER_EPOCH, device="cpu")


def _jax_trainer(bf16=False):
    return jtrainer.A2JTrainer(jconfig.A2JConfig(**SMALL), jconfig.TrainConfig(**TRAIN, bf16=bf16),
                               steps_per_epoch=STEPS_PER_EPOCH)


def _variables(model) -> dict:
    return convert_a2j({k: v.detach().clone().numpy() for k, v in model.state_dict().items()})


def _jax_state_from_port(trainer, state):
    """JAX's ``TrainState`` holding the port state's weights, running
    statistics, AdamW moments and counts, converted to the flax layout."""
    variables = _variables(state.model)
    moments = {"mu": {}, "nu": {}}
    for name, p in state.model.named_parameters():
        adam = state.optimizer.state[p]      # empty before the first step
        for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[key][name] = adam.get(torch_key, torch.zeros_like(p))
    tree = {k: a2j_variables_from_state_dict(v)["params"] for k, v in moments.items()}
    def count():   # one array each: the JAX step donates its state's buffers
        return jnp.asarray(state.step, jnp.int32)

    adam, decay, schedule = trainer.tx.init(variables["params"])
    opt_state = (adam._replace(count=count(), **tree), decay, schedule._replace(count=count()))
    return jtrainer.TrainState(step=count(), params=variables["params"],
                               batch_stats=variables["batch_stats"], opt_state=opt_state,
                               tx=trainer.tx)


@pytest.fixture(scope="module")
def steps():
    """Two float32 steps of the port's ``A2JTrainer`` (AdamW, step decay,
    batch-norm A2J) from its seed-3 init, and before each, JAX's
    ``A2JTrainer.train_step`` from the port's state (weights, running
    statistics, AdamW moments and count, converted): per step, both sides'
    losses, the state before, JAX's state after, the port's state after."""
    jt = _jax_trainer()
    trainer = _port_trainer()
    port = trainer.init_state(SEED)
    record = []
    for seed in TRAIN_SEEDS:
        before = _variables(port.model)
        after, want = jt.train_step(_jax_state_from_port(jt, port), _jax_batch(*_batch(seed)))
        port, got = trainer.train_step(port, _port_batch(*_batch(seed)))
        record.append({"jax": {k: float(v) for k, v in want.items()}, "port": got,
                       "before": before, "got": _variables(port.model),
                       "want": jax.tree_util.tree_map(np.asarray, {
                           "params": after.params, "batch_stats": after.batch_stats}),
                       "step": (int(after.step), port.step)})
    return {"trainer": trainer, "port": port, "steps": record}


# Each step starts from the same state on both sides, so the losses are a
# forward on the same weights (measured 1.0e-5). The updated parameters are
# not as close: this random ResNet-50 amplifies a rounding-level difference
# through its 16 blocks (a 1e-6 relative change of the crops moves layer3's
# activations by 1e-4 and the gradients by 1% of their norm, median over
# tensors), and AdamW's first step moves every element by about +-lr
# whatever its gradient's size, so an element whose gradient is within that
# 1% of zero moves by +-lr in a direction that rounding decides. The port
# against itself, on crops changed by 1e-6 relative, differs after one step
# by 26.5% of a tensor's change at worst (the norm of the error over the
# norm of the change), 12.5% median, 15.5% over the tree; the port against
# JAX by 35.3%, 12.5% and 15.4% (the second step: 11.7%, 1.3%, 4.0%). So
# each parameter tensor is held by that norm ratio, not element by element,
# to PARAM_TOL, and the tree to PARAMS_TOL; the biases of the head convs
# before a BatchNorm, whose exact gradient is 0 (the norm removes them) and
# whose computed one is rounding noise, only through the tree. The batch
# statistics come from the same forward: STATS_TOL of their change
# (measured 6.7e-4 at worst).
PARAM_TOL, PARAMS_TOL, STATS_TOL, LOSS_TOL = 0.5, 0.25, 2e-3, 1e-4


def _before_a_norm(key: str) -> bool:
    """The bias of a head conv that a BatchNorm follows (``conv1..4``)."""
    parts = key.split("/")
    return parts[-1] == "bias" and parts[-2] in ("conv1", "conv2", "conv3", "conv4")


def test_train_steps_match_jax_trainer(steps):
    """Two steps of the port's ``A2JTrainer`` (float32, AdamW, the step
    decay's boundary at step 1, batch-norm A2J), each against JAX's
    ``train_step`` from the same state: every loss term, then the params
    and batch_stats, each tensor relative to the step's change
    (tolerances above, with their reason)."""
    for record in steps["steps"]:
        got, want = record["port"], record["jax"]
        assert list(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
        for k in want:
            assert _rel_err(got[k].item(), want[k]) <= LOSS_TOL, k
        for collection, tol in (("params", PARAM_TOL), ("batch_stats", STATS_TOL)):
            before = dict(_flat(record["before"][collection]))
            want_after = dict(_flat(record["want"][collection]))
            err_sq = change_sq = 0.0
            for key, value in _flat(record["got"][collection]):
                change = np.linalg.norm(want_after[key] - before[key])
                err = np.linalg.norm(value - want_after[key])
                if collection == "batch_stats" or not _before_a_norm(key):
                    assert err <= tol * change + 1e-12, (collection, key, err / change)
                err_sq += err ** 2
                change_sq += change ** 2
            if collection == "params":
                assert err_sq ** 0.5 <= PARAMS_TOL * change_sq ** 0.5
    assert [r["step"] for r in steps["steps"]] == [(1, 1), (2, 2)]
    assert all(p.dtype == torch.float32 for p in steps["port"].model.parameters())


def test_eval_step_matches_jax_eval_step(steps):
    """The eval step (running statistics, the decode, rmse over u, v and d)
    on the port's trained weights against JAX's ``eval_step`` on the same
    weights, converted: pred and rmse to 1e-4 px."""
    port = steps["port"]
    image, jt = _batch(12)
    pred, rmse = steps["trainer"].eval_step(port, _port_batch(image, jt))
    assert not port.model.training
    jt_trainer = _jax_trainer()
    want_pred, want_rmse = jt_trainer.eval_step(_jax_state_from_port(jt_trainer, port),
                                                _jax_batch(image, jt))
    assert pred.dtype == torch.float32 and tuple(pred.shape) == (BATCH, 3, 3)
    assert_close(pred, want_pred, rtol=0, atol=1e-4)
    assert abs(rmse.item() - float(want_rmse)) <= 1e-4


def test_bf16_loss_matches_jax_bf16_loss(steps):
    """One bf16 step (autocast: bf16 convolutions, float32 master weights,
    BatchNorm statistics and loss) against JAX's bf16 loss on the same init
    and batch: every term to 3e-2 relative (bf16 keeps 8 bits, and the two
    forwards round at other places)."""
    image, jt = _batch(10)
    trainer = _jax_trainer(bf16=True)
    init = steps["steps"][0]["before"]
    _, (_, want) = jax.jit(trainer._loss_fn)(init["params"], init["batch_stats"],
                                             _jax_batch(image, jt))
    port = _port_trainer(bf16=True)
    state, got = port.train_step(port.init_state(SEED), _port_batch(image, jt))
    for k in want:
        assert _rel_err(got[k].item(), float(want[k])) <= 3e-2, k
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def _heads(seed, b=3, n=64, p=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"cls": rng.normal(size=(b, n, p)).astype(dtype) * 2,
            "reg": rng.normal(size=(b, n, p, 2)).astype(dtype) * 3,
            "depth": rng.uniform(0.3, 1.2, size=(b, n, p)).astype(dtype)}


def test_a2j_loss_runs_in_float32_under_autocast():
    """The loss turns autocast off: under a bf16 autocast region it equals
    its own float32 run on the same bf16 heads to 1e-6, where an einsum of
    the region would run in bf16 (checked, so that the test can fail)."""
    cfg = pconfig.A2JConfig(**SMALL)
    anchors = _t(pa2j.anchors_for(cfg))
    heads = {k: _t(v).to(torch.bfloat16) for k, v in _heads(5).items()}
    gt = _t(_batch(5, batch=3)[1])
    want = pa2j.a2j_loss(heads, gt, anchors)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = pa2j.a2j_loss(heads, gt, anchors)
        lowered = torch.einsum("bnp,nc->bpc", heads["cls"].float(), anchors)
    assert lowered.dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _rel_err(g.item(), w.item()) <= 1e-6


@pytest.mark.parametrize("quirk", [True, False])
def test_a2j_loss_and_gradient_match_jax(quirk):
    """``a2j_loss`` against JAX's, with the reference's raw-L1 depth term
    and with its smooth-L1 (beta 3): both losses to 1e-5 relative, the
    gradient of ``cls + 3 reg`` with respect to every head to 1e-5 of its
    scale."""
    cfg = pconfig.A2JConfig(**SMALL)
    anchors = pa2j.anchors_for(cfg)
    heads = _heads(6)
    heads["depth"] *= 0.1          # depth errors on both sides of beta
    gt = _batch(6, batch=3)[1]

    def jloss(h):
        c, r = ja2j.a2j_loss(h, jnp.asarray(gt), jnp.asarray(anchors), 0.5,
                             reference_depth_quirk=quirk)
        return c + 3.0 * r, (c, r)

    (_, want), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in heads.items()})
    theads = {k: _t(v).requires_grad_() for k, v in heads.items()}
    got = pa2j.a2j_loss(theads, _t(gt), _t(anchors), 0.5, reference_depth_quirk=quirk)
    (got[0] + 3.0 * got[1]).backward()
    for g, w in zip(got, want):
        assert _rel_err(g.item(), float(w)) <= 1e-5
    for k in heads:
        assert _rel_err(theads[k].grad, want_grad[k]) <= 1e-5, k


def test_trainer_refusals_and_forced_options(monkeypatch):
    """A ``mesh`` that is not a ``parallel.DataMesh`` raises ``TypeError``
    (tests/test_torch_port_parallel.py trains under a mesh); the 2D A2J's eval step on
    ``[B, P, 3]`` targets raises ``ValueError``, as JAX's fails to broadcast
    its ``[B, P, 2]`` prediction against them; ``quant`` is forced off; with
    no device and no card it raises instead of training on the CPU."""
    with pytest.raises(TypeError, match="DataMesh"):
        A2JTrainer(mesh=object(), device="cpu")
    trainer_2d = A2JTrainer(pconfig.A2JConfig(**SMALL, is_3d=False), device="cpu")
    with pytest.raises(ValueError, match="broadcast"):
        trainer_2d.eval_step(trainer_2d.init_state(SEED), _port_batch(*_batch(5, batch=2)))
    forced = A2JTrainer(pconfig.A2JConfig(**SMALL, quant="static"), device="cpu")
    assert forced.model_cfg.quant is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A2JTrainer()


def test_norm_option_keeps_the_serving_state_dict():
    """``A2J(norm="frozen")`` (serving's default) and ``norm="batch"`` have
    the same state-dict keys, the JAX converter's names; the norms are
    ``FrozenBatchNorm2d`` and ``BatchNorm2d`` in the backbone and the three
    towers alike (``"batch_sync"`` builds the synchronized subclass, with
    the same keys); ``"group"`` builds GroupNorms there, whose parameters
    are those of JAX's ``A2JSystem(norm="group")`` tree."""
    cfg = pconfig.A2JConfig(**SMALL)
    frozen, batch = pa2j.A2JSystem(cfg), pa2j.A2JSystem(cfg, norm="batch")
    assert list(frozen.state_dict()) == list(batch.state_dict())
    for model, kind in ((frozen, FrozenBatchNorm2d), (batch, BatchNorm2d)):
        for name in ("Backbone.model.bn1", "Backbone.model.layer4.2.bn3",
                     "classificationModel.bn1", "regressionModel.bn4",
                     "DepthRegressionModel.bn2"):
            assert type(model.get_submodule(name)) is kind, name
    assert "classificationModel.bn1.running_var" in frozen.state_dict()
    synced = pa2j.A2J(cfg, norm="batch_sync")
    assert list(synced.state_dict()) == list(batch.state_dict())
    assert type(synced.get_submodule("classificationModel.bn1")) is SyncBatchNorm2d
    group = pa2j.A2J(cfg, norm="group")
    for name in ("Backbone.model.bn1", "Backbone.model.layer4.2.bn3",
                 "classificationModel.bn1", "DepthRegressionModel.bn2"):
        assert type(group.get_submodule(name)) is GroupNorm, name
    shapes = jax.eval_shape(lambda: ja2j.A2JSystem(jconfig.A2JConfig(**SMALL), norm="group")
                            .init(jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {path: v.shape for path, v in
           _flat({"params": a2j_variables_from_state_dict(group.state_dict())["params"]})}
    assert set(shapes) == {"params"} and got == want


def test_a2j_variables_round_trip():
    """``a2j_variables_from_state_dict`` gives what ``convert_a2j`` gives for
    a batch-norm A2J with moved statistics, leaf for leaf, and
    ``a2j_state_dict_from_flax`` maps it back exactly."""
    model = pa2j.A2JSystem(pconfig.A2JConfig(**SMALL), norm="batch")
    model.init_weights_(torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.train()(_t(_batch(13)[0]))       # running statistics away from 0 and 1
    sd = model.state_dict()
    variables = a2j_variables_from_state_dict(sd)
    assert leaves_equal(variables, convert_a2j({k: v.numpy() for k, v in sd.items()}))
    back = a2j_state_dict_from_flax(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Train, save, step -> A; restore into a differently seeded state, step
    -> B: A == B bit for bit (parameters, running statistics, AdamW's
    moments and counts, losses, step)."""
    trainer = _port_trainer()
    batch0, batch1 = _port_batch(*_batch(10)), _port_batch(*_batch(11))
    state, _ = trainer.train_step(trainer.init_state(SEED), batch0)
    ckpt = pckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    ckpt.save(0, state)
    state, metrics_a = trainer.train_step(state, batch1)
    restored = ckpt.restore(trainer.init_state(SEED + 1))
    assert restored.step == 1
    restored, metrics_b = trainer.train_step(restored, batch1)
    assert restored.step == state.step == 2
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in ("exp_avg", "exp_avg_sq",
                                                                       "step"))
    assert all(torch.equal(metrics_a[k], metrics_b[k]) for k in metrics_a)


def test_params_and_batch_stats_npz_load_into_the_jax_package(tmp_path, steps):
    """The trained A2J's ``params.npz`` and ``batch_stats.npz`` (the files
    JAX's train_a2j writes) hold the flax keys; the JAX package's
    ``load_params_npz`` reads them, and JAX's ``A2JSystem.loss_and_predict``
    in eval mode on them gives the port's ``loss_and_predict`` (eval mode):
    losses to 1e-5 relative, the prediction to 1e-4 px."""
    model = steps["port"].model.eval()
    paths = {c: str(tmp_path / f"{c}.npz") for c in ("params", "batch_stats")}
    for collection, path in paths.items():
        pckpt.save_params_npz(path, model, collection)
    loaded = {c: jckpt.load_params_npz(p) for c, p in paths.items()}
    assert leaves_equal(loaded, _variables(model))
    image, jt = _batch(14)
    system = ja2j.A2JSystem(jconfig.A2JConfig(**SMALL), norm="batch")
    want, want_pred, _ = jax.jit(lambda v, x, g: system.loss_and_predict(v, x, g, train=False))(
        loaded, jnp.asarray(image), jnp.asarray(jt))
    with torch.no_grad():
        got, pred = model.loss_and_predict(_t(image), _t(jt))
    assert list(got) == LOSS_KEYS
    for k in want:
        assert _rel_err(got[k].item(), float(want[k])) <= 1e-5, k
    assert_close(pred, want_pred, rtol=0, atol=1e-4)
    with pytest.raises(TypeError, match="not a trainable model"):
        pckpt.save_params_npz(paths["params"], torch.nn.Linear(2, 2))
