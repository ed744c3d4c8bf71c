"""The port's 2D A2J (``is_3d=False``: no depth head) against the JAX
package's, on the CPU: the heads, the decode through K1xy's plain version,
the loss and its gradient, one ``A2JTrainer`` step, the eval step's
behaviour and the weights both ways.

The model is ``SMALL`` (32x32 crops, 3 joints, 32-wide towers). The JAX
variables come from the port's seeded init through ``convert_a2j`` with
random norms (no flax ``init``), and the JAX functions are jitted with
XLA's backend optimization off (the same operations, compiled faster).
Inputs come from numpy seeds; everything runs on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j
from handnet_tpu.models import a2j as ja2j
from handnet_tpu.train import trainer as jtrainer
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 a2j_variables_from_state_dict)
from handnet_tpu_torch.convert.torch_weights import a2j_state_dict
from handnet_tpu_torch.models import a2j as pa2j
from handnet_tpu_torch.ops import cuda_a2j
from handnet_tpu_torch.train.trainer import A2JTrainer
from test_torch_port_train_a2j import _jax_state_from_port
from torch_port_fixtures import assert_close, fast_compile, leaves_equal, randomize_norms

SMALL = dict(crop_h=32, crop_w=32, num_joints=3, head_features=32, is_3d=False)
TRAIN = dict(lr=1e-3, weight_decay=1e-4, optimizer="adamw", lr_step=1, lr_gamma=0.2, bf16=False)
SEED, BATCH = 4, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close_to(got, want, err_msg=""):
    """1e-4 relative and 1e-4 of the scale: float32 on both sides, the
    convolutions summed in another order."""
    want = np.asarray(want)
    assert_close(got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
                 err_msg=err_msg)


def _jax_eval(jt, state, image, jt_uvd):
    """JAX's ``A2JTrainer.eval_step`` (its jitted step, compiled with XLA's
    backend optimization off)."""
    batch = {"image": jnp.asarray(image), "jt_uvd": jnp.asarray(jt_uvd)}
    return fast_compile(None, state, batch, jitted=jt._eval_step)(state, batch)


def _batch(seed, batch=BATCH, dims=3):
    """Depth crops in metres and targets in crop pixels (and metres)."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0.3, 1.2, size=(batch, 32, 32, 1)).astype(np.float32)
    jt = np.concatenate([rng.uniform(0, 32, size=(batch, 3, 2)),
                         rng.uniform(0.3, 1.2, size=(batch, 3, 1))], axis=-1)
    return image, jt[..., :dims].astype(np.float32)


@pytest.fixture(scope="module")
def model():
    """The port's 2D A2J (frozen norms) with seeded weights and random norm
    statistics, and the same weights as JAX variables."""
    net = pa2j.A2JSystem(pconfig.A2JConfig(**SMALL))
    net.init_weights_(torch.Generator().manual_seed(SEED))
    variables = randomize_norms(convert_a2j(
        {k: v.numpy() for k, v in net.state_dict().items()}), seed=SEED)
    net.load_state_dict(a2j_state_dict_from_flax(variables), strict=True)
    return net.eval(), variables


def test_2d_model_has_no_depth_head():
    """No ``DepthRegressionModel`` in the 2D model, and its state dict is the
    3D model's without the depth head's keys."""
    keys_2d = set(pa2j.A2J(pconfig.A2JConfig(**SMALL)).state_dict())
    keys_3d = set(pa2j.A2J(pconfig.A2JConfig(**{**SMALL, "is_3d": True})).state_dict())
    assert keys_2d and not any(k.startswith("DepthRegressionModel.") for k in keys_2d)
    assert keys_3d - keys_2d == {k for k in keys_3d if k.startswith("DepthRegressionModel.")}


def test_2d_heads_and_decode_match_jax(model):
    """The heads (``cls``, ``reg`` only) and ``predict`` (UV ``[B, P, 2]``
    through K1xy's plain version on the CPU) against JAX's module and
    ``predict``, whose 2D decode is the einsum."""
    net, variables = model
    system = ja2j.A2JSystem(jconfig.A2JConfig(**SMALL))
    crops = _batch(8)[0]
    want = fast_compile(lambda v, x: system.module.apply(v, x), variables, jnp.asarray(crops))(
        variables, jnp.asarray(crops))
    want_uv = ja2j.a2j_postprocess(want, system.anchors)
    before = cuda_a2j.a2j_decode_xy.launches
    with torch.no_grad():
        got = net(_t(crops))
        got_uv = net.predict(_t(crops))
    assert sorted(got) == sorted(want) == ["cls", "reg"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        _close_to(got[key], want[key], err_msg=key)
    assert got_uv.dtype == torch.float32 and tuple(got_uv.shape) == (BATCH, 3, 2)
    _close_to(got_uv, want_uv, err_msg="uv")
    # the decode of the same heads on both sides: 1e-4 px (summation order)
    heads = {k: _t(np.asarray(v)) for k, v in want.items()}
    for use_kernel in (True, False):
        assert_close(pa2j.a2j_postprocess(heads, net.anchors, use_kernel=use_kernel),
                     want_uv, rtol=0, atol=1e-4)
    assert cuda_a2j.a2j_decode_xy.launches == before     # the CPU counts no launch


@pytest.mark.parametrize("dims", [2, 3])
def test_2d_loss_and_gradient_match_jax(dims):
    """``a2j_loss`` without a depth head, on ``[B, P, 3]`` and ``[B, P, 2]``
    targets, against JAX's ``:176-200``: both losses to 1e-5 relative and
    the gradient of ``cls + 3 reg`` to 1e-5 of its scale."""
    anchors = pa2j.anchors_for(pconfig.A2JConfig(**SMALL))
    rng = np.random.default_rng(6)
    n = anchors.shape[0]
    heads = {"cls": (rng.normal(size=(3, n, 3)) * 2).astype(np.float32),
             "reg": (rng.normal(size=(3, n, 3, 2)) * 3).astype(np.float32)}
    gt = _batch(6, dims=dims)[1]

    def jloss(h):
        c, r = ja2j.a2j_loss(h, jnp.asarray(gt), jnp.asarray(anchors), 0.5)
        return c + 3.0 * r, (c, r)

    (_, want), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in heads.items()})
    theads = {k: _t(v).requires_grad_() for k, v in heads.items()}
    got = pa2j.a2j_loss(theads, _t(gt), _t(anchors), 0.5)
    (got[0] + 3.0 * got[1]).backward()
    for g, w in zip(got, want):
        assert _rel_err(g.item(), float(w)) <= 1e-5
    for k in heads:
        assert _rel_err(theads[k].grad, want_grad[k]) <= 1e-5, k


@pytest.fixture(scope="module")
def step():
    """One float32 2D ``A2JTrainer`` step from its seed init and, from the
    same state (converted), JAX's 2D ``train_step``."""
    jt = jtrainer.A2JTrainer(jconfig.A2JConfig(**SMALL), jconfig.TrainConfig(**TRAIN),
                             steps_per_epoch=1)
    trainer = A2JTrainer(pconfig.A2JConfig(**SMALL), pconfig.TrainConfig(**TRAIN),
                         steps_per_epoch=1, device="cpu")
    port = trainer.init_state(SEED)
    image, jt_uvd = _batch(10)
    start = _jax_state_from_port(jt, port)
    before = jax.tree_util.tree_map(np.asarray, {"params": start.params})
    batch = {"image": jnp.asarray(image), "jt_uvd": jnp.asarray(jt_uvd)}
    after, want = fast_compile(None, start, batch, jitted=jt._train_step)(start, batch)
    port, got = trainer.train_step(port, {"image": _t(image), "jt_uvd": _t(jt_uvd)})
    return {"trainer": trainer, "jax_trainer": jt, "port": port, "got": got,
            "want": {k: float(v) for k, v in want.items()}, "before": before,
            "after": jax.tree_util.tree_map(np.asarray, {"params": after.params}),
            "port_after": a2j_variables_from_state_dict(port.model.state_dict())}


def test_2d_train_step_matches_jax(step):
    """The losses of one step to 1e-4 relative (a forward on the same
    weights), and the updated parameters by the norm of their error over
    the norm of the step's change, over the whole tree to 0.25: the
    tolerance of tests/test_torch_port_train_a2j.py's 3D steps, whose
    reason (a random ResNet-50 amplifies rounding, and AdamW moves every
    element by about lr) holds alike here."""
    assert set(step["got"]) == set(step["want"]) == {"classification", "regression",
                                                     "total_loss"}
    for k, want in step["want"].items():
        assert _rel_err(step["got"][k].item(), want) <= 1e-4, k
    before = dict(_flat(step["before"]["params"]))
    want = dict(_flat(step["after"]["params"]))
    got = dict(_flat(step["port_after"]["params"]))
    assert got.keys() == want.keys() and not any(k.startswith("depth/") for k in got)
    err = sum(np.linalg.norm(got[k] - want[k]) ** 2 for k in want) ** 0.5
    change = sum(np.linalg.norm(want[k] - before[k]) ** 2 for k in want) ** 0.5
    assert change > 0 and err <= 0.25 * change


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def test_2d_eval_step_behaves_as_jax(step):
    """JAX's 2D eval step subtracts its ``[B, P, 2]`` prediction from the
    batch's targets: ``[B, P, 3]`` targets fail to broadcast there, and the
    port raises ``ValueError`` naming it; ``[B, P, 2]`` targets give the
    RMSE over u and v on both sides (pred and rmse to 1e-4 px)."""
    trainer, port, jt = step["trainer"], step["port"], step["jax_trainer"]
    image, jt3 = _batch(12)
    with pytest.raises(TypeError, match="broadcast"):
        _jax_eval(jt, _jax_state_from_port(jt, port), image, jt3)
    with pytest.raises(ValueError, match="broadcast"):
        trainer.eval_step(port, {"image": _t(image), "jt_uvd": _t(jt3)})
    jt2 = jt3[..., :2]
    pred, rmse = trainer.eval_step(port, {"image": _t(image), "jt_uvd": _t(jt2)})
    want_pred, want_rmse = _jax_eval(jt, _jax_state_from_port(jt, port), image, jt2)
    assert tuple(pred.shape) == (BATCH, 3, 2) and not port.model.training
    assert_close(pred, want_pred, rtol=0, atol=1e-4)
    assert abs(rmse.item() - float(want_rmse)) <= 1e-4


def test_2d_weights_round_trip(model):
    """The 2D model's weights both ways, exactly: port state dict -> flax
    variables (``a2j_variables_from_state_dict`` == JAX's ``convert_a2j``
    of the same dict, no ``depth`` subtree) -> port state dict; and a
    reference-keyed state dict (``a2j_state_dict``) loads strictly."""
    net, variables = model
    sd = net.state_dict()
    flax = a2j_variables_from_state_dict(sd)
    assert "depth" not in flax["params"] and "depth" not in flax["batch_stats"]
    assert leaves_equal(flax, convert_a2j({k: v.numpy() for k, v in sd.items()}))
    assert leaves_equal(flax, variables)
    back = a2j_state_dict_from_flax(flax)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    reference = {**{k: v.clone() for k, v in sd.items()},
                 "Backbone.model.fc.weight": torch.zeros(1000, 2048),
                 "Backbone.model.bn1.num_batches_tracked": torch.tensor(0)}
    pa2j.A2JSystem(pconfig.A2JConfig(**SMALL)).load_state_dict(a2j_state_dict(reference),
                                                               strict=True)
