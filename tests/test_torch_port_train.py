"""The port's FCOS training path (``handnet_tpu_torch/train/``) against the
JAX package's, on the CPU.

Held against JAX: the GroupNorm ops' registered gradients (K2s/K2a's plain
versions; the kernels run only on a card, where chip_smoke.py's ``[train]``
phase holds them), the losses and box ops, the matcher (exactly, at the full
800x1088 table too), ``fcos_loss`` and its gradient, the trainable
BatchNorm, the schedules, the optimizers, two train steps of
``FCOSTrainer`` (float32, and a bf16 loss), the checkpoints and the params
npz. Inputs come from numpy seeds; everything runs on one torch thread.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_fcos
from handnet_tpu.models import fcos as jfcos
from handnet_tpu.ops import boxes as jboxes
from handnet_tpu.ops import focal as jfocal
from handnet_tpu.train import checkpoints as jckpt
from handnet_tpu.train import schedules as jsched
from handnet_tpu.train import trainer as jtrainer
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (fcos_state_dict_from_flax,
                                                 fcos_variables_from_state_dict)
from handnet_tpu_torch.models import fcos as pfcos
from handnet_tpu_torch.nn.resnet import BatchNorm2d, FrozenBatchNorm2d
from handnet_tpu_torch.ops import boxes as pboxes
from handnet_tpu_torch.ops import cuda_gn
from handnet_tpu_torch.ops import focal as pfocal
from handnet_tpu_torch.train import checkpoints as pckpt
from handnet_tpu_torch.train import schedules as psched
from handnet_tpu_torch.train.trainer import FCOSTrainer, TrainState, make_optimizer
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


# ---------------------------------------------------------------------------
# (a) the gradients of K2s and K2a (their plain versions on the CPU)


def _gn_case(seed, shape=(2, 5, 7, 64), dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=shape).astype(dtype)
    scale = rng.uniform(0.5, 1.5, size=shape[-1:]).astype(dtype)
    bias = rng.normal(size=shape[-1:]).astype(dtype)
    return x, scale, bias


def _gn_through_ops(x, scale, bias, relu):
    """GroupNorm as the two forward ops, so that autograd composes their
    registered gradients (``group_norm`` with grad takes K2r and K2d's
    Function instead: tests/test_torch_port_gn_backward.py)."""
    return cuda_gn.gn_apply(x, cuda_gn.gn_group_stats(x, 32), scale, bias, 1e-5, relu)


@pytest.mark.parametrize("relu", [False, True])
def test_gn_ops_gradcheck_in_float64(relu):
    """``torch.autograd.gradcheck`` of the registered gradients, float64, at
    [2, 5, 7, 64] with G=32: each op alone (the statistics as an input of
    the apply) and GroupNorm as the two together. Fast mode (random
    projections of the Jacobians): the full one takes 25 s a case here."""
    x, scale, bias = (_t(a).requires_grad_() for a in _gn_case(1))
    assert torch.autograd.gradcheck(
        lambda x, s, b: _gn_through_ops(x, s, b, relu), (x, scale, bias), fast_mode=True)
    stats = cuda_gn.gn_group_stats(x.detach(), 32).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, st, s, b: cuda_gn.gn_apply(x, st, s, b, 1e-5, relu), (x, stats, scale, bias),
        fast_mode=True)
    assert torch.autograd.gradcheck(lambda x: cuda_gn.gn_group_stats(x, 32), (x,),
                                    fast_mode=True)


@pytest.mark.parametrize("relu", [False, True])
def test_gn_gradient_matches_reference_and_flax(relu):
    """float32: dx, dscale and dbias of the ops' gradients against autograd
    through ``group_norm_reference`` (plain torch ops) to 1e-6 of each
    gradient's scale (one summation order against another), and against
    ``jax.grad`` of flax ``GroupNorm`` (+ ``relu``) to 1e-5."""
    x, scale, bias = _gn_case(2, dtype=np.float32)
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def torch_grads(fn):
        args = [_t(a).requires_grad_() for a in (x, scale, bias)]
        return [g.numpy() for g in torch.autograd.grad(fn(*args), args, _t(dy))]

    got = torch_grads(lambda x, s, b: _gn_through_ops(x, s, b, relu))
    plain = torch_grads(lambda x, s, b: cuda_gn.group_norm_reference(x, s, b, 32, relu=relu))

    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, use_fast_variance=False)

    def flax_out(xj, s, b):
        y = gn.apply({"params": {"scale": s, "bias": b}}, xj)
        return jnp.sum((jax.nn.relu(y) if relu else y) * dy)

    want = jax.grad(flax_out, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                                  jnp.asarray(bias))
    for name, g, p, w in zip(("dx", "dscale", "dbias"), got, plain, want):
        assert _rel_err(g, p) <= 1e-6, name
        assert _rel_err(g, np.asarray(w)) <= 1e-5, name


@pytest.mark.parametrize("name", ["gn_group_stats", "gn_apply"])
def test_gn_ops_pass_opcheck_with_grad(name):
    """The ops' schema, fake implementation and registered autograd, under
    FakeTensors and AOT autograd, with inputs that require grad."""
    x, scale, bias = (_t(a).requires_grad_() for a in _gn_case(4, (2, 3, 5, 64), np.float32))
    if name == "gn_group_stats":
        args = (x, 32)
    else:
        stats = cuda_gn.gn_group_stats_reference(x.detach(), 32).requires_grad_()
        args = (x, stats, scale, bias, 1e-5, True)
    torch.library.opcheck(getattr(torch.ops.handnet_torch, name).default, args)


# ---------------------------------------------------------------------------
# (b) elementwise losses and box ops


def test_losses_and_box_ops_match_jax():
    """focal, BCE, smooth-L1, ``linear_encode`` and ``giou_loss`` (with
    overlapping, disjoint and degenerate boxes) against the JAX package to
    1e-6."""
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, size=(4, 50, 3)).astype(np.float32)
    targets = (rng.uniform(size=logits.shape) < 0.3).astype(np.float32)
    diff = rng.normal(0, 2, size=(200,)).astype(np.float32)
    for got, want in [
        (pfocal.sigmoid_focal_loss(_t(logits), _t(targets)),
         jfocal.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets))),
        (pfocal.bce_with_logits(_t(logits), _t(targets)),
         jfocal.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets))),
        (pfocal.smooth_l1(_t(diff), 0.5), jfocal.smooth_l1(jnp.asarray(diff), 0.5)),
    ]:
        assert_close(got, want, rtol=1e-6, atol=1e-6)

    def boxes(n):
        xy = rng.uniform(0, 80, size=(n, 2))
        wh = rng.uniform(0, 40, size=(n, 2)) * (rng.uniform(size=(n, 1)) > 0.1)
        return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)

    b1, b2, anchors = boxes(300), boxes(300), boxes(300) + np.float32([0, 0, 8, 8])
    assert_close(pboxes.giou_loss(_t(b1), _t(b2)),
                 jboxes.giou_loss(jnp.asarray(b1), jnp.asarray(b2)), rtol=1e-6, atol=1e-6)
    assert_close(pboxes.linear_encode(_t(anchors), _t(b1)),
                 jboxes.linear_encode(jnp.asarray(anchors), jnp.asarray(b1)),
                 rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the matcher


def _tied_targets(rng, batch, h, w, m=8):
    """Padded targets with 2-4 boxes per image: the first two share a corner
    and have integer sides k x k and (k+1) x (k-1), k a multiple of 4, so
    their areas differ by 1 px^2 and ``1e8 - area`` ties in float32 (its ulp
    there is 8) where float64 prefers the second; the rest are random.
    Labels, valid masks and box_info in the data source's layout (padding:
    label 0, box_info -1 with field 4 zeroed)."""
    boxes = np.zeros((batch, m, 4), np.float32)
    labels = np.zeros((batch, m), np.int32)
    valid = np.zeros((batch, m), bool)
    info = np.full((batch, m, 5), -1.0, np.float32)
    info[..., 4] = 0.0
    for i in range(batch):
        n = int(rng.integers(2, 5))
        k = 4 * int(rng.integers(2, min(h, w) // 5))
        x1, y1 = int(rng.integers(0, w - k - 1)), int(rng.integers(0, h - k))
        boxes[i, 0] = [x1, y1, x1 + k, y1 + k]
        boxes[i, 1] = [x1, y1, x1 + k + 1, y1 + k - 1]
        for j in range(2, n):
            bw, bh = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
        for j in range(n):
            labels[i, j] = rng.integers(1, 3)
            info[i, j] = [rng.integers(0, 5), rng.integers(0, 2), rng.uniform(0, 1),
                          rng.uniform(-1, 1), rng.uniform(-1, 1)]
        valid[i, :n] = True
    return {"boxes": boxes, "labels": labels, "valid": valid, "box_info": info}


@pytest.mark.parametrize("hw", [(64, 96), (800, 1088)])
def test_match_anchors_equals_jax(hw):
    """The matched GT per anchor, exactly, on the 64x96 and the full
    800x1088 anchor tables, with GTs whose areas tie in float32: anchors
    inside both tied GTs take the first, in both packages, where float64
    would pick the second."""
    cfg = pconfig.FCOSConfig(image_h=hw[0], image_w=hw[1])
    anchors, sizes, slices = pfcos.anchors_for(cfg)
    targets = _tied_targets(np.random.default_rng(6), 4, *hw)
    boxes = targets["boxes"]
    got = pfcos.match_anchors(_t(anchors), _t(sizes), slices, _t(boxes), _t(targets["valid"]))
    want = jax.vmap(lambda b, v: jfcos.match_anchors(jnp.asarray(anchors), jnp.asarray(sizes),
                                                     slices, b, v))(
        jnp.asarray(boxes), jnp.asarray(targets["valid"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    assert (np.float32(1e8) - areas[:, 0] == np.float32(1e8) - areas[:, 1]).all()
    assert (areas[:, 1].astype(np.float64) < areas[:, 0]).all()
    # the tie is on the path: anchors matched to GT 0 whose centre is inside GT 1 too
    centres = (anchors[:, :2] + anchors[:, 2:]) / 2
    inside = ((centres[None] > boxes[:, 1, None, :2])
              & (centres[None] < boxes[:, 1, None, 2:])).all(-1)
    assert ((got.numpy() == 0) & inside).sum() > 0


# ---------------------------------------------------------------------------
# (d) fcos_loss


# the loss dict's keys in the JAX package's order (jit returns them sorted)
LOSS_KEYS = ["classification", "bbox_regression", "bbox_ctrness", "hand_lr",
             "hand_contact_state", "hand_dxdy"]


def _head(rng, batch, n, ext):
    head = {"cls_logits": rng.normal(-2, 2, size=(batch, n, 3)),
            "hand_lr": rng.normal(size=(batch, n, 2)),
            "bbox_regression": np.abs(rng.normal(2, 1.5, size=(batch, n, 4))),
            "bbox_ctrness": rng.normal(size=(batch, n, 1))}
    if ext:
        head["hand_contact_state"] = rng.normal(size=(batch, n, 5))
        head["hand_dxdy"] = rng.normal(0, 0.5, size=(batch, n, 3))
    return {k: v.astype(np.float32) for k, v in head.items()}


@pytest.mark.parametrize("ext", [True, False])
def test_fcos_loss_and_gradient_match_jax(ext):
    """Every loss term to 1e-5 relative and its gradient with respect to the
    head outputs to 1e-5 of each output's gradient scale, on the same head
    outputs and targets, with and without the extension heads."""
    cfg_kw = dict(image_h=64, image_w=96, ext=ext)
    pcfg, jcfg = pconfig.FCOSConfig(**cfg_kw), jconfig.FCOSConfig(**cfg_kw)
    anchors, sizes, slices = pfcos.anchors_for(pcfg)
    rng = np.random.default_rng(7)
    head = _head(rng, 3, anchors.shape[0], ext)
    targets = _tied_targets(rng, 3, 64, 96)

    def jloss(h):
        losses = jfcos.fcos_loss(h, {k: jnp.asarray(v) for k, v in targets.items()},
                                 jnp.asarray(anchors), jnp.asarray(sizes), slices, jcfg)
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in head.items()})
    phead = {k: _t(v).requires_grad_() for k, v in head.items()}
    plosses = pfcos.fcos_loss(phead, {k: _t(v) for k, v in targets.items()}, _t(anchors),
                              _t(sizes), slices, pcfg)
    assert list(plosses) == LOSS_KEYS[:len(jlosses)] and set(plosses) == set(jlosses)
    for k in jlosses:
        assert _rel_err(plosses[k].item(), float(jlosses[k])) <= 1e-5, k
    sum(plosses.values()).backward()
    for k in head:
        assert _rel_err(phead[k].grad.numpy(), jgrads[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# (e) trainable BatchNorm


def test_batch_norm_matches_flax_batch_norm():
    """Train mode against flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
    the output of each of 3 calls and the running statistics after them to
    1e-6; eval mode on those statistics to 1e-6. ``torch.nn.BatchNorm2d``
    (momentum 0.1) keeps the same running mean but the unbiased variance,
    which differs from flax's by n/(n-1)."""
    rng = np.random.default_rng(8)
    c = 16
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    port = BatchNorm2d(c)
    torch_bn = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        for m in (port, torch_bn):
            m.weight.copy_(_t(scale))
            m.bias.copy_(_t(bias))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    for call in range(3):
        x = rng.normal(call, 1.0 + call, size=(4, 3, 5, c)).astype(np.float32)   # NHWC
        want, updates = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, "batch_stats": updates["batch_stats"]}
        xt = _t(x).permute(0, 3, 1, 2)
        assert_close(port(xt).permute(0, 2, 3, 1).detach(), want, rtol=1e-6, atol=1e-6)
        torch_bn(xt)
    stats = variables["batch_stats"]
    assert_close(port.running_mean, stats["mean"], rtol=1e-6, atol=1e-6)
    assert_close(port.running_var, stats["var"], rtol=1e-6, atol=1e-6)
    assert_close(torch_bn.running_mean, stats["mean"], rtol=1e-6, atol=1e-6)
    assert _rel_err(torch_bn.running_var.numpy(), np.asarray(stats["var"])) > 1e-2
    port.eval()
    x = rng.normal(size=(2, 3, 5, c)).astype(np.float32)
    want = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=True).apply(
        variables, jnp.asarray(x))
    assert_close(port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach(), want,
                 rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (f) schedules, (g) optimizers


def test_schedules_equal_optax():
    """The warmup + multistep schedule and the step decay equal optax's
    float32 values at counts 0, 1, warmup - 1, warmup and each milestone
    +-1 (optax scales at the boundary itself), with and without warmup."""
    spe, milestones = 7, (2, 3)
    for warmup in (1.0, 0.0):
        got = psched.multistep_with_warmup(1.25e-3, spe, milestones, warmup_epochs=warmup)
        want = jsched.multistep_with_warmup(1.25e-3, spe, milestones, warmup_epochs=warmup)
        counts = [0, 1, spe - 1, spe] + [m * spe + d for m in milestones for d in (-1, 0, 1)]
        for count in counts:
            assert np.float32(got(count)) == np.float32(want(count)), (warmup, count)
        # the first update's rate: lr * 1e-3, to the float32 rounding of the
        # linear schedule (without warmup epochs the warmup still spans one
        # step, as in the JAX package)
        assert abs(got(0) - 1.25e-6) <= 1e-4 * 1.25e-6
    got, want = psched.step_decay(3.5e-4, 5, 10, 0.2), jsched.step_decay(3.5e-4, 5, 10, 0.2)
    for count in (0, 1, 49, 50, 51, 99, 100, 101):
        assert np.float32(got(count)) == np.float32(want(count)), count


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_matches_optax(optimizer):
    """``make_optimizer`` and ``TrainState.apply_gradients`` against the JAX
    package's ``make_optimizer`` over 5 updates with seeded gradients, the
    warmup + multistep schedule crossing its warmup and a milestone, weight
    decay on every tensor (biases and norm scales too): parameters to
    1e-6."""
    rng = np.random.default_rng(9)
    shapes = {"conv": (8, 4, 3, 3), "bias": (8,), "scale": (8,), "dense": (5, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) + (k == "scale") for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    cfg_kw = dict(lr=0.05, weight_decay=0.05, optimizer=optimizer, warmup_epochs=1)
    jschedule = jsched.multistep_with_warmup(0.05, 2, (2,))
    tx = jtrainer.make_optimizer(jconfig.TrainConfig(**cfg_kw), jschedule)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
    module = nn.ParameterDict({k: nn.Parameter(_t(v).clone()) for k, v in params.items()})
    state = TrainState(0, module, make_optimizer(pconfig.TrainConfig(**cfg_kw),
                                                 module.parameters()),
                       psched.multistep_with_warmup(0.05, 2, (2,)))
    for g in grads:
        for k, p in module.items():
            p.grad = _t(g[k]).clone()
        state.apply_gradients()
    assert state.step == 5
    for k in shapes:
        assert_close(module[k].detach(), jparams[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert _rel_err(module[k].detach().numpy(), params[k]) > 1e-3   # they moved


# ---------------------------------------------------------------------------
# (h) the train step against JAX's FCOSTrainer

SMALL = dict(image_h=64, image_w=96, fpn_channels=64, num_convs=2, ext=True)
TRAIN = dict(lr=0.01, weight_decay=1e-4, optimizer="sgd", warmup_epochs=1)
STEPS_PER_EPOCH, MILESTONES = 2, (1,)


def _batch(seed, batch=2):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, 64, 96, 3)).astype(np.float32)
    return image, _tied_targets(rng, batch, 64, 96)


def _port_batch(image, targets):
    return {"image": _t(image), "targets": {k: _t(v) for k, v in targets.items()}}


def _jax_batch(image, targets):
    return {"image": jnp.asarray(image), "targets": {k: jnp.asarray(v) for k, v in targets.items()}}


def _port_trainer(bf16=False, backbone_norm="batch", **train):
    return FCOSTrainer(pconfig.FCOSConfig(**SMALL),
                       pconfig.TrainConfig(**{**TRAIN, **train}, bf16=bf16),
                       steps_per_epoch=STEPS_PER_EPOCH, milestones_epochs=MILESTONES,
                       backbone_norm=backbone_norm, device="cpu")


def _variables(model) -> dict:
    return convert_fcos({k: v.detach().numpy() for k, v in model.state_dict().items()})


def _jax_trainer(bf16):
    return jtrainer.FCOSTrainer(jconfig.FCOSConfig(**SMALL),
                                jconfig.TrainConfig(**TRAIN, bf16=bf16),
                                steps_per_epoch=STEPS_PER_EPOCH, milestones_epochs=MILESTONES,
                                backbone_norm="batch")


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's ``FCOSTrainer`` (float32, SGD, warmup, batch-norm backbone) run
    for 2 steps from the port's seed-3 init, converted with
    ``convert_fcos`` (no flax init): the initial variables, each step's
    losses and the final params and batch_stats."""
    trainer = _jax_trainer(bf16=False)
    init = _variables(_port_trainer().init_state(3).model)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=init["params"],
                                batch_stats=init["batch_stats"],
                                opt_state=trainer.tx.init(init["params"]), tx=trainer.tx)
    losses = []
    for seed in (10, 11):
        state, metrics = trainer.train_step(state, _jax_batch(*_batch(seed)))
        losses.append({k: float(v) for k, v in metrics.items()})
    return {"init": init, "losses": losses,
            "final": jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                         "batch_stats": state.batch_stats}),
            "step": int(state.step)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


# The gradient of this small network is not smooth in its input: a 1e-7
# relative perturbation of the frames moves backbone.body.layer3.3.conv1's
# step-0 gradient by 11% of its scale (ReLU masks flip where BatchNorm
# normalizes 48 values; measured on this port and batch). The port and JAX
# differ by rounding, which is such a perturbation, so each parameter is held
# to 15% of its own change over the 2 steps (measured worst 7.4%), the whole
# tree to 2% of the whole change (measured 0.83%); batch_stats, which come
# from the forwards, to 1e-3 of their change (measured 2.5e-5); the losses to
# 1e-4 relative (measured 4e-6).
PARAM_TOL, PARAMS_TOL, STATS_TOL, LOSS_TOL = 0.15, 0.02, 1e-3, 1e-4


def test_train_steps_match_jax_trainer(jax_steps):
    """Two steps of the port's ``FCOSTrainer`` against JAX's on the same
    init and batches (float32, SGD with warmup, batch-norm backbone): every
    loss term of each step, then the params and batch_stats, each tensor
    relative to its change (tolerances above, with their reason)."""
    trainer = _port_trainer()
    state = trainer.init_state(3)
    for seed, want in zip((10, 11), jax_steps["losses"]):
        state, metrics = trainer.train_step(state, _port_batch(*_batch(seed)))
        assert list(metrics) == LOSS_KEYS + ["total_loss"] and set(metrics) == set(want)
        for k in want:
            assert _rel_err(metrics[k].item(), want[k]) <= LOSS_TOL, k
    assert state.step == jax_steps["step"] == 2
    got = _variables(state.model)
    for collection, tol in (("params", PARAM_TOL), ("batch_stats", STATS_TOL)):
        init = dict(_flat(jax_steps["init"][collection]))
        want = dict(_flat(jax_steps["final"][collection]))
        err_sq = change_sq = 0.0
        for key, value in _flat(got[collection]):
            change = want[key] - init[key]
            err = np.abs(value - want[key]).max()
            assert err <= tol * np.abs(change).max() + 1e-12, (collection, key)
            err_sq += float(np.sum((value - want[key]) ** 2))
            change_sq += float(np.sum(change ** 2))
        if collection == "params":
            assert err_sq ** 0.5 <= PARAMS_TOL * change_sq ** 0.5
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_bf16_loss_matches_jax_bf16_loss(jax_steps):
    """One bf16 step (autocast: bf16 convolutions, float32 master weights
    and norm statistics) against JAX's bf16 loss on the same init and batch:
    every term to 3e-2 relative, the total to 1e-2 (bf16 keeps 8 bits, and
    the two forwards round at other places; measured worst 8.5e-3, on
    bbox_ctrness, total 2.5e-3)."""
    image, targets = _batch(10)
    jt = _jax_trainer(bf16=True)
    init = jax_steps["init"]
    _, (_, want) = jax.jit(jt._loss_fn)(init["params"], init["batch_stats"],
                                        _jax_batch(image, targets))
    trainer = _port_trainer(bf16=True)
    state, got = trainer.train_step(trainer.init_state(3), _port_batch(image, targets))
    for k in want:
        assert _rel_err(got[k].item(), float(want[k])) <= (1e-2 if k == "total_loss" else 3e-2), k
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


# ---------------------------------------------------------------------------
# (i) checkpoints and the params npz


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Train, save, step -> A; restore into a differently seeded state, step
    -> B: A == B bit for bit (parameters, running statistics, momenta,
    losses, step). ``max_to_keep`` keeps the newest epochs."""
    trainer = _port_trainer()
    batch0, batch1 = _port_batch(*_batch(10)), _port_batch(*_batch(11))
    state, _ = trainer.train_step(trainer.init_state(3), batch0)
    ckpt = pckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    ckpt.save(0, state, extra={"note": "after one step"})
    state, metrics_a = trainer.train_step(state, batch1)
    restored = ckpt.restore(trainer.init_state(4))
    assert restored.step == 1
    restored, metrics_b = trainer.train_step(restored, batch1)
    assert restored.step == state.step == 2
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i]["momentum_buffer"], ob[i]["momentum_buffer"]) for i in oa)
    assert all(torch.equal(metrics_a[k], metrics_b[k]) for k in metrics_a)
    for epoch in (1, 2, 3):
        ckpt.save(epoch, state)
    assert ckpt.epochs() == [2, 3] and ckpt.latest_epoch() == 3
    with pytest.raises(FileNotFoundError):
        pckpt.CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_params_npz_loads_into_the_jax_package(tmp_path, jax_steps):
    """A batch-norm detector after a train step: ``save_params_npz`` writes
    the flax keys; the JAX package's ``load_params_npz`` reads them, and
    flax's eval forward on those params (with the running statistics that
    ``convert_fcos`` gives) equals the port's eval forward to 1e-5. The
    npz also loads back into a port detector, and
    ``fcos_variables_from_state_dict`` equals ``convert_fcos`` both ways."""
    trainer = _port_trainer()
    state, _ = trainer.train_step(trainer.init_state(3), _port_batch(*_batch(10)))
    model = state.model.eval()
    path = str(tmp_path / "params.npz")
    pckpt.save_params_npz(path, model)
    params = jckpt.load_params_npz(path)
    variables = _variables(model)
    assert leaves_equal(params, variables["params"])
    assert leaves_equal(fcos_variables_from_state_dict(model.state_dict()), variables)
    image = _batch(12)[0]
    want = jax.jit(lambda v, x: jfcos.FCOS(cfg=jconfig.FCOSConfig(**SMALL),
                                           backbone_norm="batch").apply(v, x, train=False))(
        {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(image))
    with torch.no_grad():
        got = model(_t(image))
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    fresh = pfcos.FCOSSystem(pconfig.FCOSConfig(**SMALL), backbone_norm="batch")
    missing, unexpected = fresh.load_state_dict(
        fcos_state_dict_from_flax({"params": pckpt.load_params_npz(path)}), strict=False)
    assert not unexpected and all(k.endswith(("running_mean", "running_var")) for k in missing)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items()
               if k not in missing)


# ---------------------------------------------------------------------------
# (j) what the trainer refuses, forces off, and keeps


def test_trainer_refusals_and_forced_options(monkeypatch):
    """A ``mesh`` that is not a ``parallel.DataMesh`` raises ``TypeError``
    and the ``"batch_sync"`` backbone without a mesh ``ValueError``
    (tests/test_torch_port_parallel.py trains both under a mesh; the
    ``"group"`` backbone is built: tests/test_torch_port_fcos_apps.py trains
    it against JAX's), the fused-tower head ``ValueError``; ``quant`` and
    ``gn_fast_variance`` are forced off; with no device and no card it
    raises instead of training on the CPU."""
    with pytest.raises(TypeError, match="DataMesh"):
        FCOSTrainer(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="batch_sync"):
        FCOSTrainer(backbone_norm="batch_sync", device="cpu")
    assert FCOSTrainer(backbone_norm="group", device="cpu").backbone_norm == "group"
    with pytest.raises(ValueError, match="unknown norm"):
        FCOSTrainer(backbone_norm="layer", device="cpu")
    forced = FCOSTrainer(pconfig.FCOSConfig(**SMALL, quant="static", gn_fast_variance=True),
                         device="cpu")
    assert forced.model_cfg.quant is False and forced.model_cfg.gn_fast_variance is False
    trainer = _port_trainer()
    state = trainer.init_state(3)
    state.model.head.fused_towers = True
    with pytest.raises(ValueError, match="fused-tower"):
        trainer.train_step(state, _port_batch(*_batch(10)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FCOSTrainer()


def test_frozen_backbone_step_keeps_statistics_and_trains_affine():
    """A ``"frozen"`` backbone trains in eval mode: its running statistics
    stay as they were, its BN ``weight`` and ``bias`` are parameters and
    move (optax updates flax's frozen-BN scale and bias too)."""
    trainer = _port_trainer(backbone_norm="frozen")
    state = trainer.init_state(3)
    body = state.model.backbone["body"]
    assert isinstance(body.bn1, FrozenBatchNorm2d)
    before = {k: v.clone() for k, v in body.state_dict().items()}
    state, metrics = trainer.train_step(state, _port_batch(*_batch(10)))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    after = body.state_dict()
    for k in before:
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["bn1.weight"], after["bn1.weight"])
    assert not torch.equal(before["layer1.0.bn2.bias"], after["layer1.0.bn2.bias"])
    assert not state.model.training


def test_fcos_system_keeps_anchor_sizes_and_loss_entry():
    """``FCOSSystem`` keeps the anchor sizes the matcher needs (a
    non-persistent buffer, out of the state dict), and ``loss`` is
    ``fcos_loss`` of its forward; a ``"batch_sync"`` backbone has the same
    state dict keys."""
    cfg = pconfig.FCOSConfig(**SMALL)
    model = pfcos.FCOSSystem(cfg, backbone_norm="batch")
    model.init_weights_(torch.Generator().manual_seed(3))
    _, sizes, _ = pfcos.anchors_for(cfg)
    assert torch.equal(model.anchor_sizes, _t(sizes))
    assert not any("anchor" in k for k in model.state_dict())
    batch = _port_batch(*_batch(10))
    model.eval()
    with torch.no_grad():
        got = model.loss(batch["image"], batch["targets"])
        want = pfcos.fcos_loss(model(batch["image"]), batch["targets"], model.anchors,
                               model.anchor_sizes, model.level_slices, cfg)
    assert all(torch.equal(got[k], want[k]) for k in want)
    synced = pfcos.FCOSSystem(cfg, backbone_norm="batch_sync")
    assert list(synced.state_dict()) == list(model.state_dict())
