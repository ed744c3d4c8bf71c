"""The GroupNorm backward of the PyTorch port (K2r: the sums, K2d: dx) as
far as the CPU reaches it.

The CUDA kernels run only on a card (chip_smoke.py's ``[train]`` phase holds
them against their plain versions there). Here: the two plain versions
composed against ``jax.grad`` of flax ``GroupNorm`` (+ ``relu``) and against
the gradient registered on the forward ops; the Python transcription of
K2r's walk and fold against the plain sums; the ops under ``opcheck``; the
``torch.autograd.Function`` that ``group_norm`` takes with grad, under
``gradcheck`` in float64; the no-grad path, which calls only the forward
ops; and an FCOS train step with the kernels' route against the plain
GroupNorm's. Inputs come from numpy seeds; one torch thread.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.nn.resnet import GroupNorm
from handnet_tpu_torch.ops import cuda_gn
from handnet_tpu_torch.train.trainer import FCOSTrainer
from torch_port_fixtures import assert_close

H100_SMS = 132
EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, shape, param_dtype="float32", offset=1.0, spread=2.0):
    """x, dy, scale and bias as numpy float32; scale and bias hold
    bfloat16 values when ``param_dtype`` is bfloat16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(offset, spread, size=shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    tdt = getattr(torch, param_dtype)
    scale, bias = (torch.from_numpy(a).to(tdt).float().numpy() for a in (scale, bias))
    return x, dy, scale, bias


def _rel_err(got, want) -> float:
    got, want = (a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
                 for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# float32 throughout. Against the registered gradient (the same float32
# formula summed in another order) to 1e-6 of each gradient's scale; with
# bfloat16 parameters the registered gradient returns dscale and dbias in
# bfloat16, so those are held to one bfloat16 step (2^-8) of their scale.
# Against flax (XLA's derivative, another association) to 1e-5, as
# tests/test_torch_port_train.py holds the registered gradient.
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (2, 3, 4, 128)])
def test_plain_backward_matches_flax_and_registered_gradient(shape, relu, param_dtype):
    x, dy, scale, bias = _case(sum(shape) + relu, shape, param_dtype)
    tdt = getattr(torch, param_dtype)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    tsc, tbi = torch.from_numpy(scale).to(tdt), torch.from_numpy(bias).to(tdt)
    stats = cuda_gn.gn_group_stats(tx, 32)
    sums, dparams = cuda_gn.gn_backward_sums(tx, tdy, stats, tsc, tbi, EPS, relu)
    dx = cuda_gn.gn_backward_dx(tx, tdy, stats, tsc, tbi, sums, EPS, relu)
    assert sums.shape == (2, 2, 32) and dparams.shape == (2, shape[-1])
    assert sums.dtype == dparams.dtype == torch.float32 and dx.dtype == torch.float32

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (tx, tsc, tbi)]
        return torch.autograd.grad(fn(*args), args, tdy)

    # group_norm with grad is the Function: the two ops, the parameters cast
    route = grads(lambda a, s, b: cuda_gn.group_norm(a, s, b, 32, EPS, relu))
    assert torch.equal(route[0], dx)
    assert route[1].dtype == route[2].dtype == tdt
    assert torch.equal(route[1], dparams[0].to(tdt)) and torch.equal(route[2], dparams[1].to(tdt))

    registered = grads(lambda a, s, b: cuda_gn.gn_apply(a, cuda_gn.gn_group_stats(a, 32), s, b,
                                                        EPS, relu))
    param_tol = 2.0 ** -8 if param_dtype == "bfloat16" else 1e-6
    assert _rel_err(dx, registered[0]) <= 1e-6
    assert _rel_err(dparams[0], registered[1].float()) <= param_tol
    assert _rel_err(dparams[1], registered[2].float()) <= param_tol

    gn = fnn.GroupNorm(num_groups=32, epsilon=EPS, use_fast_variance=False)

    def flax_out(xj, s, b):
        y = gn.apply({"params": {"scale": s, "bias": b}}, xj)
        return jnp.sum((jax.nn.relu(y) if relu else y) * dy)

    want = jax.grad(flax_out, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                                  jnp.asarray(bias))
    for name, got, w in zip(("dx", "dscale", "dbias"), (dx, dparams[0], dparams[1]), want):
        assert _rel_err(got, np.asarray(w)) <= 1e-5, name


# (B, H, W, C), dtype, ReLU, the batch the plan is made for. HW = 300 leaves
# a ragged last split; C/G = 2, 4, 8 and 16; one split and many. Then A2J-GN's
# widths at its 11x11 maps: C/G 64 (a float32 2048-channel row is 512
# chunks, one row a block) and 32, plans for B = 1, 8 and 64; B = 64 folds
# its images in 8 runs of 8 and then the runs, B = 17 in runs of 8, 8 and 1
# with a ragged last split (9 x 7 = 63 pixels); and the GroupNorm
# backbone's 25x34x512.
_SPLIT_CASES = [
    ((2, 15, 20, 256), "bfloat16", True, 8),
    ((2, 15, 20, 256), "float32", False, 1),
    ((2, 15, 20, 256), "float32", True, 128),
    ((2, 30, 40, 64), "bfloat16", True, 8),
    ((2, 30, 40, 128), "float32", True, 8),
    ((2, 9, 7, 512), "bfloat16", False, 2),
    ((3, 9, 7, 512), "float32", True, 1),
    ((2, 11, 11, 2048), "float32", True, 1),
    ((2, 11, 11, 2048), "bfloat16", False, 8),
    ((2, 11, 11, 1024), "float32", True, 64),
    ((64, 11, 11, 1024), "bfloat16", True, 64),
    ((17, 9, 7, 2048), "float32", True, 64),
    ((2, 25, 34, 512), "bfloat16", True, 8),
]


def _plan(shape, dtype, plan_batch):
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    return cuda_gn.sums_plan(plan_batch, shape[1] * shape[2], shape[3], itemsize, H100_SMS)


# Tolerance 1e-5 of each output's scale, the card's: float32 sums of up to
# 38,400 values per group in another order than the plain version's.
@pytest.mark.parametrize("shape,dtype,relu,plan_batch", _SPLIT_CASES)
def test_backward_split_emulation_matches_plain(shape, dtype, relu, plan_batch):
    x, dy, scale, bias = _case(sum(shape), shape)
    tdt = getattr(torch, dtype)
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    tsc, tbi = torch.from_numpy(scale), torch.from_numpy(bias)
    plan = _plan(shape, dtype, plan_batch)
    hw = shape[1] * shape[2]
    if hw in (300, 63) and plan_batch < 128:
        assert plan.splits > 1 and hw % plan.per_split    # a ragged last split
    if shape[3] * tx.element_size() == 8192:
        assert plan.cp == 512 and plan.rows == 1          # one 512-chunk row a block
    # the images' runs: one (B <= 8) or several, the last one short for B = 17
    assert -(-shape[0] // cuda_gn.SUMS_IMAGE_FOLD) == {64: 8, 17: 3}.get(shape[0], 1)
    stats = cuda_gn.gn_group_stats_reference(tx, 32)
    got = cuda_gn.gn_backward_split_emulation(tx, tdy, stats, tsc, tbi, EPS, relu, plan)
    want = cuda_gn.gn_backward_sums_reference(tx, tdy, stats, tsc, tbi, EPS, relu)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def test_backward_sums_keep_precision_when_mean_dominates():
    """mean >> std (1000 + 0.1 N(0, 1)): c = x - mean is exact in float32
    (both near 1000), so S2 and dscale, from the emulation and from the
    plain version, agree with float64 sums of the same float32 values to
    1e-5 of their scale; x * inv - mean * inv would lose about 6e-4."""
    shape = (2, 15, 20, 256)
    x, dy, scale, bias = _case(8, shape, offset=1000.0, spread=0.1)
    tx, tdy, tsc, tbi = (torch.from_numpy(a) for a in (x, dy, scale, bias))
    stats = cuda_gn.gn_group_stats_reference(tx, 32)
    g = tdy.double() * (cuda_gn.gn_apply_reference(tx, stats, tsc, tbi, EPS) > 0)
    centred = tx.double() - stats[:, 0].double().repeat_interleave(8, -1)[:, None, None]
    inv = torch.rsqrt(stats[:, 1].double() + EPS).repeat_interleave(8, -1)[:, None, None]
    s2 = (g * tsc.double() * centred).sum(dim=(1, 2)).unflatten(-1, (32, 8)).sum(-1)
    dscale = (g * centred * inv).sum(dim=(0, 1, 2))
    plan = _plan(shape, "float32", 8)
    for sums, dparams in (cuda_gn.gn_backward_split_emulation(tx, tdy, stats, tsc, tbi, EPS,
                                                              True, plan),
                          cuda_gn.gn_backward_sums_reference(tx, tdy, stats, tsc, tbi, EPS,
                                                             True)):
        assert _rel_err(sums[:, 1], s2) <= 1e-5
        assert _rel_err(dparams[0], dscale) <= 1e-5


@pytest.mark.parametrize("name", ["gn_backward_sums", "gn_backward_dx"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_ops_pass_opcheck(name, dtype):
    """Schema, fake implementation, and the ops under FakeTensors and AOT
    dispatch (the inputs require no grad: the ops have no gradient)."""
    x, dy, scale, bias = _case(4, (2, 3, 5, 64))
    tdt = getattr(torch, dtype)
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    tsc, tbi = torch.from_numpy(scale), torch.from_numpy(bias)
    stats = cuda_gn.gn_group_stats_reference(tx, 32)
    args = (tx, tdy, stats, tsc, tbi)
    if name == "gn_backward_dx":
        args += (cuda_gn.gn_backward_sums_reference(tx, tdy, stats, tsc, tbi, EPS, True)[0],)
    torch.library.opcheck(getattr(torch.ops.handnet_torch, name).default, args + (EPS, True))


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_function_gradcheck_in_float64(relu):
    """``gradcheck`` of the Function (the plain versions of K2s, K2a, K2r
    and K2d in float64) at [2, 5, 7, 64], G=32, fast mode; then with only
    the parameters requiring grad, when no dx is computed."""
    x, _, scale, bias = (torch.from_numpy(a).double() for a in _case(1, (2, 5, 7, 64)))
    args = tuple(t.requires_grad_() for t in (x, scale, bias))
    assert torch.autograd.gradcheck(
        lambda x, s, b: cuda_gn.group_norm(x, s, b, 32, relu=relu), args, fast_mode=True)
    assert torch.autograd.gradcheck(
        lambda s, b: cuda_gn.group_norm(x.detach(), s, b, 32, relu=relu), args[1:],
        fast_mode=True)


class _OpLog(TorchDispatchMode):
    """The ``handnet_torch`` ops that reach the dispatcher, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "handnet_torch":
            self.ops.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def test_no_grad_path_calls_only_the_forward_ops():
    """Without grad (``no_grad``, ``inference_mode``) or with nothing that
    requires it, ``group_norm`` calls K2s's and K2a's ops and nothing else,
    as the serving paths did before the backward kernels; with grad, one
    forward and backward calls each of the four ops once. ``torch.export``
    of a GroupNorm module (parameters requiring grad) puts only the two
    forward ops into the graph."""
    x, dy, scale, bias = (torch.from_numpy(a) for a in _case(5, (2, 4, 6, 64)))
    sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    forward = ["gn_group_stats", "gn_apply"]
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), _OpLog() as log:
            cuda_gn.group_norm(x, sc, bi, 32, relu=True)
        assert log.ops == forward
    with _OpLog() as log:
        cuda_gn.group_norm(x, scale, bias, 32, relu=True)
    assert log.ops == forward
    xs = x.clone().requires_grad_()
    with _OpLog() as log:
        torch.autograd.grad(cuda_gn.group_norm(xs, sc, bi, 32, relu=True), (xs, sc, bi), dy)
    assert log.ops == forward + ["gn_backward_sums", "gn_backward_dx"]

    module = GroupNorm(32, 64, relu=True)
    program = torch.export.export(module, (x.permute(0, 3, 1, 2),))
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    ours = [t for t in targets if "handnet_torch" in t]
    assert ours == ["handnet_torch.gn_group_stats.default", "handnet_torch.gn_apply.default"]


SMALL = dict(image_h=64, image_w=96, fpn_channels=64, num_convs=2, ext=True)


def _set_gn_kernels(model, on: bool) -> None:
    for mod in model.modules():
        if hasattr(mod, "use_kernel"):
            mod.use_kernel = on


def test_fcos_train_step_kernels_route_matches_plain_groupnorm():
    """One ``FCOSTrainer`` step at 64x96 (batch 2, float32, GroupNorm
    backbone and towers) through ``group_norm``'s kernels route (on the CPU:
    the Function over the four plain versions) against the same step
    through ``group_norm_reference``, which autograd differentiates. The
    forwards are the same operations (losses bit-equal); the gradients
    differ by the backward's rounding, held to 1e-4 of each tensor's norm
    (measured: 2.8e-6 at most)."""
    rng = np.random.default_rng(21)
    image = torch.from_numpy(rng.normal(size=(2, 64, 96, 3)).astype(np.float32))
    boxes = np.array([[[8.0, 6.0, 40.0, 30.0], [50.0, 20.0, 90.0, 60.0]],
                      [[10.0, 10.0, 60.0, 50.0], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    targets = {"boxes": torch.from_numpy(boxes),
               "labels": torch.tensor([[1, 2], [2, 0]], dtype=torch.int32),
               "valid": torch.tensor([[True, True], [True, False]]),
               "box_info": torch.from_numpy(rng.uniform(0, 1, (2, 2, 5)).astype(np.float32))}
    runs = []
    for on in (True, False):
        trainer = FCOSTrainer(pconfig.FCOSConfig(**SMALL),
                              pconfig.TrainConfig(optimizer="sgd", lr=1e-3, warmup_epochs=1,
                                                  bf16=False),
                              steps_per_epoch=2, backbone_norm="group", device="cpu")
        state = trainer.init_state(3)
        _set_gn_kernels(state.model, on)
        state, metrics = trainer.train_step(state, {"image": image, "targets": targets})
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in state.model.named_parameters()}))
    (loss_k, grad_k), (loss_p, grad_p) = runs
    assert loss_k == loss_p and all(np.isfinite(list(loss_k.values())))
    errs = {n: float((grad_k[n] - grad_p[n]).norm() / grad_p[n].norm().clamp(min=1e-30))
            for n in grad_p}
    assert max(errs.values()) <= 1e-4, max(errs, key=errs.get)
