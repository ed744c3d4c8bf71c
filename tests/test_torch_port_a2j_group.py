"""A2J with GroupNorm (``A2JSystem(norm="group")``) in the port, and the
GroupNorm kernels (K2s, K2a forward; K2r, K2d backward) at the wide groups
it needs, on the CPU.

A2J's GroupNorm(32) runs at C/G = 2 to 64: layer3's 1024-channel outputs
have 32-channel groups, layer4's 2048-channel outputs 64-channel groups, and
a float32 row of 2048 channels is 512 chunks of 16 bytes, one row a block.
The kernels run only on a card (``chip_smoke.py``'s ``[a2j_group]`` holds
them against their plain versions there). Here: the plans and the Python
transcription of K2s's walk at those widths against the plain versions and
the JAX package's ``gn_group_stats``/``pallas_group_norm`` in interpret
mode (K2r's is held in ``test_torch_port_gn_backward.py``); the width
checks of the four kernels; and the whole module at full channel widths
against JAX's ``A2JSystem(norm="group")``, with weights from the port's
seeded init carried to flax by the port's converter and JAX's functions
jitted: the heads, the decode, and the gradient of ``a2j_loss`` with
respect to every parameter and the crops against ``jax.grad``, the port's
backward through the four ops 65 times each. Everything runs on one torch
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j
from handnet_tpu.models import a2j as ja2j
from handnet_tpu.ops.pallas_gn import gn_group_stats, pallas_group_norm
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 a2j_variables_from_state_dict)
from handnet_tpu_torch.models import a2j as pa2j
from handnet_tpu_torch.nn.resnet import GroupNorm
from handnet_tpu_torch.ops import cuda_gn
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_fixtures import assert_close, fast_compile, leaves_equal

H100_SMS = 132
# the wide layers' maps at 176^2 crops (stride 16) are 11 x 11
WIDE = [(1024, 32), (2048, 32)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed, dtype="float32", loc=2.0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc, scale, size=shape).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("channels,itemsize", [(1024, 4), (2048, 4), (1024, 2), (2048, 2)])
@pytest.mark.parametrize("batch", [1, 8, 64, 128])
def test_wide_row_plans_cover_hw(channels, itemsize, batch):
    """The four kernels' plans take rows of 1024 and 2048 channels: a
    float32 row of 2048 is 512 chunks, one pixel row a block of 512
    threads; every other row stays within 256 threads. K2r's plan
    (``sums_plan``) keeps the grid within one wave of
    ``SUMS_BLOCKS_PER_SM`` 256-thread blocks per SM, a 512-thread block
    counting for two."""
    hw = 121
    cp = channels * itemsize // 16
    plans = [(cuda_gn.row_plan(batch, hw, channels, itemsize, H100_SMS, unroll, target,
                               cuda_gn._MAX_ROW_CHUNKS), unroll, False)
             for unroll, target in ((cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM),
                                    (cuda_gn.APPLY_UNROLL, cuda_gn.APPLY_BLOCKS_PER_SM),
                                    (cuda_gn.DX_UNROLL, cuda_gn.DX_BLOCKS_PER_SM))]
    plans.append((cuda_gn.sums_plan(batch, hw, channels, itemsize, H100_SMS),
                  cuda_gn.SUMS_UNROLL, True))
    for plan, unroll, one_wave in plans:
        assert plan.cp == cp and plan.rows == max(1, 256 // cp)
        assert plan.rows * plan.cp <= (512 if cp > 256 else 256)
        assert (plan.splits - 1) * plan.per_split < hw <= plan.splits * plan.per_split
        assert plan.per_split % (plan.rows * unroll) == 0
        if one_wave:
            wave = cuda_gn.SUMS_BLOCKS_PER_SM * H100_SMS * 256 // (plan.rows * plan.cp)
            assert batch * plan.splits <= max(batch, wave)
            assert plan.splits == min(max(1, wave // batch), -(-hw // (plan.rows * unroll)))
        else:
            assert batch * plan.splits >= H100_SMS or plan.per_split == plan.rows * unroll
    with pytest.raises(ValueError, match="at most 8192"):
        cuda_gn.sums_plan(batch, hw, 4096, 4, H100_SMS)   # 1024 chunks


# (B, H, W), C, dtype, the batch the plan is made for. 11 x 11 is the wide
# layers' map at 176^2 crops; a plan for B=1 cuts it into the most splits, a
# plan for B=128 into the fewest; 9 x 7 = 63 pixels leave a ragged last
# split; 2 x 2 (a 32^2 crop) is one split, whose block writes the result.
_SPLIT_CASES = [((2, 11, 11), c, dt, pb) for c in (1024, 2048)
                for dt in ("float32", "bfloat16") for pb in (1, 128)] + [
    ((2, 9, 7), 2048, "float32", 8), ((2, 9, 7), 1024, "bfloat16", 8),
    ((2, 2, 2), 2048, "float32", 128)]


# Tolerance 1e-4 of the statistics' scale, the card's: float32 reductions in
# another order than the plain version's and the Pallas kernel's.
@pytest.mark.parametrize("bhw,channels,dtype,plan_batch", _SPLIT_CASES)
def test_wide_stats_emulation_matches_plain_and_pallas(bhw, channels, dtype, plan_batch):
    x = _x((*bhw, channels), seed=channels + bhw[1], dtype=dtype)
    hw = bhw[1] * bhw[2]
    plan = cuda_gn.row_plan(plan_batch, hw, channels, x.element_size(), H100_SMS,
                            cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM,
                            cuda_gn._MAX_ROW_CHUNKS)
    if hw == 4:
        assert plan.splits == 1
    got = cuda_gn.gn_stats_split_emulation(x, 32, plan)
    want = cuda_gn.gn_group_stats_reference(x, 32)
    pallas = gn_group_stats(jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)), 32,
                            interpret=True)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert got.shape == want.shape == (bhw[0], 2, 32) and got.dtype == torch.float32
    assert_close(got, want, rtol=0, atol=tol)
    assert_close(want, np.asarray(pallas), rtol=0, atol=tol)


def test_wide_stats_emulation_large_offset_stability():
    """mean >> std at K = 64 (runs of four columns, then their tree): the
    Chan folds keep the variance that E[x^2]-E[x]^2 would lose."""
    x = _x((2, 11, 11, 2048), seed=8, loc=1000.0, scale=0.1)
    plan = cuda_gn.row_plan(8, 121, 2048, 4, H100_SMS, cuda_gn.STATS_UNROLL,
                            cuda_gn.STATS_BLOCKS_PER_SM, cuda_gn._MAX_ROW_CHUNKS)
    assert plan.cp == 512 and plan.rows == 1
    got = cuda_gn.gn_stats_split_emulation(x, 32, plan)
    g = x.double().reshape(2, 121, 32, 64)
    assert_close(got[:, 0], g.mean(dim=(1, 3)), rtol=0, atol=2e-3)
    assert_close(got[:, 1], g.var(dim=(1, 3), unbiased=False), rtol=1e-2, atol=0)
    assert bool((got[:, 1] > 0).all())


# float32 to 1e-5 (summation order only); bf16 to 3e-2 (both round their
# outputs to bf16), as tests/test_pallas_gn.py.
@pytest.mark.parametrize("channels,groups", WIDE)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_wide_group_norm_matches_pallas(channels, groups, dtype, tol):
    rng = np.random.default_rng(channels)
    x = rng.normal(1.0, 2.0, size=(2, 11, 11, channels)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=channels).astype(np.float32)
    bias = rng.normal(size=channels).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax.nn.relu(pallas_group_norm(jx, jnp.asarray(scale), jnp.asarray(bias), groups,
                                         eps=1e-6, interpret=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = cuda_gn.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), groups,
                             eps=1e-6, relu=True)
    assert got.dtype == tx.dtype
    assert_close(got.float(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("channels", [1024, 2048])
def test_width_checks(channels):
    """The four kernels' checks take C/G = 32 and 64, the forward's and the
    backward's (K2r, K2d) alike. A width no kernel has (128) is refused by
    all of them with ``ValueError`` naming the width, where the launch
    would otherwise fail with a bare CUDA error."""
    x = torch.zeros(2, 3, 3, channels)
    stats = torch.zeros(2, 2, 32)
    scale, bias = torch.ones(channels), torch.zeros(channels)
    cuda_gn._check_nhwc("gn_group_stats", x, 32)
    assert cuda_gn._check_params("gn_apply", x, stats, scale, bias) == 32
    for name in ("gn_backward_sums", "gn_backward_dx"):
        assert cuda_gn._check_backward(name, x, x, stats, scale, bias,
                                       stats if name == "gn_backward_dx" else None) == 32
    wide = torch.zeros(1, 1, 1, 4096)
    wide_stats, ones, zeros = torch.zeros(1, 2, 32), torch.ones(4096), torch.zeros(4096)
    with pytest.raises(ValueError, match="C/G=128"):
        cuda_gn._check_nhwc("gn_group_stats", wide, 32)
    with pytest.raises(ValueError, match="gn_apply: C=4096, G=32: C/G=128"):
        cuda_gn._check_params("gn_apply", wide, wide_stats, ones, zeros)
    for name in ("gn_backward_sums", "gn_backward_dx"):
        with pytest.raises(ValueError, match=f"{name}: C=4096, G=32: C/G=128 is not"):
            cuda_gn._check_backward(name, wide, wide, wide_stats, ones, zeros,
                                    wide_stats if name == "gn_backward_dx" else None)


# ---------------------------------------------------------------------------
# the module at full channel widths (the 32- and 64-channel groups exist only
# there): a 32^2 crop (2 x 2 maps at stride 16), 21 joints, B = 2


CROP, BATCH, SEED = 32, 2, 21
# float32 against JAX: flax's GroupNorm takes E[x^2] - E[x]^2 (its default
# fast variance), the port the exact two-pass statistics; 65 norms deep the
# heads agree to this share of their largest value (measured 4.4e-6)
HEAD_TOL = 1e-4
UVD_TOL = 1e-3            # px and depth units, on a 32-pixel crop (measured 9.5e-6)


@pytest.fixture(scope="module")
def group_a2j():
    """The port's seeded GroupNorm A2J (every norm's affine drawn at random),
    its variables through the port's converter, one batch of crops, and
    JAX's jitted apply and predict on them."""
    cfg = dict(crop_h=CROP, crop_w=CROP)
    model = pa2j.A2JSystem(pconfig.A2JConfig(**cfg), norm="group").eval()
    model.init_weights_(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.weight.shape)
                                                .astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, m.bias.shape)
                                              .astype(np.float32)))
    variables = a2j_variables_from_state_dict(model.state_dict())
    x = rng.uniform(0.3, 1.2, size=(BATCH, CROP, CROP, 1)).astype(np.float32)
    system = ja2j.A2JSystem(jconfig.A2JConfig(**cfg), norm="group")
    heads = jax.jit(lambda v, x: system.apply(v, x))(variables, x)
    uvd = jax.jit(system.predict)(variables, x)
    with torch.no_grad():
        got_heads = model(torch.from_numpy(x))
        got_uvd = model.predict(torch.from_numpy(x))
    return {"model": model, "variables": variables, "x": x, "want_heads": heads,
            "want_uvd": uvd, "heads": got_heads, "uvd": got_uvd}


def test_group_a2j_has_jax_parameters_and_kernel_norms(group_a2j):
    """65 GroupNorms (53 in the backbone, 12 in the towers), C/G 2 to 64,
    eps 1e-6, parameters only (no batch_stats; the tree's names are held
    by ``test_torch_port_train_a2j.py``), and ``use_kernels`` switches
    every norm as it switches the decode."""
    model = group_a2j["model"]
    norms = [(n, m) for n, m in model.named_modules() if isinstance(m, GroupNorm)]
    assert len(norms) == 65
    assert sum(n.startswith("Backbone.") for n, _ in norms) == 53
    widths = {m.weight.numel() // m.num_groups for _, m in norms}
    assert widths == {2, 4, 8, 16, 32, 64} and all(m.eps == 1e-6 for _, m in norms)
    assert set(group_a2j["variables"]) == {"params"}
    assert all(m.use_kernel for _, m in norms)
    model.use_kernels = False
    try:
        assert not any(m.use_kernel for _, m in norms)
        with torch.no_grad():      # on the CPU both paths are the plain versions
            plain = model.predict(torch.from_numpy(group_a2j["x"]))
        assert torch.equal(plain, group_a2j["uvd"])
    finally:
        model.use_kernels = True
    assert all(m.use_kernel for _, m in norms)
    off = pa2j.A2JSystem(pconfig.A2JConfig(crop_h=CROP, crop_w=CROP), use_kernels=False,
                         norm="group")
    assert not any(m.use_kernel for m in off.modules() if isinstance(m, GroupNorm))


@pytest.mark.parametrize("head", ["cls", "reg", "depth"])
def test_group_a2j_heads_match_jax(group_a2j, head):
    got, want = group_a2j["heads"][head], np.asarray(group_a2j["want_heads"][head])
    assert tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    assert_close(got, want, rtol=0, atol=HEAD_TOL * scale, err_msg=head)


def test_group_a2j_predict_matches_jax(group_a2j):
    got, want = group_a2j["uvd"], np.asarray(group_a2j["want_uvd"])
    assert tuple(got.shape) == want.shape == (BATCH, 21, 3)
    assert_close(got, want, rtol=0, atol=UVD_TOL)


def test_group_a2j_weights_round_trip(group_a2j):
    """The port's state dict -> flax variables is what ``convert_a2j`` gives
    (``scale``/``bias`` per norm, no ``batch_stats``), and back exactly; a
    fresh model loads it strictly."""
    sd = group_a2j["model"].state_dict()
    variables = group_a2j["variables"]
    want = convert_a2j({k: v.numpy() for k, v in sd.items()})
    assert not want.pop("batch_stats")
    assert leaves_equal(variables, want)
    back = a2j_state_dict_from_flax(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    pa2j.A2JSystem(pconfig.A2JConfig(crop_h=CROP, crop_w=CROP), norm="group").load_state_dict(
        back, strict=True)


# The gradient of cls + 3 reg (``A2JSystem.losses``, ``a2j_loss`` in float32)
# with respect to every parameter and the crops, against ``jax.grad`` through
# JAX's module (jitted, backend optimization off): float32 on both sides,
# each tensor to GRAD_TOL of its largest |value| (measured: 1.1e-5 at most
# over the 213 parameter tensors, 6.4e-6 for the crops; flax's fast
# variance and the port's two-pass statistics, and the backward's sums in
# another order, 65 norms deep). The loss to LOSS_TOL relative.
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


class _OpLog(TorchDispatchMode):
    """How often each ``handnet_torch`` op reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "handnet_torch":
            name = func.__name__.split(".")[0]
            self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def group_a2j_grad(group_a2j):
    """The port's loss and gradients (train mode, grad on: the forward
    through K2s's and K2a's ops, the backward through K2r's and K2d's; on
    the CPU their plain versions) on the module's crops and seeded targets,
    the parameters' gradients as flax trees (the port's converter), and
    JAX's ``value_and_grad`` of the same loss."""
    model, variables, x = group_a2j["model"], group_a2j["variables"], group_a2j["x"]
    rng = np.random.default_rng(SEED + 1)
    gt = np.concatenate([rng.uniform(0, CROP, size=(BATCH, 21, 2)),
                         rng.uniform(0.3, 1.2, size=(BATCH, 21, 1))], -1).astype(np.float32)
    system = ja2j.A2JSystem(jconfig.A2JConfig(crop_h=CROP, crop_w=CROP), norm="group")

    def jloss(params, crops):
        heads = system.apply({"params": params}, crops, train=True)
        cls, reg = ja2j.a2j_loss(heads, jnp.asarray(gt), system.anchors,
                                 system.cfg.spatial_factor)
        return cls + 3.0 * reg

    args = (variables["params"], jnp.asarray(x))
    loss, (want, want_x) = fast_compile(jax.value_and_grad(jloss, argnums=(0, 1)),
                                        *args)(*args)
    names, params = zip(*model.named_parameters())
    crops = torch.from_numpy(x).requires_grad_()
    model.train()
    try:
        with _OpLog() as log:
            total = model.losses(model(crops), torch.from_numpy(gt))["total_loss"]
            *grads, grad_x = torch.autograd.grad(total, [*params, crops])
    finally:
        model.eval()
    got = a2j_variables_from_state_dict(dict(zip(names, grads)))["params"]
    return {"loss": total.item(), "want_loss": float(loss), "grads": got, "want": want,
            "grad_x": grad_x, "want_x": np.asarray(want_x), "ops": log.ops}


@pytest.mark.parametrize("part", ["backbone", "classification", "regression", "depth"])
def test_group_a2j_gradient_matches_jax(group_a2j_grad, part):
    got, want = group_a2j_grad["grads"][part], group_a2j_grad["want"][part]
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(np.shape(g)) == w.shape
        assert_close(g, w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()),
                     err_msg=f"{part}{jax.tree_util.keystr(path)}")


def test_group_a2j_crop_gradient_and_loss_match_jax(group_a2j_grad):
    assert abs(group_a2j_grad["loss"] - group_a2j_grad["want_loss"]) <= LOSS_TOL * abs(
        group_a2j_grad["want_loss"])
    want = group_a2j_grad["want_x"]
    got = group_a2j_grad["grad_x"]
    assert tuple(got.shape) == want.shape == (BATCH, CROP, CROP, 1)
    assert_close(got, want, rtol=0, atol=GRAD_TOL * float(np.abs(want).max()))


def test_group_a2j_backward_runs_the_four_ops(group_a2j_grad):
    """One forward and backward of the loss: each of the 65 GroupNorms
    through ``gn_group_stats`` and ``gn_apply`` forward and
    ``gn_backward_sums`` and ``gn_backward_dx`` backward (the crops and the
    weights require grad, so every norm's dx is wanted), no plain gradient
    registered on the forward ops in their place, and no decode (the loss
    takes the einsums)."""
    assert group_a2j_grad["ops"] == {"gn_group_stats": 65, "gn_apply": 65,
                                     "gn_backward_sums": 65, "gn_backward_dx": 65}


@pytest.mark.parametrize("quant", [True, "static"])
def test_group_a2j_builds_with_int8(quant):
    """``A2J(norm="group", quant=...)`` builds as JAX's does: int8 residual
    and tower convs, the same norms and float parameters as the float model."""
    cfg = pconfig.A2JConfig(crop_h=CROP, crop_w=CROP, quant=quant)
    model = pa2j.A2J(cfg, norm="group")
    float_model = pa2j.A2J(pconfig.A2JConfig(crop_h=CROP, crop_w=CROP), norm="group")
    assert ({n for n, _ in model.named_parameters()}
            == {n for n, _ in float_model.named_parameters()})
    assert sum(isinstance(m, GroupNorm) for m in model.modules()) == 65


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_heads_take_norm_relu_without_changing_bits(norm):
    """The towers call ``norm_relu``; for the batch norms it is
    ``relu(norm(x))``, the bits of the towers before it."""
    head = pa2j.A2JHead(64, 16, features=32, norm=norm).eval()
    torch.manual_seed(3)
    x = torch.randn(2, 64, 5, 5)
    with torch.no_grad():
        for i in range(1, 5):
            getattr(head, f"bn{i}").running_var.uniform_(0.5, 1.5)
        got = head(x)
        y = x
        for i in range(1, 5):
            y = torch.relu(getattr(head, f"bn{i}")(getattr(head, f"conv{i}")(y)))
        assert torch.equal(got, head.output(y))
