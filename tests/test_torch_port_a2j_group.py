"""A2J with GroupNorm (``A2JSystem(norm="group")``) in the port, and K2s and
K2a at the wide groups it needs, on the CPU.

A2J's GroupNorm(32) runs at C/G = 2 to 64: layer3's 1024-channel outputs
have 32-channel groups, layer4's 2048-channel outputs 64-channel groups, and
a float32 row of 2048 channels is 512 chunks of 16 bytes, one row a block.
The kernels run only on a card (``chip_smoke.py``'s ``[a2j_group]`` holds
them against their plain versions there). Here: the plans and the Python
transcription of K2s's walk at those widths against the plain versions and
the JAX package's ``gn_group_stats``/``pallas_group_norm`` in interpret
mode; the width checks of the forward and backward kernels; and the whole
module at full channel widths against JAX's ``A2JSystem(norm="group")``,
with weights from the port's seeded init carried to flax by the port's
converter and JAX's apply jitted. Everything runs on one torch thread.
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
from torch_port_fixtures import assert_close, leaves_equal

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
    """K2s's and K2a's plans take rows of 1024 and 2048 channels: a float32
    row of 2048 is 512 chunks, one pixel row a block of 512 threads; every
    other row stays within 256 threads. K2r's and K2d's plans (256 chunks at
    most) refuse the 512-chunk row."""
    hw = 121
    cp = channels * itemsize // 16
    for unroll, target in ((cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM),
                           (cuda_gn.APPLY_UNROLL, cuda_gn.APPLY_BLOCKS_PER_SM)):
        plan = cuda_gn.row_plan(batch, hw, channels, itemsize, H100_SMS, unroll, target,
                                cuda_gn._MAX_ROW_CHUNKS)
        assert plan.cp == cp and plan.rows == max(1, 256 // cp)
        assert plan.rows * plan.cp <= (512 if cp > 256 else 256)
        assert (plan.splits - 1) * plan.per_split < hw <= plan.splits * plan.per_split
        assert plan.per_split % (plan.rows * unroll) == 0
        assert batch * plan.splits >= H100_SMS or plan.per_split == plan.rows * unroll
    if cp > 256:
        with pytest.raises(ValueError, match="at most 4096"):
            cuda_gn.row_plan(batch, hw, channels, itemsize, H100_SMS, cuda_gn.SUMS_UNROLL,
                             cuda_gn.SUMS_BLOCKS_PER_SM)


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
    """The forward kernels' check takes C/G = 32 and 64; the backward's (K2r,
    K2d, not widened) raises ``ValueError`` naming the width, where the launch
    would otherwise fail with a bare CUDA error. A width no kernel has (128)
    is refused by both."""
    k = channels // 32
    x = torch.zeros(2, 3, 3, channels)
    stats = torch.zeros(2, 2, 32)
    scale, bias = torch.ones(channels), torch.zeros(channels)
    cuda_gn._check_nhwc("gn_group_stats", x, 32)
    assert cuda_gn._check_params("gn_apply", x, stats, scale, bias) == 32
    for name in ("gn_backward_sums", "gn_backward_dx"):
        with pytest.raises(ValueError, match=f"{name}: C={channels}, G=32: C/G={k} is not"):
            cuda_gn._check_backward(name, x, x, stats, scale, bias,
                                    stats if name == "gn_backward_dx" else None)
    with pytest.raises(ValueError, match="C/G=128"):
        cuda_gn._check_nhwc("gn_group_stats", torch.zeros(1, 1, 1, 4096), 32)


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
