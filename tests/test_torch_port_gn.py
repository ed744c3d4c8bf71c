"""The redesigned GroupNorm (K2s statistics + K2a normalize/affine/ReLU) and
A2J decode (K1) of the PyTorch port, as far as the CPU reaches them.

The CUDA kernels run only on a card (chip_smoke.py holds them against their
plain versions there). Here: the plain versions against flax GroupNorm and
the JAX package's ``pallas_group_norm`` (interpret mode), the Python
transcriptions of the kernels' walks (K2s's split of HW and ordered fold,
K1's flat staged copies) against the plain versions and for coverage, the
plans that cut the work into blocks, and the FCOS tower with the ReLU fused
into its GroupNorm against the unfused tower.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from handnet_tpu.ops.pallas_gn import pallas_group_norm
from handnet_tpu_torch.models import fcos as pfcos
from handnet_tpu_torch.ops import cuda_a2j, cuda_gn
from torch_port_fixtures import assert_close

H100_SMS = 132


def _gn_inputs(shape=(2, 15, 20, 256), seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    return x, scale, bias


# float32 to 1e-5 (summation order only); bf16 to 3e-2: both sides round their
# outputs to bf16, one bf16 ulp at |y| ~ 4 is 1.6e-2 (as tests/test_pallas_gn.py).
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_group_norm_relu_matches_flax_and_pallas(dtype, tol):
    x, scale, bias = _gn_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jdt, use_fast_variance=False)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    flax_out = jax.nn.relu(gn.apply(params, jx))
    pallas_out = jax.nn.relu(pallas_group_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 32,
                                               interpret=True))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    got = cuda_gn.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32,
                             relu=True)
    assert got.dtype == tdt and float(got.min()) == 0.0
    assert_close(got.float(), np.asarray(flax_out, np.float32), rtol=tol, atol=tol)
    assert_close(got.float(), np.asarray(pallas_out, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_paths_agree_on_cpu(relu):
    """On the CPU the wrappers, ``use_kernel=False`` and the plain versions
    are one computation; a launch is counted nowhere."""
    x, scale, bias = (torch.from_numpy(a) for a in _gn_inputs((2, 6, 5, 64), seed=1))
    before = cuda_gn.gn_group_stats.launches, cuda_gn.gn_apply.launches
    want = cuda_gn.group_norm_reference(x, scale, bias, 32, relu=relu)
    stats = cuda_gn.gn_group_stats(x, 32)
    assert torch.equal(cuda_gn.group_norm(x, scale, bias, 32, relu=relu), want)
    assert torch.equal(cuda_gn.group_norm(x, scale, bias, 32, relu=relu, use_kernel=False),
                       want)
    assert torch.equal(cuda_gn.gn_apply(x, stats, scale, bias, relu=relu), want)
    assert torch.equal(cuda_gn.gn_apply_reference(x, stats, scale, bias, relu=relu), want)
    if relu:
        assert torch.equal(want, torch.relu(cuda_gn.group_norm_reference(x, scale, bias, 32)))
    assert (cuda_gn.gn_group_stats.launches, cuda_gn.gn_apply.launches) == before


def test_gn_apply_refuses_other_devices():
    x = torch.empty((2, 4, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gn.gn_apply(x, torch.empty((2, 2, 32), device="meta"),
                         torch.empty(64, device="meta"), torch.empty(64, device="meta"))


# (B, H, W, C), groups, dtype, batch the plan is made for. HW = 300 = 15 x 20
# leaves a ragged last split (4 x 64 + 44 pixels); C/G = 8 is one bf16 chunk,
# two float32 chunks; C/G = 2 and 4 put several groups into one chunk; C/G =
# 16 spans two bf16 chunks and four float32 chunks.
_SPLIT_CASES = [
    ((2, 15, 20, 256), 32, "bfloat16", 128),
    ((2, 15, 20, 256), 32, "float32", 128),
    ((2, 15, 20, 256), 32, "bfloat16", 1),
    ((1, 60, 80, 256), 32, "bfloat16", 1),
    ((2, 30, 40, 64), 32, "bfloat16", 8),
    ((2, 30, 40, 128), 32, "float32", 8),
    ((2, 9, 7, 512), 32, "bfloat16", 2),
    ((2, 9, 7, 512), 32, "float32", 2),
]


# Tolerance 1e-4 of the statistics' scale, the card's: float32 reductions of
# up to 38,400 values in another order than the plain version's.
@pytest.mark.parametrize("shape,groups,dtype,plan_batch", _SPLIT_CASES)
def test_stats_split_emulation_matches_plain(shape, groups, dtype, plan_batch):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(2.0, 3.0, size=shape).astype(np.float32)
                         ).to(getattr(torch, dtype))
    hw = shape[1] * shape[2]
    plan = cuda_gn.row_plan(plan_batch, hw, shape[3], x.element_size(), H100_SMS,
                            cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM)
    if hw == 300:
        assert plan.splits > 1 and hw % plan.per_split  # a ragged last split
    got = cuda_gn.gn_stats_split_emulation(x, groups, plan)
    want = cuda_gn.gn_group_stats_reference(x, groups)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert_close(got, want, rtol=0, atol=tol)


def test_stats_split_emulation_large_offset_stability():
    """mean >> std over splits: the Chan folds keep the variance that
    E[x^2]-E[x]^2 would lose (tolerances as the card's check)."""
    x = torch.from_numpy((1000.0 + 0.1 * np.random.default_rng(8).normal(
        size=(2, 15, 20, 256))).astype(np.float32))
    plan = cuda_gn.row_plan(8, 300, 256, 4, H100_SMS, cuda_gn.STATS_UNROLL,
                            cuda_gn.STATS_BLOCKS_PER_SM)
    got = cuda_gn.gn_stats_split_emulation(x, 32, plan)
    g = x.double().reshape(2, 300, 32, 8)
    assert_close(got[:, 0], g.mean(dim=(1, 3)), rtol=0, atol=2e-3)
    assert_close(got[:, 1], g.var(dim=(1, 3), unbiased=False), rtol=1e-2, atol=0)
    assert bool((got[:, 1] > 0).all())


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("hw", [4800, 1200, 300])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_row_plans_cover_hw_and_fill_the_card(batch, hw, itemsize):
    for unroll, target in ((cuda_gn.STATS_UNROLL, cuda_gn.STATS_BLOCKS_PER_SM),
                           (cuda_gn.APPLY_UNROLL, cuda_gn.APPLY_BLOCKS_PER_SM)):
        plan = cuda_gn.row_plan(batch, hw, 256, itemsize, H100_SMS, unroll, target)
        assert plan.cp * 16 == 256 * itemsize and 32 <= plan.rows * plan.cp <= 256
        assert (plan.splits - 1) * plan.per_split < hw <= plan.splits * plan.per_split
        assert plan.per_split % (plan.rows * unroll) == 0    # whole unrolled trips
        # the SMs are filled, or every block is down to a single trip
        assert (batch * plan.splits >= H100_SMS
                or plan.per_split == plan.rows * unroll)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        cuda_gn.row_plan(1, 64, 100, 2, H100_SMS, 8, 8)


# The main path's (N, P), an odd pair whose flat run is no whole number of
# 16-byte words (element-wise staging), and a long N that needs several chunks.
@pytest.mark.parametrize("n,p,itemsize,batch", [
    (1936, 21, 2, 128), (1936, 21, 2, 1), (1936, 21, 4, 8),
    (50, 7, 2, 3), (333, 5, 4, 1), (7744, 21, 4, 128),
])
def test_a2j_flat_copies_cover_each_element_once(n, p, itemsize, batch):
    plan = cuda_a2j.decode_plan(batch, n, p, itemsize, H100_SMS)
    assert plan.vec == (16 // itemsize if (n * p) % (16 // itemsize) == 0 else 1)
    assert plan.rows * p <= 512
    assert (plan.splits - 1) * plan.per_split < n <= plan.splits * plan.per_split
    assert plan.per_split % plan.vec == 0 and plan.chunk % plan.vec == 0
    assert plan.chunk * p * 4 * itemsize <= 42 * 1024
    copied, read, read_joint = cuda_a2j.staged_elements(plan, n, p)
    flat = np.arange(n * p)
    assert np.array_equal(np.sort(copied), flat)     # every (anchor, joint) copied once
    assert np.array_equal(np.sort(read), flat)       # and read once,
    assert np.array_equal(read % p, read_joint)      # by a thread that owns its joint
    if (n, p, batch) == (1936, 21, 128):
        assert plan.vec == 8 and plan.splits * batch == 1024    # two waves of 4 x 132
    if (n, p, batch) == (1936, 21, 1):
        assert plan.splits > 1                       # a B=1 call is more than one block


def test_a2j_decode_plan_refuses_unaligned_vectors_and_sizes():
    assert cuda_a2j.decode_plan(8, 1936, 21, 2, H100_SMS, aligned=False).vec == 1
    with pytest.raises(ValueError, match="unsupported sizes"):
        cuda_a2j.decode_plan(1, 16, 513, 4, H100_SMS)


def _unfused_tower(channels, num_convs):
    """The tower as it was: [conv, GroupNorm, ReLU] triplets."""
    layers = []
    for _ in range(num_convs):
        layers += [nn.Conv2d(channels, channels, 3, padding=1),
                   pfcos.GroupNorm(32, channels), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tower_with_fused_relu_equals_unfused_tower(dtype):
    """Same state-dict keys (0, 1, 3, 4, ...: the reference's triplet
    numbers), same output bits on the CPU."""
    torch.manual_seed(0)
    old = _unfused_tower(64, 3)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, param in old.named_parameters():
            if name.split(".")[0] in ("1", "4", "7"):   # the GroupNorms
                param.copy_(torch.from_numpy(rng.normal(1.0, 0.5, size=param.shape)
                                             .astype(np.float32)))
    new = pfcos.ConvTower(64, 3)
    assert list(new.state_dict()) == list(old.state_dict()) == [
        f"{i}.{leaf}" for i in (0, 1, 3, 4, 6, 7) for leaf in ("weight", "bias")]
    new.load_state_dict(old.state_dict(), strict=True)
    assert [type(m).__name__ for m in new] == ["Conv2d", "GroupNorm"] * 3
    assert all(m.relu for m in new if isinstance(m, pfcos.GroupNorm))
    old, new = old.to(dtype), new.to(dtype)
    x = torch.from_numpy(rng.normal(size=(2, 64, 9, 7)).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = old(x.clone()), new(x.clone())
    assert got.dtype == dtype and float(got.min()) == 0.0
    assert torch.equal(got, want)
