"""Kernels K1 (A2J decode) and K2 (GroupNorm statistics) of the PyTorch port:
their plain PyTorch versions against the JAX package's Pallas kernels (run
in interpret mode, as tests/test_pallas_a2j.py and tests/test_pallas_gn.py
run them on the CPU) and against the einsum / flax GroupNorm they replace.

The CUDA kernels themselves build and run only on a card; chip_smoke.py
compares them with these plain versions there. Here we check that a CPU
tensor takes the plain version without counting a launch, and that nothing
falls back quietly.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu.config import A2JConfig
from handnet_tpu.models.a2j import a2j_postprocess
from handnet_tpu.models.a2j import anchors_for as jax_a2j_anchors
from handnet_tpu.ops.pallas_a2j import a2j_decode_pallas
from handnet_tpu.ops.pallas_gn import gn_group_stats as pallas_gn_stats
from handnet_tpu_torch.kernels import build
from handnet_tpu_torch.ops import cuda_a2j, cuda_gn
from torch_port_fixtures import assert_close


def _a2j_inputs(crop, joints, batch, seed):
    cfg = A2JConfig(crop_h=crop, crop_w=crop, num_joints=joints)
    n = cfg.feat_h * cfg.feat_w * cfg.num_anchors
    rng = np.random.default_rng(seed)
    cls = (rng.normal(size=(batch, n, joints)) * 2).astype(np.float32)
    reg = (rng.normal(size=(batch, n, joints, 2)) * 5).astype(np.float32)
    depth = rng.normal(size=(batch, n, joints)).astype(np.float32)
    return cls, reg, depth, np.asarray(jax_a2j_anchors(cfg))


# Shapes of tests/test_pallas_a2j.py plus the fast profile's N = 11*11*16 =
# 1936, P = 21 at B = 2. Tolerance 1e-4 (as there): both sides upcast the
# same (possibly bf16-rounded) inputs to float32; only the summation order
# differs.
@pytest.mark.parametrize("crop,joints,batch,dtype", [
    (64, 8, 2, "float32"),
    (32, 4, 1, "bfloat16"),
    (176, 21, 2, "float32"),
    (176, 21, 2, "bfloat16"),
])
def test_a2j_decode_plain_matches_pallas_and_einsum(crop, joints, batch, dtype):
    cls, reg, depth, anchors = _a2j_inputs(crop, joints, batch, seed=crop + joints)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcls, jreg, jdep = (jnp.asarray(a).astype(jdt) for a in (cls, reg, depth))
    pallas = np.asarray(a2j_decode_pallas(jcls, jreg, jdep, jnp.asarray(anchors),
                                          interpret=True))
    einsum = np.asarray(a2j_postprocess({"cls": jcls, "reg": jreg, "depth": jdep},
                                        jnp.asarray(anchors)))
    tcls, treg, tdep = (torch.from_numpy(a).to(tdt) for a in (cls, reg, depth))
    got = cuda_a2j.a2j_decode_reference(tcls, treg, tdep, torch.from_numpy(anchors))
    assert got.dtype == torch.float32 and got.shape == (batch, joints, 3)
    assert_close(got, pallas, rtol=1e-4, atol=1e-4)
    assert_close(got, einsum, rtol=1e-4, atol=1e-4)


# K1xy, the 2D A2J's decode: its plain version against the einsum that the
# JAX package's 2D decode is (models/a2j.py:145-153), 1e-4 as above.
@pytest.mark.parametrize("crop,joints,batch,dtype", [
    (64, 8, 2, "float32"),
    (176, 21, 2, "bfloat16"),
])
def test_a2j_decode_xy_plain_matches_einsum(crop, joints, batch, dtype):
    cls, reg, _, anchors = _a2j_inputs(crop, joints, batch, seed=crop + joints + 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcls, jreg = (jnp.asarray(a).astype(jdt) for a in (cls, reg))
    einsum = np.asarray(a2j_postprocess({"cls": jcls, "reg": jreg}, jnp.asarray(anchors)))
    tcls, treg = (torch.from_numpy(a).to(tdt) for a in (cls, reg))
    got = cuda_a2j.a2j_decode_xy_reference(tcls, treg, torch.from_numpy(anchors))
    assert got.dtype == torch.float32 and got.shape == (batch, joints, 2)
    assert_close(got, einsum, rtol=1e-4, atol=1e-4)


# K1xy's staging: the main path's (N, P), an unaligned pair and a long N, as
# K1's cases in tests/test_torch_port_gn.py; without depth a chunk stages
# three values per element, so it holds at least K1's anchors.
@pytest.mark.parametrize("n,p,itemsize,batch", [
    (1936, 21, 2, 128), (1936, 21, 2, 1), (1936, 21, 4, 8),
    (50, 7, 2, 3), (333, 5, 4, 1), (7744, 21, 4, 128),
])
def test_a2j_xy_flat_copies_cover_each_element_once(n, p, itemsize, batch):
    plan = cuda_a2j.decode_plan(batch, n, p, itemsize, 132, depth=False)
    plan_3d = cuda_a2j.decode_plan(batch, n, p, itemsize, 132)
    assert plan._replace(chunk=0) == plan_3d._replace(chunk=0)   # the same blocks
    assert plan.chunk >= plan_3d.chunk and plan.chunk % plan.vec == 0
    assert plan.chunk * p * 3 * itemsize <= 42 * 1024
    if plan.per_split > plan.chunk:   # a chunk of K1xy is as large as 42 KB allows
        assert (plan.chunk + plan.vec) * p * 3 * itemsize > 42 * 1024
    copied, read, read_joint = cuda_a2j.staged_elements(plan, n, p, depth=False)
    flat = np.arange(n * p)
    assert np.array_equal(np.sort(copied), flat)
    assert np.array_equal(np.sort(read), flat)
    assert np.array_equal(read % p, read_joint)


def test_a2j_staged_streams_start_on_whole_copies():
    """The transcription refuses a plan whose staged streams (cls, depth,
    reg) would not start on a whole 16-byte copy in shared memory."""
    plan = cuda_a2j.decode_plan(8, 1936, 21, 2, 132)
    with pytest.raises(AssertionError, match="does not start"):
        cuda_a2j.staged_elements(plan._replace(chunk=plan.chunk - 1), 1936, 21, depth=False)
    with pytest.raises(AssertionError, match="does not start"):
        cuda_a2j.staged_elements(plan._replace(chunk=plan.chunk - 1), 1936, 21)


def _ref_stats(x, groups):
    b, h, w, c = x.shape
    g = x.astype(np.float64).reshape(b, h * w, groups, c // groups)
    return g.mean(axis=(1, 3)), g.var(axis=(1, 3))


# Shapes and tiles of tests/test_pallas_gn.py: the fast profile's P3 level
# (ragged 4800/1024 tiles), a single short tile, exact tiles plus a ragged
# tail, exact division. Tolerance 1e-5, as there (float32 summation order).
@pytest.mark.parametrize("shape,tile", [
    ((2, 60, 80, 256), 1024),
    ((3, 4, 5, 256), 1024),
    ((2, 30, 40, 128), 256),
    ((1, 8, 16, 256), 128),
])
def test_gn_stats_plain_matches_pallas(shape, tile):
    x = np.random.default_rng(7).normal(2.0, 3.0, size=shape).astype(np.float32)
    got = cuda_gn.gn_group_stats_reference(torch.from_numpy(x), 32).numpy()
    pallas = np.asarray(pallas_gn_stats(jnp.asarray(x), 32, tile=tile, interpret=True))
    mean, var = _ref_stats(x, 32)
    assert got.shape == (shape[0], 2, 32) and got.dtype == np.float32
    assert_close(got, pallas, rtol=1e-5, atol=1e-5)
    assert_close(got[:, 0], mean, rtol=1e-5, atol=1e-5)
    assert_close(got[:, 1], var, rtol=1e-5, atol=1e-5)


def test_gn_stats_plain_large_offset_stability():
    """mean >> std: the regime where E[x^2]-E[x]^2 loses all precision in
    float32; the two-pass form keeps the variance (tolerances as
    tests/test_pallas_gn.py:48-57)."""
    x = (1000.0 + 0.1 * np.random.default_rng(8).normal(size=(2, 30, 40, 256))
         ).astype(np.float32)
    got = cuda_gn.gn_group_stats_reference(torch.from_numpy(x), 32).numpy()
    pallas = np.asarray(pallas_gn_stats(jnp.asarray(x), 32, tile=256, interpret=True))
    mean, var = _ref_stats(x, 32)
    assert_close(got[:, 0], mean, rtol=1e-6, atol=0)
    assert_close(got[:, 1], var, rtol=1e-2, atol=0)
    assert_close(got[:, 1], pallas[:, 1], rtol=1e-2, atol=0)
    assert (got[:, 1] > 0).all()


# float32 to 1e-5 (summation order only); bf16 to 3e-2 — both sides round
# their outputs to bf16, one bf16 ulp at |y| ~ 4 is 1.6e-2 (as
# tests/test_pallas_gn.py:60-76).
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_group_norm_matches_flax(dtype, tol):
    rng = np.random.default_rng(9)
    x = rng.normal(1.0, 2.0, size=(2, 15, 20, 256)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(256,)).astype(np.float32)
    bias = rng.normal(size=(256,)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=getattr(jnp, dtype),
                       use_fast_variance=False)
    want = gn.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = cuda_gn.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.float(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_wrappers_take_plain_path_on_cpu():
    """A CPU tensor runs the plain version and counts no kernel launch."""
    gn_before = cuda_gn.gn_group_stats.launches
    a2j_before = cuda_a2j.a2j_decode.launches
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 6, 5, 64))
                         .astype(np.float32))
    assert torch.equal(cuda_gn.gn_group_stats(x, 32),
                       cuda_gn.gn_group_stats_reference(x, 32))
    cls, reg, depth, anchors = (torch.from_numpy(a) for a in _a2j_inputs(32, 4, 2, 3))
    assert torch.equal(cuda_a2j.a2j_decode(cls, reg, depth, anchors),
                       cuda_a2j.a2j_decode_reference(cls, reg, depth, anchors))
    assert cuda_gn.gn_group_stats.launches == gn_before
    assert cuda_a2j.a2j_decode.launches == a2j_before


def test_a2j_decode_xy_takes_plain_path_on_cpu_and_refuses_other_devices():
    """K1xy's wrapper: a CPU tensor runs the plain version (the u, v of K1's
    plain version on the same heads) and counts no launch; a meta tensor
    raises."""
    before = cuda_a2j.a2j_decode_xy.launches
    cls, reg, depth, anchors = (torch.from_numpy(a) for a in _a2j_inputs(32, 4, 2, 3))
    got = cuda_a2j.a2j_decode_xy(cls, reg, anchors)
    assert torch.equal(got, cuda_a2j.a2j_decode_xy_reference(cls, reg, anchors))
    assert torch.equal(got, cuda_a2j.a2j_decode_reference(cls, reg, depth, anchors)[..., :2])
    assert cuda_a2j.a2j_decode_xy.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_a2j.a2j_decode_xy(torch.empty((1, 16, 4), device="meta"),
                               torch.empty((1, 16, 4, 2), device="meta"),
                               torch.empty((16, 2), device="meta"))


def test_wrappers_refuse_other_devices():
    """Dispatch is by device: anything but CPU or CUDA raises."""
    x = torch.empty((2, 4, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gn.gn_group_stats(x, 32)
    cls = torch.empty((1, 16, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_a2j.a2j_decode(cls, torch.empty((1, 16, 4, 2), device="meta"),
                            torch.empty((1, 16, 4), device="meta"),
                            torch.empty((16, 2), device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No quiet fallback: without nvcc the build raises a clear error and
    returns no plain stand-in."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    build.load_library.cache_clear()
    try:
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
    assert not (tmp_path / "build").exists()
