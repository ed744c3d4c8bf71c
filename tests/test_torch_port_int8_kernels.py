"""The two steps of the port's int8 conv (``handnet_tpu_torch/ops/cuda_int8_conv.py``:
K3q ``int8_quantize``, K3g ``int8_conv_gemm``) where there is no card.

The CUDA kernels build and run only on a card, where chip_smoke.py holds them
bit for bit against the plain versions used here. These tests check what the
CPU can: that the two wrappers compose to the one-piece plain version bit for
bit; that each step agrees with jitted JAX on the same numpy inputs (the
quantized integers and the int32 sums exactly, the float32 epilogue to rtol
1e-6: the same operations in the same order); and that the geometry the host
hands to TMA's im2col mode, and the tile and tap arithmetic transcribed from
the kernel, gather exactly the NHWC im2col of the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from handnet_tpu_torch.ops import cuda_int8_conv as k3
from torch_port_fixtures import assert_close

# (kernel, stride, padding, dilation): the five classes of the int8 path
CLASSES = {
    "1x1_s1": (1, 1, 0, 1),
    "1x1_s2": (1, 2, 0, 1),
    "3x3_s1_p1": (3, 1, 1, 1),
    "3x3_s2_p1": (3, 2, 1, 1),
    "3x3_s1_p2_d2": (3, 1, 2, 2),
}


def _operands(seed, k, batch=3, h=9, w=11, cin=64, cout=128):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, h, w, cin)) * 3).astype(np.float32)
    x[1] *= 0.25
    wq = rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)
    sw = rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, wq, sw, bias


def _scales(x, per_sample):
    amax = np.abs(x).max(axis=(1, 2, 3)) if per_sample else np.float32(0.8 * np.abs(x).max())
    return (amax / np.float32(127)).astype(np.float32)


@pytest.mark.parametrize("per_sample", [False, True], ids=["per_layer", "per_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_two_steps_equal_the_plain_conv(name, dtype, per_sample):
    """quantize, int32 conv of q, dequantize — through the two wrappers and
    written out — equal int8_conv_reference bit for bit."""
    k, s, p, d = CLASSES[name]
    x, wq, sw, bias = _operands(list(CLASSES).index(name), k)
    xt = torch.from_numpy(x).to(dtype)
    sx = torch.from_numpy(np.asarray(_scales(x, per_sample)))
    wqt, swt, bt = torch.from_numpy(wq), torch.from_numpy(sw), torch.from_numpy(bias)
    geom = ((s, s), (p, p), (d, d))
    want = k3.int8_conv_reference(xt, wqt, sx, swt, bt, *geom)
    q = k3.int8_quantize(xt, sx)
    assert q.dtype == torch.int8 and torch.equal(q, k3.quantize_activation(xt, sx))
    got = k3.int8_conv_gemm(q, wqt, sx, swt, bt, *geom, dtype)
    written_out = k3.dequantize(k3.int8_conv_int32_reference(q, wqt, *geom), sx, swt, bt)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(written_out.to(dtype), want)
    assert torch.equal(k3.int8_conv(xt, wqt, sx, swt, bt, *geom), want)


@pytest.mark.parametrize("per_sample", [False, True], ids=["per_layer", "per_sample"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_matches_jax(dtype, per_sample):
    """K3q's function against jitted JAX: clip(round(x / sx)) as int8, with
    values on .5 ties (round half to even) and beyond the clip range."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 5, 6, 64)) * 40).astype(np.float32)
    x[0, 0, 0, :6] = [0.5, 1.5, 2.5, -2.5, 200.0, -300.0]
    sx = np.asarray([1.0, 0.37], np.float32) if per_sample else np.float32(1.0)
    jx = jnp.asarray(x).astype(dtype)
    scale = jnp.asarray(sx).reshape(-1, 1, 1, 1) if per_sample else jnp.asarray(sx)
    want = jax.jit(lambda v, s: jnp.clip(jnp.round(v.astype(jnp.float32) / s), -127, 127)
                   .astype(jnp.int8))(jx, scale)
    got = k3.int8_quantize(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(np.asarray(sx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 0, :6].tolist() == [0, 2, 2, -2, 127, -127]


@pytest.mark.parametrize("name", list(CLASSES))
def test_int8_conv_gemm_matches_jax(name):
    """K3g's function against jitted JAX on the same int8 operands: XLA's
    int8 conv_general_dilated with int32 sums, then the JAX package's
    epilogue. Tolerance rtol 1e-6 of the float32 result (the integer sums are
    exact on both sides)."""
    k, s, p, d = CLASSES[name]
    x, wq, sw, bias = _operands(30 + list(CLASSES).index(name), k)
    sx = _scales(x, per_sample=True)
    q = k3.quantize_activation(torch.from_numpy(x), torch.from_numpy(sx))

    def jax_side(q, w, sx, sw, bias):
        acc = jax.lax.conv_general_dilated(
            q, w, window_strides=(s, s), padding=((p, p), (p, p)), rhs_dilation=(d, d),
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        return acc, acc.astype(jnp.float32) * (sx.reshape(-1, 1, 1, 1) * sw) + bias

    acc, want = jax.jit(jax_side)(jnp.asarray(q.numpy()), jnp.asarray(wq.transpose(1, 2, 3, 0)),
                                  jnp.asarray(sx), jnp.asarray(sw), jnp.asarray(bias))
    geom = ((s, s), (p, p), (d, d))
    got_acc = k3.int8_conv_int32_reference(q, torch.from_numpy(wq), *geom)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    got = k3.int8_conv_gemm(q, torch.from_numpy(wq), torch.from_numpy(sx), torch.from_numpy(sw),
                            torch.from_numpy(bias), *geom, torch.float32)
    assert_close(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def _im2col(q, k, s, p, d):
    """NHWC im2col as int8_conv_int32_reference builds it: [M, k*k*C]."""
    b, h, w, c = q.shape
    ho, wo = k3.output_size(h, w, k, k, (s, s), (p, p), (d, d))
    qp = F.pad(q, (0, 0, p, p, p, p))
    taps = [qp[:, ky * d: ky * d + (ho - 1) * s + 1: s, kx * d: kx * d + (wo - 1) * s + 1: s]
            for ky in range(k) for kx in range(k)]
    return torch.cat(taps, dim=-1).reshape(b * ho * wo, k * k * c), ho, wo


# odd map sizes, a map smaller than one 128-pixel tile (5x4, three images in
# one tile), and tiles that start mid-row and run across images
@pytest.mark.parametrize("batch,h,w", [(2, 9, 11), (3, 5, 4), (2, 15, 20), (5, 11, 11)],
                         ids=["9x11", "5x4", "15x20", "11x11"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_tma_im2col_geometry_reproduces_im2col(name, batch, h, w):
    """Gathering q through the tensor map's geometry (bounding box corners,
    traversal strides, per-tap offsets, the tile's start pixel; zeros outside
    the image and past the last one) gives the plain version's im2col, tile
    by tile, tap by tap, for both channel tiles."""
    k, s, p, d = CLASSES[name]
    rng = np.random.default_rng(h * w + k + s + d)
    channels = 128
    q = torch.from_numpy(rng.integers(-127, 128, (batch, h, w, channels), dtype=np.int8))
    cols, ho, wo = _im2col(q, k, s, p, d)
    geo = k3.im2col_geometry(k, k, (s, s), (p, p), (d, d))
    assert geo.traversal == (s, s) and len(geo.offsets) == k * k
    # the bounding box holds exactly the output's base pixels
    for size, lo, up, n_out in ((h, geo.lower[0], geo.upper[0], ho),
                                (w, geo.lower[1], geo.upper[1], wo)):
        assert len(range(lo, size + up, s)) == n_out
    m = batch * ho * wo
    for m0 in range(0, m, k3.TILE_M):
        start = k3.tile_start(m0, ho, wo, geo)
        live = min(k3.TILE_M, m - m0)
        for tap, offset in enumerate(geo.offsets):
            for c0 in (0, 64):
                got = k3.tma_im2col_gather(q, geo, start, offset, c0, 64)
                want = torch.zeros((k3.TILE_M, 64), dtype=torch.int8)
                want[:live] = cols[m0:m0 + live, tap * channels + c0: tap * channels + c0 + 64]
                assert torch.equal(got, want), (m0, tap, c0)


def test_wrappers_count_no_launch_on_cpu_and_refuse_other_devices():
    x, wq, sw, bias = _operands(3, 3)
    before = (k3.int8_quantize.launches, k3.int8_conv_gemm.launches)
    sx = torch.tensor(0.05)
    q = k3.int8_quantize(torch.from_numpy(x), sx)
    k3.int8_conv_gemm(q, torch.from_numpy(wq), sx, torch.from_numpy(sw), None,
                      (1, 1), (1, 1), (1, 1), torch.float32)
    assert (k3.int8_quantize.launches, k3.int8_conv_gemm.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        k3.int8_quantize(torch.from_numpy(x).to("meta"), sx)
    with pytest.raises(ValueError, match="unsupported device"):
        k3.int8_conv_gemm(q.to("meta"), torch.from_numpy(wq), sx, torch.from_numpy(sw), None,
                          (1, 1), (1, 1), (1, 1), torch.float32)
