"""int8 modules of the PyTorch port (``handnet_tpu_torch/nn/quant.py``,
``ops/cuda_int8_conv.py``) against ``handnet_tpu/nn/quant.py``.

Inputs come from numpy seeds and reach both sides as numpy arrays; both run
in float32 on the CPU, where the port's int8 conv takes K3's plain version.
The JAX side runs under ``jax.jit``, as the JAX package serves and
calibrates: compiled, its ``/ 127.0`` is a multiply by the float32
reciprocal of 127, which the port reproduces. Quantized integers and scales
are compared bit for bit. ``QuantConv``
outputs to rtol 1e-6: the quantized operands are identical and the int32
sums exact, so only the float32 epilogue could differ, and it runs the same
operations in the same order on both sides.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from handnet_tpu.nn import quant as jquant
from handnet_tpu_torch.convert.from_flax import flax_calibration_key, port_calibration_name
from handnet_tpu_torch.nn import quant as pquant
from handnet_tpu_torch.ops import cuda_int8_conv as k3
from torch_port_fixtures import assert_close, nhwc

REPO = Path(__file__).resolve().parent.parent

# (kernel, stride, padding, dilation): the five geometries of the int8 path
# (ResNet 1x1 and downsample, 3x3, strided 3x3, A2J layer4's dilated 3x3)
GEOMETRIES = {
    "1x1_s1": (1, 1, 0, 1),
    "1x1_s2": (1, 2, 0, 1),
    "3x3_s1_p1": (3, 1, 1, 1),
    "3x3_s2_p1": (3, 2, 1, 1),
    "3x3_s1_p2_d2": (3, 1, 2, 2),
}


def _half_steps(dtype_np=np.float32):
    """[2, 3, 3, 8] values whose amax is 127 (scale exactly 1), with every
    x.5 tie from -126.5 to 126.5 present: round half to even decides them."""
    ties = np.arange(-126.5, 127.0, 1.0)
    rng = np.random.default_rng(0)
    x = rng.choice(ties, size=(2, 3, 3, 8))
    x[:, 0, 0, 0] = 127.0
    x[0, 1, 1, :4] = [0.5, 1.5, 2.5, -2.5]
    return x.astype(dtype_np)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "half_steps"])
def test_quantize_symmetric_bit_equal(dtype, case):
    """Ints bit-equal and scales equal, per sample (activations) and per
    output channel (weights, HWIO on the JAX side, OIHW on the port's)."""
    if case == "random":
        x = (np.random.default_rng(1).standard_normal((2, 5, 5, 8)) * 7).astype(np.float32)
    else:
        x = _half_steps()
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    quantize = jax.jit(jquant.quantize_symmetric, static_argnames="axes")
    jq, js = quantize(jx, axes=(1, 2, 3))
    pq, ps = pquant.quantize_symmetric(px, dims=(1, 2, 3))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    if case == "half_steps":  # sample 0 has scale 1: ties go to even
        assert float(ps[0]) == 1.0
        assert pq[0, 1, 1, :4].tolist() == [0, 2, 2, -2]
    # the same tensor read as a [kh, kw, I, O] kernel: per-O scales
    jq, js = quantize(jx, axes=(0, 1, 2))
    pq, ps = pquant.quantize_symmetric(px.permute(3, 2, 0, 1), dims=(1, 2, 3))
    np.testing.assert_array_equal(pq.permute(2, 3, 1, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.reshape(-1).numpy(), np.asarray(js).reshape(-1))


def _jax_conv(geometry, features, use_bias, static):
    k, s, p, d = GEOMETRIES[geometry]
    # the JAX package builds its 1x1 convs with the default SAME padding
    padding = "SAME" if k == 1 else p
    return jquant.QuantConv(features=features, kernel_size=(k, k), strides=s,
                            padding=padding, kernel_dilation=d, use_bias=use_bias,
                            static_scale=static)


def _port_conv(geometry, cin, cout, use_bias, mode):
    k, s, p, d = GEOMETRIES[geometry]
    return pquant.QuantConv(cin, cout, k, stride=s, padding=p, dilation=d,
                            bias=use_bias, mode=mode)


def _conv_inputs(seed, cin=64, cout=64, k=3, h=9, w=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, h, w, cin)) * 3).astype(np.float32)
    x[1] *= 0.25  # per-sample scales differ
    kernel = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_quantconv_matches_jax(geometry, mode, use_bias):
    k = GEOMETRIES[geometry][0]
    seed = 4 * list(GEOMETRIES).index(geometry) + 2 * (mode == "static") + use_bias
    x, kernel, bias = _conv_inputs(seed, k=k)
    params = {"kernel": kernel, **({"bias": bias} if use_bias else {})}
    variables = {"params": params}
    port = _port_conv(geometry, 64, 64, use_bias, mode)
    state = {"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}
    if use_bias:
        state["bias"] = torch.from_numpy(bias)
    if mode == "static":
        amax = np.float32(0.8 * np.abs(x).max())  # some activations saturate
        variables["quant_stats"] = {"act_amax": amax}
        state["act_amax"] = torch.tensor(amax)
    port.load_state_dict(state, strict=True)
    want = jax.jit(_jax_conv(geometry, 64, use_bias, mode == "static").apply)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert_close(nhwc(got), want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def test_quantconv_calibration_mode_matches_jax():
    """Calibrating folds the global batch amax into act_amax with max (a
    smaller later batch does not shrink it) and computes the dynamic path."""
    x, kernel, bias = _conv_inputs(7)
    jconv = _jax_conv("3x3_s1_p1", 64, True, static=True)
    v = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
         "quant_stats": {"act_amax": jnp.float32(0.0)}}
    calibrate = jax.jit(lambda v, x: jconv.apply(v, x, mutable=["quant_stats"]))
    want, upd = calibrate(v, jnp.asarray(x))
    _, upd2 = calibrate({**v, **upd}, jnp.asarray(x * 0.5))
    port = _port_conv("3x3_s1_p1", 64, 64, True, "static")
    port.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(bias), "act_amax": torch.tensor(0.0)})
    port.calibrating = True
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    port(torch.from_numpy(x * 0.5).permute(0, 3, 1, 2))
    assert float(port.act_amax) == float(upd2["quant_stats"]["act_amax"]) == np.abs(x).max()
    assert_close(nhwc(got), want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
    dynamic = _port_conv("3x3_s1_p1", 64, 64, True, "dynamic")
    dynamic.load_state_dict({k: v for k, v in port.state_dict().items() if k != "act_amax"})
    assert torch.equal(got, dynamic(torch.from_numpy(x).permute(0, 3, 1, 2)))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_int8_conv_plain_int32_is_exact(geometry):
    """K3's plain version: the im2col + torch._int_mm int32 result equals a
    float64 convolution of the same int8 values exactly (|sum| < 2**53)."""
    k, s, p, d = GEOMETRIES[geometry]
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 10, 9, 64), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (128, k, k, 64), dtype=np.int8))
    got = k3.int8_conv_int32_reference(q, wq, (s, s), (p, p), (d, d))
    want = F.conv2d(q.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                    stride=s, padding=p, dilation=d).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.double(), want)


def test_int8_conv_wrapper_on_cpu_takes_plain_version():
    """On a CPU tensor the wrapper returns the plain version's result and
    counts no launch; per-sample and per-layer scales, f32 and bf16."""
    x, kernel, bias = _conv_inputs(5)
    conv = _port_conv("3x3_s2_p1", 64, 64, True, "dynamic")
    conv.weight.data.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    wq, sw = conv.quantized_weight()
    before = (k3.int8_quantize.launches, k3.int8_conv_gemm.launches)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        for sx in (torch.tensor([0.05, 0.02]), torch.tensor(0.04)):
            args = (xt, wq, sx, sw, torch.from_numpy(bias), (2, 2), (1, 1), (1, 1))
            got = k3.int8_conv(*args)
            assert got.dtype == dtype and got.shape == (2, 5, 6, 64)
            assert torch.equal(got, k3.int8_conv_reference(*args))
    assert (k3.int8_quantize.launches, k3.int8_conv_gemm.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        k3.int8_conv(torch.from_numpy(x).to("meta"), wq, sx, sw, None, (1, 1), (1, 1), (1, 1))


def test_quantconv_weight_cache_follows_the_weight():
    """int8 weights are rebuilt when the float weight changes in place or
    is replaced, and are not part of the state dict."""
    conv = _port_conv("1x1_s1", 64, 64, False, "static")
    wq0, sw0 = conv.quantized_weight()
    assert conv.quantized_weight()[0] is wq0
    with torch.no_grad():
        conv.weight.mul_(2.0)
    wq1, sw1 = conv.quantized_weight()
    assert torch.equal(wq1, wq0) and torch.equal(sw1, 2 * sw0)
    conv.load_state_dict({"weight": -conv.weight.detach().clone(),
                          "act_amax": torch.tensor(1.0)})
    assert torch.equal(conv.quantized_weight()[0], -wq0)
    assert sorted(conv.state_dict()) == ["act_amax", "weight"]


def test_conv_layer_modes():
    kinds = {q: pquant.conv_layer(q, 64, 64, 3, padding=1)
             for q in (False, True, "dynamic", "static")}
    assert type(kinds[False]) is torch.nn.Conv2d
    assert [kinds[q].mode for q in (True, "dynamic", "static")] == [
        "dynamic", "dynamic", "static"]
    assert not hasattr(kinds[True], "act_amax")
    assert float(kinds["static"].act_amax) == 0.0


def test_calibration_key_map_covers_bench_calib():
    """Every key of configs/bench_calib.npz maps to a port buffer name and
    back; the names follow the port's module paths."""
    keys = np.load(REPO / "configs" / "bench_calib.npz").files
    assert len(keys) == 113
    for key in keys:
        assert flax_calibration_key(port_calibration_name(key)) == key
    assert port_calibration_name("detector/quant_stats/fpn/lateral_2/act_amax") == \
        "detector.backbone.fpn.inner_blocks.2.act_amax"
    assert port_calibration_name("detector/quant_stats/head/reg_tower/conv3/act_amax") == \
        "detector.head.regression_head.conv.9.act_amax"
    assert port_calibration_name("a2j/quant_stats/backbone/layer4_0/downsample_conv/"
                                 "act_amax") == "a2j.Backbone.model.layer4.0.downsample.0.act_amax"
    assert port_calibration_name("a2j/quant_stats/depth/conv2/act_amax") == \
        "a2j.DepthRegressionModel.conv2.act_amax"
    with pytest.raises(KeyError):
        port_calibration_name("detector/params/fpn/lateral_0/kernel")
