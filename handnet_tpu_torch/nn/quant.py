"""int8 convolutions for serving: dynamic or calibrated static activation scales.

Counterpart of ``handnet_tpu/nn/quant.py``. :class:`QuantConv` is a drop-in
``nn.Conv2d`` with the same ``weight``/``bias`` parameters (float32), so a
float checkpoint serves int8 unchanged:

* weights: symmetric per output channel, ``sw[o] = max(max|w[o]|, 1e-8) / 127``,
  quantized once from the float32 weight and cached (outside the state dict)
  until the weight changes; an exported program takes them as call
  arguments instead (:func:`given_weights`), quantized once when the
  artifact loads;
* every ``/ 127`` of a scale is a multiply by the float32 reciprocal of 127:
  XLA compiles the JAX package's division by the constant 127 that way, and
  the two differ by one ulp for some amaxes, enough to flip a quantized
  activation that lies on a rounding tie;
* activations: ``dynamic`` takes one scale per sample from its amax;
  ``static`` takes one per layer from the calibrated ``act_amax`` buffer;
* the conv accumulates int8 x int8 in int32 and dequantizes by
  ``sx[b] * sw[o]`` in its epilogue: kernels K3q (quantize) and K3g (int8
  GEMM) on a CUDA tensor (``ops/cuda_int8_conv.py``), their plain versions
  on a CPU tensor.

Calibration (:meth:`HandNetPipeline.calibrate
<handnet_tpu_torch.models.pipeline.HandNetPipeline.calibrate>`) sets
``calibrating`` on the static layers: each forward then folds the batch's
global amax into ``act_amax`` with ``max``, in place, and computes the
dynamic path. ``save_calibration``/``load_calibration`` use the JAX
package's npz keys (``detector/quant_stats/backbone/layer1_0/conv1/act_amax``),
so a calibration written by either package loads into the other.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.convert.from_flax import flax_calibration_key, port_calibration_name
from handnet_tpu_torch.ops.cuda_int8_conv import int8_conv, int8_conv_reference


# float32(1 / 127): the constant XLA multiplies by for ``/ 127.0``
_INV_127 = float(np.float32(1.0 / 127.0))


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as the JAX package computes it once
    compiled: a multiply by the float32 reciprocal of 127."""
    return torch.clamp_min(amax, 1e-8) * _INV_127


def quantize_symmetric(x: torch.Tensor, dims) -> tuple:
    """Symmetric int8 quantization: ``(q, scale)`` with ``x ~= q * scale``.

    ``dims`` are reduced for the amax and kept as size 1 in ``scale``.
    ``scale`` is :func:`scale_from_amax`; ``q = clip(round(x / scale),
    -127, 127)`` with true division and round half to even, as the JAX
    package computes it.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = scale_from_amax(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(wq [O, kh, kw, I] int8, sw [O] float32)`` of a float conv weight
    ``[O, I, kh, kw]``: per output channel, in K3g's weight layout."""
    with torch.no_grad():
        wq, sw = quantize_symmetric(w, dims=(1, 2, 3))
        return wq.permute(0, 2, 3, 1).contiguous(), sw.reshape(-1).contiguous()


class QuantConv(nn.Conv2d):
    """int8 ``nn.Conv2d`` for serving (``mode`` "dynamic" or "static").

    Inputs and outputs are NCHW in channels_last memory, as in the rest of
    the port; the output has the input's dtype. ``use_kernel`` False takes
    K3's plain version on a CUDA tensor too (to price the kernel). A static
    layer holds ``act_amax`` (float32 scalar, 0 until calibrated).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, bias: bool = True, mode: str = "dynamic"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        if mode not in ("dynamic", "static"):
            raise ValueError(f"QuantConv: mode {mode!r} (dynamic or static)")
        self.mode = mode
        self.use_kernel = True
        self.calibrating = False
        if mode == "static":
            self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32))
        self._weight_cache = None
        # (wq, sw) set by given_weights: the exported programs' arguments
        self.given = None

    def quantized_weight(self):
        """``(wq [O, kh, kw, I] int8, sw [O] float32)`` of the current weight.

        The pair set by :func:`given_weights` if there is one (an exported
        program's arguments: under ``torch.export`` the weight has no
        storage to key a cache on); else cached until the weight changes."""
        if self.given is not None:
            return self.given
        w = self.weight
        key = (w.device, w.data_ptr(), w._version)
        if self._weight_cache is None or self._weight_cache[0] != key:
            self._weight_cache = (key, *quantize_weight(w))
        return self._weight_cache[1:]

    def activation_scale(self, x: torch.Tensor) -> torch.Tensor:
        """``sx`` of NHWC ``x``: ``[B]`` per sample (dynamic, calibrating) or
        ``[]`` from ``act_amax`` (static). Calibrating folds the batch's
        global amax into ``act_amax``."""
        if self.mode == "static" and not self.calibrating:
            return scale_from_amax(self.act_amax)
        # |x| and max are exact in x's dtype: reduce first, then widen
        amax = x.abs().amax(dim=(1, 2, 3)).float()
        if self.calibrating:
            if self.mode != "static":
                raise RuntimeError("QuantConv: only a static layer calibrates")
            self.act_amax.copy_(torch.maximum(self.act_amax, amax.max()))
        return scale_from_amax(amax)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        sx = self.activation_scale(nhwc)
        wq, sw = self.quantized_weight()
        bias = None if self.bias is None else self.bias.float()
        conv = int8_conv if self.use_kernel else int8_conv_reference
        y = conv(nhwc, wq, sx, sw, bias, self.stride, self.padding, self.dilation)
        return y.permute(0, 3, 1, 2)


def conv_layer(quant: Union[bool, str], *args, **kwargs) -> nn.Conv2d:
    """``nn.Conv2d`` or :class:`QuantConv` with the same arguments:
    ``quant`` False -> float; True or "dynamic" -> per-sample int8;
    "static" -> calibrated int8."""
    if quant == "static":
        return QuantConv(*args, mode="static", **kwargs)
    if quant:
        return QuantConv(*args, mode="dynamic", **kwargs)
    return nn.Conv2d(*args, **kwargs)


@contextlib.contextmanager
def given_weights(module: nn.Module, weights: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
    """Within the block, every :class:`QuantConv` under ``module`` takes its
    ``(wq, sw)`` from ``weights`` (by layer name) instead of quantizing its
    weight: an exported program's graph then holds no weight quantization."""
    layers = [(m, weights[name]) for name, m in module.named_modules()
              if isinstance(m, QuantConv)]
    for m, pair in layers:
        m.given = tuple(pair)
    try:
        yield
    finally:
        for m, _ in layers:
            m.given = None


def _static_layers(module: nn.Module):
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, QuantConv) and m.mode == "static"]


def set_calibrating(module: nn.Module, on: bool) -> None:
    """Switch every static :class:`QuantConv` under ``module`` into (or out
    of) calibration mode."""
    for _, m in _static_layers(module):
        m.calibrating = on


def assert_calibrated(module: nn.Module) -> None:
    """Raise if any static ``act_amax`` under ``module`` is still zero (an
    uncalibrated static layer saturates every activation to +-127 and
    serves finite garbage). A no-op for float and dynamic models."""
    bad = [name for name, m in _static_layers(module) if float(m.act_amax) == 0.0]
    if bad:
        raise ValueError(
            f"{len(bad)} static-int8 activation scale(s) are zero — the model was "
            f"never calibrated (HandNetPipeline.calibrate / load_calibration), or "
            f"calibration saw all-zero inputs. First: {bad[:3]}")


@torch.no_grad()
def apply_margin(module: nn.Module, margin: float) -> None:
    """Widen every calibrated ``act_amax`` by ``1 + margin``, in place
    (headroom against activations beyond the calibrated range)."""
    if margin <= -1.0:
        raise ValueError(f"quant margin must be > -1, got {margin}")
    factor = torch.tensor(1.0 + margin, dtype=torch.float32)
    for _, m in _static_layers(module):
        m.act_amax.mul_(factor.to(m.act_amax.device))


def npz_path(path: str) -> str:
    """The on-disk path of a calibration file (``np.savez`` appends
    ``.npz`` to a path without it)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_calibration(path: str, pipeline: nn.Module) -> int:
    """Write every static ``act_amax`` of a ``HandNetPipeline`` to an npz
    under the JAX package's keys. Returns the number saved; raises when the
    pipeline has no static layer."""
    flat = {flax_calibration_key(f"{name}.act_amax"): m.act_amax.detach().cpu().numpy()
            for name, m in _static_layers(pipeline)}
    if not flat:
        raise ValueError("the pipeline holds no static-int8 layer "
                         "(is the config quant='static'?)")
    np.savez(npz_path(path), **flat)
    return len(flat)


@torch.no_grad()
def load_calibration(path: str, pipeline: nn.Module) -> int:
    """Load an npz written by :func:`save_calibration` or by the JAX
    package's ``save_calibration`` into a ``HandNetPipeline``'s
    ``act_amax`` buffers, in place. Every key must name a static layer of
    this pipeline. Returns the number loaded."""
    buffers = {f"{name}.act_amax": m.act_amax for name, m in _static_layers(pipeline)}
    data = np.load(npz_path(path))
    for key in data.files:
        name = port_calibration_name(key)
        if name not in buffers:
            raise KeyError(f"calibration entry {key!r} ({name}) does not match the "
                           f"pipeline's static layers — wrong config/architecture?")
        buffers[name].copy_(torch.as_tensor(data[key], dtype=torch.float32))
    return len(data.files)
