"""int8 convolution with float activations quantized on load: CUDA kernel K3.

Counterpart of the int8 convolution inside ``handnet_tpu/nn/quant.py``
``QuantConv.__call__`` (:122-151), which XLA computes. Activations are NHWC
(the bytes of the port's channels_last NCHW tensors), weights int8
``[O, kh, kw, I]`` with per-output-channel scales. A CUDA tensor launches
``csrc/int8_conv.cu``; a CPU tensor takes :func:`int8_conv_reference`, an
explicit NHWC im2col of the int8 tensor multiplied with ``torch._int_mm``.
Both run the same float32 epilogue, so they agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from handnet_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNEL_MULTIPLE = 64  # K3 tiles K by 64 channels of one tap, N by 64 or 128

Pair = Tuple[int, int]


def output_size(h: int, w: int, kh: int, kw: int, stride: Pair, padding: Pair,
                dilation: Pair) -> Pair:
    """Output height and width of a convolution with symmetric padding."""
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1 for n, k, s, p, d in
                 zip((h, w), (kh, kw), stride, padding, dilation))


def quantize_activation(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8, with ``sx`` one scale per
    sample (``[B]``) or one for the tensor (``[]``). True division, and
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = sx.reshape(-1, 1, 1, 1) if sx.dim() else sx
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``float(acc) * (sx * sw)`` then ``+ bias``, in float32 and in the JAX
    package's order, for an NHWC int32 ``acc``."""
    scale = (sx.reshape(-1, 1, 1, 1) if sx.dim() else sx) * sw
    out = acc.float() * scale
    return out if bias is None else out + bias


def int8_conv_int32_reference(q: torch.Tensor, wq: torch.Tensor, stride: Pair,
                              padding: Pair, dilation: Pair) -> torch.Tensor:
    """Exact int32 convolution of int8 NHWC ``q`` with int8 ``[O, kh, kw, I]``
    ``wq``: pad with int8 zeros, concatenate the kh*kw shifted and strided
    views along channels (NHWC im2col, K in (ky, kx, c) order) and multiply
    with ``torch._int_mm``. Returns ``[B, Ho, Wo, O]`` int32."""
    b, h, w, c = q.shape
    o, kh, kw, _ = wq.shape
    ho, wo = output_size(h, w, kh, kw, stride, padding, dilation)
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    qp = F.pad(q, (0, 0, pw, pw, ph, ph))
    taps = [qp[:, ky * dh: ky * dh + (ho - 1) * sh + 1: sh,
               kx * dw: kx * dw + (wo - 1) * sw + 1: sw]
            for ky in range(kh) for kx in range(kw)]
    cols = torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0].contiguous()
    acc = torch._int_mm(cols.reshape(b * ho * wo, kh * kw * c),
                        wq.reshape(o, kh * kw * c).t())
    return acc.reshape(b, ho, wo, o)


def int8_conv_reference(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                        sw: torch.Tensor, bias: Optional[torch.Tensor],
                        stride: Pair, padding: Pair, dilation: Pair) -> torch.Tensor:
    """Plain version of K3: quantize, exact int32 conv, dequantize. ``x`` is
    NHWC float; returns NHWC in ``x.dtype``."""
    q = quantize_activation(x, sx)
    acc = int8_conv_int32_reference(q, wq, stride, padding, dilation)
    return dequantize(acc, sx, sw, bias).to(x.dtype)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor], stride: Pair, padding: Pair,
              dilation: Pair) -> torch.Tensor:
    """int8 convolution of NHWC float ``x`` (quantized on load by ``sx``)
    with int8 weights ``wq`` ``[O, kh, kw, I]`` and their scales ``sw``
    ``[O]``; ``bias`` ``[O]`` float32 or None. Returns ``[B, Ho, Wo, O]`` in
    ``x.dtype``.

    A CPU tensor takes :func:`int8_conv_reference`. A CUDA tensor launches
    K3 (float32 or bfloat16, contiguous NHWC, 16-byte aligned, I and O
    multiples of 64) or raises.
    """
    if x.device.type == "cpu":
        return int8_conv_reference(x, wq, sx, sw, bias, stride, padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"int8_conv: expected x [B, H, W, C] and wq [O, kh, kw, C], "
                         f"got {tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_conv: dtype {x.dtype} (float32 or bfloat16 only)")
    b, h, w, c = x.shape
    o, kh, kw, wc = wq.shape
    if wq.dtype != torch.int8 or wc != c:
        raise ValueError(f"int8_conv: wq must be int8 [O, kh, kw, {c}], got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if c % _CHANNEL_MULTIPLE or o % _CHANNEL_MULTIPLE:
        raise ValueError(f"int8_conv: C={c} and O={o} must be multiples of "
                         f"{_CHANNEL_MULTIPLE}")
    ho, wo = output_size(h, w, kh, kw, stride, padding, dilation)
    if b == 0 or ho <= 0 or wo <= 0:
        raise ValueError(f"int8_conv: empty output for input {tuple(x.shape)}")
    if sx.dtype != torch.float32 or sx.numel() not in (1, b) or sx.dim() > 1:
        raise ValueError(f"int8_conv: sx must be float32 [] or [{b}], got "
                         f"{sx.dtype} {tuple(sx.shape)}")
    vectors = (("sw", sw), ("bias", bias))
    for name, t in vectors:
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (o,)):
            raise ValueError(f"int8_conv: {name} must be float32 [{o}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = [x, wq, sx, sw] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_conv: every operand must be contiguous on x's device")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv: x and wq must be 16-byte aligned")
    out = torch.empty((b, ho, wo, o), dtype=x.dtype, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.hn_int8_conv(
            x.data_ptr(), wq.data_ptr(), sx.data_ptr(), 1 if sx.numel() == b and sx.dim() else 0,
            sw.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c, o, ho, wo, kh, kw, *stride, *padding, *dilation,
            _DTYPE_CODES[x.dtype], stream)
    build.check_launch("hn_int8_conv", code)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0  # kernel launches, counted by the wrapper
