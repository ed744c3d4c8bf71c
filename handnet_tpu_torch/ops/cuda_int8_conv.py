"""int8 convolution of float activations: CUDA kernels K3q and K3g.

Counterpart of the int8 convolution inside ``handnet_tpu/nn/quant.py``
``QuantConv.__call__`` (:122-151), which XLA computes. Activations are NHWC
(the bytes of the port's channels_last NCHW tensors), weights int8
``[O, kh, kw, I]`` with per-output-channel scales. :func:`int8_conv` is two
steps, each a wrapper with its kernel and its plain version:

* :func:`int8_quantize` — ``x`` to int8 ``q``, each element once:
  ``csrc/int8_quantize.cu`` (K3q) on a CUDA tensor, :func:`quantize_activation`
  on a CPU tensor;
* :func:`int8_conv_gemm` — the int32 implicit GEMM of ``q`` with the weights
  and the float32 dequantize-and-bias epilogue: ``csrc/int8_conv.cu`` (K3g, a
  TMA-fed ``wgmma`` kernel) on a CUDA tensor; on a CPU tensor an explicit NHWC
  im2col multiplied with ``torch._int_mm`` (:func:`int8_conv_int32_reference`)
  and :func:`dequantize` (:func:`int8_conv_gemm_reference`).

Each step is a ``torch.library`` op (``handnet_torch::int8_quantize``,
``handnet_torch::int8_conv_gemm``): the CPU implementation is the plain
version, the CUDA one checks the operands and launches the kernel, and the
fake one gives ``torch.export`` the output's shape and dtype.

Integer sums are exact and both sides run the same float32 operations in the
same order, so kernels and plain versions agree bit for bit.

K3g reads the activations through a TMA tensor map in im2col mode. The part
of that geometry which the host computes (:func:`im2col_geometry`) is passed
to the kernel; the part which the kernel computes per tile and tap is
transcribed here (:func:`tile_start`, :func:`tma_im2col_gather`), so that a
CPU test can hold both against the plain im2col.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from handnet_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNEL_MULTIPLE = 64  # K3g tiles K by 64 or 128 channels of one tap, N by 64 to 256
TILE_M = 128            # output pixels per K3g tile (kBM in csrc/int8_conv.cu)

Pair = Tuple[int, int]


def output_size(h: int, w: int, kh: int, kw: int, stride: Pair, padding: Pair,
                dilation: Pair) -> Pair:
    """Output height and width of a convolution with symmetric padding."""
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1 for n, k, s, p, d in
                 zip((h, w), (kh, kw), stride, padding, dilation))


def quantize_activation(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8, with ``sx`` one scale per
    sample (``[B]``) or one for the tensor (``[]``). True division, and
    ``torch.round`` rounds half to even, as ``jnp.round`` does. Plain version
    of K3q."""
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
    """Plain version of :func:`int8_conv`: quantize, exact int32 conv,
    dequantize. ``x`` is NHWC float; returns NHWC in ``x.dtype``."""
    q = quantize_activation(x, sx)
    acc = int8_conv_int32_reference(q, wq, stride, padding, dilation)
    return dequantize(acc, sx, sw, bias).to(x.dtype)


# --- the im2col tensor map's geometry ----------------------------------------


class Im2colGeometry(NamedTuple):
    """What TMA's im2col mode needs to read a convolution's A operand from
    NHWC ``q``; every pair is (h, w). A base pixel walks the bounding box
    ``[lower, size - 1 + upper]`` in steps of ``traversal``, W fastest, then
    H, then the image; tap ``t`` reads each base pixel at ``+ offsets[t]``,
    and whatever falls outside the tensor reads as 0."""
    lower: Pair
    upper: Pair
    traversal: Pair
    offsets: Tuple[Pair, ...]   # per tap, in (ky, kx) order


def im2col_geometry(kh: int, kw: int, stride: Pair, padding: Pair,
                    dilation: Pair) -> Im2colGeometry:
    """Bounding box, traversal strides and tap offsets of a convolution with
    symmetric padding: the box starts ``padding`` before the image and ends
    where the last tap of the last output pixel still lies ``padding`` past
    it, so it holds exactly ``output_size`` base pixels."""
    (ph, pw), (dh, dw) = padding, dilation
    return Im2colGeometry(
        lower=(-ph, -pw),
        upper=(ph - dh * (kh - 1), pw - dw * (kw - 1)),
        traversal=tuple(stride),
        offsets=tuple((ky * dh, kx * dw) for ky in range(kh) for kx in range(kw)))


def tile_start(m0: int, ho: int, wo: int, geo: Im2colGeometry) -> Tuple[int, int, int]:
    """``(n, h, w)`` of the base pixel of output pixel ``m0`` (NHWC order):
    the coordinates K3g's producer gives TMA for the tile that starts there
    (``csrc/int8_conv.cu``, "tile_start")."""
    n, rest = divmod(m0, ho * wo)
    oy, ox = divmod(rest, wo)
    return n, geo.lower[0] + oy * geo.traversal[0], geo.lower[1] + ox * geo.traversal[1]


def tma_im2col_gather(q: torch.Tensor, geo: Im2colGeometry, start: Tuple[int, int, int],
                      offset: Pair, c0: int, channels: int,
                      pixels: int = TILE_M) -> torch.Tensor:
    """What one im2col-mode TMA load of K3g brings: ``[pixels, channels]``
    int8, the channels ``c0..c0+channels`` of ``pixels`` consecutive base
    pixels from ``start`` (W fastest, wrapping at the bounding box into the
    next row and the next image), each read at ``+ offset``; zeros outside
    the tensor, past the last image included."""
    b, h, w, _ = q.shape
    (lh, lw), (uh, uw), (th, tw) = geo.lower, geo.upper, geo.traversal
    n, y, x = start
    rows = []
    zero = torch.zeros(channels, dtype=q.dtype)
    for _ in range(pixels):
        py, px = y + offset[0], x + offset[1]
        inside = n < b and 0 <= py < h and 0 <= px < w
        rows.append(q[n, py, px, c0:c0 + channels] if inside else zero)
        x += tw
        if x > w - 1 + uw:
            x, y = lw, y + th
            if y > h - 1 + uh:
                y, n = lh, n + 1
    return torch.stack(rows)


# --- the wrappers --------------------------------------------------------------


def _check_sx(name: str, sx: torch.Tensor, batch: int) -> int:
    """Validate an activation scale; returns its stride in elements (0 for
    one scale for the tensor, 1 per sample)."""
    if sx.dtype != torch.float32 or sx.numel() not in (1, batch) or sx.dim() > 1:
        raise ValueError(f"{name}: sx must be float32 [] or [{batch}], got "
                         f"{sx.dtype} {tuple(sx.shape)}")
    return 1 if sx.dim() and sx.numel() == batch else 0


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_operands(name: str, first: torch.Tensor, others) -> None:
    for t in others:
        if t is not None and (t.device != first.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every operand must be contiguous on "
                             f"{first.device}")


def _int8_quantize_cuda(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::int8_quantize``: launches K3q."""
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_quantize: expected float32 or bfloat16 [B, H, W, C], got "
                        f"{x.dtype} {tuple(x.shape)}")
    b = x.shape[0]
    per_sample = x[0].numel() if b else 0
    if b == 0 or per_sample == 0 or per_sample % 16:
        raise ValueError(f"int8_quantize: {tuple(x.shape)} must hold a positive multiple "
                         "of 16 elements per sample")
    sx_stride = _check_sx("int8_quantize", sx, b)
    _check_operands("int8_quantize", x, (x, sx))
    if x.data_ptr() % 16:
        raise ValueError("int8_quantize: x must be 16-byte aligned")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.hn_int8_quantize(x.data_ptr(), sx.data_ptr(), sx_stride, q.data_ptr(), b,
                                    per_sample, _DTYPE_CODES[x.dtype],
                                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("hn_int8_quantize", code)
    int8_quantize.launches += 1
    return q


def int8_quantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """NHWC float ``x`` (float32 or bfloat16) to int8 by ``sx`` (``[]`` or
    ``[B]`` float32): ``clip(round(x / sx), -127, 127)``; the op
    ``handnet_torch::int8_quantize``.

    A CPU tensor takes :func:`quantize_activation`. A CUDA tensor launches
    K3q (contiguous, 16-byte aligned, a multiple of 16 elements per sample)
    or raises.
    """
    _check_device("int8_quantize", x)
    return torch.ops.handnet_torch.int8_quantize(x, sx)


int8_quantize.launches = 0  # K3q launches, counted by the op's CUDA implementation


def int8_conv_gemm_reference(q: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                             sw: torch.Tensor, bias: Optional[torch.Tensor], stride: Pair,
                             padding: Pair, dilation: Pair,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K3g: :func:`int8_conv_int32_reference`, then
    :func:`dequantize`, cast to ``out_dtype``."""
    acc = int8_conv_int32_reference(q, wq, stride, padding, dilation)
    return dequantize(acc, sx, sw, bias).to(out_dtype)


def _int8_conv_gemm_cuda(q: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                         sw: torch.Tensor, bias: Optional[torch.Tensor], stride: Pair,
                         padding: Pair, dilation: Pair,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::int8_conv_gemm``: launches K3g."""
    if q.dim() != 4 or wq.dim() != 4 or q.dtype != torch.int8:
        raise ValueError(f"int8_conv_gemm: expected int8 q [B, H, W, C] and wq [O, kh, kw, C], "
                         f"got {q.dtype} {tuple(q.shape)} and {tuple(wq.shape)}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_conv_gemm: dtype {out_dtype} (float32 or bfloat16 only)")
    b, h, w, c = q.shape
    o, kh, kw, wc = wq.shape
    if wq.dtype != torch.int8 or wc != c:
        raise ValueError(f"int8_conv_gemm: wq must be int8 [O, kh, kw, {c}], got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if c % _CHANNEL_MULTIPLE or o % _CHANNEL_MULTIPLE:
        raise ValueError(f"int8_conv_gemm: C={c} and O={o} must be multiples of "
                         f"{_CHANNEL_MULTIPLE}")
    ho, wo = output_size(h, w, kh, kw, stride, padding, dilation)
    if b == 0 or ho <= 0 or wo <= 0:
        raise ValueError(f"int8_conv_gemm: empty output for input {tuple(q.shape)}")
    sx_stride = _check_sx("int8_conv_gemm", sx, b)
    for name, t in (("sw", sw), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (o,)):
            raise ValueError(f"int8_conv_gemm: {name} must be float32 [{o}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_operands("int8_conv_gemm", q, (q, wq, sx, sw, bias))
    if q.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv_gemm: q and wq must be 16-byte aligned")
    geo = im2col_geometry(kh, kw, stride, padding, dilation)
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.hn_int8_conv_gemm(
            q.data_ptr(), wq.data_ptr(), sx.data_ptr(), sx_stride, sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c, o, ho, wo, kh, kw, *stride, *dilation, *geo.lower, *geo.upper,
            _DTYPE_CODES[out_dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("hn_int8_conv_gemm", code)
    int8_conv_gemm.launches += 1
    return out


def _int8_conv_gemm_fake(q, wq, sx, sw, bias, stride, padding, dilation, out_dtype):
    ho, wo = output_size(q.shape[1], q.shape[2], wq.shape[1], wq.shape[2], stride, padding,
                         dilation)
    return q.new_empty((q.shape[0], ho, wo, wq.shape[0]), dtype=out_dtype)


def int8_conv_gemm(q: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: Pair, padding: Pair, dilation: Pair,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """int32 convolution of int8 NHWC ``q`` with int8 ``wq`` ``[O, kh, kw, I]``,
    dequantized by ``sx`` (``[]`` or ``[B]``) times ``sw`` ``[O]``, plus
    ``bias`` ``[O]`` float32 or None; the op ``handnet_torch::int8_conv_gemm``.
    Returns ``[B, Ho, Wo, O]`` in ``out_dtype`` (float32 or bfloat16).

    A CPU tensor takes :func:`int8_conv_gemm_reference`. A CUDA tensor
    launches K3g (contiguous NHWC, 16-byte aligned, I and O multiples of 64)
    or raises.
    """
    _check_device("int8_conv_gemm", q)
    return torch.ops.handnet_torch.int8_conv_gemm(q, wq, sx, sw, bias, stride, padding,
                                                  dilation, out_dtype)


int8_conv_gemm.launches = 0  # K3g launches, counted by the op's CUDA implementation

_LIB = torch.library.Library("handnet_torch", "FRAGMENT")
_LIB.define("int8_quantize(Tensor x, Tensor sx) -> Tensor")
_LIB.impl("int8_quantize", quantize_activation, "CPU")
_LIB.impl("int8_quantize", _int8_quantize_cuda, "CUDA")
torch.library.register_fake("handnet_torch::int8_quantize",
                            lambda x, sx: torch.empty_like(x, dtype=torch.int8), lib=_LIB)
_LIB.define("int8_conv_gemm(Tensor q, Tensor wq, Tensor sx, Tensor sw, Tensor? bias, "
            "int[2] stride, int[2] padding, int[2] dilation, ScalarType out_dtype) -> Tensor")
_LIB.impl("int8_conv_gemm", int8_conv_gemm_reference, "CPU")
_LIB.impl("int8_conv_gemm", _int8_conv_gemm_cuda, "CUDA")
torch.library.register_fake("handnet_torch::int8_conv_gemm", _int8_conv_gemm_fake, lib=_LIB)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor], stride: Pair, padding: Pair,
              dilation: Pair) -> torch.Tensor:
    """int8 convolution of NHWC float ``x`` (quantized by ``sx``) with int8
    weights ``wq`` ``[O, kh, kw, I]`` and their scales ``sw`` ``[O]``;
    ``bias`` ``[O]`` float32 or None. Returns ``[B, Ho, Wo, O]`` in
    ``x.dtype``: :func:`int8_quantize`, then :func:`int8_conv_gemm`. On a CUDA
    tensor both launch their kernels or raise; on a CPU tensor both take
    their plain versions."""
    q = int8_quantize(x, sx)
    return int8_conv_gemm(q, wq, sx, sw, bias, stride, padding, dilation, x.dtype)
