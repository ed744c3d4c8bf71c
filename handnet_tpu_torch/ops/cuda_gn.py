"""GroupNorm over NHWC activations: CUDA kernels K2s and K2a, and the
backward's K2r and K2d.

Counterpart of ``handnet_tpu/ops/pallas_gn.py:123-169``. On a CUDA tensor
:func:`group_norm` is two launches: the statistics (per-(image, group) mean
and biased variance, exact two-pass numerics) from ``csrc/gn_stats.cu``
(K2s), then normalize, affine and the optional ReLU in one pass from
``csrc/gn_apply.cu`` (K2a) — the pass the JAX package leaves to XLA's
fusion. On a CPU tensor both take their plain versions
(:func:`gn_group_stats_reference`, :func:`gn_apply_reference`).

With grad, :func:`group_norm` is a ``torch.autograd.Function`` whose
forward is K2s and K2a and whose backward is two more launches: the
per-group sums ``S1, S2`` and the parameters' gradients in one read of x
and dy (``csrc/gn_backward_sums.cu``, K2r), then dx in one pass
(``csrc/gn_backward_dx.cu``, K2d). Both recompute the ReLU mask from x with
K2a's operations, so no output is saved. The JAX package's ``pallas_gn``
defines no gradient (its training towers are flax ``GroupNorm``s that XLA
differentiates), so these two replace no Pallas kernel.

The kernels walk an image the same way: a block is ``rows`` pixel rows by
``cp`` 16-byte chunk columns, and each image's pixels are cut into
``splits`` runs of ``per_split`` pixels, one block each (:func:`row_plan`).
All four take every group width of GroupNorm(32) over 64 to 2048
channels (C/G 2 to 64) and rows of up to 512 chunks (float32 C = 2048,
one pixel row a block), and raise ``ValueError`` beyond.
K2s's and K2r's blocks meet in a workspace and the last one folds the
splits in order; K2r then folds the images in runs of ``SUMS_IMAGE_FOLD``
and the runs in order, each fold by the block that arrives last.
:func:`gn_stats_split_emulation` and :func:`gn_backward_split_emulation`
transcribe those walks and folds, so that a CPU test can hold them against
the plain versions.

Each kernel is a ``torch.library`` op (``handnet_torch::gn_group_stats``,
``gn_apply``, ``gn_backward_sums``, ``gn_backward_dx``): the CPU
implementation is the plain version, the CUDA one checks the input and
launches the kernel, and the fake one gives ``torch.export`` the output's
shape. The two forward ops also have a registered gradient
(``torch.library.register_autograd``) in plain PyTorch, for whoever
differentiates an op directly: each works in float32 from the saved input
and statistics (float64 for a float64 input, which only the plain versions
take) and returns ``dx`` in x's dtype.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from handnet_tpu_torch.kernels import build, scratch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_GROUP_WIDTHS = (2, 4, 8, 16, 32, 64)  # GroupNorm(32) over 64..2048 channels
_MAX_THREADS = 256       # kMaxThreads of gn_stats.cu, gn_apply.cu and gn_backward_*.cu
_MAX_ROW_CHUNKS = 512    # kWideThreads of the same four sources: one row a block
STATS_RUN = 4            # kRun of gn_stats.cu: a group's chunk columns folded in order
STATS_UNROLL = 8         # kUnroll of gn_stats.cu: loads a thread has in flight
APPLY_UNROLL = 4         # kUnroll of gn_apply.cu
SUMS_UNROLL = 4          # kUnroll of gn_backward_sums.cu (loads of x; as many of dy)
DX_UNROLL = 4            # kUnroll of gn_backward_dx.cu
STATS_BLOCKS_PER_SM = 8  # blocks the plans aim at, per SM, over the whole batch
APPLY_BLOCKS_PER_SM = 16
# K2r: 256-thread blocks per SM in its one wave (row_plan's one_wave), so
# that an image's last block folds few partials and no block waits for a
# second wave
SUMS_BLOCKS_PER_SM = 2
SUMS_IMAGE_FOLD = 8      # image_fold of gn_backward_sums.cu: images per run of the second fold
DX_BLOCKS_PER_SM = 16


class RowPlan(NamedTuple):
    """How K2s and K2a cut ``[B, HW, C]`` into blocks."""
    cp: int         # 16-byte chunks in a pixel's C channels: the block's columns
    rows: int       # pixel rows of a block: rows * cp threads
    splits: int     # blocks per image (gridDim.x)
    per_split: int  # pixels per block; the last split may be shorter


def row_plan(batch: int, hw: int, channels: int, itemsize: int, sm_count: int,
             unroll: int, blocks_per_sm: int, max_chunks: int = _MAX_THREADS,
             one_wave: bool = False) -> RowPlan:
    """Blocks of at most 256 threads that read whole pixel rows (a row of
    more than 256 chunks, up to ``max_chunks``, is a block of one row), and
    enough splits of HW that ``batch * splits`` reaches ``blocks_per_sm``
    blocks per SM, as long as a split keeps one unrolled trip of the block
    (``rows * unroll`` pixels). Splits are whole trips, so only an image's
    last split is ragged. All four kernels take rows of up to
    ``_MAX_ROW_CHUNKS``.

    With ``one_wave`` (K2r) the splits stop short of the target instead:
    ``batch * splits`` stays within ``blocks_per_sm`` 256-thread blocks per
    SM, a wider block counting for its threads, so that the grid is one
    wave (at B=64, 11x11: 4 splits of 256-thread blocks, not 5)."""
    row_bytes = channels * itemsize
    if row_bytes % 16 or row_bytes // 16 > max_chunks:
        raise ValueError(f"GroupNorm kernels: C={channels} x {itemsize} bytes must be a "
                         f"multiple of 16 bytes and at most {16 * max_chunks}")
    cp = row_bytes // 16
    rows = max(1, _MAX_THREADS // cp)
    trip = rows * unroll
    if one_wave:
        want = max(1, blocks_per_sm * sm_count * _MAX_THREADS // (rows * cp) // batch)
    else:
        want = -(-blocks_per_sm * sm_count // batch)
    splits = max(1, min(want, -(-hw // trip)))
    per_split = -(-(-(-hw // splits)) // trip) * trip
    return RowPlan(cp, rows, -(-hw // per_split), per_split)


def sums_plan(batch: int, hw: int, channels: int, itemsize: int, sm_count: int) -> RowPlan:
    """K2r's plan: :func:`row_plan` with ``one_wave``, ``SUMS_UNROLL`` and
    ``SUMS_BLOCKS_PER_SM``, rows of up to ``_MAX_ROW_CHUNKS``."""
    return row_plan(batch, hw, channels, itemsize, sm_count, SUMS_UNROLL, SUMS_BLOCKS_PER_SM,
                    _MAX_ROW_CHUNKS, one_wave=True)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for a float64
    ``x`` (the gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def gn_group_stats_reference(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of K2s: ``[B, H, W, C]`` -> ``[B, 2, G]`` float32 (group
    means, biased group variances); float64 for a float64 ``x``.

    The corrected two-pass form in float32: the deviations from a first
    mean give both the variance and a correction of that mean, so neither
    loses precision when mean >> std.
    """
    b, h, w, c = x.shape
    g = x.to(_acc_dtype(x)).reshape(b, h * w, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 3))
    dev = g - mean[:, None, :, None]
    correction = dev.mean(dim=(1, 3))
    var = dev.square().mean(dim=(1, 3)) - correction.square()
    return torch.stack([mean + correction, var], dim=1)


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_nhwc(name: str, x: torch.Tensor, num_groups: int) -> None:
    """What the kernels take on the card: float32 or bfloat16, contiguous
    NHWC, 16-byte aligned, C/G one of ``_SUPPORTED_GROUP_WIDTHS``."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} (float32 or bfloat16 only)")
    b, h, w, c = x.shape
    if c % num_groups or c // num_groups not in _SUPPORTED_GROUP_WIDTHS:
        raise ValueError(f"{name}: C={c}, G={num_groups}: C/G={c / num_groups:g} is not a "
                         f"group width it takes, one of {_SUPPORTED_GROUP_WIDTHS}")
    if b * h * w == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")


def _gn_group_stats_cuda(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::gn_group_stats``: launches K2s."""
    _check_nhwc("gn_group_stats", x, num_groups)
    b, h, w, c = x.shape
    plan = row_plan(b, h * w, c, x.element_size(), scratch.sm_count(x.device.index),
                    STATS_UNROLL, STATS_BLOCKS_PER_SM, _MAX_ROW_CHUNKS)
    if num_groups > plan.rows * plan.cp:
        raise ValueError(f"gn_group_stats: G={num_groups} groups exceed the block's "
                         f"{plan.rows * plan.cp} threads")
    out = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partials = counters = None
        if plan.splits > 1:  # the blocks of an image meet in a workspace
            partials = torch.empty((b, plan.splits, 3, num_groups), dtype=torch.float32,
                                   device=x.device)
            counters = scratch.split_counters(x.device, stream, b)
        code = lib.hn_gn_group_stats(x.data_ptr(), out.data_ptr(), scratch.ptr(partials),
                                     scratch.ptr(counters), b, h * w, c, num_groups,
                                     plan.cp, plan.rows, plan.splits, plan.per_split,
                                     _DTYPE_CODES[x.dtype], stream)
    build.check_launch("hn_gn_group_stats", code)
    gn_group_stats.launches += 1
    return out


def gn_group_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-(image, group) GroupNorm statistics of NHWC ``x`` in one read:
    the op ``handnet_torch::gn_group_stats``.

    Returns ``[B, 2, G]`` float32: ``[:, 0]`` means, ``[:, 1]`` biased
    variances over (H, W, C/G), as flax ``GroupNorm(use_fast_variance=False)``
    computes them. A CPU tensor takes :func:`gn_group_stats_reference`; a
    CUDA tensor launches K2s (float32 or bfloat16, contiguous NHWC, 16-byte
    aligned) or raises. Two launches on the same input give the same bits.
    """
    _check_device("gn_group_stats", x)
    return torch.ops.handnet_torch.gn_group_stats(x, num_groups)


gn_group_stats.launches = 0  # kernel launches, counted by the op's CUDA implementation


def gn_apply_reference(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5,
                       relu: bool = False) -> torch.Tensor:
    """Plain version of K2a: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    in float32 (float64 for a float64 ``x``) with ``stats [B, 2, G]`` (means,
    biased variances), cast to ``x.dtype``, then the ReLU."""
    acc = _acc_dtype(x)
    k = x.shape[-1] // stats.shape[-1]
    mean = stats[:, 0].to(acc).repeat_interleave(k, dim=-1)[:, None, None, :]
    inv = torch.rsqrt(stats[:, 1].to(acc) + eps).repeat_interleave(k, dim=-1)
    mul = (inv * scale.to(acc))[:, None, None, :]
    y = (x.to(acc) - mean).mul_(mul).add_(bias.to(acc)).to(x.dtype)
    return torch.relu_(y) if relu else y


def _check_params(name: str, x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, sums: Optional[torch.Tensor] = None) -> int:
    """What K2a, K2r and K2d take beside x on the card: ``stats`` (and K2d's
    ``sums``) contiguous float32 ``[B, 2, G]``; ``scale`` and ``bias``
    contiguous ``[C]``, both float32 or both bfloat16; all on x's device.
    Returns G."""
    if stats.dim() != 3:
        raise ValueError(f"{name}: stats must be [B, 2, G], got {tuple(stats.shape)}")
    num_groups = stats.shape[-1]
    _check_nhwc(name, x, num_groups)
    b, h, w, c = x.shape
    per_group = [("stats", stats)] + ([("sums", sums)] if sums is not None else [])
    for key, t in per_group:
        if (tuple(t.shape) != (b, 2, num_groups) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous float32 [{b}, 2, G], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for key, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,) or not t.is_contiguous() or t.dtype != scale.dtype:
            raise ValueError(f"{name}: {key} must be contiguous [{c}] of scale's dtype")
    if scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: scale and bias dtype {scale.dtype} (float32 or bfloat16)")
    for key, t in (*per_group, ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
    return num_groups


def _gn_apply_cuda(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::gn_apply``: launches K2a."""
    num_groups = _check_params("gn_apply", x, stats, scale, bias)
    b, h, w, c = x.shape
    plan = row_plan(b, h * w, c, x.element_size(), scratch.sm_count(x.device.index),
                    APPLY_UNROLL, APPLY_BLOCKS_PER_SM, _MAX_ROW_CHUNKS)
    out = torch.empty_like(x)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.hn_gn_apply(x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), b, h * w, c, num_groups,
                               plan.cp, plan.rows, plan.splits, plan.per_split, eps,
                               int(relu), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                               stream)
    build.check_launch("hn_gn_apply", code)
    gn_apply.launches += 1
    return out


def gn_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Normalize, affine and optional ReLU of NHWC ``x`` in one pass, from
    the statistics ``[B, 2, G]`` of :func:`gn_group_stats`; returns a new
    tensor of ``x``'s shape and dtype: the op ``handnet_torch::gn_apply``.

    A CPU tensor takes :func:`gn_apply_reference`; a CUDA tensor launches
    K2a (``x`` as K2s takes it; ``scale`` and ``bias`` contiguous ``[C]``,
    both float32 or both bfloat16) or raises. The kernel rounds each
    operation as the plain version does: the two agree bit for bit.
    """
    _check_device("gn_apply", x)
    return torch.ops.handnet_torch.gn_apply(x, stats, scale, bias, eps, relu)


gn_apply.launches = 0  # kernel launches, counted by the op's CUDA implementation

_LIB = torch.library.Library("handnet_torch", "FRAGMENT")
_LIB.define("gn_group_stats(Tensor x, int num_groups) -> Tensor")
_LIB.impl("gn_group_stats", gn_group_stats_reference, "CPU")
_LIB.impl("gn_group_stats", _gn_group_stats_cuda, "CUDA")
torch.library.register_fake(
    "handnet_torch::gn_group_stats",
    lambda x, num_groups: x.new_empty((x.shape[0], 2, num_groups), dtype=_acc_dtype(x)),
    lib=_LIB)
_LIB.define("gn_apply(Tensor x, Tensor stats, Tensor scale, Tensor bias, float eps, "
            "bool relu) -> Tensor")
_LIB.impl("gn_apply", gn_apply_reference, "CPU")
_LIB.impl("gn_apply", _gn_apply_cuda, "CUDA")
torch.library.register_fake(
    "handnet_torch::gn_apply", lambda x, stats, scale, bias, eps, relu: torch.empty_like(x),
    lib=_LIB)


def _backward_mask(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward ReLU's mask, ``y > 0`` of K2a's output in x's dtype,
    recomputed from x with the plain apply's operations (which K2a equals
    bit for bit)."""
    return gn_apply_reference(x, stats, scale, bias, eps) > 0


def gn_backward_sums_reference(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                               relu: bool = False):
    """Plain version of K2r: GroupNorm's backward sums, in float32 (float64
    for a float64 ``x``).

    With ``g = dy * [y > 0]`` (``g = dy`` without the ReLU), ``c = x -
    mean`` and ``inv = rsqrt(var + eps)`` from ``stats [B, 2, G]``, returns
    ``sums [B, 2, G]`` (``S1 = Σ g·scale`` and ``S2 = Σ g·scale·c`` over each
    image's group) and ``dparams [2, C]`` (``dscale = Σ g·c·inv`` and
    ``dbias = Σ g`` over B, H and W)."""
    acc = _acc_dtype(x)
    num_groups = stats.shape[-1]
    k = x.shape[-1] // num_groups
    g = dy.to(acc)
    if relu:
        g = torch.where(_backward_mask(x, stats, scale, bias, eps), g, 0.0)
    centred = x.to(acc) - _per_channel(stats[:, 0].to(acc), k)
    inv = torch.rsqrt(stats[:, 1].to(acc) + eps)
    g_scaled = g * scale.to(acc)
    sums = torch.stack([_group_sum(g_scaled, num_groups),
                        _group_sum(g_scaled * centred, num_groups)], dim=1)
    dscale = (g * centred * _per_channel(inv, k)).sum(dim=(0, 1, 2))
    return sums, torch.stack([dscale, g.sum(dim=(0, 1, 2))])


def gn_backward_dx_reference(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor, sums: torch.Tensor,
                             eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Plain version of K2d: ``dx = inv·(g·scale − S1/n) − c·inv³·S2/n`` from
    K2r's ``sums``, over each group's ``n = H·W·C/G`` values, in float32
    (float64 for a float64 ``x``), cast to x's dtype. The operations and
    their order are K2d's: ``((g·(inv·scale)) − inv·(S1·(1/n))) −
    c·(inv·inv·inv·(S2·(1/n)))``."""
    acc = _acc_dtype(x)
    b, h, w, c = x.shape
    num_groups = stats.shape[-1]
    k = c // num_groups
    inv_n = 1.0 / (h * w * k)
    inv = torch.rsqrt(stats[:, 1].to(acc) + eps)                          # [B, G]
    mul = (inv.repeat_interleave(k, dim=-1) * scale.to(acc))[:, None, None, :]
    shift = _per_channel(inv * (sums[:, 0].to(acc) * inv_n), k)
    slope = _per_channel(inv * inv * inv * (sums[:, 1].to(acc) * inv_n), k)
    g = dy.to(acc)
    if relu:
        g = torch.where(_backward_mask(x, stats, scale, bias, eps), g, 0.0)
    centred = x.to(acc) - _per_channel(stats[:, 0].to(acc), k)
    return (g * mul - shift - centred * slope).to(x.dtype)


def _check_backward(name: str, x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    sums: Optional[torch.Tensor] = None) -> int:
    """What K2r and K2d take on the card: x as K2s takes it (C/G 2 to
    64), dy of x's shape, dtype and layout, the parameters as K2a takes
    them. Returns G."""
    num_groups = _check_params(name, x, stats, scale, bias, sums)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy {dy.dtype} {tuple(dy.shape)} on {dy.device} must match "
                         f"x {x.dtype} {tuple(x.shape)} on {x.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"{name}: dy must be contiguous NHWC, 16-byte aligned")
    return num_groups


def _gn_backward_sums_cuda(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, eps: float, relu: bool):
    """CUDA implementation of ``handnet_torch::gn_backward_sums``: launches K2r."""
    num_groups = _check_backward("gn_backward_sums", x, dy, stats, scale, bias)
    b, h, w, c = x.shape
    plan = sums_plan(b, h * w, c, x.element_size(), scratch.sm_count(x.device.index))
    runs = -(-b // SUMS_IMAGE_FOLD)
    sums = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    dparams = torch.empty((2, c), dtype=torch.float32, device=x.device)
    # per image: each block's per-channel partials, then the image's dparams
    # terms; then each run of images' sums
    work = torch.empty((b * (plan.splits + 1) + runs, 2, c), dtype=torch.float32,
                       device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = scratch.split_counters(x.device, stream, b + runs + 1)
        code = lib.hn_gn_backward_sums(x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
                                       scale.data_ptr(), bias.data_ptr(), sums.data_ptr(),
                                       dparams.data_ptr(), work.data_ptr(),
                                       counters.data_ptr(), b, h * w, c, num_groups, plan.cp,
                                       plan.rows, plan.splits, plan.per_split, SUMS_IMAGE_FOLD,
                                       eps, int(relu), _DTYPE_CODES[x.dtype],
                                       _DTYPE_CODES[scale.dtype], stream)
    build.check_launch("hn_gn_backward_sums", code)
    gn_backward_sums.launches += 1
    return sums, dparams


def gn_backward_sums(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                     relu: bool = False):
    """GroupNorm's backward sums in one read of x and dy: the op
    ``handnet_torch::gn_backward_sums``. Returns ``(sums [B, 2, G], dparams
    [2, C])`` float32, as :func:`gn_backward_sums_reference` defines them.

    A CPU tensor takes the plain version; a CUDA tensor launches K2r (x and
    dy of one dtype, float32 or bfloat16, contiguous NHWC, 16-byte aligned;
    ``stats`` from :func:`gn_group_stats`; ``scale`` and ``bias`` as
    :func:`gn_apply` takes them) or raises. Two launches on the same inputs
    give the same bits.
    """
    _check_device("gn_backward_sums", x)
    return torch.ops.handnet_torch.gn_backward_sums(x, dy, stats, scale, bias, eps, relu)


gn_backward_sums.launches = 0  # kernel launches, counted by the op's CUDA implementation


def _gn_backward_dx_cuda(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor, sums: torch.Tensor,
                         eps: float, relu: bool) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::gn_backward_dx``: launches K2d."""
    num_groups = _check_backward("gn_backward_dx", x, dy, stats, scale, bias, sums=sums)
    b, h, w, c = x.shape
    plan = row_plan(b, h * w, c, x.element_size(), scratch.sm_count(x.device.index),
                    DX_UNROLL, DX_BLOCKS_PER_SM, _MAX_ROW_CHUNKS)
    dx = torch.empty_like(x)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.hn_gn_backward_dx(x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
                                     scale.data_ptr(), bias.data_ptr(), sums.data_ptr(),
                                     dx.data_ptr(), b, h * w, c, num_groups, plan.cp, plan.rows,
                                     plan.splits, plan.per_split, eps,
                                     1.0 / (h * w * (c // num_groups)), int(relu),
                                     _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], stream)
    build.check_launch("hn_gn_backward_dx", code)
    gn_backward_dx.launches += 1
    return dx


def gn_backward_dx(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, sums: torch.Tensor,
                   eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """GroupNorm's dx in one pass, from K2r's ``sums``: the op
    ``handnet_torch::gn_backward_dx``; a new tensor of x's shape and dtype.

    A CPU tensor takes :func:`gn_backward_dx_reference`; a CUDA tensor
    launches K2d (inputs as :func:`gn_backward_sums` takes them, ``sums``
    contiguous float32 ``[B, 2, G]``) or raises. Given the same sums, the
    kernel and the plain version agree bit for bit.
    """
    _check_device("gn_backward_dx", x)
    return torch.ops.handnet_torch.gn_backward_dx(x, dy, stats, scale, bias, sums, eps, relu)


gn_backward_dx.launches = 0  # kernel launches, counted by the op's CUDA implementation

_LIB.define("gn_backward_sums(Tensor x, Tensor dy, Tensor stats, Tensor scale, Tensor bias, "
            "float eps, bool relu) -> (Tensor, Tensor)")
_LIB.impl("gn_backward_sums", gn_backward_sums_reference, "CPU")
_LIB.impl("gn_backward_sums", _gn_backward_sums_cuda, "CUDA")
torch.library.register_fake(
    "handnet_torch::gn_backward_sums",
    lambda x, dy, stats, scale, bias, eps, relu: (
        x.new_empty((x.shape[0], 2, stats.shape[-1]), dtype=_acc_dtype(x)),
        x.new_empty((2, x.shape[-1]), dtype=_acc_dtype(x))),
    lib=_LIB)
_LIB.define("gn_backward_dx(Tensor x, Tensor dy, Tensor stats, Tensor scale, Tensor bias, "
            "Tensor sums, float eps, bool relu) -> Tensor")
_LIB.impl("gn_backward_dx", gn_backward_dx_reference, "CPU")
_LIB.impl("gn_backward_dx", _gn_backward_dx_cuda, "CUDA")
torch.library.register_fake(
    "handnet_torch::gn_backward_dx",
    lambda x, dy, stats, scale, bias, sums, eps, relu: torch.empty_like(x), lib=_LIB)


# profiler ranges around the two registered gradients: a profile reads the
# device time of an op's plain gradient from them
GN_BACKWARD_RANGES = ("handnet_torch::gn_group_stats_backward",
                      "handnet_torch::gn_apply_backward")


def _per_channel(t: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, G]`` per-group values -> ``[B, 1, 1, C]``, broadcast over NHWC."""
    return t.repeat_interleave(k, dim=-1)[:, None, None, :]


def _group_sum(t: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, G]``: the sum over each image's group."""
    return t.sum(dim=(1, 2)).unflatten(-1, (num_groups, -1)).sum(dim=-1)


def _stats_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0], output)


def _stats_backward(ctx, grad_stats):
    """d mean / dx = 1/n and d var / dx = 2 (x - mean) / n over each group's
    n = H·W·C/G values (the biased variance's derivative through its mean
    vanishes, since the deviations sum to zero)."""
    x, stats = ctx.saved_tensors
    acc = _acc_dtype(x)
    b, h, w, c = x.shape
    num_groups = stats.shape[-1]
    k = c // num_groups
    n = h * w * k
    with torch.profiler.record_function(GN_BACKWARD_RANGES[0]):
        grad_stats = grad_stats.to(acc)
        centred = x.to(acc) - _per_channel(stats[:, 0].to(acc), k)
        dx = _per_channel(grad_stats[:, 0] / n, k) + centred * _per_channel(
            grad_stats[:, 1] * (2.0 / n), k)
        return dx.to(x.dtype), None


def _apply_setup(ctx, inputs, output) -> None:
    x, stats, scale, _, ctx.eps, ctx.relu = inputs
    ctx.bias_dtype = inputs[3].dtype
    ctx.save_for_backward(x, stats, scale, output if ctx.relu else None)


def _apply_backward(ctx, grad_y):
    """The gradients of ``y = relu((x - mean) * rsqrt(var + eps) * scale +
    bias)`` with respect to x, the statistics, scale and bias. The ReLU's
    mask is ``y > 0``: the cast output, as flax's ``nn.relu`` sees it."""
    x, stats, scale, y = ctx.saved_tensors
    acc = _acc_dtype(x)
    num_groups = stats.shape[-1]
    k = x.shape[-1] // num_groups
    with torch.profiler.record_function(GN_BACKWARD_RANGES[1]):
        g = grad_y.to(acc)
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        inv = torch.rsqrt(stats[:, 1].to(acc) + ctx.eps)                    # [B, G]
        centred = x.to(acc) - _per_channel(stats[:, 0].to(acc), k)
        g_scaled = g * scale.to(acc)
        d_mean = -_group_sum(g_scaled, num_groups) * inv
        d_var = -0.5 * _group_sum(g_scaled * centred, num_groups) * inv ** 3
        d_scale = (g * centred * _per_channel(inv, k)).sum(dim=(0, 1, 2))
        return ((g_scaled * _per_channel(inv, k)).to(x.dtype),
                torch.stack([d_mean, d_var], dim=1).to(stats.dtype),
                d_scale.to(scale.dtype), g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype), None, None)


torch.library.register_autograd("handnet_torch::gn_group_stats", _stats_backward,
                                setup_context=_stats_setup, lib=_LIB)
torch.library.register_autograd("handnet_torch::gn_apply", _apply_backward,
                                setup_context=_apply_setup, lib=_LIB)


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float = 1e-5,
                         relu: bool = False) -> torch.Tensor:
    """Plain version of :func:`group_norm`: the plain statistics, then the
    plain apply."""
    return gn_apply_reference(x, gn_group_stats_reference(x, num_groups), scale, bias,
                              eps, relu)


def _nhwc_grad(dy: torch.Tensor) -> torch.Tensor:
    """dy as K2r and K2d read it: contiguous NHWC, 16-byte aligned. A copy
    is made only where dy is not, and counted in ``group_norm.dy_copies``."""
    if dy.is_contiguous() and dy.data_ptr() % 16 == 0:
        return dy
    group_norm.dy_copies += 1
    return dy.clone(memory_format=torch.contiguous_format)


class _GroupNormFunction(torch.autograd.Function):
    """``group_norm`` with grad: K2s and K2a forward, K2r and K2d backward
    (their plain versions on the CPU). Saves x, the statistics and the
    parameters; the backward recomputes the ReLU mask from them."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, relu):
        stats = gn_group_stats(x, num_groups)
        ctx.save_for_backward(x, stats, scale, bias)
        ctx.eps, ctx.relu = eps, relu
        return gn_apply(x, stats, scale, bias, eps, relu)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stats, scale, bias = ctx.saved_tensors
        dy = _nhwc_grad(dy)
        sums, dparams = gn_backward_sums(x, dy, stats, scale, bias, ctx.eps, ctx.relu)
        dx = (gn_backward_dx(x, dy, stats, scale, bias, sums, ctx.eps, ctx.relu)
              if ctx.needs_input_grad[0] else None)
        return dx, dparams[0].to(scale.dtype), dparams[1].to(bias.dtype), None, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5, relu: bool = False,
               use_kernel: bool = True) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of NHWC ``x``, then a ReLU if
    ``relu``.

    Matches ``flax.linen.GroupNorm(num_groups, epsilon=eps,
    use_fast_variance=False)`` to fp tolerance:
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, returned in
    ``x.dtype``. On a CUDA tensor it is K2s then K2a, two launches and no
    other pass over the activation; when grad is on and x, scale or bias
    requires it, the backward is K2r then K2d, two more
    (:class:`_GroupNormFunction`). On a CPU tensor the same calls take the
    plain versions; with ``use_kernel`` False it is
    :func:`group_norm_reference`, which autograd differentiates.
    """
    if not use_kernel:
        return group_norm_reference(x, scale, bias, num_groups, eps, relu)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormFunction.apply(x, scale, bias, num_groups, eps, relu)
    return gn_apply(x, gn_group_stats(x, num_groups), scale, bias, eps, relu)


group_norm.dy_copies = 0  # gradients copied to contiguous NHWC before K2r and K2d


class _Stat(NamedTuple):
    n: float              # values folded so far: the same for every group
    mean: torch.Tensor
    m2: torch.Tensor


def _chan_combine(a: _Stat, b: _Stat) -> _Stat:
    """``chan_combine`` of gn_stats.cu."""
    if b.n == 0:
        return a
    if a.n == 0:
        return b
    total = a.n + b.n
    delta = b.mean - a.mean
    frac = torch.tensor(b.n, dtype=torch.float32) / torch.tensor(total, dtype=torch.float32)
    return _Stat(total, a.mean + delta * frac, a.m2 + (b.m2 + delta * delta * a.n * frac))


def _fold_rows(parts: List[_Stat]) -> _Stat:
    """``fold_rows`` of gn_stats.cu: row r takes row r + ceil(active / 2)
    while the active rows halve."""
    parts = list(parts)
    active = len(parts)
    while active > 1:
        half = (active + 1) // 2
        for row in range(active - half):
            parts[row] = _chan_combine(parts[row], parts[row + half])
        active = half
    return parts[0]


def _two_pass(vals: torch.Tensor) -> _Stat:
    """``two_pass`` of gn_stats.cu over the last axis."""
    count = vals.shape[-1]
    mean = vals.sum(dim=-1) * (1.0 / count)
    return _Stat(float(count), mean, (vals - mean[..., None]).square().sum(dim=-1))


def gn_stats_split_emulation(x: torch.Tensor, num_groups: int, plan: RowPlan,
                             unroll: int = STATS_UNROLL) -> torch.Tensor:
    """K2s's walk and fold (``csrc/gn_stats.cu``) in float32 tensor code, for
    any ``plan``: every thread's unrolled trips and ragged end, the tree over
    a block's rows, the chunk columns of a group (runs of ``STATS_RUN`` in
    order, the runs by the rows' tree), and the splits in order.

    It shares the kernel's structure, not its bits (a sum inside one trip may
    run in another order); a CPU test holds it against
    :func:`gn_group_stats_reference`.
    """
    b, h, w, c = x.shape
    hw, k = h * w, c // num_groups
    per_chunk = c // plan.cp               # E: values in a 16-byte chunk
    width = min(k, per_chunk)              # W: of them, in one group
    span = k // width                      # J: chunk columns of one group
    # [B, HW, chunk column, groups in the chunk, W]
    xf = x.float().reshape(b, hw, plan.cp, per_chunk // width, width)
    zero = _Stat(0.0, torch.zeros(()), torch.zeros(()))
    partials = []
    for split in range(plan.splits):
        p0, p1 = split * plan.per_split, min(hw, (split + 1) * plan.per_split)
        rows = []
        for row in range(plan.rows):
            st, p = zero, p0 + row
            while p + (unroll - 1) * plan.rows < p1:       # an unrolled trip
                trip = xf[:, p:p + unroll * plan.rows:plan.rows]
                st = _chan_combine(st, _two_pass(trip.permute(0, 2, 3, 1, 4).flatten(-2)))
                p += unroll * plan.rows
            while p < p1:                                  # the ragged end
                st = _chan_combine(st, _two_pass(xf[:, p]))
                p += plan.rows
            rows.append(st)
        block = _fold_rows(rows)                           # mean, m2: [B, cp, S]
        if block.n == 0:
            raise AssertionError(f"split {split} of {plan} is empty")
        cols = [_Stat(block.n, block.mean[:, i::span, 0], block.m2[:, i::span, 0])
                for i in range(span)] if span > 1 else [
            _Stat(block.n, block.mean.flatten(1), block.m2.flatten(1))]
        run = min(span, STATS_RUN)
        runs = []
        for first in range(0, span, run):                  # a run of columns, in order
            group = cols[first]
            for col in cols[first + 1:first + run]:
                group = _chan_combine(group, col)
            runs.append(group)
        partials.append(_fold_rows(runs))                  # the runs' tree; mean, m2: [B, G]
    lanes = min(plan.splits, plan.rows * plan.cp // num_groups)
    folded = []
    for lane in range(lanes):                              # splits lane, lane + lanes, ...
        acc = zero
        for part in partials[lane::lanes]:
            acc = _chan_combine(acc, part)
        folded.append(acc)
    total = _fold_rows(folded)
    if total.n != hw * k:
        raise AssertionError(f"{plan} covers {total.n} values per group, not {hw * k}")
    return torch.stack([total.mean, total.m2 / total.n], dim=1)


def gn_backward_split_emulation(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor, eps: float,
                                relu: bool, plan: RowPlan):
    """K2r's walk and folds (``csrc/gn_backward_sums.cu``) in float32 tensor
    code, for any ``plan``: each thread's running per-channel sums of ``g``
    and ``g·c`` over its pixels in order, the tree over a block's rows, the
    splits of an image in order, the group sums of ``scale·Σ``, each image's
    ``dscale`` and ``dbias`` terms, the images in runs of
    ``SUMS_IMAGE_FOLD`` in order, and the runs in order (one run: its sum
    is ``dparams``).

    It shares the kernel's structure, not its bits (the kernel fuses
    multiply-adds); a CPU test holds it against
    :func:`gn_backward_sums_reference`. Returns ``(sums, dparams)``.
    """
    b, h, w, c = x.shape
    hw, num_groups = h * w, stats.shape[-1]
    k = c // num_groups
    g = dy.float().reshape(b, hw, c)
    if relu:
        g = torch.where(_backward_mask(x, stats, scale, bias, eps).reshape(b, hw, c), g, 0.0)
    mean = stats[:, 0].float().repeat_interleave(k, dim=-1)                   # [B, C]
    centred = x.float().reshape(b, hw, c) - mean[:, None, :]
    zero = torch.zeros(b, 2, c)
    seen = torch.zeros(hw, dtype=torch.int64)
    image = []
    for split in range(plan.splits):
        p0, p1 = split * plan.per_split, min(hw, (split + 1) * plan.per_split)
        rows = []
        for row in range(plan.rows):                       # a thread's pixels, in order
            acc = zero.clone()
            for p in range(p0 + row, p1, plan.rows):
                acc[:, 0] += g[:, p]
                acc[:, 1] += g[:, p] * centred[:, p]
                seen[p] += 1
            rows.append(acc)
        active = len(rows)                                 # the block's tree over rows
        while active > 1:
            half = (active + 1) // 2
            for row in range(active - half):
                rows[row] = rows[row] + rows[row + half]
            active = half
        image.append(rows[0])                              # the block's partial [B, 2, C]
    if not bool((seen == 1).all()):
        raise AssertionError(f"{plan} does not cover each of {hw} pixels once")
    folded = _fold_in_order(image)                         # an image's splits, in order
    scaled = (folded * scale.float()).unflatten(-1, (num_groups, k))        # [B, 2, G, K]
    sums = scaled[..., 0]
    for i in range(1, k):                                  # a group's channels, in order
        sums = sums + scaled[..., i]
    inv = torch.rsqrt(stats[:, 1].float() + eps).repeat_interleave(k, dim=-1)
    terms = torch.stack([inv * folded[:, 1], folded[:, 0]], dim=1)          # [B, 2, C]
    runs = [_fold_in_order(terms[first:first + SUMS_IMAGE_FOLD])           # images, in order
            for first in range(0, b, SUMS_IMAGE_FOLD)]
    return sums, runs[0] if len(runs) == 1 else _fold_in_order(runs)       # runs, in order


def _fold_in_order(parts) -> torch.Tensor:
    """``fold_columns`` of gn_backward_sums.cu: zero, plus each part in order."""
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc
