"""GroupNorm over NHWC activations: CUDA kernels K2s and K2a.

Counterpart of ``handnet_tpu/ops/pallas_gn.py:123-169``. On a CUDA tensor
:func:`group_norm` is two launches: the statistics (per-(image, group) mean
and biased variance, exact two-pass numerics) from ``csrc/gn_stats.cu``
(K2s), then normalize, affine and the optional ReLU in one pass from
``csrc/gn_apply.cu`` (K2a) — the pass the JAX package leaves to XLA's
fusion. On a CPU tensor both take their plain versions
(:func:`gn_group_stats_reference`, :func:`gn_apply_reference`).

Both kernels walk an image the same way: a block is ``rows`` pixel rows by
``cp`` 16-byte chunk columns, and each image's pixels are cut into
``splits`` runs of ``per_split`` pixels, one block each (:func:`row_plan`).
K2s's blocks meet in a workspace and the last one folds the splits in order;
:func:`gn_stats_split_emulation` transcribes that walk and fold, so that a
CPU test can hold it against the plain version.

Each kernel is a ``torch.library`` op (``handnet_torch::gn_group_stats``,
``handnet_torch::gn_apply``): the CPU implementation is the plain version,
the CUDA one checks the input and launches the kernel, and the fake one
gives ``torch.export`` the output's shape. Each op has a registered
gradient (``torch.library.register_autograd``) in plain PyTorch, so the
training forward runs K2s and K2a and its backward runs no kernel of this
module: the JAX package's ``pallas_gn`` defines no gradient, and its
training towers are flax ``GroupNorm``s that XLA differentiates. The two
gradients compose into GroupNorm's backward; each works in float32 from
the saved input and statistics (float64 for a float64 input, which only
the plain versions take) and returns ``dx`` in x's dtype.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from handnet_tpu_torch.kernels import build, scratch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_GROUP_WIDTHS = (2, 4, 8, 16)  # GroupNorm(32) over 64..512 channels
_MAX_THREADS = 256       # kMaxThreads of gn_stats.cu and gn_apply.cu
STATS_UNROLL = 8         # kUnroll of gn_stats.cu: loads a thread has in flight
APPLY_UNROLL = 4         # kUnroll of gn_apply.cu
STATS_BLOCKS_PER_SM = 8  # blocks the plans aim at, per SM, over the whole batch
APPLY_BLOCKS_PER_SM = 16


class RowPlan(NamedTuple):
    """How K2s and K2a cut ``[B, HW, C]`` into blocks."""
    cp: int         # 16-byte chunks in a pixel's C channels: the block's columns
    rows: int       # pixel rows of a block: rows * cp threads
    splits: int     # blocks per image (gridDim.x)
    per_split: int  # pixels per block; the last split may be shorter


def row_plan(batch: int, hw: int, channels: int, itemsize: int, sm_count: int,
             unroll: int, blocks_per_sm: int) -> RowPlan:
    """Blocks of at most 256 threads that read whole pixel rows, and enough
    splits of HW that ``batch * splits`` reaches ``blocks_per_sm`` blocks per
    SM, as long as a split keeps one unrolled trip of the block
    (``rows * unroll`` pixels). Splits are whole trips, so only an image's
    last split is ragged."""
    row_bytes = channels * itemsize
    if row_bytes % 16 or row_bytes // 16 > _MAX_THREADS:
        raise ValueError(f"GroupNorm kernels: C={channels} x {itemsize} bytes must be a "
                         f"multiple of 16 bytes and at most {16 * _MAX_THREADS}")
    cp = row_bytes // 16
    rows = _MAX_THREADS // cp
    trip = rows * unroll
    want = -(-blocks_per_sm * sm_count // batch)
    splits = max(1, min(want, -(-hw // trip)))
    per_split = -(-(-(-hw // splits)) // trip) * trip
    return RowPlan(cp, rows, -(-hw // per_split), per_split)


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
    """What K2s and K2a take on the card: float32 or bfloat16, contiguous
    NHWC, 16-byte aligned, C/G one of the supported widths."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} (float32 or bfloat16 only)")
    b, h, w, c = x.shape
    if c % num_groups or c // num_groups not in _SUPPORTED_GROUP_WIDTHS:
        raise ValueError(f"{name}: C={c}, G={num_groups}: C/G must be one "
                         f"of {_SUPPORTED_GROUP_WIDTHS}")
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
                    STATS_UNROLL, STATS_BLOCKS_PER_SM)
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


def _gn_apply_cuda(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::gn_apply``: launches K2a."""
    if stats.dim() != 3:
        raise ValueError(f"gn_apply: stats must be [B, 2, G], got {tuple(stats.shape)}")
    num_groups = stats.shape[-1]
    _check_nhwc("gn_apply", x, num_groups)
    b, h, w, c = x.shape
    if (tuple(stats.shape) != (b, 2, num_groups) or stats.dtype != torch.float32
            or not stats.is_contiguous()):
        raise ValueError(f"gn_apply: stats must be contiguous float32 [{b}, 2, G], got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,) or not t.is_contiguous() or t.dtype != scale.dtype:
            raise ValueError(f"gn_apply: {name} must be contiguous [{c}] of scale's dtype")
    if scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_apply: scale and bias dtype {scale.dtype} (float32 or bfloat16)")
    for name, t in (("stats", stats), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"gn_apply: {name} on {t.device}, x on {x.device}")
    plan = row_plan(b, h * w, c, x.element_size(), scratch.sm_count(x.device.index),
                    APPLY_UNROLL, APPLY_BLOCKS_PER_SM)
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


# profiler ranges around the two gradients: a profile of a train step reads
# the GroupNorm backward's device time from them
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


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5, relu: bool = False,
               use_kernel: bool = True) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of NHWC ``x``, then a ReLU if
    ``relu``.

    Matches ``flax.linen.GroupNorm(num_groups, epsilon=eps,
    use_fast_variance=False)`` to fp tolerance:
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, returned in
    ``x.dtype``. On a CUDA tensor it is K2s then K2a, two launches and no
    other pass over the activation; on a CPU tensor, or with ``use_kernel``
    False, it is :func:`group_norm_reference`.
    """
    if not use_kernel:
        return group_norm_reference(x, scale, bias, num_groups, eps, relu)
    return gn_apply(x, gn_group_stats(x, num_groups), scale, bias, eps, relu)


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
    a block's rows, the chunk columns of a group, and the splits in order.

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
        group = cols[0]
        for col in cols[1:]:                               # serially, in column order
            group = _chan_combine(group, col)
        partials.append(group)                             # mean, m2: [B, G]
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
