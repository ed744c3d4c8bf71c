"""GroupNorm over NHWC activations: statistics from CUDA kernel K2.

Counterpart of ``handnet_tpu/ops/pallas_gn.py:123-169``. The statistics
(per-(image, group) mean and biased variance, exact two-pass numerics) come
from ``csrc/gn_stats.cu`` on a CUDA tensor and from
:func:`gn_group_stats_reference` on a CPU tensor; the normalize and affine
apply stays plain PyTorch, as the JAX package left it to XLA.
"""

from __future__ import annotations

import torch

from handnet_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_GROUP_WIDTHS = (2, 4, 8, 16)  # GroupNorm(32) over 64..512 channels


def gn_group_stats_reference(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of K2: ``[B, H, W, C]`` -> ``[B, 2, G]`` float32 (group
    means, biased group variances).

    The corrected two-pass form in float32: the deviations from a first
    mean give both the variance and a correction of that mean, so neither
    loses precision when mean >> std.
    """
    b, h, w, c = x.shape
    g = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 3))
    dev = g - mean[:, None, :, None]
    correction = dev.mean(dim=(1, 3))
    var = dev.square().mean(dim=(1, 3)) - correction.square()
    return torch.stack([mean + correction, var], dim=1)


def gn_group_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-(image, group) GroupNorm statistics of NHWC ``x`` in one read.

    Returns ``[B, 2, G]`` float32: ``[:, 0]`` means, ``[:, 1]`` biased
    variances over (H, W, C/G), as flax ``GroupNorm(use_fast_variance=False)``
    computes them. A CPU tensor takes :func:`gn_group_stats_reference`; a
    CUDA tensor launches the kernel (float32 or bfloat16, contiguous NHWC,
    16-byte aligned) or raises.
    """
    if x.device.type == "cpu":
        return gn_group_stats_reference(x, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"gn_group_stats: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"gn_group_stats: expected [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_group_stats: dtype {x.dtype} (float32 or bfloat16 only)")
    b, h, w, c = x.shape
    if c % num_groups or c // num_groups not in _SUPPORTED_GROUP_WIDTHS:
        raise ValueError(f"gn_group_stats: C={c}, G={num_groups}: C/G must be one "
                         f"of {_SUPPORTED_GROUP_WIDTHS}")
    if b * h * w == 0:
        raise ValueError(f"gn_group_stats: empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gn_group_stats: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError("gn_group_stats: x must be 16-byte aligned")
    out = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.hn_gn_group_stats(x.data_ptr(), out.data_ptr(), b, h * w, c,
                                     num_groups, _DTYPE_CODES[x.dtype], stream)
    build.check_launch("hn_gn_group_stats", code)
    gn_group_stats.launches += 1
    return out


gn_group_stats.launches = 0  # kernel launches, counted by the wrapper


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               use_kernel: bool = True) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of NHWC ``x``.

    Matches ``flax.linen.GroupNorm(num_groups, epsilon=eps,
    use_fast_variance=False)`` to fp tolerance: statistics from K2 (or its
    plain version when ``use_kernel`` is False), then
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32, returned in
    ``x.dtype``.
    """
    stats = (gn_group_stats(x, num_groups) if use_kernel
             else gn_group_stats_reference(x, num_groups))
    k = x.shape[-1] // num_groups
    mean = stats[:, 0].repeat_interleave(k, dim=-1)[:, None, None, :]
    inv = torch.rsqrt(stats[:, 1] + eps).repeat_interleave(k, dim=-1)
    mul = (inv * scale.float())[:, None, None, :]
    y = (x.float() - mean).mul_(mul).add_(bias.float())
    return y.to(x.dtype)
