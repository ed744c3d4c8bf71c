"""A2J anchor decode: CUDA kernel K1 and its plain version.

Counterpart of ``handnet_tpu/ops/pallas_a2j.py:26-75`` and of the einsum path
of ``handnet_tpu/models/a2j.py:144-153``. Per image and joint: a softmax over
the N anchors, then the softmax-weighted means of ``anchor + offset`` and of
depth.
"""

from __future__ import annotations

import torch

from handnet_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_JOINTS = 1024  # one block holds one thread per joint at least


def a2j_decode_reference(cls: torch.Tensor, reg: torch.Tensor,
                         depth: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 (the einsum form): ``cls [B,N,P]``,
    ``reg [B,N,P,2]``, ``depth [B,N,P]``, ``anchors [N,2]`` -> ``[B,P,3]``
    float32."""
    w = torch.softmax(cls.float(), dim=1)                       # [B, N, P]
    pos = anchors.float()[None, :, None, :] + reg.float()       # [B, N, P, 2]
    xy = torch.einsum("bnp,bnpc->bpc", w, pos)
    d = torch.einsum("bnp,bnp->bp", w, depth.float())
    return torch.cat([xy, d[..., None]], dim=-1)


def a2j_decode(cls: torch.Tensor, reg: torch.Tensor, depth: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
    """Fused A2J decode -> UVD ``[B, P, 3]`` float32.

    A CPU tensor takes :func:`a2j_decode_reference`. CUDA tensors launch the
    kernel, which reads ``cls``, ``reg`` and ``depth`` in place through their
    strides (one dtype for all three: float32 or bfloat16) with float32
    ``anchors [N, 2]``; anything else raises.
    """
    if cls.device.type == "cpu":
        return a2j_decode_reference(cls, reg, depth, anchors)
    if cls.device.type != "cuda":
        raise ValueError(f"a2j_decode: unsupported device {cls.device}")
    if cls.dim() != 3:
        raise ValueError(f"a2j_decode: cls must be [B, N, P], got {tuple(cls.shape)}")
    b, n, p = cls.shape
    if tuple(reg.shape) != (b, n, p, 2) or tuple(depth.shape) != (b, n, p):
        raise ValueError(f"a2j_decode: shapes cls {tuple(cls.shape)}, reg "
                         f"{tuple(reg.shape)}, depth {tuple(depth.shape)} disagree")
    if tuple(anchors.shape) != (n, 2):
        raise ValueError(f"a2j_decode: anchors must be [{n}, 2], got {tuple(anchors.shape)}")
    for name, t in (("reg", reg), ("depth", depth), ("anchors", anchors)):
        if t.device != cls.device:
            raise ValueError(f"a2j_decode: {name} on {t.device}, cls on {cls.device}")
    if cls.dtype not in _DTYPE_CODES or reg.dtype != cls.dtype or depth.dtype != cls.dtype:
        raise TypeError(f"a2j_decode: dtypes {cls.dtype}/{reg.dtype}/{depth.dtype}: "
                        "one of float32 or bfloat16 for all three")
    if anchors.dtype != torch.float32 or not anchors.is_contiguous():
        raise ValueError("a2j_decode: anchors must be contiguous float32")
    if b == 0 or n == 0 or not 1 <= p <= _MAX_JOINTS:
        raise ValueError(f"a2j_decode: unsupported sizes B={b}, N={n}, P={p}")
    out = torch.empty((b, p, 3), dtype=torch.float32, device=cls.device)
    lib = build.load_library()
    with torch.cuda.device(cls.device):
        stream = torch.cuda.current_stream(cls.device).cuda_stream
        code = lib.hn_a2j_decode(
            cls.data_ptr(), reg.data_ptr(), depth.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), b, n, p, *cls.stride(), *reg.stride(), *depth.stride(),
            _DTYPE_CODES[cls.dtype], stream)
    build.check_launch("hn_a2j_decode", code)
    a2j_decode.launches += 1
    return out


a2j_decode.launches = 0  # kernel launches, counted by the wrapper
