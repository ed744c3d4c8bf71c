"""A2J anchor decode: CUDA kernel K1, its depth-free variant K1xy, and
their plain versions.

Counterpart of ``handnet_tpu/ops/pallas_a2j.py:26-75`` and of the einsum path
of ``handnet_tpu/models/a2j.py:144-153``. Per image and joint: a softmax over
the N anchors, then the softmax-weighted means of ``anchor + offset`` and of
depth. K1xy serves the 2D A2J (no depth head): the same kernel
(``kDepth`` false) without the depth stream, ``[B, P, 2]`` out.

The kernel (``csrc/a2j_decode.cu``) cuts an image's anchors into splits, one
block each, and stages each block's anchors through shared memory in chunks,
copied as flat runs of 16 bytes (:func:`decode_plan`).
:func:`staged_elements` transcribes which element each copy and each thread
touches, so that a CPU test can check that every ``(anchor, joint)`` is
copied once and read once, by a thread of its joint.

The kernels are the ``torch.library`` ops ``handnet_torch::a2j_decode`` and
``handnet_torch::a2j_decode_xy``: the CPU implementation is the plain
version, the CUDA implementation checks the inputs and launches the kernel,
and the fake implementation gives ``torch.export`` the output's shape, so an
exported graph records the op itself.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from handnet_tpu_torch.kernels import build, scratch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 512           # kMaxThreads of a2j_decode.cu
_MAX_JOINTS = _MAX_THREADS   # a block holds at least one thread per joint
_STAGE_BYTES = 42 * 1024     # kStageBytes: a chunk's cls, depth and reg in shared memory
# values staged per (anchor, joint): cls, depth, reg u and v; K1xy has no depth
_STAGED_VALUES = {True: 4, False: 3}
# Blocks the plan aims at, per SM, over the whole batch, and never more: four
# blocks of 504 threads fit an SM, so at B=128 the grid is two full waves.
BLOCKS_PER_SM = 8
_MIN_ANCHORS_PER_SPLIT = 64


class DecodePlan(NamedTuple):
    """How K1 cuts ``[B, N, P]`` into blocks."""
    vec: int        # elements per staged copy: 16 / itemsize, or 1 (unaligned runs)
    rows: int       # anchor rows of a block: rows * P threads
    splits: int     # blocks per image (gridDim.x)
    per_split: int  # anchors per block; the last split may be shorter
    chunk: int      # anchors staged in shared memory at a time


def decode_plan(batch: int, n: int, p: int, itemsize: int, sm_count: int,
                aligned: bool = True, depth: bool = True) -> DecodePlan:
    """Blocks of at most 512 threads, one thread per (anchor row, joint);
    as many splits of N as keep ``batch * splits`` within ``BLOCKS_PER_SM``
    blocks per SM and a split at 64 anchors or more; chunks of at most 42 KB
    of the staged streams (cls, depth and reg's two values per element; K1xy,
    ``depth=False``, stages three values, so its chunks hold a third more
    anchors). Where an image's ``N * P`` values are whole 16-byte words (and
    the tensors are ``aligned``), splits and chunks are multiples of ``vec``
    anchors, so every staged run starts and ends on 16 bytes."""
    if not 1 <= p <= _MAX_JOINTS or n < 1 or batch < 1:
        raise ValueError(f"a2j_decode: unsupported sizes B={batch}, N={n}, P={p}")
    full = 16 // itemsize
    vec = full if aligned and (n * p) % full == 0 else 1
    rows = max(1, min(_MAX_THREADS // p, n))
    chunk = _STAGE_BYTES // (_STAGED_VALUES[depth] * p * itemsize) // vec * vec
    if chunk < 1:
        raise ValueError(f"a2j_decode: P={p} joints of {itemsize} bytes do not fit a "
                         f"{_STAGE_BYTES}-byte stage")
    want = BLOCKS_PER_SM * sm_count // batch
    splits = max(1, min(want, n // _MIN_ANCHORS_PER_SPLIT))
    per_split = -(-(-(-n // splits)) // vec) * vec
    return DecodePlan(vec, rows, -(-n // per_split), per_split, min(chunk, per_split))


def staged_elements(plan: DecodePlan, n: int, p: int, depth: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's index arithmetic for one image: for every staged copy, in
    launch order, the flat elements ``anchor * P + joint`` of ``cls`` it
    brings in (``copied``), and for every read a thread makes of the staged
    chunk, the flat element it reads (``read``) and the joint that thread
    owns (``read_joint``). The streams lie in shared memory one after the
    other (cls, depth where ``depth``, reg), each of ``chunk * P`` values
    per value of an element; every stream must start on a whole copy."""
    starts = [0, plan.chunk * p] if depth else [0]
    starts.append(starts[-1] + plan.chunk * p)                  # reg's (u, v) pairs
    if any(start % plan.vec for start in starts):
        raise AssertionError(f"{plan}: a staged stream does not start on a whole "
                             f"{plan.vec}-element copy")
    copied, read, read_joint = [], [], []
    threads = plan.rows * p
    for split in range(plan.splits):
        a_end = min(n, (split + 1) * plan.per_split)
        for a0 in range(split * plan.per_split, a_end, plan.chunk):
            count = min(plan.chunk, a_end - a0)
            first = a0 * p
            if (count * p) % plan.vec or first % plan.vec:
                raise AssertionError(f"chunk at anchor {a0} of {plan}: a {plan.vec}-element "
                                     "copy would not start and end on whole words")
            for i in range(count * p // plan.vec):          # copy i of the chunk
                copied.append(first + i * plan.vec + np.arange(plan.vec))
            tid = np.arange(threads)
            for a in range(0, count, plan.rows):            # the threads' trips
                anchor = a + tid // p
                live = anchor < count
                read.append(first + anchor[live] * p + tid[live] % p)
                read_joint.append(tid[live] % p)
    return np.concatenate(copied), np.concatenate(read), np.concatenate(read_joint)


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


def a2j_decode_xy_reference(cls: torch.Tensor, reg: torch.Tensor,
                            anchors: torch.Tensor) -> torch.Tensor:
    """Plain version of K1xy (the softmax and one einsum): ``cls [B,N,P]``,
    ``reg [B,N,P,2]``, ``anchors [N,2]`` -> ``[B,P,2]`` float32."""
    w = torch.softmax(cls.float(), dim=1)                       # [B, N, P]
    pos = anchors.float()[None, :, None, :] + reg.float()       # [B, N, P, 2]
    return torch.einsum("bnp,bnpc->bpc", w, pos)


def _launch(name: str, cls: torch.Tensor, reg: torch.Tensor, depth, anchors: torch.Tensor
            ) -> torch.Tensor:
    """Check what K1 (``depth`` a tensor) or K1xy (``depth`` None) takes,
    then launch it on the current stream: ``[B, P, 3]`` or ``[B, P, 2]``."""
    if cls.dim() != 3:
        raise ValueError(f"{name}: cls must be [B, N, P], got {tuple(cls.shape)}")
    b, n, p = cls.shape
    heads = (("cls", cls), ("reg", reg)) + ((("depth", depth),) if depth is not None else ())
    if tuple(reg.shape) != (b, n, p, 2) or (depth is not None
                                             and tuple(depth.shape) != (b, n, p)):
        raise ValueError(f"{name}: shapes " + ", ".join(f"{k} {tuple(t.shape)}"
                                                       for k, t in heads) + " disagree")
    if tuple(anchors.shape) != (n, 2):
        raise ValueError(f"{name}: anchors must be [{n}, 2], got {tuple(anchors.shape)}")
    for key, t in heads[1:] + (("anchors", anchors),):
        if t.device != cls.device:
            raise ValueError(f"{name}: {key} on {t.device}, cls on {cls.device}")
    if cls.dtype not in _DTYPE_CODES or any(t.dtype != cls.dtype for _, t in heads):
        raise TypeError(f"{name}: dtypes " + "/".join(str(t.dtype) for _, t in heads)
                        + f": one of float32 or bfloat16 for all {len(heads)}")
    if (anchors.dtype != torch.float32 or not anchors.is_contiguous()
            or anchors.data_ptr() % 8):
        raise ValueError(f"{name}: anchors must be contiguous float32, 8-byte aligned")
    for key, t in heads:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous (strides "
                             f"{t.stride()}); call .contiguous() on a strided view")
    aligned = not any(t.data_ptr() % 16 for _, t in heads)
    with_depth = depth is not None
    plan = decode_plan(b, n, p, cls.element_size(), scratch.sm_count(cls.device.index),
                       aligned, depth=with_depth)
    out = torch.empty((b, p, 3 if with_depth else 2), dtype=torch.float32, device=cls.device)
    lib = build.load_library()
    with torch.cuda.device(cls.device):
        stream = torch.cuda.current_stream(cls.device).cuda_stream
        partials = counters = None
        if plan.splits > 1:  # the blocks of an image meet in a workspace
            partials = torch.empty((b, plan.splits, 5 if with_depth else 4, p),
                                   dtype=torch.float32, device=cls.device)
            counters = scratch.split_counters(cls.device, stream, b)
        common = (anchors.data_ptr(), out.data_ptr(), scratch.ptr(partials),
                  scratch.ptr(counters), b, n, p, *plan, _DTYPE_CODES[cls.dtype], stream)
        if with_depth:
            entry = "hn_a2j_decode"
            code = lib.hn_a2j_decode(cls.data_ptr(), reg.data_ptr(), depth.data_ptr(), *common)
        else:
            entry = "hn_a2j_decode_xy"
            code = lib.hn_a2j_decode_xy(cls.data_ptr(), reg.data_ptr(), *common)
    build.check_launch(entry, code)
    return out


def _a2j_decode_cuda(cls: torch.Tensor, reg: torch.Tensor, depth: torch.Tensor,
                     anchors: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::a2j_decode``: launches K1."""
    out = _launch("a2j_decode", cls, reg, depth, anchors)
    a2j_decode.launches += 1
    return out


def _a2j_decode_xy_cuda(cls: torch.Tensor, reg: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    """CUDA implementation of ``handnet_torch::a2j_decode_xy``: launches K1xy."""
    out = _launch("a2j_decode_xy", cls, reg, None, anchors)
    a2j_decode_xy.launches += 1
    return out


def _a2j_decode_fake(cls: torch.Tensor, reg: torch.Tensor, depth: torch.Tensor,
                     anchors: torch.Tensor) -> torch.Tensor:
    return cls.new_empty((cls.shape[0], cls.shape[2], 3), dtype=torch.float32)


def _a2j_decode_xy_fake(cls: torch.Tensor, reg: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    return cls.new_empty((cls.shape[0], cls.shape[2], 2), dtype=torch.float32)


_LIB = torch.library.Library("handnet_torch", "FRAGMENT")
_LIB.define("a2j_decode(Tensor cls, Tensor reg, Tensor depth, Tensor anchors) -> Tensor")
_LIB.impl("a2j_decode", a2j_decode_reference, "CPU")
_LIB.impl("a2j_decode", _a2j_decode_cuda, "CUDA")
torch.library.register_fake("handnet_torch::a2j_decode", _a2j_decode_fake, lib=_LIB)
_LIB.define("a2j_decode_xy(Tensor cls, Tensor reg, Tensor anchors) -> Tensor")
_LIB.impl("a2j_decode_xy", a2j_decode_xy_reference, "CPU")
_LIB.impl("a2j_decode_xy", _a2j_decode_xy_cuda, "CUDA")
torch.library.register_fake("handnet_torch::a2j_decode_xy", _a2j_decode_xy_fake, lib=_LIB)


def a2j_decode(cls: torch.Tensor, reg: torch.Tensor, depth: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
    """Fused A2J decode -> UVD ``[B, P, 3]`` float32: the op
    ``handnet_torch::a2j_decode``.

    A CPU tensor takes :func:`a2j_decode_reference`. CUDA tensors launch the
    kernel, which reads contiguous ``cls``, ``reg`` and ``depth`` in place
    (one dtype for all three: float32 or bfloat16; ``reg``'s u and v stay
    interleaved) with float32 ``anchors [N, 2]``; anything else raises:
    a strided view is never copied silently. Two launches on the same
    inputs give the same bits.
    """
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a2j_decode: unsupported device {cls.device}")
    return torch.ops.handnet_torch.a2j_decode(cls, reg, depth, anchors)


a2j_decode.launches = 0  # kernel launches, counted by the op's CUDA implementation


def a2j_decode_xy(cls: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Fused A2J decode without depth -> UV ``[B, P, 2]`` float32: the op
    ``handnet_torch::a2j_decode_xy`` (K1xy), for the 2D A2J.

    A CPU tensor takes :func:`a2j_decode_xy_reference`; CUDA tensors launch
    the kernel under :func:`a2j_decode`'s rules (contiguous ``cls`` and
    ``reg`` of one dtype, float32 ``anchors``; anything else raises). Two
    launches on the same inputs give the same bits.
    """
    if cls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a2j_decode_xy: unsupported device {cls.device}")
    return torch.ops.handnet_torch.a2j_decode_xy(cls, reg, anchors)


a2j_decode_xy.launches = 0  # kernel launches, counted by the op's CUDA implementation
