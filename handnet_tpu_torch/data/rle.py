"""RLE binary-mask ops: the pycocotools.mask API on a C++ kernel.

A copy of ``handnet_tpu/data/rle.py`` (the port imports nothing of the JAX
package), with the same API and the same COCO compressed-counts codec:

    encode(mask)  decode(rle)  toBbox(rle)  area(rle)  iou(dt, gt, iscrowd)
    merge(rles, intersect=False)

RLE dicts are ``{'size': [h, w], 'counts': bytes}``. The run scans are the
C++ kernel ``native/rle/rle.cpp``, which is read and never written: it is
built with ``g++`` at first use into ``build/handnet_tpu_torch/rle/``
(``data/host_build.py``), and a failed build raises instead of falling
back. Each op's numpy route is its plain version, taken where ``native``
is False; the tests hold the two against each other and against the JAX
package's module.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from handnet_tpu_torch.data import host_build

_SRC = Path(__file__).resolve().parents[2] / "native" / "rle" / "rle.cpp"


def _lib() -> ctypes.CDLL:
    lib = host_build.load("rle", str(_SRC))
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_area.restype = ctypes.c_uint64
    lib.rle_iou.restype = ctypes.c_double
    lib.rle_merge.restype = ctypes.c_int
    return lib


def _u32(arr):
    return np.ascontiguousarray(arr, np.uint32)


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_char_p)


# ---------------------------------------------------------------------------
# counts <-> COCO compressed string (LEB128-with-sign-and-delta codec).


def counts_to_string(counts: np.ndarray) -> bytes:
    """COCO RLE char codec: delta-encode every count after the 2nd, then
    6-bit varint with 0x30 bias (the published pycocotools format)."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, c in enumerate(counts):
        x = c - (counts[i - 2] if i > 2 else 0)
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # sign-propagating arithmetic shift emulation
            if x == 0 and not (chunk & 0x10):
                more = False
            elif x == -1 and (chunk & 0x10):
                more = False
            else:
                more = True
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)


def string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


# ---------------------------------------------------------------------------
# Core ops (the C++ kernel, or the numpy route where ``native`` is False).


def _encode_counts(mask_colmajor_flat: np.ndarray, h: int, w: int,
                   native: bool = True) -> np.ndarray:
    if native:
        counts = np.empty(h * w + 1, np.uint32)
        m = np.ascontiguousarray(mask_colmajor_flat, np.uint8)
        n = _lib().rle_encode(_ptr(m), h, w, _ptr(counts))
        return counts[:n].copy()
    # run lengths via diff of change points
    m = mask_colmajor_flat.astype(bool)
    change = np.flatnonzero(m[1:] != m[:-1]) + 1
    bounds = np.concatenate([[0], change, [m.size]])
    runs = np.diff(bounds).astype(np.uint32)
    if m[0]:
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def encode(mask: np.ndarray, native: bool = True) -> Union[dict, List[dict]]:
    """Encode HxW (or HxWxN, fortran-order) uint8 masks to RLE dict(s)."""
    if mask.ndim == 2:
        h, w = mask.shape
        flat = np.asfortranarray(mask).ravel(order="F")
        counts = _encode_counts(flat, h, w, native)
        return {"size": [h, w], "counts": counts_to_string(counts)}
    assert mask.ndim == 3
    return [encode(mask[:, :, i], native) for i in range(mask.shape[2])]


def _get_counts(rle: dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return string_to_counts(c)
    return _u32(c)


def decode(rle: Union[dict, Sequence[dict]], native: bool = True) -> np.ndarray:
    if isinstance(rle, dict):
        h, w = rle["size"]
        counts = _get_counts(rle)
        if native:
            out = np.empty(h * w, np.uint8)
            _lib().rle_decode(_ptr(_u32(counts)), len(counts), h, w, _ptr(out))
        else:
            vals = np.zeros(len(counts), np.uint8)
            vals[1::2] = 1
            out = np.repeat(vals, counts.astype(np.int64))
            out = np.resize(out, h * w).astype(np.uint8)
        return out.reshape((w, h)).T  # column-major -> HxW
    return np.stack([decode(r, native) for r in rle], axis=2)


def area(rle: Union[dict, Sequence[dict]], native: bool = True):
    if isinstance(rle, dict):
        counts = _get_counts(rle)
        if native:
            return int(_lib().rle_area(_ptr(_u32(counts)), len(counts)))
        return int(counts[1::2].sum())
    return np.asarray([area(r, native) for r in rle])


def toBbox(rle: Union[dict, Sequence[dict]], native: bool = True) -> np.ndarray:
    """Tight [x, y, w, h] box (reference call site a2jdataset.py:219)."""
    if isinstance(rle, dict):
        h, w = rle["size"]
        counts = _get_counts(rle)
        if native:
            bbox = np.empty(4, np.float64)
            _lib().rle_to_bbox(_ptr(_u32(counts)), len(counts), h, w, _ptr(bbox))
            return bbox
        m = decode(rle, native=False)
        ys, xs = np.nonzero(m)
        if len(xs) == 0:
            return np.zeros(4)
        return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                           ys.max() - ys.min() + 1], np.float64)
    return np.stack([toBbox(r, native) for r in rle])


def iou(dt: Sequence[dict], gt: Sequence[dict],
        iscrowd: Optional[Sequence[int]] = None, native: bool = True) -> np.ndarray:
    """Pairwise IoU matrix [len(dt), len(gt)] (maskApi rleIou semantics)."""
    if iscrowd is None:
        iscrowd = [0] * len(gt)
    out = np.zeros((len(dt), len(gt)))
    lib = _lib() if native else None
    for i, d in enumerate(dt):
        cd = _u32(_get_counts(d))
        for j, g in enumerate(gt):
            cg = _u32(_get_counts(g))
            if lib is not None:
                out[i, j] = lib.rle_iou(_ptr(cd), len(cd), _ptr(cg), len(cg), int(iscrowd[j]))
            else:
                md = decode(d, native=False).astype(bool)
                mg = decode(g, native=False).astype(bool)
                inter = np.logical_and(md, mg).sum()
                denom = md.sum() if iscrowd[j] else (md.sum() + mg.sum()
                                                     - inter)
                out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def merge(rles: Sequence[dict], intersect: bool = False, native: bool = True) -> dict:
    """Union (or intersection) of several RLEs (maskApi rleMerge)."""
    assert len(rles) > 0
    h, w = rles[0]["size"]
    acc = _get_counts(rles[0])
    lib = _lib() if native else None
    for r in rles[1:]:
        cb = _get_counts(r)
        if lib is not None:
            out = np.empty(len(acc) + len(cb) + 2, np.uint32)
            n = lib.rle_merge(_ptr(_u32(acc)), len(acc), _ptr(_u32(cb)), len(cb),
                              int(intersect), _ptr(out))
            acc = out[:n].copy()
        else:
            ma = decode({"size": [h, w], "counts": acc}, native=False).astype(bool)
            mb = decode(r, native=False).astype(bool)
            m = (ma & mb) if intersect else (ma | mb)
            acc = _encode_counts(np.asfortranarray(m).ravel(order="F"), h, w, native=False)
    return {"size": [h, w], "counts": counts_to_string(acc)}
