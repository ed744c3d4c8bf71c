"""A small MessagePack codec, and flax's ``msgpack_serialize`` format on it.

The card's machine does not list the ``msgpack`` package, so the port
carries the part of the format that ``utils/statepack.py`` writes and
reads, as it carries ``data/yaml_lite.py``.

:func:`packb` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes
for ``None``, ``bool``, ``int`` (up to 64 bits), ``float`` (as float64),
``str``, ``bytes``, ``list``/``tuple`` (as arrays) and ``dict`` (in its
iteration order), in the smallest encoding of each, and
``msgpack.ExtType``-like :class:`Ext` values. :func:`unpackb` reads every
type of the format except timestamps (maps into ``dict``, arrays into
``list``, str into ``str``, bin into ``bytes``, an ext into :class:`Ext`
unless ``ext_hook`` maps it).

:func:`msgpack_serialize` and :func:`msgpack_restore` are
``flax.serialization``'s: the tree's dicts with their keys sorted (flax
copies the tree through ``jax.tree_util.tree_map``, which sorts them), a
numpy array as ext type 1 whose payload is the MessagePack of ``(shape,
dtype name, C-order bytes)``, and a numpy scalar as ext type 3 (an array of
shape ``()``). With ``strict_types``, as flax packs, a ``tuple`` in the
tree is refused; a ``float`` subclass such as ``np.float64`` is a numpy
scalar. flax splits an array over 2**30 bytes into chunks; no state of the
port comes near that, and both functions refuse such an array.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

EXT_NDARRAY = 1       # flax.serialization._MsgpackExtType.ndarray
EXT_NPSCALAR = 3      # ... .npscalar
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


class Ext(NamedTuple):
    """An extension value: its type code and its payload."""
    code: int
    data: bytes


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for limit, head, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if n < limit:
                out += bytes([head]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} does not fit 64 bits")
    else:
        for limit, head, fmt in ((-(1 << 7), 0xD0, ">b"), (-(1 << 15), 0xD1, ">h"),
                                 (-(1 << 31), 0xD2, ">i"), (-(1 << 63), 0xD3, ">q")):
            if n >= limit:
                out += bytes([head]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} does not fit 64 bits")


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int, heads) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    one (``heads`` holds their codes; None where the type has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for limit, head, fmt in zip((1 << 8, 1 << 16, 1 << 32), heads, (">B", ">H", ">I")):
        if head is not None and n < limit:
            out += bytes([head]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} over 2**32")


_NATIVE = (type(None), bool, int, float, str, bytes, Ext, list, tuple, dict)


def _native(obj: Any, strict: bool) -> bool:
    """Whether msgpack packs ``obj`` itself: with ``strict_types`` only
    these exact types, and no tuple (an ``Ext`` is checked before it)."""
    if strict:
        return type(obj) in _NATIVE and type(obj) is not tuple
    return isinstance(obj, _NATIVE)


def _pack(obj: Any, out: bytearray, default: Optional[Callable], strict: bool) -> None:
    if default is not None and not _native(obj, strict):
        obj = default(obj)
    if not _native(obj, strict):
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(len(obj), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, Ext):
        n = len(obj.data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code) + obj.data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out, default, strict)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out, default, strict)
            _pack(value, out, default, strict)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj: Any, default: Optional[Callable] = None, strict_types: bool = False) -> bytes:
    """``msgpack.packb(obj, default=default, strict_types=strict_types,
    use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out, default, strict_types)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, ext_hook: Optional[Callable], raw: bool):
        self.data, self.pos, self.ext_hook, self.raw = memoryview(data), 0, ext_hook, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data cut short")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                   0xDF: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.string(n)
        if b <= 0xDD:
            return [self.read() for _ in range(n)]
        return self.map(n)

    def string(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        return self.ext_hook(code, data) if self.ext_hook else Ext(code, data)


def unpackb(data: bytes, ext_hook: Optional[Callable] = None, raw: bool = False) -> Any:
    """``msgpack.unpackb(data, ext_hook=ext_hook, raw=raw)`` (lists for
    arrays). Trailing bytes raise ``ValueError``."""
    reader = _Reader(data, ext_hook, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return obj


# --- flax.serialization's format ---------------------------------------------

def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"msgpack_serialize: an array of {arr.nbytes} bytes would be "
                         "chunked by flax; not supported here")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_pack(obj):
    if isinstance(obj, np.ndarray):
        return Ext(EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return Ext(EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    return obj


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return Ext(code, data)


def _sorted_tree(tree):
    """The copy ``jax.tree_util.tree_map(lambda x: x, tree)`` makes: every
    dict with its keys sorted; lists and tuples kept as they are."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)`` for a tree of dicts
    (string keys), lists, python scalars, strings and numpy arrays and
    scalars: the same bytes."""
    return packb(_sorted_tree(tree), default=_ext_pack, strict_types=True)


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore(data)``: arrays come back as
    writable numpy copies. A chunked array (flax's, over 2**30 bytes)
    raises ``ValueError``."""
    tree = unpackb(data, ext_hook=_ext_unpack, raw=False)

    def walk(node):
        if isinstance(node, dict):
            if _CHUNKED in node:
                raise ValueError("msgpack_restore: a chunked array (over 2**30 bytes) is "
                                 "not supported here")
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, np.ndarray):
            return node.copy()
        return node

    return walk(tree)
