# -*- coding: utf-8 -*-
"""Flax msgpack for parameter trees, without the ``msgpack`` package.

The JAX package saves and loads weights with
``flax.serialization.to_bytes`` / ``from_bytes`` (a ``.msgpack`` file of the
``{"params": ...}`` tree). This is the port's counterpart, so files move
both ways: ``loads`` reads what the JAX ``save_params`` wrote, and the JAX
``load_params`` reads what ``dumps`` writes.

The format (``flax/serialization.py``): msgpack maps with str keys, and
each array as msgpack ext type 1 whose payload is itself the msgpack of
``(shape, dtype name, C-order bytes)``. Scalars of numpy type are ext type
3 with the same payload. Flax splits arrays of more than 2**30 bytes into
chunks (a map tagged ``__msgpack_chunked_array__``); ``loads`` joins them,
``dumps`` raises for such an array (the largest leaf of the full
``KokoroConfig()`` is 6 MB). Covered types: maps, lists, str, bytes, bool,
None, ints, floats and arrays.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_LEAF_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE


# ---- encoding ----------------------------------------------------------------

def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 2 ** 8), (0xCD, ">BH", 2 ** 16),
                               (0xCE, ">BI", 2 ** 32),
                               (0xCF, ">BQ", 2 ** 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2 ** 7), (0xD1, ">Bh", -2 ** 15),
                               (0xD2, ">Bi", -2 ** 31),
                               (0xD3, ">Bq", -2 ** 63)):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              c8: int | None, c16: int, c32: int) -> None:
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n < 2 ** 8:
        out += struct.pack(">BB", c8, n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", c16, n)
    else:
        out += struct.pack(">BI", c32, n)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 2 ** 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 2 ** 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it, "
                         "which this codec does not write")
    return dumps_raw((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, 0xC4, 0xC5, 0xC6)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, None, 0xDC, 0xDD)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, None, 0xDE, 0xDF)
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif hasattr(obj, "__array__"):  # a tensor or another array type
        _pack(out, np.asarray(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def dumps_raw(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (arrays as flax's ext types)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def dumps(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a dict tree of arrays: keys are
    written as str, as flax's state dicts have them."""
    def state(node):
        if isinstance(node, dict):
            return {str(k): state(v) for k, v in node.items()}
        return node
    return dumps_raw(state(tree))


# ---- decoding ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the array payload so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
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
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext_len = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_len:
            return self._ext(self.unpack(ext_len[b]))
        fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed_ext:
            return self._ext(fixed_ext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self._str(self.unpack(strs[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        arr = _array_from_payload(data)
        return arr[()] if code == EXT_NPSCALAR else arr


def _array_from_payload(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data, raw=True).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes, which the port "
                         "does not use")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:  # flax keeps tuples as {"0": ..., "1": ...}
        def items(d):
            return [d[str(i)] for i in range(len(d))]
        return np.concatenate(items(node["chunks"])).reshape(
            items(node["shape"]))
    return {k: _unchunk(v) for k, v in node.items()}


def loads(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts and numpy
    arrays that ``data`` holds (chunked arrays joined)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())

