"""A small msgpack codec for flax's checkpoint byte layout.

The reference writes its deploy checkpoints with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``. Neither ``msgpack`` nor ``flax`` is a dependency of
the port, so this module encodes exactly what those two produce for a
checkpoint payload, byte for byte:

- the payload is first rebuilt as a pytree would be, so every dict's keys
  come out sorted;
- nil, bool, int (the smallest encoding), float (always float64), str,
  bytes (bin), lists and dicts, with msgpack's size-graded headers;
- a numpy array is ext type 1 whose payload is msgpack of
  ``(shape, dtype.name, C-order bytes)``; a numpy scalar is ext type 3
  with the same payload (flax's ``_ndarray_to_bytes``);
- tuples are refused, as ``strict_types`` refuses them in flax.

Arrays above flax's chunking limit (2**30 bytes) would be split into
chunks by flax; this codec refuses them instead.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2**30


def _header(out: bytearray, n: int, fix: int | None, fix_max: int,
            codes: tuple[int, ...]) -> None:
    """A size header: the fix form for ``n <= fix_max``, else the first of
    the 8/16/32-bit forms (``codes``, None where a width is absent) that
    holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out += struct.pack(fmt, code, n)
            return
    raise ValueError(f"msgpack object of size {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack("BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes is above the "
                         f"{MAX_ARRAY_BYTES}-byte leaf limit (flax chunks it)")
    # Packed as msgpack does a tuple outside strict mode: an array.
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")],
                 strict=False)


def _pack(out: bytearray, obj, strict: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t in (bytes, bytearray):
        _header(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t is str:
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is list or (t is tuple and not strict):
        _header(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item, strict)
    elif t is dict:
        _header(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        data = _ndarray_bytes(np.asarray(obj))
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _header(out, len(data), None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack("b", code)
        out += data
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def _tree_sorted(obj):
    """The payload as a pytree round trip leaves it: dict keys sorted at
    every level (lists keep their order)."""
    if type(obj) is dict:
        return {k: _tree_sorted(obj[k]) for k in sorted(obj)}
    if type(obj) is list:
        return [_tree_sorted(v) for v in obj]
    return obj


def packb(obj, *, strict: bool = True) -> bytes:
    """msgpack bytes of ``obj`` (no key sorting)."""
    out = bytearray()
    _pack(out, obj, strict)
    return bytes(out)


def serialize(payload) -> bytes:
    """``flax.serialization.msgpack_serialize(payload)``, byte for byte."""
    return packb(_tree_sorted(payload))


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def _ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype, buf = _Reader(data, raw=True).read()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode()),
                                count=-1, offset=0).reshape(shape, order="C")
            return arr if code == EXT_NDARRAY else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self.unpack("B")
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
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return self._str(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self._map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def restore(data: bytes):
    """``flax.serialization.msgpack_restore(data)`` for what
    :func:`serialize` writes: dicts, lists, str, bytes, numbers, nil,
    bool and (read-only) numpy arrays."""
    reader = _Reader(data, raw=False)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj
