"""A parquet codec in numpy and the standard library.

The reference writes and reads its processed data through ``pyarrow``
(``pq.write_table`` in ``dct_tpu/etl/preprocess.py:_publish_part``,
``pq.read_table`` in ``dct_tpu/data/dataset.py``). ``pyarrow`` is not a
dependency of the port, so this module covers what the ETL handoff needs:

- :func:`write_table` writes one file of one row group: flat REQUIRED
  columns of DOUBLE, FLOAT, INT32 or INT64, PLAIN encoding, UNCOMPRESSED,
  one V1 data page per column, and a thrift-compact ``FileMetaData`` footer.
  It publishes atomically (a temporary sibling, then ``os.replace``), so a
  concurrent directory listing never sees a torn file.
- :func:`read_table` reads a file, or a Spark-style directory of
  ``*.parquet`` part files in name order (names that start with ``_`` or
  ``.`` are skipped, as Spark's ``_SUCCESS`` is). Besides what the writer
  writes it reads what ``pyarrow``'s defaults write: SNAPPY pages, a
  dictionary page followed by RLE_DICTIONARY data pages (indices in the
  RLE/bit-packed hybrid, the bit width in the page's first byte), PLAIN
  pages after a dictionary fallback, OPTIONAL columns with definition
  levels in every page (V1: behind a 4-byte length; V2: uncompressed, the
  length in the page header), and V2 data pages. A null raises
  :class:`ParquetError`: the processed data has none.

Nested schemas, repeated fields, other physical types and other codecs
raise :class:`ParquetError` naming what was found.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"PAR1"

# Thrift compact protocol type ids.
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE = range(8)
_BINARY, _LIST, _SET, _MAP, _STRUCT = range(8, 13)

# Parquet enums (parquet.thrift).
_PHYSICAL = {1: np.dtype("<i4"), 2: np.dtype("<i8"), 4: np.dtype("<f4"),
             5: np.dtype("<f8")}
_TYPE_ID = {np.dtype(np.int32): 1, np.dtype(np.int64): 2,
            np.dtype(np.float32): 4, np.dtype(np.float64): 5}
REQUIRED, OPTIONAL = 0, 1
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3
CREATED_BY = "dct_tpu_torch parquet codec"


class ParquetError(ValueError):
    """A parquet file this codec cannot read (or a null in a column)."""


# ----------------------------------------------------------------------
# Thrift compact protocol.

def _varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


class _CompactReader:
    """Decodes a compact-protocol struct into ``{field id: value}``,
    nested structs as dicts and lists as lists (the type ids travel with
    the data, so no schema is needed)."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _zigzag(self) -> int:
        n, self.pos = _varint(self.buf, self.pos)
        return (n >> 1) ^ -(n & 1)

    def _value(self, t: int):
        buf = self.buf
        if t in (_TRUE, _FALSE):  # an element of a collection: one byte
            self.pos += 1
            return buf[self.pos - 1] == _TRUE
        if t == _BYTE:
            self.pos += 1
            return struct.unpack_from("<b", buf, self.pos - 1)[0]
        if t in (_I16, _I32, _I64):
            return self._zigzag()
        if t == _DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", buf, self.pos - 8)[0]
        if t == _BINARY:
            n, self.pos = _varint(buf, self.pos)
            self.pos += n
            return bytes(buf[self.pos - n:self.pos])
        if t in (_LIST, _SET):
            head = buf[self.pos]
            self.pos += 1
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n, self.pos = _varint(buf, self.pos)
            return [self._value(et) for _ in range(n)]
        if t == _MAP:
            n, self.pos = _varint(buf, self.pos)
            if n == 0:
                return {}
            kv = buf[self.pos]
            self.pos += 1
            return {self._value(kv >> 4): self._value(kv & 0x0F)
                    for _ in range(n)}
        if t == _STRUCT:
            return self.read_struct()
        raise ParquetError(f"unknown thrift compact type {t}")

    def read_struct(self) -> dict:
        out, last = {}, 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _STOP:
                return out
            t, delta = head & 0x0F, head >> 4
            fid = last + delta if delta else self._zigzag()
            # A bool field carries its value in the type id.
            out[fid] = (t == _TRUE) if t in (_TRUE, _FALSE) else self._value(t)
            last = fid


class _CompactWriter:
    """Encodes ``[(field id, type id, value), ...]`` structs; a list value
    is ``(element type id, items)``, a struct value a field list; a None
    value leaves the field out."""

    def __init__(self):
        self.out = bytearray()

    def _varint(self, n: int) -> None:
        while n >= 0x80:
            self.out.append((n & 0x7F) | 0x80)
            n >>= 7
        self.out.append(n)

    def _value(self, t: int, v) -> None:
        if t in (_I16, _I32, _I64):
            self._varint((v << 1) ^ (v >> 63))
        elif t == _BINARY:
            b = v.encode() if isinstance(v, str) else bytes(v)
            self._varint(len(b))
            self.out += b
        elif t == _LIST:
            et, items = v
            if len(items) < 15:
                self.out.append((len(items) << 4) | et)
            else:
                self.out.append(0xF0 | et)
                self._varint(len(items))
            for item in items:
                self._value(et, item)
        elif t == _STRUCT:
            self.write_struct(v)
        else:
            raise ParquetError(f"the writer does not encode thrift type {t}")

    def write_struct(self, fields) -> "_CompactWriter":
        last = 0
        for fid, t, v in fields:
            if v is None:
                continue
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | t)
            else:
                self.out.append(t)
                self._varint((fid << 1) ^ (fid >> 63))
            self._value(t, v)
            last = fid
        self.out.append(_STOP)
        return self


def _struct_bytes(fields) -> bytes:
    return bytes(_CompactWriter().write_struct(fields).out)


# ----------------------------------------------------------------------
# Writer.

def write_table(path: str, columns: dict) -> str:
    """Write ``columns`` (name -> 1-D array of float64, float32, int64 or
    int32, all of one length) as one parquet file at ``path``, published
    atomically. Returns ``path``."""
    if not columns:
        raise ParquetError("a parquet table needs at least one column")
    arrays = {name: np.asarray(a) for name, a in columns.items()}
    n_rows = {len(a) for a in arrays.values()}
    if len(n_rows) != 1 or any(a.ndim != 1 for a in arrays.values()):
        raise ParquetError(
            f"columns must be 1-D and of one length: "
            f"{ {k: a.shape for k, a in arrays.items()} }")
    n = n_rows.pop()
    body = bytearray(MAGIC)
    chunks, schema = [], [[(4, _BINARY, "schema"), (5, _I32, len(arrays))]]
    for name, a in arrays.items():
        if a.dtype not in _TYPE_ID:
            raise ParquetError(f"column {name!r}: dtype {a.dtype} is not one "
                               "of float64, float32, int64, int32")
        ptype = _TYPE_ID[a.dtype]
        values = np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes()
        header = _struct_bytes([
            (1, _I32, DATA_PAGE), (2, _I32, len(values)),
            (3, _I32, len(values)),
            (5, _STRUCT, [(1, _I32, n), (2, _I32, PLAIN), (3, _I32, RLE),
                          (4, _I32, RLE)]),
        ])
        offset = len(body)
        body += header
        body += values
        size = len(header) + len(values)
        chunks.append((offset, size, [
            (2, _I64, offset),
            (3, _STRUCT, [
                (1, _I32, ptype), (2, _LIST, (_I32, [PLAIN])),
                (3, _LIST, (_BINARY, [name])), (4, _I32, UNCOMPRESSED),
                (5, _I64, n), (6, _I64, size), (7, _I64, size),
                (9, _I64, offset),
            ]),
        ]))
        schema.append([(1, _I32, ptype), (3, _I32, REQUIRED),
                       (4, _BINARY, name)])
    total = sum(size for _, size, _ in chunks)
    footer = _struct_bytes([
        (1, _I32, 1),
        (2, _LIST, (_STRUCT, schema)),
        (3, _I64, n),
        (4, _LIST, (_STRUCT, [[
            (1, _LIST, (_STRUCT, [fields for _, _, fields in chunks])),
            (2, _I64, total), (3, _I64, n), (5, _I64, chunks[0][0]),
            (6, _I64, total), (7, _I16, 0),
        ]])),
        (6, _BINARY, CREATED_BY),
    ])
    body += footer
    body += struct.pack("<I", len(footer))
    body += MAGIC
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(body)
    os.replace(tmp, path)
    return path


# ----------------------------------------------------------------------
# Reader.

def snappy_decompress(src: bytes) -> bytes:
    """Raw snappy (the block format parquet pages use): a varint length,
    then literals and back-references; a back-reference whose offset is
    smaller than its length repeats the bytes it overlaps."""
    n, pos = _varint(src, 0)
    out = bytearray(n)
    op = 0
    end = len(src)
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                width = length - 59
                length = int.from_bytes(src[pos:pos + width], "little")
                pos += width
            length += 1
            out[op:op + length] = src[pos:pos + length]
            pos += length
            op += length
            continue
        if kind == 1:
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | src[pos]
            pos += 1
        else:
            width = 2 if kind == 2 else 4
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + width], "little")
            pos += width
        start = op - offset
        if offset == 0 or start < 0 or op + length > n:
            raise ParquetError("corrupt snappy block")
        if offset >= length:
            out[op:op + length] = out[start:start + length]
        else:
            pattern = bytes(out[start:op])
            out[op:op + length] = (pattern * (length // offset + 1))[:length]
        op += length
    if op != n:
        raise ParquetError(f"snappy block decoded to {op} bytes, header "
                           f"says {n}")
    return bytes(out)


def _decompress(body: bytes, codec: int) -> bytes:
    if codec == UNCOMPRESSED:
        return body
    if codec == SNAPPY:
        return snappy_decompress(body)
    raise ParquetError(f"compression codec {codec} is not supported "
                       "(UNCOMPRESSED and SNAPPY are)")


def rle_bitpacked_hybrid(buf, bit_width: int, count: int) -> np.ndarray:
    """The RLE/bit-packed hybrid (definition levels, dictionary indices):
    ``count`` values as int64. Runs whose header's low bit is 0 repeat one
    value of ``ceil(bit_width / 8)`` bytes; runs whose low bit is 1 pack
    groups of 8 values LSB first."""
    out = np.empty(count, np.int64)
    value_bytes = (bit_width + 7) // 8
    weights = np.left_shift(np.int64(1), np.arange(bit_width, dtype=np.int64))
    pos = filled = 0
    while filled < count:
        if pos >= len(buf):
            raise ParquetError("RLE/bit-packed run ends early")
        header, pos = _varint(buf, pos)
        if header & 1:
            groups = header >> 1
            nbytes = groups * bit_width
            if bit_width:
                bits = np.unpackbits(
                    np.frombuffer(buf, np.uint8, count=nbytes, offset=pos),
                    bitorder="little").reshape(-1, bit_width)
                vals = bits.astype(np.int64) @ weights
            else:
                vals = np.zeros(groups * 8, np.int64)
            pos += nbytes
            take = min(len(vals), count - filled)
            out[filled:filled + take] = vals[:take]
        else:
            value = int.from_bytes(buf[pos:pos + value_bytes], "little")
            pos += value_bytes
            take = min(header >> 1, count - filled)
            out[filled:filled + take] = value
        filled += take
    return out


def _check_levels(levels: np.ndarray, name: str) -> None:
    if not np.all(levels == 1):
        raise ParquetError(
            f"column {name!r} holds {int(np.sum(levels != 1))} null values; "
            "the processed data must have none")


def _values(raw: bytes, encoding: int, dtype: np.dtype, n: int,
            dictionary: np.ndarray | None, name: str) -> np.ndarray:
    if encoding == PLAIN:
        if len(raw) < n * dtype.itemsize:
            raise ParquetError(f"column {name!r}: PLAIN page holds "
                               f"{len(raw)} bytes for {n} values")
        return np.frombuffer(raw, dtype, count=n)
    if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise ParquetError(f"column {name!r}: dictionary-encoded page "
                               "without a dictionary page")
        idx = rle_bitpacked_hybrid(raw[1:], raw[0], n) if n else np.zeros(
            0, np.int64)
        return dictionary[idx]
    raise ParquetError(f"column {name!r}: page encoding {encoding} is not "
                       "supported (PLAIN and dictionary encodings are)")


def _read_chunk(data: bytes, meta: dict, name: str, optional: bool):
    dtype = _PHYSICAL.get(meta[1])
    if dtype is None:
        raise ParquetError(f"column {name!r}: physical type {meta[1]} is not "
                           "supported (INT32, INT64, FLOAT, DOUBLE are)")
    codec, total = meta[4], meta[5]
    pos = meta[9]
    if meta.get(11) and 0 < meta[11] < pos:
        pos = meta[11]
    dictionary, parts, seen = None, [], 0
    while seen < total:
        reader = _CompactReader(data, pos)
        header = reader.read_struct()
        start = reader.pos
        body = data[start:start + header[3]]
        pos = start + header[3]
        kind = header[1]
        if kind == DICTIONARY_PAGE:
            raw = _decompress(body, codec)
            dictionary = np.frombuffer(raw, dtype, count=header[7][1])
            continue
        if kind == DATA_PAGE:
            page = header[5]
            n = page[1]
            raw = _decompress(body, codec)
            if optional:
                length = int.from_bytes(raw[:4], "little")
                _check_levels(rle_bitpacked_hybrid(raw[4:4 + length], 1, n),
                              name)
                raw = raw[4 + length:]
            parts.append(_values(raw, page[2], dtype, n, dictionary, name))
        elif kind == DATA_PAGE_V2:
            page = header[8]
            n, rep_len, def_len = page[1], page[6], page[5]
            if page.get(2):
                raise ParquetError(f"column {name!r} holds {page[2]} null "
                                   "values; the processed data must have "
                                   "none")
            if optional:
                _check_levels(rle_bitpacked_hybrid(
                    body[rep_len:rep_len + def_len], 1, n), name)
            raw = body[rep_len + def_len:]
            if page.get(7, True):
                raw = _decompress(raw, codec)
            parts.append(_values(raw, page[4], dtype, n, dictionary, name))
        else:
            continue  # an index page: nothing to read
        seen += n
    if not parts:
        return np.zeros(0, dtype)
    return np.concatenate(parts) if len(parts) > 1 else parts[0].copy()


def read_file(path: str) -> dict:
    """One parquet file -> ``{column: 1-D array}`` in schema order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError(f"{path} is not a parquet file")
    meta_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    meta = _CompactReader(data, len(data) - 8 - meta_len).read_struct()
    leaves = meta[2][1:]
    for leaf in leaves:
        if leaf.get(5):
            raise ParquetError(f"{path}: nested column {leaf[4]!r} is not "
                               "supported")
        if leaf.get(3, REQUIRED) not in (REQUIRED, OPTIONAL):
            raise ParquetError(f"{path}: repeated column {leaf[4]!r} is not "
                               "supported")
    names = [leaf[4].decode() for leaf in leaves]
    parts: dict[str, list] = {name: [] for name in names}
    for group in meta[4]:
        for chunk, leaf, name in zip(group[1], leaves, names):
            parts[name].append(_read_chunk(
                data, chunk[3], name, leaf.get(3, REQUIRED) == OPTIONAL))
    return {name: (np.concatenate(p) if len(p) != 1 else p[0])
            if p else np.zeros(0, _PHYSICAL[leaf[1]])
            for (name, p), leaf in zip(parts.items(), leaves)}


def part_files(path: str) -> list[str]:
    """The part files of a Spark-style parquet directory, in name order:
    ``*.parquet`` names that do not start with ``_`` or ``.``."""
    return [os.path.join(path, name) for name in sorted(os.listdir(path))
            if name.endswith(".parquet") and not name.startswith(("_", "."))]


def read_table(path: str) -> dict:
    """A parquet file or a directory of part files -> ``{column: 1-D
    array}``; the parts of a directory are concatenated in name order and
    must share one schema."""
    if not os.path.isdir(path):
        return read_file(path)
    files = part_files(path)
    if not files:
        raise ParquetError(f"no parquet part files in {path}")
    tables = [read_file(p) for p in files]
    names = list(tables[0])
    for p, t in zip(files, tables):
        if list(t) != names:
            raise ParquetError(f"{p} has columns {list(t)}, {files[0]} has "
                               f"{names}")
    return {name: np.concatenate([t[name] for t in tables])
            for name in names}
