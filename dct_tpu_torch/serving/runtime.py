"""Host-side serving helpers, copied from ``dct_tpu/serving/runtime.py``.

The request contract is the reference's: ``{"data": [...]}`` parsed into a
float32 array (:func:`parse_envelope_array` fast path, ``json.loads``
otherwise), validated per family (:func:`validate_payload`: a failure is
the request's fault, HTTP 400), scored, and answered as probabilities.
Packages store weights as f32 arrays or, for a bf16 package, as ``k::bf16``
uint16 bit patterns (:func:`assemble_weights`). int8 (``k::q8``) packages
are not ported yet.
"""

from __future__ import annotations

import re

import numpy as np


def softmax_numpy(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def bf16_pack(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit pattern (round-to-nearest-even) as uint16."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_unpack(u: np.ndarray) -> np.ndarray:
    """bf16 bit pattern (uint16) -> float32 (exact widening)."""
    return (
        np.ascontiguousarray(u, np.uint16).astype(np.uint32) << 16
    ).view(np.float32)


def assemble_weights(flat: dict) -> dict:
    """A flat npz mapping -> serving weights (original keys, f32 arrays).
    ``k::bf16`` entries widen exactly to f32; an int8 ``k::q8`` entry
    raises ``NotImplementedError`` (ROADMAP Queue A: int8 packages)."""
    out: dict = {}
    for k, v in flat.items():
        if k.endswith("::q8") or k.endswith("::scale"):
            raise NotImplementedError(
                f"int8 package entry {k!r}: int8 QuantTensor packages are "
                "not ported to dct_tpu_torch yet (ROADMAP Queue A)"
            )
        if k.endswith("::bf16"):
            out[k[:-6]] = bf16_unpack(v)
        else:
            out[k] = v
    return out


_SEQUENCE_FAMILIES = (
    "weather_gru", "weather_transformer", "weather_transformer_causal",
    "weather_transformer_pp", "weather_moe",
)


def validate_payload(meta: dict, data) -> np.ndarray:
    """Client input -> float32 batch array. Raises ``ValueError`` for
    anything that is the request's fault (ragged or non-numeric rows,
    wrong shape, non-finite values after the float32 cast)."""
    with np.errstate(over="ignore", invalid="ignore"):
        x = np.asarray(data, dtype=np.float32)
    expected = int(meta["input_dim"])
    family = meta.get("model", "weather_mlp")
    if family in _SEQUENCE_FAMILIES:
        seq_len = int(meta["seq_len"])
        if x.ndim == 2:
            x = x[None, :, :]
        if x.ndim != 3 or x.shape[1] != seq_len or x.shape[2] != expected:
            raise ValueError(
                f"Expected shape [N, {seq_len}, {expected}] (windows of "
                f"features: {meta.get('feature_names', '?')}), got "
                f"{list(x.shape)}"
            )
    else:
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != expected:
            raise ValueError(
                f"Expected shape [N, {expected}] (features: "
                f"{meta.get('feature_names', '?')}), got {list(x.shape)}"
            )
    if not np.isfinite(x).all():
        raise ValueError("features must be finite after float32 conversion")
    return x


#: Exact JSON number grammar: the fast path accepts precisely what
#: json.loads would.
_JSON_NUM = rb"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_NUM_LIST_RE = re.compile(_JSON_NUM + rb"(?:," + _JSON_NUM + rb")*")
#: Whitespace between two number bytes would splice tokens when stripped.
_WS_SPLICE_RE = re.compile(rb"[0-9.eE+-][ \t\r\n]+[0-9.eE+-]")


def parse_envelope_array(body: bytes) -> np.ndarray | None:
    """Raw ``{"data": [...]}`` bytes -> float32 ndarray, without building
    Python lists. Returns ``None`` for anything that is not a strictly
    rectangular JSON-numeric envelope of depth 1 to 3; the caller then
    takes the ``json.loads`` path, whose errors are the 400 contract."""
    if _WS_SPLICE_RE.search(body):
        return None
    s = body.translate(None, b" \t\r\n")
    if not (s.startswith(b'{"data":[') and s.endswith(b']}')):
        return None
    arr = s[8:-1]
    depth = 0
    for c in arr:
        if c != 0x5B:  # ord('[')
            break
        depth += 1
    if not 1 <= depth <= 3 or arr.count(b"[") != arr.count(b"]"):
        return None
    flat_txt = arr.translate(None, b"[]")
    if not flat_txt or _NUM_LIST_RE.fullmatch(flat_txt) is None:
        return None
    if not (arr.startswith(b"[" * depth) and arr.endswith(b"]" * depth)):
        return None
    if depth == 1:
        if arr.count(b"[") != 1:
            return None
        shape: tuple = (flat_txt.count(b",") + 1,)
    elif depth == 2:
        rows = arr[2:-2].split(b"],[")
        width = rows[0].count(b",") + 1
        if any(
            b"[" in r or b"]" in r or not r or r.count(b",") + 1 != width
            for r in rows
        ):
            return None
        shape = (len(rows), width)
    else:
        outer = arr[3:-3].split(b"]],[[")
        seq = feat = None
        for win in outer:
            rows = win.split(b"],[")
            if seq is None:
                seq = len(rows)
                feat = rows[0].count(b",") + 1
            if len(rows) != seq or any(
                b"[" in r or b"]" in r or not r
                or r.count(b",") + 1 != feat
                for r in rows
            ):
                return None
        shape = (len(outer), seq, feat)
    expected = 1
    for d in shape:
        expected *= d
    parser = getattr(np, "fromstring", None)
    if parser is None:
        return None
    try:
        with np.errstate(over="ignore", invalid="ignore"):
            flat = parser(flat_txt.decode("ascii"), dtype=np.float32, sep=",")
    except (ValueError, DeprecationWarning, UnicodeDecodeError):
        return None
    if flat.size != expected:
        return None
    return flat.reshape(shape)
