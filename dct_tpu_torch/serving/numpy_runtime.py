"""Dependency-free inference runtime for every deployed model family.

The reference's generated ``score.py`` re-declares the torch model class and
loads a Lightning checkpoint inside the serving container
(dags/azure_manual_deploy.py:54-125), pulling torch+lightning into the
inference image and hardcoding ``input_dim=5`` (:109). Here the deploy
package carries the weights as a plain ``model.npz`` (+ JSON meta with the
true architecture/feature names from the checkpoint), and inference is pure
numpy — the serving container needs no ML framework at all, for ANY family:

- ``weather_mlp``        — sequential dense stack (w0/b0.. keys);
- ``weather_gru``        — stacked GRU over windows (flat flax-path keys);
- ``weather_transformer``— encoder over windows (flat flax-path keys).

:func:`score_payload` dispatches on ``meta["model"]`` and validates the
payload shape per family. This module is the single source of truth: the
score.py generator embeds its source verbatim so the deployed copy cannot
drift from the tested one.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def softmax_numpy(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def rows_mm(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Row-invariant 2D matmul: ``x[i] @ w`` computed as an independent
    ``[1, K] @ [K, M]`` product per row.

    A plain ``[N, K] @ [K, M]`` GEMM picks different BLAS kernels (and
    different FMA groupings) at different ``N``, so row ``i``'s bits can
    depend on how many OTHER rows share the call — which would make a
    micro-batched score depend on co-batched traffic. Batched matmul
    over a size-1 middle axis runs each row as its own ``[1, K]`` GEMM,
    bit-identical to scoring that row alone, at any stacking. The
    micro-batcher (serving/batching.py) threads this in via the ``mm``
    hooks below; the direct :func:`score_payload` path keeps the plain
    GEMM (``mm=np.matmul`` defaults — bits unchanged for existing
    consumers)."""
    return (x[:, None, :] @ w)[:, 0, :]


#: K-reduction block for the int8 integer GEMM: every partial product is
#: <= 127*127 and 1024 of them sum below 2**24, so each block's
#: accumulation is EXACT in float32 — no rounding for any BLAS kernel or
#: FMA grouping to disagree about.
_INT8_CHUNK = 1024


def bf16_pack(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit pattern (round-to-nearest-even) as uint16.

    Pure-numpy twin of ``jnp.asarray(a, jnp.bfloat16)``'s rounding:
    halves the stored bytes; :func:`bf16_unpack` widens back exactly."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_unpack(u: np.ndarray) -> np.ndarray:
    """bf16 bit pattern (uint16) -> float32 (exact widening)."""
    return (
        np.ascontiguousarray(u, np.uint16).astype(np.uint32) << 16
    ).view(np.float32)


class QuantTensor:
    """An int8 weight matrix with per-output-channel symmetric scales,
    dequantized INSIDE the matmul.

    ``np.matmul(x, qt)`` (and the ``@`` operator — numpy routes both
    through ``__array_ufunc__``) quantizes the activation rows
    dynamically (symmetric int8, one scale per row), runs the GEMM as a
    float32-carried INTEGER product, and rescales by
    ``row_scale * channel_scale``. Because every intermediate value of
    the integer reduction is an integer below 2**24 (the K axis is
    chunked to ``_INT8_CHUNK`` columns), the float32 accumulation is
    exact — the result is bit-identical under any BLAS kernel, batch
    size, or row stacking. That restores the micro-batcher's
    row-invariance contract through ONE plain GEMM, where the f32 twin
    must fall back to the per-row ``rows_mm`` path: quantization here
    buys speed precisely by making the fast path exact.

    Only 2D matmul kernels are packed this way (serving/quant.py);
    biases, layernorm affines, and stacked 3D+ trees stay f32, so every
    other op in the forward pass is untouched.
    """

    __slots__ = ("q", "scale", "qf")

    #: Logical dtype: the tensor stands in for a float32 weight matrix.
    dtype = np.dtype(np.float32)

    def __init__(self, q: np.ndarray, scale: np.ndarray):
        self.q = np.ascontiguousarray(q, np.int8)
        self.scale = np.ascontiguousarray(scale, np.float32)
        # float32 carrier of the int8 entries: cast once at load — the
        # GEMM consumes it directly on every call.
        self.qf = self.q.astype(np.float32)

    @property
    def shape(self) -> tuple:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def dequantize(self) -> np.ndarray:
        """Dense f32 reconstruction (jax-engine and debugging path)."""
        return self.qf * self.scale[None, :]

    def matmul(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        amax = np.abs(x2).max(axis=1) if x2.size else np.zeros(
            x2.shape[0], np.float32
        )
        sx = (amax / np.float32(127.0)).astype(np.float32)
        inv = np.where(sx > 0, np.float32(1.0) / np.where(sx > 0, sx, 1), 0)
        xq = x2 * inv[:, None].astype(np.float32)
        np.rint(xq, out=xq)
        np.clip(xq, -127.0, 127.0, out=xq)
        acc = None
        for c in range(0, k, _INT8_CHUNK):
            part = xq[:, c:c + _INT8_CHUNK] @ self.qf[c:c + _INT8_CHUNK]
            # Fixed-order elementwise adds between exact integer blocks:
            # still deterministic and row-independent.
            acc = part if acc is None else acc + part
        acc *= sx[:, None]
        acc *= self.scale
        return acc.reshape(*lead, self.q.shape[1])

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if (
            ufunc is np.matmul and method == "__call__"
            and len(inputs) == 2 and inputs[1] is self and not kwargs
        ):
            return self.matmul(inputs[0])
        return NotImplemented

    def __rmatmul__(self, x):
        return self.matmul(x)


def assemble_weights(flat: dict) -> dict:
    """Reconstitute serving weights from a flat npz-style mapping.

    Quantized packages (serving/quant.py) store ``k::q8`` (int8) +
    ``k::scale`` (f32 per output channel) pairs and ``k::bf16`` (uint16
    bf16 bit patterns); a plain f32 package passes through unchanged.
    The ``::`` separator cannot collide with flax ``/`` paths. Returns
    the original keys mapped to f32 arrays or :class:`QuantTensor`s —
    every forward above consumes either transparently."""
    out: dict = {}
    for k, v in flat.items():
        if k.endswith("::q8"):
            out[k[:-4]] = QuantTensor(v, flat[k[:-4] + "::scale"])
        elif k.endswith("::scale"):
            continue
        elif k.endswith("::bf16"):
            out[k[:-6]] = bf16_unpack(v)
        else:
            out[k] = v
    return out


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _gelu_tanh(x: np.ndarray) -> np.ndarray:
    # jax.nn.gelu default (approximate=True): the tanh approximation.
    return 0.5 * x * (
        1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3))
    )


def _layernorm(x: np.ndarray, scale: np.ndarray, bias: np.ndarray,
               eps: float = 1e-6) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * scale + bias


def _sincos_positions(seq_len: int, d_model: int) -> np.ndarray:
    # Mirrors dct_tpu.models.transformer.sincos_positions.
    pos = np.arange(seq_len)[:, None].astype(np.float32)
    i = np.arange(d_model // 2)[None, :].astype(np.float32)
    ang = pos / np.power(10000.0, 2.0 * i / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def mlp_forward_numpy(weights: dict, x: np.ndarray,
                      mm=np.matmul) -> np.ndarray:
    """Forward pass of a sequential dense stack (dropout is inference-off).

    weights keys: w0/b0 .. wN/bN, exported from the flax checkpoint by the
    packager; ReLU between layers, raw logits at the last. ``mm`` is the
    2D-matmul hook (:func:`rows_mm` makes the pass row-invariant for the
    micro-batcher; the default keeps the plain GEMM).
    """
    n_layers = sum(1 for k in weights if k.startswith("w"))
    h = x
    for i in range(n_layers):
        h = mm(h, weights[f"w{i}"]) + weights[f"b{i}"]
        if i < n_layers - 1:
            h = np.maximum(h, 0.0)
    return h


def gru_forward_numpy(weights: dict, meta: dict, x: np.ndarray,
                      mm=np.matmul) -> np.ndarray:
    """Stacked GRU inference; weights carry flax paths
    (``gru_<i>/x_gates/kernel`` etc., gate order r,z,n — torch semantics:
    reset gate applied to the full hidden pre-activation). ``mm`` hooks
    the 2D matmuls (recurrence + head) — the x-gate product is a 3D
    stacked matmul and is per-window-invariant already."""
    n_layers = int(meta["n_layers"])
    h_seq = x
    h = None
    for i in range(n_layers):
        xg = h_seq @ weights[f"gru_{i}/x_gates/kernel"] + weights[
            f"gru_{i}/x_gates/bias"
        ]  # [N, S, 3H]
        wh = weights[f"gru_{i}/h_kernel"]
        bh = weights[f"gru_{i}/h_bias"]
        h = np.zeros((x.shape[0], wh.shape[0]), np.float32)
        # Only the last layer's final state feeds the head; intermediate
        # layers need the full output sequence as the next layer's input.
        keep_seq = i < n_layers - 1
        outs = []
        for t in range(xg.shape[1]):
            hg = mm(h, wh) + bh
            xr, xz, xn = np.split(xg[:, t], 3, axis=-1)
            hr, hz, hn = np.split(hg, 3, axis=-1)
            r = _sigmoid(xr + hr)
            z = _sigmoid(xz + hz)
            n = np.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            if keep_seq:
                outs.append(h)
        if keep_seq:
            h_seq = np.stack(outs, axis=1)
    return mm(h, weights["head/kernel"]) + weights["head/bias"]


@functools.lru_cache(maxsize=8)
def _rope_tables_np(s: int, half: int) -> tuple:
    """Cached [S, Dh/2] cos/sin tables: a served L-layer transformer
    would otherwise rebuild identical trig tables 2L times per request."""
    inv = 1.0 / np.power(
        10000.0, np.arange(half, dtype=np.float32) / half
    )
    ang = np.arange(s, dtype=np.float32)[:, None] * inv[None, :]
    return np.cos(ang), np.sin(ang)


def _rope_numpy(x: np.ndarray) -> np.ndarray:
    """Rotate q/k [N, H, S, Dh] — numpy twin of
    dct_tpu.models.transformer.apply_rope (rotate-half pairing)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_tables_np(x.shape[-2], half)
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1
    )


def _mha_numpy(weights: dict, prefix: str, h: np.ndarray,
               n_heads: int, causal: bool = False,
               window: int | None = None,
               n_kv_heads: int | None = None,
               rope: bool = False) -> np.ndarray:
    """Multi-head attention matching
    dct_tpu.models.transformer.MultiHeadAttention's fused-qkv layout
    (``causal`` masks positions > query, the causal family's path;
    ``window`` adds the sliding-window band; ``n_kv_heads`` selects the
    GQA group-major layout; ``rope`` rotates q/k — each must mirror
    training or the served model silently differs from the trained
    one)."""
    n, s, d_model = h.shape
    head_dim = d_model // n_heads
    g = n_kv_heads or n_heads
    hg = n_heads // g
    qkv = h @ weights[f"{prefix}/qkv_proj/kernel"] + weights[
        f"{prefix}/qkv_proj/bias"
    ]
    qkv = qkv.reshape(n, s, g, hg + 2, head_dim)
    q = np.swapaxes(
        qkv[:, :, :, :hg].reshape(n, s, n_heads, head_dim), 1, 2
    )  # [N, H, S, Dh]
    k = np.swapaxes(qkv[:, :, :, hg], 1, 2)  # [N, G, S, Dh]
    v = np.swapaxes(qkv[:, :, :, hg + 1], 1, 2)
    if rope:
        q = _rope_numpy(q)
        k = _rope_numpy(k)
    if hg > 1:
        k = np.repeat(k, hg, axis=1)
        v = np.repeat(v, hg, axis=1)
    scores = q @ np.swapaxes(k, -1, -2) / math.sqrt(head_dim)
    if causal:
        mask = np.tril(np.ones((s, s), bool))
        if window is not None:
            pos = np.arange(s)
            mask &= pos[:, None] - pos[None, :] < window
        scores = np.where(mask, scores, -1e30)
    o = softmax_numpy(scores) @ v  # [N, H, S, Dh]
    o = np.moveaxis(o, 1, 2).reshape(n, s, d_model)
    return o @ weights[f"{prefix}/o_proj/kernel"] + weights[
        f"{prefix}/o_proj/bias"
    ]


def _dense_ffn_numpy(w: dict, pre: str, f: np.ndarray) -> np.ndarray:
    f = _gelu_tanh(f @ w[f"{pre}/ffn_in/kernel"] + w[f"{pre}/ffn_in/bias"])
    return f @ w[f"{pre}/ffn_out/kernel"] + w[f"{pre}/ffn_out/bias"]


def _pre_ln_block(w: dict, pre: str, h: np.ndarray, n_heads: int, ffn,
                  causal: bool = False, window: int | None = None,
                  n_kv_heads: int | None = None,
                  rope: bool = False) -> np.ndarray:
    """One pre-LN residual block (attention + FFN) — the single source of
    the block math for the transformer, MoE, causal, AND pipeline-stage
    serving paths (train/serve parity lives or dies here)."""
    a = _layernorm(h, w[f"{pre}/ln_attn/scale"], w[f"{pre}/ln_attn/bias"])
    h = h + _mha_numpy(
        w, f"{pre}/attn", a, n_heads, causal, window, n_kv_heads, rope
    )
    f = _layernorm(h, w[f"{pre}/ln_ffn/scale"], w[f"{pre}/ln_ffn/bias"])
    return h + ffn(w, pre, f)


def _head_numpy(weights: dict, h: np.ndarray,
                per_position: bool, horizon: int = 1,
                mm=np.matmul) -> np.ndarray:
    h = _layernorm(h, weights["ln_out/scale"], weights["ln_out/bias"])
    pooled = h[:, -1, :] if per_position else h.mean(axis=1)
    out = mm(pooled, weights["head/kernel"]) + weights["head/bias"]
    if per_position and horizon > 1:
        # Multi-horizon causal head: [B, H*C] -> [B, H, C] — forecasts
        # for steps t+1..t+H from the window's last position.
        return out.reshape(out.shape[0], horizon, -1)
    return out


def _encoder_numpy(weights: dict, meta: dict, x: np.ndarray, ffn, *,
                   causal: bool = False,
                   per_position: bool = False,
                   mm=np.matmul) -> np.ndarray:
    """Shared pre-LN encoder skeleton (in_proj + positions, per-block
    attention and FFN residuals, final LN + mean-pool + head). ``ffn`` is
    ``(weights, block_prefix, h) -> h_ffn`` — the only point where the
    transformer and MoE families differ. The causal family sets both
    flags; ``per_position`` serves the LAST position's logits (the
    next-step forecast for the window)."""
    d_model = int(meta["d_model"])
    n_heads = int(meta["n_heads"])
    n_layers = int(meta["n_layers"])
    # Same config normalization as the registry: <= 0 = off for both
    # (truthiness alone would turn a -1 sentinel into an all-masked band
    # the trained model never had).
    _w = int(meta.get("attn_window", 0) or 0)
    window = _w if _w > 0 and causal else None
    _g = int(meta.get("n_kv_heads", 0) or 0)
    n_kv = _g if _g > 0 else None
    rope = str(meta.get("pos_embed", "sincos")) == "rope"
    s = x.shape[1]

    h = x @ weights["in_proj/kernel"] + weights["in_proj/bias"]
    if not rope:  # rope rotates q/k inside attention instead
        h = h + _sincos_positions(s, d_model)
    for i in range(n_layers):
        h = _pre_ln_block(
            weights, f"block_{i}", h, n_heads, ffn, causal, window, n_kv,
            rope,
        )
    return _head_numpy(
        weights, h, per_position, horizon=int(meta.get("horizon", 1)),
        mm=mm,
    )


def transformer_forward_numpy(
    weights: dict, meta: dict, x: np.ndarray, *, causal: bool = False,
    mm=np.matmul,
) -> np.ndarray:
    """Pre-LN encoder inference; weights carry flax paths
    (``block_<i>/attn/qkv_proj/kernel`` etc.). ``causal`` serves the
    decoder-style causal family (per-position head, last position out).
    Every block matmul is a 3D/4D stacked product (per-window-invariant
    by construction); ``mm`` hooks the one 2D site, the pooled head."""

    return _encoder_numpy(
        weights, meta, x, _dense_ffn_numpy, causal=causal,
        per_position=causal, mm=mm,
    )


def transformer_pp_forward_numpy(
    weights: dict, meta: dict, x: np.ndarray, mm=np.matmul
) -> np.ndarray:
    """Pipeline-parallel transformer inference: the ``pp_stages`` param is
    a stacked tree (leading dim = stage,
    dct_tpu.models.transformer.WeatherTransformerPP); serving just
    unstacks it and applies the stages sequentially — pipelining is a
    training-time throughput construct, numerically the sequential stack."""
    d_model = int(meta["d_model"])
    n_heads = int(meta["n_heads"])
    n_layers = int(meta["n_layers"])
    n_stages = int(meta["n_stages"])
    layers_per_stage = n_layers // n_stages
    s = x.shape[1]

    rope = str(meta.get("pos_embed", "sincos")) == "rope"
    h = x @ weights["in_proj/kernel"] + weights["in_proj/bias"]
    if not rope:
        h = h + _sincos_positions(s, d_model)
    stage_keys = {
        k[len("pp_stages/"):]: v
        for k, v in weights.items()
        if k.startswith("pp_stages/")
    }
    _g = int(meta.get("n_kv_heads", 0) or 0)
    n_kv = _g if _g > 0 else None
    for st in range(n_stages):
        w = {k: v[st] for k, v in stage_keys.items()}
        for i in range(layers_per_stage):
            h = _pre_ln_block(
                w, f"block_{i}", h, n_heads, _dense_ffn_numpy,
                n_kv_heads=n_kv, rope=rope,
            )
    return _head_numpy(weights, h, per_position=False, mm=mm)


def _moe_ffn_numpy(weights: dict, prefix: str, h: np.ndarray,
                   capacity_factor: float, top_k: int = 1) -> np.ndarray:
    """MoE inference matching dct_tpu.models.moe.MoEFFN: same routing
    (switch top-1 or GShard top-k with normalized gates), capacity, and
    choice-major arrival-order drop semantics as training."""
    b, s, d = h.shape
    n = b * s
    tokens = h.reshape(n, d)
    logits = tokens @ weights[f"{prefix}/router/kernel"] + weights[
        f"{prefix}/router/bias"
    ]
    probs = softmax_numpy(logits)
    e = probs.shape[-1]
    capacity = max(1, int(capacity_factor * top_k * n / e))
    if top_k == 1:
        expert_choice = np.argmax(probs, axis=-1)[None, :]
        gate_choice = np.max(probs, axis=-1)[None, :]
    else:
        topi = np.argsort(-probs, axis=-1)[:, :top_k]  # [N, k] best-first
        topv = np.take_along_axis(probs, topi, axis=-1)
        gates = topv / np.maximum(topv.sum(axis=-1, keepdims=True), 1e-9)
        expert_choice = topi.T
        gate_choice = gates.T
    flat_idx = expert_choice.reshape(top_k * n)
    flat_gate = gate_choice.reshape(top_k * n)

    out2 = np.zeros((top_k * n, d), tokens.dtype)
    w_in = weights[f"{prefix}/experts_in_kernel"]
    b_in = weights[f"{prefix}/experts_in_bias"]
    w_out = weights[f"{prefix}/experts_out_kernel"]
    b_out = weights[f"{prefix}/experts_out_bias"]
    for ex in range(e):
        ids = np.nonzero(flat_idx == ex)[0][:capacity]  # choice-major order
        if ids.size == 0:
            continue
        t = tokens[ids % n]
        a = _gelu_tanh(t @ w_in[ex] + b_in[ex])
        out2[ids] = (a @ w_out[ex] + b_out[ex]) * flat_gate[ids, None]
    return out2.reshape(top_k, n, d).sum(axis=0).reshape(b, s, d)


def moe_forward_numpy(weights: dict, meta: dict, x: np.ndarray) -> np.ndarray:
    """MoE encoder inference (same skeleton as the transformer, with the
    dense FFN replaced by the switch-routed expert mixture)."""
    capacity_factor = float(meta.get("capacity_factor", 1.25))
    top_k = int(meta.get("router_top_k", 1))

    def moe_ffn(w, pre, f):
        return _moe_ffn_numpy(w, f"{pre}/moe", f, capacity_factor, top_k)

    return _encoder_numpy(weights, meta, x, moe_ffn)


def forward_numpy(weights: dict, meta: dict, x: np.ndarray,
                  mm=np.matmul) -> np.ndarray:
    """Dispatch inference on the checkpoint's model family.

    ``mm`` is the 2D-matmul hook (:func:`rows_mm` = row-invariant bits
    for the micro-batcher). The MoE family ignores it: its routing
    capacity depends on the total token count, so batch-invariance there
    is the batcher's job (it scores MoE requests as separate segments,
    serving/batching.py)."""
    family = meta.get("model", "weather_mlp")
    if family == "weather_gru":
        return gru_forward_numpy(weights, meta, x, mm=mm)
    if family == "weather_transformer":
        return transformer_forward_numpy(weights, meta, x, mm=mm)
    if family == "weather_transformer_causal":
        return transformer_forward_numpy(weights, meta, x, causal=True, mm=mm)
    if family == "weather_transformer_pp":
        return transformer_pp_forward_numpy(weights, meta, x, mm=mm)
    if family == "weather_moe":
        return moe_forward_numpy(weights, meta, x)
    return mlp_forward_numpy(weights, x, mm=mm)


_SEQUENCE_FAMILIES = (
    "weather_gru", "weather_transformer", "weather_transformer_causal",
    "weather_transformer_pp", "weather_moe",
)


def validate_payload(meta: dict, data) -> np.ndarray:
    """Client-input validation: payload -> float32 batch array.

    Raises ValueError for anything that is the REQUEST's fault (ragged or
    non-numeric rows, wrong shape, non-finite values after float32
    conversion) — callers can map exactly this to an HTTP 400 while
    treating any later forward-pass failure as a server defect."""
    # A huge JSON number overflowing the float32 cast is the REQUEST's
    # fault, reported below as a clean 400 via the finiteness check —
    # numpy's "overflow encountered in cast" RuntimeWarning would only
    # leak noise into the server log for a condition already handled.
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
        # Includes float32 overflow of huge JSON numbers: softmax of an
        # inf logit is NaN, which is not valid strict JSON.
        raise ValueError(
            "features must be finite after float32 conversion"
        )
    return x


#: Exact JSON number grammar (one token, then comma-separated): the
#: fast path accepts PRECISELY what json.loads would, so it can never
#: answer 200 to a payload the contract path would 400 (no leading
#: zeros/plus signs, no bare trailing dots, no NaN/Infinity literals).
_JSON_NUM = rb"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_NUM_LIST_RE = None  # compiled lazily (module import stays regex-free)

#: Whitespace BETWEEN two number-grammar bytes means the global strip
#: below would splice tokens together ("[1 2]" -> "12" — invalid JSON
#: scored as the wrong number). Whitespace next to punctuation
#: (pretty-printed arrays) never matches.
_WS_SPLICE_RE = None


def parse_envelope_array(body: bytes) -> np.ndarray | None:
    """Zero-copy(-ish) fast path for the ``{"data": [...]}`` envelope:
    raw request bytes -> float32 ndarray without materializing the
    nested Python lists (and millions of boxed floats) ``json.loads``
    would build. The numeric text is parsed C-side in one pass
    (``np.fromstring`` text mode) after the bracket structure is
    verified rectangular and every token is matched against the exact
    JSON number grammar (one C-side regex pass — a malformed token like
    ``4.5.6`` must fall back, not half-parse).

    Returns ``None`` for anything that is not a strictly rectangular
    JSON-numeric envelope (ragged rows, strings, objects, nesting
    deeper than 3, extra top-level keys, non-JSON numerics) — the
    caller then falls back to the ``json.loads`` path, whose error
    reporting stays the contract. Overflow to ``inf`` is still rejected
    downstream by :func:`validate_payload`."""
    import re

    global _NUM_LIST_RE, _WS_SPLICE_RE
    if _NUM_LIST_RE is None:
        _NUM_LIST_RE = re.compile(
            _JSON_NUM + rb"(?:," + _JSON_NUM + rb")*"
        )
        _WS_SPLICE_RE = re.compile(rb"[0-9.eE+-][ \t\r\n]+[0-9.eE+-]")
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
    # Every token must be an exact JSON number (comma-separated): this
    # one pass rejects strings/objects/true/null AND malformed numerics
    # np.fromstring would silently half-parse ("4.5.6" -> 4.5).
    if not flat_txt or _NUM_LIST_RE.fullmatch(flat_txt) is None:
        return None

    # Rectangularity: every row at every level must agree in length —
    # the flat parse below cannot see brackets, so shape is proven here
    # (splitting on the row separators costs O(rows) small bytes
    # objects, never a Python float).
    if not (arr.startswith(b"[" * depth) and arr.endswith(b"]" * depth)):
        return None
    if depth == 1:
        if arr.count(b"[") != 1:  # e.g. [3,[1,2]] — not a flat vector
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
    if parser is None:  # a future numpy without text-mode fromstring:
        return None  # the json.loads path is always correct, just slower
    try:
        with np.errstate(over="ignore", invalid="ignore"):
            flat = parser(
                flat_txt.decode("ascii"), dtype=np.float32, sep=","
            )
    except (ValueError, DeprecationWarning, UnicodeDecodeError):
        return None
    if flat.size != expected:
        # A token fromstring could not parse truncates the output — the
        # count check catches it and the json path reports it properly.
        return None
    return flat.reshape(shape)


def score_payload(weights: dict, meta: dict, data) -> dict:
    """The run()-body: validate + forward + softmax.

    Mirrors the reference's response contract
    (dags/azure_manual_deploy.py:116-124): {"probabilities": [[...], ...]}.
    Row families take {"data": [[feature vector], ...]}; sequence families
    take {"data": [[[row x seq_len] window], ...]} (one window may be passed
    un-batched).
    """
    x = validate_payload(meta, data)
    probs = softmax_numpy(forward_numpy(weights, meta, x))
    return {"probabilities": probs.tolist()}
