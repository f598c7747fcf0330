"""Mixture-of-Experts family (counterpart of ``dct_tpu/models/moe.py``).

``WeatherMoE`` is the pre-LN encoder of :mod:`.transformer` with the dense
feed-forward replaced by :class:`MoEFFN`, a routed mixture of expert FFNs
over the flattened tokens:

- the router is an f32 dense layer; top-1 takes the best expert with its
  probability as the gate, top-k the k best (``torch.sort(stable=True)``,
  so ties go to the lower index as ``lax.top_k``'s do) with gates
  normalised over the k;
- the k choices of every token form ``k * N`` dispatch entries ordered
  choice-major (every first choice before any second), each expert takes
  its first ``capacity = max(1, int(cf * k * N / E))`` entries in that
  order, and the rest are dropped (their output is zero; the block's
  residual passes the token through);
- two engines compute the same mixture: ``einsum`` (one-hot dispatch and
  combine tensors ``[kN, E, C]``) and ``sorted`` (a stable sort by expert,
  ranks within each expert, a scatter into an ``[E, C, D]`` buffer whose
  extra last row takes every dropped entry and is sliced off, so dropped
  tokens get no gradient); ``auto`` picks sorted once ``k * N * E * C``
  reaches ``auto_threshold``. The expert products are plain batched GEMMs,
  as in the reference (no Pallas kernel lies there);
- the Switch load-balance loss ``w * E * sum_e(frac_e * mean_prob_e)``
  (``frac`` from the first choices) is kept per layer for the train step,
  the counterpart of the reference's ``sow("aux_loss", ...)``:
  :meth:`WeatherMoE.aux_loss` sums the terms of the last forward.

Under data parallelism (:func:`~dct_tpu_torch.models.mlp.set_data_block`
with ``W > 1``) each process holds one block of the global batch and the
routing stays the reference's, which runs one program over the global
batch:

- the processes all-gather their ``[k, E]`` choice counts once per layer
  and forward (:func:`~dct_tpu_torch.parallel.mesh.all_gather_rows`), in
  lockstep; the blocks are equal, so the global token count is ``W`` times
  a block's and no count is read back to the host;
- ``einsum`` routes over the global batch: capacity from the global token
  count, and each entry's slot offset by the entries of its expert that
  come before it in the global choice-major order (earlier choices of
  every process, then the same choice of lower ranks);
- ``sorted`` routes each process's tokens alone with capacity from its own
  token count, as the reference's ``_sorted_sharded`` does at ep=1;
- ``auto`` decides with the global count, as the reference does;
- the load-balance loss of a process is ``w * E * sum_e(frac_e *
  probsum_e) / N`` with the global ``frac`` and ``N`` and its own
  probability sums: summed over the processes (the step's all-reduce), it
  is the reference's loss and gradient.

On a model axis of ``M`` ranks (the reference's expert parallelism,
``dct_tpu/models/moe.py:65-104, 308-360``) the expert stacks split their
expert dim (``E/M`` experts per rank; ``E`` must divide by ``M``) and the
model ranks of a data block, which hold the same tokens:

- ``sorted`` routes by chunks, as the reference's ``_sorted_sharded``:
  rank ``r`` takes the ``r``-th of ``M`` equal chunks of its block's
  tokens with capacity ``max(1, int(cf * k * chunk / E))`` from the chunk
  (so at tight capacity other tokens drop than in the one-shard engine),
  scatters them into its ``[E, C, D]`` buffer, sends expert ``e``'s slots
  to the rank owning ``e`` and gets its own experts' slots from every rank
  (``all_to_all_single``), runs its experts, sends the results back the
  same way, and the ranks all-gather the chunks' outputs (the gather's
  backward keeps the rank's own rows; the tokens and gates enter through
  :func:`~dct_tpu_torch.parallel.mesh.copy_to_model`, whose backward sums
  the chunks' gradients). Where a block's tokens or the experts do not
  split over ``M``, ``auto`` takes ``einsum`` and ``sorted`` raises, as the
  reference does. With the experts replicated (a rule says so) each rank
  routes its chunk alike and runs every expert itself;
- ``einsum`` keeps the global routing; each rank computes its experts'
  slice of the expert outputs and the combine sums over the model group;
- the router, the gates and the load-balance loss are computed on every
  model rank from the same tokens (the loss is not reduced over the model
  group).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dct_tpu_torch.convert import init_listed
from dct_tpu_torch.models.mlp import Dropout, TorchStyleDense
from dct_tpu_torch.models.transformer import (
    LayerNorm,
    MultiHeadAttention,
    rope_tables,
    sincos_positions,
)
from dct_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_to_all_model,
    copy_to_model,
    gather_from_model,
    get_mesh,
    reduce_from_model,
)

ENGINES = ("auto", "sorted", "einsum")


def _expert_ffn(batch, w_in, b_in, w_out, b_out):
    """Per-expert FFN over ``[E, C, D]`` slots: two batched GEMMs with a
    tanh-GELU between."""
    h = F.gelu(torch.bmm(batch, w_in) + b_in[:, None, :], approximate="tanh")
    return torch.bmm(h, w_out) + b_out[:, None, :]


def _sorted_moe(tokens, expert_idx, gate, w_in, b_in, w_out, b_out, *,
                e_total: int, capacity: int, ep_shard=None):
    """Sorted dispatch on one shard: tokens ``[N, D]``, ``expert_idx``
    ``[N]``, ``gate`` ``[N]`` -> ``[N, D]`` gated expert outputs (zero for
    an entry past its expert's capacity). With ``ep_shard`` the expert
    weights are this rank's ``[E/M, ...]`` and the ``[E, C, D]`` buffer is
    exchanged over the model group so that each rank runs its own
    experts."""
    n, d = tokens.shape
    order = torch.argsort(expert_idx, stable=True)  # keeps arrival order
    sorted_e = expert_idx[order]
    counts = torch.bincount(expert_idx, minlength=e_total)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=tokens.device) - starts[sorted_e]
    keep = pos < capacity
    # Row e*C+c is (expert e, slot c); every dropped entry goes to the
    # last row, which is sliced off before the experts run.
    dst = torch.where(keep, sorted_e * capacity + pos, e_total * capacity)
    buf = tokens.new_zeros(e_total * capacity + 1, d).index_put(
        (dst,), tokens[order])
    expert_in = buf[:-1].reshape(e_total, capacity, d)
    if ep_shard is None:
        out_e = _expert_ffn(expert_in, w_in, b_in, w_out, b_out)
    else:
        ep = ep_shard.size
        e_local = e_total // ep
        # [dst, E/M, C, D] -> [src, E/M, C, D]: every rank's slots of my
        # experts, run as one batch per expert.
        z = all_to_all_model(expert_in.reshape(ep, e_local, capacity, d),
                             ep_shard)
        z = z.transpose(0, 1).reshape(e_local, ep * capacity, d)
        z = _expert_ffn(z, w_in, b_in, w_out, b_out)
        z = z.reshape(e_local, ep, capacity, d).transpose(0, 1)
        out_e = all_to_all_model(z.contiguous(), ep_shard).reshape(
            e_total, capacity, d)
    out_flat = torch.cat([out_e.reshape(e_total * capacity, d),
                          out_e.new_zeros(1, d)])
    out_sorted = out_flat[dst] * keep[:, None].to(out_e.dtype)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(n, device=order.device)
    return out_sorted[unsort] * gate[:, None]


class MoEFFN(nn.Module):
    """Routed mixture of ``n_experts`` FFNs over ``[B, S, D]`` tokens
    (module docstring). ``last_aux`` holds the pre-weighted load-balance
    term of the last forward. Its expert stacks are a tensor-parallel
    unit."""

    tp_leaves = {"experts_in_kernel": ("model", None, None),
                 "experts_in_bias": ("model", None),
                 "experts_out_kernel": ("model", None, None),
                 "experts_out_bias": ("model", None)}

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01,
                 dispatch: str = "auto", top_k: int = 1,
                 auto_threshold: int = 1 << 21, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(
                f"top_k={top_k} must be in [1, n_experts={n_experts}]")
        if dispatch not in ENGINES:
            raise ValueError(
                f"moe_dispatch={dispatch!r} must be "
                "'auto' | 'sorted' | 'einsum'")
        self.d_model, self.d_ff, self.n_experts = d_model, d_ff, n_experts
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.dispatch, self.top_k = dispatch, top_k
        self.auto_threshold = auto_threshold
        self.compute_dtype = compute_dtype
        self.router = TorchStyleDense(d_model, n_experts, device=device,
                                      dtype=dtype,
                                      compute_dtype=torch.float32)
        kw = {"device": device, "dtype": dtype}
        e = n_experts
        self.experts_in_kernel = nn.Parameter(
            torch.empty(e, d_model, d_ff, **kw))
        self.experts_in_bias = nn.Parameter(torch.empty(e, d_ff, **kw))
        self.experts_out_kernel = nn.Parameter(
            torch.empty(e, d_ff, d_model, **kw))
        self.experts_out_bias = nn.Parameter(torch.empty(e, d_model, **kw))
        self.flax_params = {
            "experts_in_kernel": ("uniform", d_model),
            "experts_in_bias": ("uniform", d_model),
            "experts_out_kernel": ("uniform", d_ff),
            "experts_out_bias": ("uniform", d_ff),
        }
        init_listed(self)
        # (W, p): this process holds block p of W of the global batch.
        self.block = (1, 0)
        self.takes_data_block = True
        self.last_aux: torch.Tensor | None = None
        self.last_engine: str | None = None
        # The model axis (None: one rank) and whether the experts split
        # over it.
        self.ep = None
        self.experts_split = False

    def shard_model_axis(self, shard, *, split: bool) -> None:
        """Route by the model axis ``shard`` and, with ``split``, keep
        this rank's block of the experts."""
        self.ep = shard
        if not split:
            return
        if self.n_experts % shard.size:
            raise ValueError(
                f"expert parallelism over model={shard.size} needs "
                f"n_experts ({self.n_experts}) to divide by it")
        n = self.n_experts // shard.size
        rows = slice(shard.index * n, (shard.index + 1) * n)
        for name in self.flax_params:
            setattr(self, name, nn.Parameter(
                getattr(self, name).data[rows].clone()))
        self.experts_split = True

    def capacity(self, n: int) -> int:
        """Slots per expert for ``n`` tokens (the reference's float
        arithmetic)."""
        return max(1, int(self.capacity_factor * self.top_k * n
                          / self.n_experts))

    def engine_for(self, n: int) -> str:
        """The engine ``dispatch`` selects for ``n`` (global) tokens."""
        if self.dispatch != "auto":
            return self.dispatch
        k, e = self.top_k, self.n_experts
        return ("sorted" if k * n * e * self.capacity(n) >= self.auto_threshold
                else "einsum")

    def _route(self, tokens):
        """f32 router -> (probs [N, E], choices [k, N], gates [k, N])."""
        probs = torch.softmax(self.router(tokens.float()), dim=-1)
        if self.top_k == 1:
            gate, choice = probs.max(dim=-1)
            return probs, choice[None], gate[None]
        topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topv, topi = topv[:, :self.top_k], topi[:, :self.top_k]
        gates = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
        return probs, topi.T, gates.T

    def _counts(self, choice):
        """``[W, k, E]`` int64: every process's per-choice expert counts
        (one all-gather when ``W > 1``)."""
        k = choice.shape[0]
        e = self.n_experts
        offsets = torch.arange(k, device=choice.device)[:, None] * e
        counts = torch.bincount((choice + offsets).reshape(-1),
                                minlength=k * e).reshape(k, e)
        if self.block[0] == 1:
            return counts[None]
        if get_mesh().data_size != self.block[0]:
            raise RuntimeError(
                f"MoE routing over {self.block[0]} data blocks needs a data "
                f"axis of that size (have {get_mesh().data_size})")
        return all_gather_rows(counts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        n = b * s
        e, k = self.n_experts, self.top_k
        ct = self.compute_dtype or x.dtype
        tokens = x.reshape(n, d)
        probs, choice, gate = self._route(tokens)

        per_choice = self._counts(choice)  # [W, k, E]
        world, rank = self.block
        # Blocks are equal (the loader splits every global batch so), so
        # the global token count needs no collective and no host read.
        n_global = world * n
        # Load balance over the global tokens; this block's share of the
        # probability mass (the step sums the shares over processes).
        frac = per_choice[:, 0].sum(dim=0).float() / n_global
        self.last_aux = (self.aux_weight * e
                         * torch.sum(frac * probs.sum(dim=0)) / n_global)

        engine = self.engine_for(n_global)
        ep = self.ep.size if self.ep is not None else 1
        if engine == "sorted" and ep > 1 and (e % ep or n % ep):
            if self.dispatch == "sorted":
                raise ValueError(
                    f"sorted MoE dispatch cannot tile tokens [B={b * world}"
                    f", S={s}] experts E={e} over mesh data={world}, seq=1, "
                    f"model={ep}")
            engine = "einsum"  # auto: fall back rather than fail
        self.last_engine = engine
        wi = self.experts_in_kernel.to(ct)
        bi = self.experts_in_bias.to(ct)
        wo = self.experts_out_kernel.to(ct)
        bo = self.experts_out_bias.to(ct)
        if engine == "sorted" and ep > 1:
            return self._sorted_sharded(tokens.to(ct), choice, gate.to(ct),
                                        wi, bi, wo, bo).reshape(b, s, d)
        toks = tokens.to(ct)
        flat_tokens = toks.repeat(k, 1) if k > 1 else toks
        flat_idx = choice.reshape(k * n)
        flat_gate = gate.reshape(k * n).to(ct)

        if engine == "sorted":
            out2 = _sorted_moe(flat_tokens, flat_idx, flat_gate, wi, bi, wo,
                               bo, e_total=e, capacity=self.capacity(n))
        else:
            capacity = self.capacity(n_global)
            onehot = F.one_hot(choice, e).float()  # [k, N, E]
            # Entries of each expert ahead of this block's choice j in the
            # global choice-major order: every process's choices < j, then
            # choice j of the lower ranks.
            per_choice = per_choice.float()
            total = per_choice.sum(dim=0)  # [k, E] over every process
            ahead = (torch.cumsum(total, dim=0) - total
                     + per_choice[:rank].sum(dim=0))
            position = (torch.cumsum(onehot, dim=1) - onehot
                        + ahead[:, None, :]).reshape(k * n, e)
            onehot = onehot.reshape(k * n, e)
            keep = (position < capacity).float() * onehot
            slot_of = torch.sum(position * onehot, dim=-1).long()
            slot = F.one_hot(torch.clamp(slot_of, max=capacity - 1),
                             capacity).float()  # kept entries are < C
            disp = (keep[:, :, None] * slot[:, None, :]).to(ct)  # [kN, E, C]
            if self.experts_split:
                # My experts' slice; the combine sums over the model group.
                e_local = wi.shape[0]
                lo = self.ep.index * e_local
                disp = disp[:, lo:lo + e_local]
                flat_tokens = copy_to_model(flat_tokens, self.ep)
            expert_in = torch.einsum("nec,nd->ecd", disp, flat_tokens)
            out_e = _expert_ffn(expert_in, wi, bi, wo, bo)
            out2 = torch.einsum("nec,ecd->nd", disp, out_e)
            if self.experts_split:
                out2 = reduce_from_model(out2, self.ep)
            out2 = out2 * flat_gate[:, None]
        out = out2.reshape(k, n, d).sum(dim=0) if k > 1 else out2
        return out.reshape(b, s, d)

    def _sorted_sharded(self, tokens, choice, gate, wi, bi, wo, bo):
        """The reference's ``_sorted_sharded`` on this model rank: route
        its chunk of the block's tokens (``[N, D]``; ``choice`` and
        ``gate`` ``[k, N]``) with the chunk's capacity, then all-gather the
        chunks' outputs -> ``[N, D]``."""
        n, d = tokens.shape
        e, k = self.n_experts, choice.shape[0]
        shard = self.ep
        chunk = n // shard.size
        cap = max(1, int(self.capacity_factor * k * chunk / e))
        mine = slice(shard.index * chunk, (shard.index + 1) * chunk)
        tok_my = copy_to_model(tokens, shard)[mine]
        gate_my = copy_to_model(gate, shard)[:, mine]
        flat_tokens = tok_my.repeat(k, 1) if k > 1 else tok_my
        if not self.experts_split:
            # Replicated experts see this rank's chunk only: their
            # gradients sum over the model group.
            wi, bi, wo, bo = (copy_to_model(t, shard)
                              for t in (wi, bi, wo, bo))
        out2 = _sorted_moe(
            flat_tokens, choice[:, mine].reshape(k * chunk),
            gate_my.reshape(k * chunk), wi, bi, wo, bo, e_total=e,
            capacity=cap, ep_shard=shard if self.experts_split else None)
        out_my = out2.reshape(k, chunk, d).sum(dim=0) if k > 1 else out2
        return gather_from_model(out_my, shard)


class MoEBlock(nn.Module):
    """Pre-LN block: attention, then the expert mixture, each followed by
    dropout before its residual add."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, n_experts: int,
                 attn_fn, *, dropout: float = 0.0,
                 n_kv_heads: int | None = None, moe_kw: dict,
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=compute_dtype)
        self.ln_attn = LayerNorm(d_model, **kw)
        self.attn = MultiHeadAttention(d_model, n_heads, attn_fn,
                                       n_kv_heads=n_kv_heads, **ckw)
        self.ln_ffn = LayerNorm(d_model, **kw)
        self.moe = MoEFFN(d_model, d_ff, n_experts, **moe_kw, **ckw)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, rope=None,
                key: tuple | None = None) -> torch.Tensor:
        h = self.attn(self.ln_attn(x), rope)
        x = x + self.drop(h, None if key is None else key + (0,))
        h = self.moe(self.ln_ffn(x))
        return x + self.drop(h, None if key is None else key + (1,))


class WeatherMoE(nn.Module):
    """MoE encoder over ``[B, S, F]`` windows -> ``[B, num_classes]`` f32
    logits (mean-pooled head)."""

    # Capacity, and so which tokens are dropped, depends on the rows
    # scored together: scorers keep a request at its true shape.
    routing_depends_on_batch = True

    def __init__(self, input_dim: int, seq_len: int, *, d_model: int = 64,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 128,
                 n_experts: int = 4, capacity_factor: float = 1.25,
                 router_aux_weight: float = 0.01, num_classes: int = 2,
                 dropout: float = 0.1, attn_fn=None, dispatch: str = "auto",
                 top_k: int = 1, auto_threshold: int = 1 << 21,
                 n_kv_heads: int | None = None, pos_embed: str = "sincos",
                 device=None, dtype=torch.float32,
                 compute_dtype=None):
        super().__init__()
        if d_model % 2 or d_model % n_heads:
            raise ValueError(
                f"d_model={d_model} must be even (sinusoidal positions) "
                f"and divisible by n_heads={n_heads}")
        if pos_embed not in ("sincos", "rope"):
            raise ValueError(
                f"pos_embed={pos_embed!r} must be 'sincos' or 'rope'")
        if attn_fn is None:
            from dct_tpu_torch.ops.attention import make_attention_fn

            attn_fn = make_attention_fn()
        self.compute_dtype = compute_dtype or dtype
        self.input_dim, self.seq_len = input_dim, seq_len
        self.n_layers, self.pos_embed = n_layers, pos_embed
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=self.compute_dtype)
        moe_kw = dict(capacity_factor=capacity_factor,
                      aux_weight=router_aux_weight, dispatch=dispatch,
                      top_k=top_k, auto_threshold=auto_threshold)
        self.in_proj = TorchStyleDense(input_dim, d_model, **ckw)
        for i in range(n_layers):
            self.add_module(f"block_{i}", MoEBlock(
                d_model, n_heads, d_ff, n_experts, attn_fn, dropout=dropout,
                n_kv_heads=n_kv_heads, moe_kw=moe_kw, **ckw))
        self.ln_out = LayerNorm(d_model, **kw)
        self.head = TorchStyleDense(d_model, num_classes, **ckw)
        if pos_embed == "rope":
            cos, sin = rope_tables(seq_len, d_model // n_heads)
            self.register_buffer("rope_cos", cos.to(device), persistent=False)
            self.register_buffer("rope_sin", sin.to(device), persistent=False)
        else:
            self.register_buffer(
                "pos_table", sincos_positions(seq_len, d_model).to(device),
                persistent=False)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def aux_loss(self) -> torch.Tensor | None:
        """The sum over layers of the load-balance terms of the last
        forward (None before the first)."""
        terms = [blk.moe.last_aux for blk in self.blocks()]
        if any(t is None for t in terms):
            return None
        return torch.stack(terms).sum()

    def forward(self, x: torch.Tensor,
                dropout_key: tuple | None = None) -> torch.Tensor:
        dtype = self.compute_dtype
        h = self.in_proj(x.to(dtype))
        rope = None
        if self.pos_embed == "rope":
            t = h.shape[1]
            rope = (self.rope_cos[:t], self.rope_sin[:t])
        else:
            h = h + self.pos_table.to(dtype)
        for i, block in enumerate(self.blocks()):
            key = None if dropout_key is None else tuple(dropout_key) + (i,)
            h = block(h, rope, key)
        h = self.ln_out(h)
        return self.head(h.mean(dim=1)).float()
