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
with ``W > 1``) each process holds one block of the global batch, and on
a seq axis of ``S`` ranks (:meth:`MoEFFN.shard_seq_axis`, set by a
:class:`WeatherMoE` whose attention is the axis's engine) the ``T/S``
positions of seq shard ``j`` of that block's rows. The routing stays the
reference's, which runs one program over the global ``[B, T]`` tokens:

- the processes of the gradient group (data x seq) all-gather their
  per-row ``[k, B/W, E]`` choice counts once per layer and forward
  (:func:`~dct_tpu_torch.parallel.mesh.all_gather_grad`), in lockstep; the
  blocks and shards are equal, so the global token count is ``W S``
  times a process's and no count is read back to the host. Per-process
  totals would not do: under ``seq`` a rank's positions of a row lie
  between those of the seq ranks before and after it;
- ``einsum`` routes over the global tokens: capacity from the global
  count, and each entry's slot offset by the entries of its expert that
  come before it in the global flat order (``[B, T]`` row-major,
  choice-major over k): every earlier choice, then the same choice of the
  earlier data blocks, of the block's earlier rows and of the row's
  positions on the lower seq ranks;
- ``sorted`` routes each process's ``(B/W) (T/S)`` tokens alone with
  capacity from their count, as the reference's ``_sorted_sharded`` does
  at ep=1; where they do not tile the model axis, :func:`sorted_tiling`
  raises or falls back to ``einsum`` as the reference does;
- ``auto`` decides with the global count, as the reference does;
- the load-balance loss of a process is ``w * E * sum_e(frac_e *
  probsum_e) / N`` with the global ``frac`` and ``N`` and its own
  probability sums: summed over data x seq (the step's all-reduce, on
  every seq rank: the cross entropy alone counts on seq index 0), it is
  the reference's loss and gradient.

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
    embed_positions,
    mean_pool,
    rope_tables,
    sincos_positions,
)
from dct_tpu_torch.parallel.mesh import (
    all_gather_grad,
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


def sorted_tiling(b: int, s: int, e: int, *, dp: int, sp: int, ep: int,
                  dispatch: str) -> str:
    """The sorted engine's tiling test on a global ``[b, s]`` token grid
    with ``e`` experts over data x seq x model (``dct_tpu/models/
    moe.py:244-272``): ``"sorted"`` where every (data, seq) shard's tokens
    split into ``ep`` chunks and the experts over ``ep``; where not,
    ``"einsum"`` for fewer rows than data blocks (the reference's batch-1
    escape) and for ``auto``, and a raise, with the reference's message,
    when ``sorted`` was asked for."""
    if dp * sp * ep == 1:
        return "sorted"
    if (b % dp == 0 and s % sp == 0 and e % ep == 0
            and ((b // dp) * (s // sp)) % ep == 0):
        return "sorted"
    if b < dp:
        return "einsum"
    if dispatch == "sorted":
        raise ValueError(
            f"sorted MoE dispatch cannot tile tokens [B={b}, S={s}] experts "
            f"E={e} over mesh data={dp}, seq={sp}, model={ep}")
    return "einsum"  # auto: fall back rather than fail


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
        # The seq axis: this process holds seq shard ``seq_index`` of
        # ``seq_size`` of every row's positions.
        self.seq_size, self.seq_index = 1, 0

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

    def shard_seq_axis(self, shard) -> None:
        """Route as seq shard ``shard.index`` of ``shard.size``: this
        process's tokens are those positions of its block's rows."""
        self.seq_size, self.seq_index = shard.size, shard.index

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

    def _row_counts(self, choice, rows: int):
        """``[D, S, k, B, E]`` float: the per-row, per-choice expert counts
        of every process of the gradient group (one all-gather when it
        has more than one), for ``choice`` ``[k, B*T]`` over ``rows``
        rows of this process."""
        k, n = choice.shape
        e = self.n_experts
        row = torch.arange(n, device=choice.device) // (n // rows)
        slot = ((torch.arange(k, device=choice.device)[:, None] * rows
                 + row) * e + choice)
        counts = torch.bincount(slot.reshape(-1), minlength=k * rows * e)
        counts = counts.reshape(k, rows, e)
        world, seq = self.block[0], self.seq_size
        if world * seq == 1:
            return counts[None, None].float()
        mesh = get_mesh()
        if (mesh.data_size, mesh.seq_size) != (world, seq):
            raise RuntimeError(
                f"MoE routing over {world} data blocks and {seq} seq shards "
                f"needs a grid of that shape (have data={mesh.data_size}, "
                f"seq={mesh.seq_size})")
        return all_gather_grad(counts).float()

    def _ahead(self, counts):
        """``[k, B, E]``: for each choice, row and expert of this
        process, the entries of that expert before its first position in
        the reference's global flat order (``[B, T]`` row-major, choice
        major over k): every earlier choice, then the same choice of the
        earlier data blocks, of this block's earlier rows, and of this
        row's positions on the lower seq ranks."""
        p, q = self.block[1], self.seq_index
        per_choice = counts.sum(dim=(0, 1, 3))  # [k, E]
        rows = counts.sum(dim=1)  # [D, k, B, E] over the seq ranks
        mine = rows[p]
        before = (torch.cumsum(per_choice, dim=0) - per_choice
                  + rows[:p].sum(dim=(0, 2)))
        return (before[:, None] + torch.cumsum(mine, dim=1) - mine
                + counts[p, :q].sum(dim=0))

    def pick_engine(self, b: int, s: int) -> str:
        """The engine for a ``[b, s]`` token block of this process: the
        ``dispatch`` policy on the global token count, then the
        reference's tiling test of the sorted engine over data x seq x
        model (``dct_tpu/models/moe.py:244-272``)."""
        dp, sp = self.block[0], self.seq_size
        ep = self.ep.size if self.ep is not None else 1
        engine = self.engine_for(b * s * dp * sp)
        if engine == "sorted":
            engine = sorted_tiling(b * dp, s * sp, self.n_experts, dp=dp,
                                   sp=sp, ep=ep, dispatch=self.dispatch)
        return engine

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        n = b * s
        e, k = self.n_experts, self.top_k
        ct = self.compute_dtype or x.dtype
        tokens = x.reshape(n, d)
        probs, choice, gate = self._route(tokens)
        engine = self.pick_engine(b, s)
        counts = self._row_counts(choice, b)  # [D, S, k, B, E]
        # Blocks and shards are equal (the loader splits every global
        # batch so, the seq axis every window), so the global token count
        # needs no collective and no host read.
        n_global = self.block[0] * self.seq_size * n
        # Load balance over the global tokens; this process's share of
        # the probability mass (the step sums the shares over data x seq).
        frac = counts[:, :, 0].sum(dim=(0, 1, 2)) / n_global
        self.last_aux = (self.aux_weight * e
                         * torch.sum(frac * probs.sum(dim=0)) / n_global)
        self.last_engine = engine
        ep = self.ep.size if self.ep is not None else 1
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
            onehot = F.one_hot(choice, e).float().reshape(k, b, s, e)
            # An entry's slot: the entries of its expert ahead of it in
            # the global order (other processes' included), then this
            # row's earlier positions.
            position = (torch.cumsum(onehot, dim=2) - onehot
                        + self._ahead(counts)[:, :, None, :]
                        ).reshape(k * n, e)
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
                key: tuple | None = None, seq=None) -> torch.Tensor:
        """``seq``: ``(positions, T)`` of a seq rank's slice."""
        h = self.attn(self.ln_attn(x), rope)
        x = x + self.drop(h, None if key is None else key + (0,), seq)
        h = self.moe(self.ln_ffn(x))
        return x + self.drop(h, None if key is None else key + (1,), seq)


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
        # The sequence-parallel engine, whose layout the forward takes.
        self.seq_parallel = attn_fn if hasattr(attn_fn, "positions") else None
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
        if self.seq_parallel is not None:
            for block in self.blocks():
                block.moe.shard_seq_axis(self.seq_parallel.shard)
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
        """``dropout_key`` as the transformer's. On a seq axis this rank
        keeps its positions of ``x`` from the input to the pooled head,
        whose sum is all-reduced over the seq ranks."""
        h, rope, seq = embed_positions(self, x)
        for i, block in enumerate(self.blocks()):
            key = None if dropout_key is None else tuple(dropout_key) + (i,)
            h = block(h, rope, key, seq)
        return self.head(mean_pool(self, self.ln_out(h), x.shape[1])).float()
