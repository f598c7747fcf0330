"""Partition rules and dtype rules (counterpart of
``dct_tpu/parallel/sharding_rules.py``).

**Partition rules.** A per-family table maps regexes over a leaf's
``/``-joined path to a partition spec over the ``data``/``model``/``seq``/
``pipe`` axes (a tuple with one entry per dimension, ``None`` for a
replicated one; ``()`` replicates the whole leaf), as the reference's
``PartitionSpec`` s: the transformer's ``qkv_proj``/``ffn_in`` are
column-parallel (the output dim over ``model``), ``o_proj``/``ffn_out``
row-parallel (the input dim; the bias replicated, added after the
all-reduce), and the MoE's expert stacks split their expert dim. Paths
and shapes are the reference's (flax layout: dense kernels ``[in, out]``;
``params/params/block_0/attn/qkv_proj/kernel`` for a parameter,
``opt_state/[0]/mu/params/...`` for its Adam moment), so the same rules
select the same leaves. ``DCT_SHARD_RULES`` prepends operator clauses
(:func:`parse_rules`: the reference's grammar and errors, word for word).

Where the reference hands its specs to GSPMD, which inserts the
collectives and reshards whatever it is given, the port computes the
placements itself (:func:`shard_state_with_rules`). Each leaf has two:

- its **stored** specs, where the parameter and its moments live
  between steps: any rule's spec over the four axes, one axis a dim
  (each moment's by the clauses matching its own ``opt_state`` path, so
  Adam's ``mu`` and ``nu`` may differ), with ZeRO-1
  (``shard_opt``: the moments of an otherwise replicated leaf split
  their leading dim over ``data``) and FSDP (``shard_params``: the
  parameter as well), the reference's per-leaf rule
  (:func:`_data_shard_spec`). Moments stored apart from their parameter
  are updated in the first moment's placement, the parameter's block
  brought there and back (:func:`respec`), and a later moment stored
  apart from the first is brought there for the update and its block
  kept after it (``Leaf.slot_specs``). A pipeline stage leaf
  (``pp_stages/...``, stacked ``[n_stages, ...]``) is stored and
  computed ``P("pipe", <the table's spec of the path inside the stage>,
  None...)``, the reference's structural rule, which ZeRO-1 and FSDP
  never split over ``data``;
- its **compute** spec, what its module computes with: the family
  table's tensor-parallel slice where its unit (an attention's
  ``qkv_proj``/``o_proj``, a block's ``ffn_in``/``ffn_out``, an MoE's
  expert stacks) is split over ``model`` (any of the unit's leaves stored
  over ``model``), else the whole leaf; a stage leaf's is its stage's
  slice of that. The split units' modules run the
  collectives (:mod:`dct_tpu_torch.parallel.mesh`); the sizes must
  divide (whole KV groups, ``d_ff``, the experts) or the placement
  raises.

A leaf whose two specs differ is **resharded** at its use
(:mod:`dct_tpu_torch.parallel.reshard`): its stored block is all-gathered
over its axes and narrowed to the compute slice when its unit runs, and
its gradient goes back to the stored block. A rule raises, naming its
clause, only for a dim its axis does not divide or a spec the leaf
cannot take (longer than its rank, or one axis on two dims). The gather
half (:func:`gather_leaf`, :func:`gather_tree`,
:func:`make_shard_and_gather_fns`) brings a stored leaf back dense: a
collective every process runs, which the publish path (deploy
checkpoints, packages) calls before the coordinator writes.

**Dtype rules.** ``DCT_DTYPE_RULES='pattern=dtype[;pattern=dtype...]'``
selects parameters by a regex over their flax path and casts the matching
ones to a low precision for the forward and backward; the f32 masters,
gradients and optimizer state stay f32 (:func:`cast_params_by_rules`).
"""

from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXIS_NAMES = ("data", "model", "seq", "pipe")


def P(*dims) -> tuple:
    """A partition spec: one mesh axis (or None) per dimension."""
    return tuple(dims)


# The transformer-family name rules (column-parallel shards the OUTPUT
# dim, row-parallel the INPUT dim; a row-parallel bias stays replicated),
# plus expert parallelism (the MoE's [E, ...] stacks over ``model``). The
# router stays replicated (no rule matches it). The reference's table,
# ``sharding_rules.py:55-64``.
_TENSOR_PARALLEL_RULES = (
    (r"(^|/)experts_in_kernel$", P("model", None, None)),
    (r"(^|/)experts_in_bias$", P("model", None)),
    (r"(^|/)experts_out_kernel$", P("model", None, None)),
    (r"(^|/)experts_out_bias$", P("model", None)),
    (r"(qkv_proj|ffn_in).*/kernel$", P(None, "model")),
    (r"(qkv_proj|ffn_in).*/bias$", P("model")),
    (r"(o_proj|ffn_out).*/kernel$", P("model", None)),
    (r"(o_proj|ffn_out).*/bias$", P()),
)

#: Per-family default rule tables (families without an entry use
#: ``None``'s). A family whose params match no pattern (the MLP, the GRU)
#: replicates everywhere: pure data parallelism.
FAMILY_RULES: dict = {
    None: _TENSOR_PARALLEL_RULES,
    "weather_mlp": _TENSOR_PARALLEL_RULES,
    "weather_gru": _TENSOR_PARALLEL_RULES,
    "weather_transformer": _TENSOR_PARALLEL_RULES,
    "weather_transformer_causal": _TENSOR_PARALLEL_RULES,
    "weather_transformer_pp": _TENSOR_PARALLEL_RULES,
    "weather_moe": _TENSOR_PARALLEL_RULES,
}


def parse_rules(text: str):
    """``DCT_SHARD_RULES`` grammar -> tuple of (regex, spec).

    ``pattern=axes[;pattern=axes...]``: ``pattern`` is a regex matched
    (``re.search``) against the leaf's ``/``-joined path; ``axes`` is a
    comma-separated per-dimension list of mesh axis names (``-`` for a
    replicated dimension, the empty string for a fully replicated
    leaf). Malformed specs raise ``ValueError`` naming the offending
    clause: a typo'd layout must never silently train replicated."""
    rules = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"DCT_SHARD_RULES clause {clause!r} has no '=': expected "
                "pattern=axis,axis,..."
            )
        pattern, _, axes = clause.rpartition("=")
        pattern = pattern.strip()
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"DCT_SHARD_RULES pattern {pattern!r} is not a valid "
                f"regex: {e}"
            ) from e
        dims = []
        if axes.strip():
            for tok in axes.split(","):
                tok = tok.strip()
                if tok in ("-", "", "none", "None"):
                    dims.append(None)
                elif tok in AXIS_NAMES:
                    dims.append(tok)
                else:
                    raise ValueError(
                        f"DCT_SHARD_RULES clause {clause!r}: unknown mesh "
                        f"axis {tok!r} (valid: {', '.join(AXIS_NAMES)}, "
                        "'-' for a replicated dim)"
                    )
        rules.append((pattern, P(*dims)))
    return tuple(rules)


#: parse_rules memo keyed by the raw env string (rules resolve once per
#: leaf; the env string is fixed within a placement pass).
_PARSE_CACHE: dict[str, tuple] = {}


def _env_rules() -> tuple:
    env = os.environ.get("DCT_SHARD_RULES")
    if not env:
        return ()
    cached = _PARSE_CACHE.get(env)
    if cached is None:
        cached = parse_rules(env)
        if len(_PARSE_CACHE) > 8:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[env] = cached
    return cached


def rules_for_family(family: str | None = None):
    """The active rule table for ``family``: any ``DCT_SHARD_RULES``
    overrides first (first match wins), then the family's defaults."""
    base = FAMILY_RULES.get(family, FAMILY_RULES[None])
    return _env_rules() + tuple(base)


def rules_digest(family: str | None = None) -> str:
    """Content digest of the active rule table (the reference keys its
    AOT executables and layout manifests with it)."""
    blob = "|".join(
        f"{pat}={','.join(str(a) for a in spec)}"
        for pat, spec in rules_for_family(family)
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def path_str(path) -> str:
    """A path (a sequence of keys) -> the ``/``-joined string the rule
    regexes match."""
    return "/".join(
        str(getattr(k, "key", getattr(k, "name", k))) for k in path
    )


def match_partition_rules(rules, tree):
    """Spec tree for a nested dict (or list) ``tree`` of arrays under
    ``rules``: scalars and unmatched leaves replicate (``()``), the first
    matching rule wins."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (f"[{i}]",))
                              for i, v in enumerate(node))
        if (node.ndim if hasattr(node, "ndim") else np.ndim(node)) == 0:
            return P()
        name = path_str(path)
        for pattern, spec in rules:
            if re.search(pattern, name):
                return spec
        return P()

    return walk(tree, ())


def _resolve(name: str, family: str | None, ndim: int | None = None):
    """(spec, the ``DCT_SHARD_RULES`` clause that gave it or None) for
    the ``/``-joined path ``name`` of a leaf of rank ``ndim``. A pipeline
    stage leaf (a path through ``pp_stages``, stacked ``[n_stages, ...]``)
    puts its stage dim on ``pipe`` and matches the rules against the
    path inside the stage, padded with None to ``ndim`` (2 when None):
    ``P("pipe", *inner, None...)``, as the reference's
    ``spec_for_path`` (``dct_tpu/parallel/sharding_rules.py:308-327``),
    so the stage's blocks keep their tensor-parallel placement."""
    names = name.split("/")
    stage = "pp_stages" in names
    if stage:
        name = "/".join(names[names.index("pp_stages") + 1:])
    spec, clause = P(), None
    for pattern, s in _env_rules():
        if re.search(pattern, name):
            axes = ",".join("-" if a is None else a for a in s)
            spec, clause = s, f"{pattern}={axes}"
            break
    else:
        for pattern, s in FAMILY_RULES.get(family, FAMILY_RULES[None]):
            if re.search(pattern, name):
                spec = s
                break
    if stage:
        pad = (2 if ndim is None else ndim) - 1 - len(spec)
        spec = P("pipe", *spec, *([None] * max(pad, 0)))
    return spec, clause


def spec_for_path(path, ndim: int | None = None,
                  family: str | None = None) -> tuple:
    """The rule table's spec for the leaf at ``path`` (of rank ``ndim``;
    :func:`_resolve`)."""
    names = [str(getattr(k, "key", k)) for k in path]
    return _resolve("/".join(names), family, ndim)[0]


def _data_shard_spec(leaf, mesh) -> tuple | None:
    """Data-axis leading-dim spec for a leaf whose leading dim divides
    evenly over ``data`` (and is at least its size), else None: the
    reference's per-leaf ZeRO-1 / FSDP rule. ``leaf`` is an array or a
    shape."""
    shape = tuple(getattr(leaf, "shape", leaf))
    data = mesh.shape["data"]
    if (data > 1 and len(shape) >= 1 and shape[0] % data == 0
            and shape[0] >= data):
        return P("data", *([None] * (len(shape) - 1)))
    return None


# ------------------------------------------------------------ state tree


def opt_slots(tx, st, prefix=("opt_state",)):
    """The optimizer state's leaves in optax's order, each as
    ``(kind, path, value)``: ``("count", path, int)`` or ``("moments",
    path, [tensor per parameter])``, paths as the reference's state tree
    gives them (``opt_state/[0]/mu``; a clip's chain nests the rest under
    ``[1]``, as ``optax.chain(clip, tx)`` does)."""
    if tx.kind == "chain":
        parts = list(zip(tx.parts, st))
        nested = bool(parts) and parts[0][0].kind == "clip"
        out = []
        for j, (t, s) in enumerate(parts):
            where = (prefix + ("[1]", f"[{j - 1}]") if nested and j
                     else prefix + (f"[{j}]",))
            out += opt_slots(t, s, where)
        return out
    if tx.kind == "adam":
        return [("count", prefix + ("count",), st["count"]),
                ("moments", prefix + ("mu",), st["mu"]),
                ("moments", prefix + ("nu",), st["nu"])]
    if tx.kind == "lion":
        return [("count", prefix + ("count",), st["count"]),
                ("moments", prefix + ("mu",), st["mu"])]
    if tx.kind == "trace":
        return [("moments", prefix + ("trace",), st)]
    if tx.kind == "schedule":
        return [("count", prefix + ("count",), st)]
    return []


def state_leaf_paths(state) -> list[tuple[str, tuple, int | None]]:
    """Every leaf of the reference's ``{"opt_state", "params", "rng",
    "step"}`` tree in ``jax.tree.leaves`` order, as ``(kind, path,
    param)``: ``param`` is the index in ``model.parameters()`` of the
    parameter a moment or parameter leaf mirrors (None for counts, the
    rng and the step)."""
    from dct_tpu_torch.checkpoint.manager import _param_order

    order = _param_order(state.model)
    out = []
    for kind, path, _ in opt_slots(state.tx, state.opt_state):
        if kind == "count":
            out.append(("count", path, None))
            continue
        for i, key, _tr in order:
            out.append(("moment", path + ("params", *key.split("/")), i))
    for i, key, _tr in order:
        out.append(("param", ("params", "params", *key.split("/")), i))
    out.append(("rng", ("rng",), None))
    out.append(("step", ("step",), None))
    return out


def state_shardings(state, mesh, *, shard_opt: bool = False,
                    shard_params: bool = False,
                    family: str | None = None) -> dict:
    """``{path: spec}`` over the train state's leaves, as the reference's
    ``state_shardings`` gives them on a mesh of ``mesh.shape``: scalars
    replicate; rule matches (parameters and their mirrored moments) keep
    their spec; with ``shard_opt`` the otherwise replicated moments split
    their leading dim over ``data`` (ZeRO-1), with ``shard_params`` the
    parameters too (FSDP). ``mesh`` needs only a ``shape`` mapping."""
    shapes = _global_shapes(state.model)
    out = {}
    for kind, path, i in state_leaf_paths(state):
        name = path_str(path)
        if i is None:
            out[name] = P()
            continue
        shape = shapes[i]
        spec = _resolve(name, family, len(shape))[0] if shape else P()
        if spec == P() and shape:
            eligible = (shard_opt and kind == "moment") or shard_params
            if eligible:
                spec = _data_shard_spec(shape, mesh) or spec
        out[name] = spec
    return out


def _global_shapes(model: nn.Module) -> list[tuple]:
    """The flax-layout global shape of every parameter (in
    ``model.parameters()`` order), shards included."""
    from dct_tpu_torch.convert import flax_names, flax_shape

    layout = getattr(model, "dct_layout", None)
    names = flax_names(model)
    out = []
    for i, (name, p) in enumerate(model.named_parameters()):
        if layout is not None:
            out.append(layout.leaves[i].shape)
            continue
        out.append(flax_shape(tuple(p.shape), names[name][1]))
    return out


# ------------------------------------------------------------ placement


@dataclass
class Leaf:
    """One parameter's layout, in flax coordinates: its global ``shape``,
    the stored specs of the parameter and of its moments, the spec its
    module computes with (module docstring), and the ``mesh`` that places
    this process. An axis of one process splits nothing."""

    name: str
    key: str
    transposed: bool
    shape: tuple
    param_spec: tuple
    moment_spec: tuple
    compute_spec: tuple = ()
    mesh: object = None
    #: The stored specs of the moments kept apart from ``moment_spec``
    #: (the first moment's, where the update runs), by moment path.
    slot_specs: dict = field(default_factory=dict)

    def splits(self, spec) -> list[tuple[int, str]]:
        """``(flax dim, axis)`` of every dim ``spec`` splits over more
        than one process."""
        if self.mesh is None:
            return []
        return [(d, a) for d, a in enumerate(spec)
                if a is not None and self.mesh.shape[a] > 1]

    def axes(self, spec) -> tuple:
        return tuple(a for _, a in self.splits(spec))

    def stored_spec(self, kind: str, path=()) -> tuple:
        """The stored spec of this leaf's parameter (``kind`` "param") or
        of its moment at the state path ``path``."""
        if kind != "moment":
            return self.param_spec
        for slot, spec in self.slot_specs.items():
            if path_str(path).startswith(slot + "/"):
                return spec
        return self.moment_spec

    @property
    def resharded(self) -> bool:
        """Stored apart from how it is computed: gathered at its use."""
        return self.splits(self.param_spec) != self.splits(self.compute_spec)

    @property
    def apart(self) -> bool:
        """Moments stored apart from the parameter: updated in their
        placement (:meth:`~dct_tpu_torch.train.state.TrainState.
        update_params`)."""
        return self.splits(self.moment_spec) != self.splits(self.param_spec)

    @property
    def zero1(self) -> bool:
        """ZeRO-1's placement: moments split over ``data`` on the leading
        dim where the parameter is replicated."""
        return (self.apart and not self.splits(self.param_spec)
                and self.splits(self.moment_spec) == [(0, "data")])

    def tdim(self, d: int) -> int:
        """Flax dim ``d`` in torch layout (a dense kernel's last two dims
        are swapped)."""
        n = len(self.shape)
        if self.transposed and n >= 2 and d >= n - 2:
            return 2 * n - 3 - d
        return d

    def block_shape(self, spec) -> tuple:
        out = list(self.shape)
        for d, a in self.splits(spec):
            out[d] //= self.mesh.shape[a]
        return tuple(out)

    def offsets(self, spec) -> tuple:
        """Global start offsets (flax layout) of this process's block
        under ``spec``."""
        blk = self.block_shape(spec)
        off = [0] * len(self.shape)
        for d, a in self.splits(spec):
            off[d] = self.mesh.axis_index(a) * blk[d]
        return tuple(off)

    def local(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This process's block under ``spec`` of a full torch-layout
        tensor (a view)."""
        blk, off = self.block_shape(spec), self.offsets(spec)
        for d, _ in self.splits(spec):
            t = t.narrow(self.tdim(d), off[d], blk[d])
        return t


class StateLayout:
    """The placement of a model's parameters and moments on a mesh
    (:func:`shard_state_with_rules`): one :class:`Leaf` per parameter."""

    def __init__(self, mesh, leaves: list[Leaf]):
        self.mesh, self.leaves = mesh, leaves

    @property
    def sharded(self) -> bool:
        return any(lf.splits(lf.param_spec) or lf.splits(lf.moment_spec)
                   for lf in self.leaves)

    def resharded(self) -> list[int]:
        """Parameters stored apart from how they are computed."""
        return [i for i, lf in enumerate(self.leaves) if lf.resharded]

    def zero1(self) -> list[int]:
        """Parameters whose moments alone split over ``data`` (ZeRO-1)."""
        return [i for i, lf in enumerate(self.leaves) if lf.zero1]

    def apart(self) -> list[int]:
        """Parameters whose moments are stored apart otherwise."""
        return [i for i, lf in enumerate(self.leaves)
                if lf.apart and not lf.zero1]


def _unit_error(name, spec, clause, why) -> ValueError:
    where = (f"DCT_SHARD_RULES clause {clause!r}" if clause
             else "the family rule table")
    return ValueError(f"{where} asks for {spec_to_json(spec)} on {name}: "
                      f"{why}")


def _check_spec(name, shape, spec, clause, mesh) -> None:
    """The two placements the port refuses (module docstring)."""
    named = [a for a in spec if a is not None]
    if len(spec) > len(shape) or len(set(named)) != len(named):
        raise _unit_error(name, spec, clause, f"a leaf of shape "
                          f"{tuple(shape)} cannot take it (longer than its "
                          "rank, or one axis on two dims)")
    for d, a in enumerate(spec):
        # The family tables' units check their own sizes, naming them.
        if clause and a is not None and shape[d] % mesh.shape[a]:
            raise _unit_error(name, spec, clause, f"dim {d} ({shape[d]}) "
                              f"does not divide over {a}={mesh.shape[a]}")


def _leaf_specs(key: str, ndim: int, moment_paths, family):
    """(param spec, its clause, ``[(moment path, spec, clause)]`` for
    each moment mirror) of the leaf at flax ``key``: each resolved on its
    own path, as the reference matches every ``opt_state`` path."""
    pname = path_str(("params", "params", *key.split("/")))
    pspec, pclause = _resolve(pname, family, ndim)
    moments = []
    for prefix in moment_paths:
        name = path_str(prefix + ("params", *key.split("/")))
        moments.append((path_str(prefix), *_resolve(name, family, ndim)))
    return pspec, pclause, moments


def split_units(model: nn.Module, mesh, spec_of) -> dict:
    """Split the tensor-parallel units of ``model`` over ``model``: a unit
    computes its table's slice when the model axis has more than one
    process and ``spec_of(key)`` (a leaf's stored spec) puts any of its
    leaves on ``model``, else it stays whole. Returns ``{flax key: the
    table spec}`` of every leaf of a split unit."""
    m = mesh.shape["model"]
    shard = mesh.model_shard()
    pipe = mesh.pipe_shard()
    for mod in model.modules():
        if hasattr(mod, "split_pipe_axis"):
            mod.split_pipe_axis(pipe)
    out = {}
    for prefix, mod in model.named_modules():
        want = getattr(mod, "tp_leaves", None)
        if want is None:
            continue
        base = prefix.replace(".", "/")
        keys = {f"{base}/{rel}" if base else rel: spec
                for rel, spec in want.items()}
        split = m > 1 and any("model" in spec_of(k) for k in keys)
        mod.shard_model_axis(shard, split=split)
        if split:
            out.update(keys)
    # A pipeline stage's leaves compute with this rank's stage.
    return {k: (P("pipe", *spec) if k.startswith("pp_stages/") else spec)
            for k, spec in out.items()}


def shard_state_with_rules(state, mesh, *, shard_opt: bool = False,
                           shard_params: bool = False,
                           family: str | None = None):
    """Place a fresh train state on ``mesh`` by the rules (module
    docstring): split the tensor-parallel units of the model over
    ``model``, keep each resharded parameter as its stored block (the
    module's parameter emptied, its unit gathering it at use), and set up
    the optimizer state over what each process updates. Returns the
    state, its :class:`StateLayout` in ``state.layout`` (and
    ``state.model.dct_layout``)."""
    from dct_tpu_torch.checkpoint.manager import _param_order
    from dct_tpu_torch.convert import flax_names
    from dct_tpu_torch.parallel import reshard

    model = state.model
    names = flax_names(model)
    shapes = _global_shapes(model)
    moment_paths = [path for kind, path, _ in
                    opt_slots(state.tx, state.opt_state)
                    if kind == "moments"]
    if not moment_paths:
        moment_paths = [("opt_state",)]
    key_of = {i: key for i, key, _ in _param_order(model)}
    # The full tensors, before any unit keeps its slice.
    full = [p.detach() for p in model.parameters()]
    leaves: list[Leaf] = []
    for i, name in enumerate(n for n, _ in model.named_parameters()):
        key, shape = key_of[i], tuple(shapes[i])
        pspec, pc, moments = _leaf_specs(key, len(shape), moment_paths,
                                         family)
        ds = _data_shard_spec(shape, mesh)
        _check_spec(key, shape, pspec, pc, mesh)
        if ds is not None and pspec == P() and shard_params:
            pspec = ds
        specs = []
        for path, mspec, mc in moments:
            _check_spec(key, shape, mspec, mc, mesh)
            if ds is not None and mspec == P() and (shard_opt
                                                    or shard_params):
                mspec = ds
            specs.append((path, mspec))
        lf = Leaf(name=name, key=key, transposed=names[name][1],
                  shape=shape, param_spec=pspec, moment_spec=specs[0][1],
                  compute_spec=(P("pipe") if key.startswith("pp_stages/")
                                else P()), mesh=mesh)
        lf.slot_specs = {path: spec for path, spec in specs[1:]
                         if lf.splits(spec) != lf.splits(lf.moment_spec)}
        leaves.append(lf)
    by_key = {lf.key: lf for lf in leaves}
    for key, spec in split_units(
            model, mesh, lambda k: by_key[k].param_spec).items():
        by_key[key].compute_spec = spec

    layout = StateLayout(mesh, leaves)
    model.dct_layout = layout
    state.layout = layout
    state.place_params(full)
    # The update space, from the full tensors; the moments stored apart
    # from it keep their own blocks.
    state.opt_state = state.tx.init([
        lf.local(full[i], lf.moment_spec) if lf.apart
        else state.stored_param(i) for i, lf in enumerate(leaves)])
    state.store_moments()
    reshard.install_units(state)
    return state


def place_for_inference(model: nn.Module, mesh, family: str | None = None):
    """Split ``model``'s tensor-parallel units over ``mesh``'s model axis
    by the rules, as a trained state's compute placement
    (:func:`shard_state_with_rules`), for a forward that needs no stored
    placement: the scoring engines on a world. Returns the model."""
    from dct_tpu_torch.convert import flax_names

    names = flax_names(model)
    spec = {names[n][0]: _resolve(
        path_str(("params", "params", *names[n][0].split("/"))), family,
        p.ndim)[0] for n, p in model.named_parameters()}
    split_units(model, mesh, spec.__getitem__)
    return model


# ------------------------------------------------------------- gather


def flax_layout(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A torch-layout tensor in flax layout (dense kernels ``[in, out]``,
    behind a stage dim for a stage-stacked one), and back: the swap is
    its own inverse."""
    return t.transpose(-1, -2) if transposed and t.ndim >= 2 else t


def gather_leaf(t: torch.Tensor, leaf: Leaf | None = None,
                spec=()) -> np.ndarray:
    """One stored block (torch layout) -> the dense flax-layout host
    array. A leaf that ``spec`` splits across processes is all-gathered
    over the group of each axis that splits it: a collective every
    process of those groups runs."""
    from dct_tpu_torch.parallel.reshard import all_gather_dims

    a = t.detach().float()
    if leaf is not None:
        for d, axis in leaf.splits(spec):
            (a,) = all_gather_dims([a], [leaf.tdim(d)], leaf.mesh, axis)
    transposed = leaf is not None and leaf.transposed
    return np.array(flax_layout(a, transposed).cpu().numpy(), order="C")


def gather_tree(state) -> dict:
    """The train state's parameters as ``{"params": <nested flax tree>}``
    of dense f32 host arrays, however they are placed (the publish
    contract: a deploy checkpoint or a package never holds one shard).
    A collective when any parameter is split: every process calls it."""
    layout = getattr(state, "layout", None)
    model = state.model
    from dct_tpu_torch.convert import flax_names, swap_layout

    names = flax_names(model)
    tree: dict = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        if layout is None:
            value = swap_layout(gather_leaf(p, None), names[name][1])
            key = names[name][0]
        else:
            lf = layout.leaves[i]
            stored = state.stored_param(i)
            value = gather_leaf(stored, lf, lf.param_spec)
            key = lf.key
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = np.ascontiguousarray(value, np.float32)
    return {"params": tree}


def respec(t: torch.Tensor, leaf: Leaf, src, dst) -> torch.Tensor:
    """This process's block under ``dst`` of the leaf whose block under
    ``src`` is ``t`` (torch layout): all-gathered over each axis ``src``
    splits (a collective of that axis's group), then narrowed."""
    from dct_tpu_torch.parallel.reshard import all_gather_dims

    for d, axis in leaf.splits(src):
        (t,) = all_gather_dims([t], [leaf.tdim(d)], leaf.mesh, axis)
    return leaf.local(t, dst).contiguous()


def make_shard_and_gather_fns(layout: StateLayout, *, moments=False):
    """(shard_fns, gather_fns), one pair per parameter (``moments``: of
    its optimizer moments): ``shard_fn(dense flax array)`` -> the torch
    tensor this process stores; ``gather_fn(stored tensor)`` -> the dense
    flax host array (a collective when the leaf is split)."""

    def pair(lf: Leaf):
        spec = lf.moment_spec if moments else lf.param_spec

        def shard_fn(a):
            t = flax_layout(torch.as_tensor(np.asarray(a, np.float32)),
                            lf.transposed)
            return lf.local(t, spec).contiguous()

        def gather_fn(t):
            return gather_leaf(t, lf, spec)

        return shard_fn, gather_fn

    pairs = [pair(lf) for lf in layout.leaves]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# ------------------------------------------------------- introspection


def spec_to_json(spec) -> list:
    """A spec -> JSON-able per-dim axis list (nested tuples, several axes
    on one dim, become lists)."""
    out = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def leaf_spec(state, path: str):
    """The spec a train-state leaf (by its reference path) is placed
    with, from ``state.layout``; ``()`` for an unplaced state."""
    layout = getattr(state, "layout", None)
    for kind, lpath, i in state_leaf_paths(state):
        if path_str(lpath) != path:
            continue
        if i is None or layout is None:
            return P()
        return layout.leaves[i].stored_spec(kind, lpath)
    raise KeyError(path)


def layout_mismatches(state, declared: dict) -> list[dict]:
    """Where the state's placement differs from a declared ``{path:
    spec}`` layout (:func:`state_shardings`): ``[{path, actual,
    declared}]``, trailing Nones ignored. The port's placement is
    explicit, so a fresh state matches its own declaration; the check
    stands where the reference reconciles its step's drift."""

    def norm(s):
        dims = list(tuple(s))
        while dims and dims[-1] is None:
            dims.pop()
        return tuple(dims)

    out = []
    for kind, lpath, _ in state_leaf_paths(state):
        name = path_str(lpath)
        if name not in declared:
            continue
        actual = leaf_spec(state, name)
        if norm(actual) != norm(declared[name]):
            out.append({"path": name, "actual": spec_to_json(actual),
                        "declared": spec_to_json(declared[name])})
    return out


# ------------------------------------------------------------ dtype rules

#: Accepted dtype tokens (right-hand side of a clause) -> canonical name.
DTYPE_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "float16": "float16",
    "f32": "float32", "float32": "float32",
}


def parse_dtype_rules(text: str):
    """``DCT_DTYPE_RULES`` grammar -> tuple of (regex, dtype name).
    Malformed specs raise ``ValueError`` naming the offending clause."""
    rules = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"DCT_DTYPE_RULES clause {clause!r} has no '=': expected "
                "pattern=dtype"
            )
        pattern, _, dname = clause.rpartition("=")
        pattern = pattern.strip()
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"DCT_DTYPE_RULES pattern {pattern!r} is not a valid "
                f"regex: {e}"
            ) from e
        canonical = DTYPE_ALIASES.get(dname.strip().lower())
        if canonical is None:
            raise ValueError(
                f"DCT_DTYPE_RULES clause {clause!r}: unknown dtype "
                f"{dname.strip()!r} (valid: "
                f"{', '.join(sorted(set(DTYPE_ALIASES)))})"
            )
        rules.append((pattern, canonical))
    return tuple(rules)


def dtype_rules():
    """The active ``DCT_DTYPE_RULES`` table (empty tuple when unset)."""
    return parse_dtype_rules(os.environ.get("DCT_DTYPE_RULES", ""))


def cast_params_by_rules(model: nn.Module) -> dict[str, torch.Tensor] | None:
    """Torch parameter name -> the parameter cast to its rule's dtype
    (first match wins; unmatched parameters pass as they are), for
    ``torch.func.functional_call``; ``None`` when no rules are set. The
    casts are differentiable, so gradients reach the f32 masters."""
    from dct_tpu_torch.convert import flax_names

    if not dtype_rules():
        return None
    names = flax_names(model)
    out = {}
    for name, p in model.named_parameters():
        dtype = rule_dtype(names[name][0])
        out[name] = p if dtype is None else p.to(dtype)
    return out


def rule_dtype(key: str):
    """The ``DCT_DTYPE_RULES`` dtype of the parameter at flax ``key``
    (first match wins), or None."""
    path = "params/" + key
    for pattern, dname in dtype_rules():
        if re.search(pattern, path):
            return getattr(torch, dname)
    return None


def dtype_rules_digest() -> str:
    """Content digest of the active dtype rules, recorded in the resume
    tier's layout manifest (``"off"`` when no rules are set), as the
    reference's ``dtype_rules_digest``."""
    rules = dtype_rules()
    if not rules:
        return "off"
    blob = "|".join(f"{pat}={dname}" for pat, dname in rules)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]
