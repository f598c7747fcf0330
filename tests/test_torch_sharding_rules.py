"""The port's partition rules and process grid against the JAX package's
(CPU, no processes).

The grammar and its errors, the digest, and the spec of every state leaf
of each family (parameters and their optimizer moments, ZeRO-1 and FSDP
included) equal the reference's ``parse_rules``, ``rules_digest``,
``match_partition_rules`` and ``state_shardings`` on a ``data=4,
model=2`` mesh of the 8 virtual CPU devices; so do the data-axis
decisions of ``_data_shard_spec`` and the grid's errors. The placements
the port computes itself (tensor-parallel slices; rule layouts outside
the family tables, stored apart from how they are computed, with the
reference's specs on a ``data=2, model=2, seq=2`` mesh, moments stored
apart from their parameter among them; the refusals of a ``pipe`` clause
and of a dim its axis does not divide) are pinned too.
"""

import jax
import numpy as np
import pytest

from dct_tpu.config import MeshConfig as JaxMeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.config import TrainConfig as JaxTrainConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.parallel import mesh as jax_mesh
from dct_tpu.parallel import sharding_rules as ref
from dct_tpu.train.state import create_train_state as jax_state
from dct_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.parallel import mesh as port_mesh
from dct_tpu_torch.parallel import sharding_rules as port
from dct_tpu_torch.parallel.mesh import ProcessMesh
from dct_tpu_torch.train.state import create_train_state
from torch_threads import one_torch_thread  # noqa: F401

F_IN = 5
FAMILIES = {
    "weather_mlp": dict(hidden_dim=64),
    "weather_transformer": dict(seq_len=8, d_model=16, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=32),
    "weather_transformer_causal": dict(seq_len=8, d_model=16, n_heads=2,
                                       n_layers=1, d_ff=32, horizon=2),
    "weather_gru": dict(seq_len=8, hidden_dim=16, n_layers=2),
    "weather_moe": dict(seq_len=8, d_model=16, n_heads=2, n_layers=1,
                        d_ff=32, n_experts=4),
}
OPTIMIZERS = [dict(optimizer="adam"),
              dict(optimizer="sgd", momentum=0.9, grad_clip_norm=1.0)]
FLAGS = [dict(), dict(shard_opt=True), dict(shard_params=True)]


def _spec(s) -> tuple:
    return tuple(s)


@pytest.mark.parametrize("text", [
    ".*dense.*/kernel$=-,model; head/bias$=data ;x$=",
    "qkv_proj.*/kernel$=;experts_.*=model,-,-",
    "a=none,None,seq,pipe",
    "",
])
def test_parse_rules_matches_the_reference(text):
    assert [(p, _spec(s)) for p, s in port.parse_rules(text)] == [
        (p, _spec(s)) for p, s in ref.parse_rules(text)]


@pytest.mark.parametrize("bad", ["no-equals-clause", "a=(model",
                                 "k$=model,upside"])
def test_parse_rules_errors_word_for_word(bad):
    with pytest.raises(ValueError) as theirs:
        ref.parse_rules(bad)
    with pytest.raises(ValueError) as ours:
        port.parse_rules(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("env", [None, "qkv_proj.*/kernel$=;head=data"])
@pytest.mark.parametrize("family", [None, "weather_transformer",
                                    "weather_moe"])
def test_rules_digest_and_table_match(monkeypatch, env, family):
    if env is None:
        monkeypatch.delenv("DCT_SHARD_RULES", raising=False)
    else:
        monkeypatch.setenv("DCT_SHARD_RULES", env)
    assert port.rules_digest(family) == ref.rules_digest(family)
    assert [(p, _spec(s)) for p, s in port.rules_for_family(family)] == [
        (p, _spec(s)) for p, s in ref.rules_for_family(family)]


def _pair(family, opt, input_dim=F_IN):
    fields = dict(FAMILIES[family], name=family)
    seq = family != "weather_mlp"
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=input_dim)
    jst = jax_state(jmodel, input_dim=input_dim, lr=1e-3, seed=0,
                    example_shape=(1, fields["seq_len"], input_dim) if seq
                    else None, **opt)
    model = get_model(ModelConfig(**fields), input_dim=input_dim,
                      device="cpu")
    pst = create_train_state(model, input_dim=input_dim, lr=1e-3, seed=0,
                             **opt)
    return jst, pst


def _ref_specs(shardings) -> dict:
    return {ref.path_str(path): _spec(getattr(s, "spec", s)) for path, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


@pytest.mark.parametrize("flags", FLAGS, ids=["plain", "zero1", "fsdp"])
@pytest.mark.parametrize("opt", OPTIMIZERS, ids=["adam", "sgd_clip"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_shardings_match_the_reference_on_data4_model2(family, opt,
                                                             flags):
    jst, pst = _pair(family, opt)
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=4, model=2))
    theirs = _ref_specs(ref.state_shardings(jst, mesh, family=family,
                                            **flags))
    ours = port.state_shardings(pst, ProcessMesh(4, 2, rank=0, world=8),
                                family=family, **flags)
    assert {k: _spec(v) for k, v in ours.items()} == theirs


@pytest.mark.parametrize("family", ["weather_transformer", "weather_moe"])
def test_match_partition_rules_over_the_param_tree(family):
    jst, pst = _pair(family, OPTIMIZERS[0])
    theirs = _ref_specs(ref.match_partition_rules(
        ref.rules_for_family(family), {"params": jst.params}))
    from dct_tpu_torch.checkpoint.manager import param_tree

    tree = {"params": param_tree(pst.model)}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[port.path_str(path)] = _spec(node)

    walk(port.match_partition_rules(port.rules_for_family(family), tree),
         ())
    assert flat == theirs


@pytest.mark.parametrize("shape", [(5,), (64,), (8, 3), (3, 8), (4,), (2,),
                                   (4, 4, 2), ()])
def test_data_shard_spec_decisions(shape):
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=4, model=2))
    theirs = ref._data_shard_spec(np.zeros(shape), mesh)
    ours = port._data_shard_spec(shape, ProcessMesh(4, 2, rank=0, world=8))
    assert (None if theirs is None else _spec(theirs)) == ours


def test_layout_mismatches_names_the_drifted_leaf():
    _, pst = _pair("weather_transformer", OPTIMIZERS[0])
    mesh = ProcessMesh(1, 2, rank=0, world=2)
    port.shard_state_with_rules(pst, mesh, family="weather_transformer")
    declared = port.state_shardings(pst, mesh, family="weather_transformer")
    assert port.layout_mismatches(pst, declared) == []
    path = "params/params/block_0/attn/qkv_proj/kernel"
    assert _spec(declared[path]) == (None, "model")
    declared[path] = ()
    assert port.layout_mismatches(pst, declared) == [
        {"path": path, "actual": [None, "model"], "declared": []}]


def test_tensor_parallel_placement_slices_whole_groups():
    _, pst = _pair("weather_transformer", OPTIMIZERS[0])
    full = {n: p.detach().clone() for n, p in
            pst.model.named_parameters()}
    port.shard_state_with_rules(pst, ProcessMesh(1, 2, rank=1, world=2),
                                family="weather_transformer")
    attn = pst.model.block_0.attn
    assert attn.local == (2, 1, 8)
    params = dict(pst.model.named_parameters())
    # Rank 1 of 2: the second KV group's rows of qkv (its 2 q heads, k
    # and v), the second half of o_proj's and ffn_out's input columns.
    torch_eq = np.testing.assert_array_equal
    for name, want in (
            ("block_0.attn.qkv_proj.weight",
             full["block_0.attn.qkv_proj.weight"][16:]),
            ("block_0.attn.o_proj.weight",
             full["block_0.attn.o_proj.weight"][:, 8:]),
            ("block_0.ffn_in.bias", full["block_0.ffn_in.bias"][16:]),
            ("block_0.ffn_out.bias", full["block_0.ffn_out.bias"])):
        torch_eq(params[name].detach().numpy(), want.numpy())
    lf = pst.layout.leaves[list(params).index(
        "block_0.attn.qkv_proj.weight")]
    assert (lf.shape, lf.splits(lf.param_spec), lf.offsets(lf.param_spec)
            ) == ((16, 32), [(1, "model")], (0, 16))
    # The Adam moments follow the slices.
    assert pst.opt_state[0]["mu"][list(params).index(
        "block_0.attn.qkv_proj.weight")].shape == (16, 16)


@pytest.mark.parametrize("rules,name,stored,compute", [
    # A unit split in part: the qkv kernel stored whole, computed as its
    # tensor-parallel slice.
    ("qkv_proj.*/kernel$=", "block_0.attn.qkv_proj.weight", (),
     (None, "model")),
    # A leaf on model outside the tables, computed whole.
    ("head/kernel$=-,model", "head.weight", (None, "model"), ()),
    # A seq placement, computed whole.
    ("in_proj/kernel$=seq", "in_proj.weight", ("seq",), ()),
], ids=["unit_in_part", "head_on_model", "in_proj_on_seq"])
def test_rule_layouts_outside_the_tables_match_the_reference(
        monkeypatch, rules, name, stored, compute):
    monkeypatch.setenv("DCT_SHARD_RULES", rules)
    jst, pst = _pair("weather_transformer", OPTIMIZERS[0], input_dim=6)
    jmesh = jax_mesh.make_mesh(JaxMeshConfig(data=2, model=2, seq=2))
    theirs = _ref_specs(ref.state_shardings(jst, jmesh,
                                            family="weather_transformer"))
    mesh = ProcessMesh(2, 2, 2, rank=5, world=8)
    port.shard_state_with_rules(pst, mesh, family="weather_transformer")
    declared = port.state_shardings(pst, mesh, family="weather_transformer")
    assert {k: _spec(v) for k, v in declared.items()} == theirs
    assert port.layout_mismatches(pst, theirs) == []
    names = [n for n, _ in pst.model.named_parameters()]
    i = names.index(name)
    lf = pst.layout.leaves[i]
    assert (lf.param_spec, lf.moment_spec, lf.compute_spec) == (
        stored, stored, compute)
    assert lf.resharded
    # The process stores its block alone (torch layout); the module's
    # parameter is empty until its unit gathers it.
    block = lf.block_shape(stored)
    want = block[::-1] if lf.transposed else block
    assert tuple(pst.stored_param(i).shape) == tuple(want)
    assert pst.params[i].numel() == 0
    assert pst.model.block_0.attn.local == (2, 1, 8)


@pytest.mark.parametrize("rules,name,stored,moments", [
    # Moments split over data on a dim ZeRO-1 does not take.
    ("(mu|nu)/params/block_0/ffn_in/kernel$=-,data",
     "block_0.ffn_in.weight", (None, "model"), (None, "data")),
    # A parameter on data (computed whole), its moments replicated.
    ("(mu|nu)/params/block_1/ffn_out/kernel$=;block_1/ffn_out/kernel$=data",
     "block_1.ffn_out.weight", ("data",), ()),
    # A parameter on model, its moments over seq as well.
    ("(mu|nu)/params/head/kernel$=seq,model;head/kernel$=-,model",
     "head.weight", (None, "model"), ("seq", "model")),
], ids=["moments_on_dim1", "param_on_data", "moments_on_seq"])
def test_moments_stored_apart_match_the_reference(monkeypatch, rules, name,
                                                  stored, moments):
    monkeypatch.setenv("DCT_SHARD_RULES", rules)
    jst, pst = _pair("weather_transformer", OPTIMIZERS[0], input_dim=6)
    jmesh = jax_mesh.make_mesh(JaxMeshConfig(data=2, model=2, seq=2))
    theirs = _ref_specs(ref.state_shardings(jst, jmesh,
                                            family="weather_transformer"))
    mesh = ProcessMesh(2, 2, 2, rank=5, world=8)
    port.shard_state_with_rules(pst, mesh, family="weather_transformer")
    declared = port.state_shardings(pst, mesh, family="weather_transformer")
    assert {k: _spec(v) for k, v in declared.items()} == theirs
    names = [n for n, _ in pst.model.named_parameters()]
    i = names.index(name)
    lf = pst.layout.leaves[i]
    assert (lf.param_spec, lf.moment_spec) == (stored, moments)
    assert lf.apart and not lf.zero1 and pst.layout.apart() == [i]
    # The moments hold the moments' block (torch layout).
    block = lf.block_shape(moments)
    want = block[::-1] if lf.transposed else block
    assert tuple(pst.opt_state[0]["mu"][i].shape) == tuple(want)


@pytest.mark.parametrize("rules,match", [
    ("in_proj/kernel$=pipe", "dim 0 \\(5\\) does not divide over pipe=2"),
    ("in_proj/kernel$=data", "dim 0 \\(5\\) does not divide over data=2"),
], ids=["pipe", "indivisible"])
def test_a_pipe_clause_and_an_indivisible_dim_raise_naming_the_clause(
        monkeypatch, rules, match):
    """A clause may name ``pipe`` (the pipe axis is ported), and one whose
    dim does not divide over its axis raises naming the clause."""
    monkeypatch.setenv("DCT_SHARD_RULES", rules)
    _, pst = _pair("weather_transformer", OPTIMIZERS[0])
    with pytest.raises(ValueError, match=match) as e:
        port.shard_state_with_rules(
            pst, ProcessMesh(2, 1, 1, 2, rank=0, world=4),
            family="weather_transformer")
    assert e.match(rules.replace("$", "\\$"))


def test_rules_replicating_every_unit_and_a_data_leading_rule(monkeypatch):
    monkeypatch.setenv("DCT_SHARD_RULES",
                       "(qkv_proj|o_proj|ffn_in|ffn_out).*=;head/kernel$=data")
    _, pst = _pair("weather_transformer", OPTIMIZERS[0])
    port.shard_state_with_rules(pst, ProcessMesh(2, 2, rank=3, world=4),
                                family="weather_transformer")
    assert pst.model.block_0.attn.local == (4, 2, 16)
    names = [n for n, _ in pst.model.named_parameters()]
    lf = pst.layout.leaves[names.index("head.weight")]
    assert (lf.axes(lf.param_spec), lf.axes(lf.moment_spec),
            lf.offsets(lf.param_spec)) == (("data",), ("data",), (8, 0))
    assert pst.stored_param(names.index("head.weight")).shape == (2, 8)


@pytest.mark.parametrize("family,fields,match", [
    ("weather_transformer", dict(n_heads=4, n_kv_heads=1), "n_kv_heads=1"),
    ("weather_transformer", dict(d_ff=33), "d_ff \\(33\\)"),
    ("weather_moe", dict(n_experts=3), "n_experts \\(3\\)"),
])
def test_sizes_that_do_not_split_raise_naming_them(family, fields, match):
    cfg = dict(FAMILIES[family], name=family, **fields)
    model = get_model(ModelConfig(**cfg), input_dim=F_IN, device="cpu")
    pst = create_train_state(model, input_dim=F_IN, lr=1e-3, seed=0)
    with pytest.raises(ValueError, match=match):
        port.shard_state_with_rules(pst, ProcessMesh(1, 2, rank=0, world=2),
                                    family=family)


@pytest.mark.parametrize("cfg", [dict(data=-1, model=-1), dict(data=3),
                                 dict(data=4, model=4), dict(data=2),
                                 dict(data=-1, model=3)])
def test_grid_errors_match_the_reference(cfg):
    with pytest.raises(ValueError) as theirs:
        jax_mesh.make_mesh(JaxMeshConfig(**cfg))
    with pytest.raises(ValueError) as ours:
        port_mesh.resolve_sizes(MeshConfig(**cfg), 8)
    if "covers" in str(theirs.value):  # the subset escape is the reference's
        assert "covers" in str(ours.value)
    else:
        assert str(ours.value) == str(theirs.value)


def test_grid_places_processes_in_enumeration_order():
    sizes = port_mesh.resolve_sizes(MeshConfig(data=-1, model=2), 8)
    assert sizes == {"data": 4, "model": 2, "seq": 1, "pipe": 1}
    grid = jax_mesh.make_mesh(JaxMeshConfig(data=4, model=2)).devices
    for p in range(8):
        m = ProcessMesh(4, 2, rank=p, world=8)
        row, col = np.argwhere(grid[..., 0, 0] == jax.devices()[p])[0]
        assert (m.data_index, m.model_index) == (row, col)


@pytest.mark.parametrize("axis,item", [("SEQ", 16), ("PIPE", 17)])
def test_seq_and_pipe_axes_raise_naming_their_items(monkeypatch, axis, item):
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train_job import refuse_unported_env

    monkeypatch.setattr(port_mesh, "process_count", lambda: 2)
    cfg = MeshConfig(data=1, **{axis.lower(): 2})
    if axis == "SEQ":
        # Items 16 and 16b ported the seq axis: the job and the grid take
        # it, and both families that item 16b refused build on it (the
        # MoE's attention the axis's engine, its routing over data x seq;
        # the GRU replicated). What the seq axis still cannot run on the
        # card (a ragged shard) names item 16b.
        from dct_tpu_torch.ops.attention import (
            SequenceParallelAttention,
            ring_flash,
        )

        refuse_unported_env({"DCT_MESH_SEQ": "2"})
        mesh = port_mesh.make_mesh(cfg)
        assert mesh.shape["seq"] == 2 and mesh.seq_shard().size == 2
        moe = get_model(ModelConfig(name="weather_moe", seq_len=8),
                        input_dim=5, device="cpu", mesh=mesh)
        assert isinstance(moe.seq_parallel, SequenceParallelAttention)
        assert all(b.moe.seq_size == 2 for b in moe.blocks())
        gru = get_model(ModelConfig(name="weather_gru", seq_len=8),
                        input_dim=5, device="cpu", mesh=mesh)
        assert gru.seq_len == 8
        with pytest.raises(ValueError, match=f"item {item}b"):
            ring_flash(192, striped=False, window=None, device="cuda")
    else:
        # Item 17a ported the pipe axis: the job and the grid take it, and
        # the pipeline family builds on it, a stage a rank once placed.
        refuse_unported_env({"DCT_MESH_PIPE": "2"})
        mesh = port_mesh.make_mesh(cfg)
        assert mesh.shape["pipe"] == 2 and mesh.pipe_shard().size == 2
        pp = get_model(ModelConfig(name="weather_transformer_pp",
                                   seq_len=8, n_layers=2, n_stages=2),
                       input_dim=5, device="cpu", mesh=mesh)
        port.split_units(pp, mesh, lambda key: ())
        assert pp.pp_stages.pipe.index == mesh.pipe_index
        assert pp.pp_stages.block_0.ffn_in.weight.shape[0] == 1
    # The model axis and the shard knobs are no longer refused.
    refuse_unported_env({"DCT_MESH_MODEL": "2", "DCT_SHARD_OPT_STATE": "1",
                         "DCT_SHARD_PARAMS": "1",
                         "DCT_SHARD_RULES": "x=model"})


def test_config_matches_the_reference(monkeypatch):
    for k, v in (("DCT_MESH_DATA", "2"), ("DCT_MESH_MODEL", "4"),
                 ("DCT_SHARD_OPT_STATE", "1"), ("DCT_SHARD_PARAMS", "true")):
        monkeypatch.setenv(k, v)
    assert vars(MeshConfig.from_env()) == vars(JaxMeshConfig.from_env())
    ours, theirs = TrainConfig.from_env(), JaxTrainConfig.from_env()
    assert (ours.shard_opt_state, ours.shard_params) == (
        theirs.shard_opt_state, theirs.shard_params) == (True, True)


def test_loop_forwards_the_mesh_and_shard_knobs_to_its_ranks(tmp_path,
                                                              monkeypatch):
    """A supervised round's ranks rebuild the loop's grid and layout: the
    env the launcher receives carries ``DCT_MESH_*`` and ``DCT_SHARD_*``
    from the loop's RunConfig, as the reference's loop's does."""
    import dct_tpu_torch.launch.launcher as launcher_mod
    from dct_tpu_torch.config import (
        DataConfig,
        LoopConfig,
        RunConfig,
        TrainConfig,
    )
    from dct_tpu_torch.continuous.loop import AlwaysOnLoop

    captured = {}

    class FakeLauncher:
        def __init__(self, **kw):
            pass

        def supervise(self, cmd, *, world_size, env, **kw):
            captured.update(env)

            class R:
                success, classification, restarts = True, "clean", 0
                attempts = []
            return R()

    monkeypatch.setattr(launcher_mod, "LocalProcessLauncher", FakeLauncher)
    monkeypatch.setenv("DCT_SHARD_RULES", "qkv_proj.*/kernel$=")
    cfg = RunConfig(
        data=DataConfig(processed_dir=str(tmp_path / "proc"),
                        models_dir=str(tmp_path / "models"),
                        raw_csv=str(tmp_path / "raw.csv")),
        train=TrainConfig(shard_opt_state=True),
        mesh=MeshConfig(data=2, model=2),
        loop=LoopConfig(train_mode="supervised",
                        packages_dir=str(tmp_path / "pkgs")),
    )
    loop = AlwaysOnLoop(cfg, device="cpu", client=object())
    loop._run_round_supervised()
    assert captured["DCT_MESH_DATA"] == "2"
    assert captured["DCT_MESH_MODEL"] == "2"
    assert captured["DCT_SHARD_OPT_STATE"] == "1"
    assert captured["DCT_SHARD_PARAMS"] == "0"
    assert captured["DCT_SHARD_RULES"] == "qkv_proj.*/kernel$="
