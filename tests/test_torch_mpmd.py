"""The MPMD pipeline of the port (``dct_tpu_torch.parallel.mpmd``,
``mpmd_transfer``, ``train.mpmd_trainer``, ``train.mpmd_worker``) held to
the JAX package's on the same numpy inputs, on the CPU:

- the stage-spec grammar and its refusals, message for message;
- the 1F1B and GPipe op lists for P in {2, 3, 4} and M in 1..8, and the
  analytic and measured bubbles, equal to the reference's;
- the state pivot: each stage's parameters equal the reference's
  ``split_params`` of the same init, and split then merge is bitwise for
  adam and sgd-momentum;
- the port's ``MpmdRunner`` against the reference's (its 8 virtual CPU
  devices) from one init with sgd-momentum: every step's loss within
  1e-5 over 6 steps, the eval sums within 1e-4 and the parameters after
  the steps within 1e-4, at the reference test's shape (T=8) and at T=256,
  where the flash path's plain version runs; gpipe equals 1f1b; the step
  report's phases;
- the transfer plane: f32 frames byte for byte the reference's, bf16
  through its uint16 view, a timeout and a torn frame raising, the links
  in either start order;
- the checkpoint pivots (MPMD -> SPMD by ``adopt_mpmd_checkpoint`` and by
  ``Trainer.fit``'s resume, SPMD -> MPMD by ``MpmdTrainer.fit``'s) bitwise,
  an untileable stage map refused, the optimizer-change and torn-set
  refusals;
- a two-process ``mpmd_worker`` world at ``1,1`` under the port's
  supervisor equal to the in-process ``MpmdTrainer`` within 1e-6 (train
  and val losses of both epochs).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.config import ModelConfig as RefModelConfig
from dct_tpu.config import MpmdConfig as RefMpmdConfig
from dct_tpu.config import RunConfig as RefRunConfig
from dct_tpu.parallel import mpmd as ref
from dct_tpu.parallel import mpmd_transfer as ref_transfer
from dct_tpu.train import mpmd_trainer as ref_mt
from dct_tpu_torch.config import ModelConfig, MpmdConfig, RunConfig
from dct_tpu_torch.convert import flax_weights, load_flax_weights
from dct_tpu_torch.parallel import mpmd, mpmd_transfer
from dct_tpu_torch.tracking.client import LocalTracking
from dct_tpu_torch.train import mpmd_trainer as mt
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(name="weather_transformer_pp", dropout=0.0, seq_len=8,
             d_model=16, n_heads=2, n_layers=2, d_ff=32, n_stages=2)
INPUT_DIM, BATCH, LR = 5, 8, 0.05
SGD = dict(optimizer="sgd", momentum=0.9)


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    """160 rows (15 train batches of 8 windows of 8 an epoch), processed by
    the port's ETL."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    root = tmp_path_factory.mktemp("mpmd_rows")
    csv = generate_weather_csv(str(root / "weather.csv"), rows=160, seed=7)
    preprocess_csv_to_parquet(csv, str(root / "processed"))
    return str(root / "processed")


def _cfgs(tmp=None, m=4, schedule="1f1b", **model):
    """(the port's RunConfig, the reference's) of one MPMD run."""
    out = []
    for run, mcfg, mpcfg in ((RunConfig, ModelConfig, MpmdConfig),
                             (RefRunConfig, RefModelConfig, RefMpmdConfig)):
        cfg = run()
        cfg.model = mcfg(**{**SMALL, **model})
        cfg.train.bf16_compute = False
        cfg.train.batch_size = BATCH
        cfg.train.lr = LR
        cfg.train.optimizer, cfg.train.momentum = SGD["optimizer"], \
            SGD["momentum"]
        cfg.mpmd = mpcfg(stages="1,1", microbatches=m, schedule=schedule)
        if tmp is not None:
            cfg.data.models_dir = str(tmp / "models")
        out.append(cfg)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


_REF_STATES: dict = {}


def _states(cfg, ref_cfg):
    """The reference's full state (its flax init, built once a model and
    optimizer; it is immutable) and a new port full state holding the
    same values."""
    key = (repr(ref_cfg.model), ref_cfg.train.optimizer,
           ref_cfg.train.momentum)
    if key not in _REF_STATES:
        ref_full = ref_mt.build_full_state(ref_cfg, INPUT_DIM,
                                           compute_dtype=jnp.float32)
        _REF_STATES[key] = (ref_full, _flat(
            jax.device_get(ref_full.params)["params"]))
    ref_full, flat = _REF_STATES[key]
    full = mt.build_full_state(cfg, INPUT_DIM)
    load_flax_weights(full.model, flat)
    return full, ref_full


def _port_runner(cfg, full):
    spec = cfg.mpmd.to_spec()
    devices = mpmd.carve_stage_meshes(spec.device_counts, device="cpu")
    fns = mt.build_stage_fns(cfg.model)
    return mpmd.MpmdRunner(
        spec, [mpmd.split_state(full, k, spec.n_stages)
               for k in range(spec.n_stages)],
        [mpmd.make_stage_programs(k, spec.n_stages, fns)
         for k in range(spec.n_stages)], devices)


def _ref_runner(cfg, full):
    spec = cfg.mpmd.to_spec(n_devices=jax.device_count())
    meshes = ref.carve_stage_meshes(spec.device_counts, model=1)
    fns = ref_mt.build_stage_fns(cfg.model, INPUT_DIM,
                                 compute_dtype=jnp.float32)
    return ref.MpmdRunner(
        spec, [ref_mt.shard_stage_state(ref.split_state(full, k, 2),
                                        meshes[k]) for k in range(2)],
        [ref.make_stage_programs(k, 2, fns) for k in range(2)], meshes)


def _batches(n, seq_len, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, seq_len, INPUT_DIM))
             .astype(np.float32),
             rng.integers(0, 2, BATCH).astype(np.int32),
             np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32))
            for _ in range(n)]


def _errors(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


# ----------------------------------------------------------------------
# Spec grammar, schedules, bubbles.


@pytest.mark.parametrize("text,n_devices", [
    ("2", 8), ("1,1", None), (" 2 , 1 , 1 ", None), ("4", None),
    ("", 8), ("two", 8), ("1", 8), ("0,1", 8), ("3", 8), ("4,4,4", 8),
    ("-1,2", None), ("5,", None),
])
def test_stage_spec_parses_and_refuses_as_the_reference(text, n_devices):
    got = _errors(mpmd.parse_stage_spec, text, n_devices=n_devices)
    want = _errors(ref.parse_stage_spec, text, n_devices=n_devices)
    assert got == want
    if want is None:
        assert (mpmd.parse_stage_spec(text, n_devices=n_devices)
                == ref.parse_stage_spec(text, n_devices=n_devices))


@pytest.mark.parametrize("knobs", [
    dict(stages="1,1", schedule="zigzag"),
    dict(stages="1,1,1", microbatches=2),
    dict(stages="1,1", transfer_timeout_s=0),
    dict(stages="1,1"),
    dict(stages="3", microbatches=5, schedule="GPipe", port_base=123),
])
def test_spec_from_the_knobs_equals_the_reference(knobs):
    got = _errors(MpmdConfig(**knobs).to_spec)
    want = _errors(RefMpmdConfig(**knobs).to_spec)
    assert got == want
    if want is None:
        assert (MpmdConfig(**knobs).to_spec().__dict__
                == RefMpmdConfig(**knobs).to_spec().__dict__)


def test_mpmd_config_reads_the_reference_knobs(monkeypatch):
    for k, v in (("DCT_MPMD_STAGES", "1,1,1"), ("DCT_MPMD_MICROBATCHES", "6"),
                 ("DCT_MPMD_SCHEDULE", " GPipe "),
                 ("DCT_MPMD_TRANSFER_TIMEOUT_S", "9.5"),
                 ("DCT_MPMD_PORT_BASE", "29700")):
        monkeypatch.setenv(k, v)
    assert (RunConfig.from_env().mpmd.__dict__
            == RefRunConfig.from_env().mpmd.__dict__)


@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_schedules_equal_the_reference(kind, p):
    for m in range(1, 9):
        got = [[(o.kind, o.mb, o.phase) for o in ops]
               for ops in mpmd.build_schedule(p, m, kind)]
        want = [[(o.kind, o.mb, o.phase) for o in ops]
                for ops in ref.build_schedule(p, m, kind)]
        assert got == want, (p, m)
    assert _errors(mpmd.build_schedule, p, 4, "zigzag") == _errors(
        ref.build_schedule, p, 4, "zigzag")


def test_bubbles_equal_the_reference():
    for p in (2, 3, 4):
        for m in range(1, 9):
            assert mpmd.analytic_bubble(p, m) == ref.analytic_bubble(p, m)
    for args in ((0.4, 0.7, 4, 8), (1.0, 1.5, 2, 4), (0.1, 0.05, 2, 4),
                 (2.0, 9.0, 1, 3)):
        assert mpmd.measured_bubble(*args) == ref.measured_bubble(*args)
    for bad in ((1.0, 2.0, 8, 8), (0.0, 1.0, 2, 4)):
        assert _errors(mpmd.measured_bubble, *bad) == _errors(
            ref.measured_bubble, *bad)


def test_stage_layers_and_the_untileable_refusals():
    for args in ((4, 2), (2, 3), (4, 1), (6, 3)):
        assert _errors(mpmd.stage_layers, *args) == _errors(
            ref.stage_layers, *args)
    cfg, ref_cfg = _cfgs()
    full, ref_full = _states(cfg, ref_cfg)
    got = _errors(mpmd.split_params, full.model, 0, 4)
    assert got == _errors(ref.split_params, ref_full.params, 0, 4)
    assert "untileable" in got[1]
    cfg.model = ModelConfig(name="weather_transformer", dropout=0.0,
                            seq_len=8, d_model=16, n_heads=2, n_layers=2,
                            d_ff=32)
    plain = mt.build_full_state(cfg, INPUT_DIM)
    assert "pipeline-parallel family" in _errors(
        mpmd.split_params, plain.model, 0, 2)[1]


def test_carve_takes_one_card_a_stage_and_names_item_17c():
    cpus = [torch.device("cpu")] * 4
    assert mpmd.carve_stage_meshes((1, 1, 1), cpus) == cpus[:3]
    assert mpmd.carve_stage_meshes((1, 1), device="cpu") == cpus[:2]
    with pytest.raises(mpmd.MpmdSpecError, match="need 3 devices, have 2"):
        mpmd.carve_stage_meshes((1, 1, 1), cpus[:2])
    for counts, model in (((2, 1), 1), ((1, 1), 2)):
        with pytest.raises(mpmd.MpmdSpecError, match="item 17c"):
            mpmd.carve_stage_meshes(counts, cpus, model=model)
        with pytest.raises(mpmd.MpmdSpecError, match="item 17c"):
            mpmd.carve_stage_meshes(counts, model=model, device="cpu")


def test_trainer_mode_refusals_equal_the_reference():
    for field, value in (("dropout", 0.2), ("name", "weather_mlp")):
        cfg, ref_cfg = _cfgs()
        setattr(cfg.model, field, value)
        setattr(ref_cfg.model, field, value)
        assert _errors(mt._validate_cfg, cfg) == _errors(
            ref_mt._validate_cfg, ref_cfg)
    for field, value in (("grad_clip_norm", 1.0), ("lr_schedule", "cosine"),
                         ("warmup_steps", 3)):
        cfg, ref_cfg = _cfgs()
        setattr(cfg.train, field, value)
        setattr(ref_cfg.train, field, value)
        got = _errors(mt._validate_cfg, cfg)
        assert got is not None and got == _errors(ref_mt._validate_cfg,
                                                  ref_cfg)


# ----------------------------------------------------------------------
# The state pivot.


def _tensors(state) -> list[np.ndarray]:
    from dct_tpu_torch.checkpoint.manager import state_leaves

    return state_leaves(state)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_split_matches_the_reference_and_merge_is_bitwise(optimizer):
    cfg, ref_cfg = _cfgs()
    cfg.train.optimizer = ref_cfg.train.optimizer = optimizer
    cfg.train.momentum = ref_cfg.train.momentum = (
        0.9 if optimizer == "sgd" else 0.0)
    full, ref_full = _states(cfg, ref_cfg)
    for k in range(2):
        stage = mpmd.split_state(full, k, 2)
        got = flax_weights(stage.model)
        want = _flat(jax.device_get(
            ref.split_params(ref_full.params, k, 2))["params"])
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(
                got[key].reshape(value.shape), value, err_msg=key)
    # Non-zero moments: two sequential steps first.
    from dct_tpu_torch.train import steps

    step = steps.make_train_step()
    for x, y, w in _batches(2, SMALL["seq_len"]):
        full, _ = step(full, x, y, w)
    stages = [mpmd.split_state(full, k, 2) for k in range(2)]
    assert "in_proj" in dict(stages[0].model.named_children())
    assert "head" in dict(stages[1].model.named_children())
    assert "in_proj" not in dict(stages[1].model.named_children())
    merged = mpmd.merge_stage_states(
        stages, mt.build_full_state(cfg, INPUT_DIM))
    before, after = _tensors(full), _tensors(merged)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# The runner against the reference's.


@pytest.mark.parametrize("seq_len,steps", [(8, 6), (256, 6)])
def test_runner_matches_the_reference_runner(seq_len, steps):
    cfg, ref_cfg = _cfgs(seq_len=seq_len)
    full, ref_full = _states(cfg, ref_cfg)
    runner, ref_runner = _port_runner(cfg, full), _ref_runner(ref_cfg,
                                                              ref_full)
    batches = _batches(steps, seq_len)
    for i, (x, y, w) in enumerate(batches):
        got, _ = runner.train_step(x, y, w)
        want, _ = ref_runner.train_step(x, y, w)
        assert abs(got - want) < 1e-5, f"step {i}: {got} vs {want}"
    x, y, w = batches[0]
    for a, b in zip(runner.eval_pass(x, y, w),
                    ref_runner.eval_pass(x, y, w)):
        assert abs(a - b) < 1e-4
    for k in range(2):
        got = flax_weights(runner.states[k].model)
        want = _flat(jax.device_get(ref_runner.states[k].params)["params"])
        for key, value in want.items():
            np.testing.assert_allclose(got[key].reshape(value.shape), value,
                                       atol=1e-4, rtol=0, err_msg=key)
        assert runner.states[k].step == steps


def test_gpipe_equals_1f1b_and_the_report_attributes_phases():
    cfg, ref_cfg = _cfgs()
    gp, _ = _cfgs(schedule="gpipe")
    full, _ = _states(cfg, ref_cfg)
    r1 = _port_runner(cfg, full)
    r2 = _port_runner(gp, full)
    for x, y, w in _batches(3, SMALL["seq_len"]):
        l1, wall = r1.train_step(x, y, w)
        l2, _ = r2.train_step(x, y, w)
        assert l1 == pytest.approx(l2, abs=1e-7)
    rep = r1.step_bubble(wall)
    assert rep["schedule"] == "1f1b" and rep["n_microbatches"] == 4
    assert 0.0 <= rep["step_bubble"] <= 1.0
    assert 0.0 <= rep["steady_bubble"] <= 1.0
    assert rep["analytic_bubble"] == pytest.approx(ref.analytic_bubble(2, 4))
    first, last = rep["stages"]
    # Stage 0 warms up; the last stage has no fill; busy is the phases
    # plus the update.
    assert first["fill_s"] > 0 and last["fill_s"] == 0
    for s in rep["stages"]:
        assert s["steady_s"] > 0
        assert s["busy_s"] >= s["fill_s"] + s["steady_s"] + s["drain_s"]
        assert set(s["launches"]) == {"flash_fwd", "flash_bwd_dkdv",
                                      "flash_bwd_dq"}
    assert r2.step_bubble(wall)["schedule"] == "gpipe"


def test_a_wedged_stage_times_out_loudly():
    with pytest.raises(mpmd.MpmdTransferTimeout):
        mpmd.QueueChannel().recv(timeout=0.05)
    cfg, ref_cfg = _cfgs()
    full, _ = _states(cfg, ref_cfg)
    runner = _port_runner(cfg, full)
    runner.spec.transfer_timeout_s = 0.2

    def wedged(*args):
        time.sleep(0.5)
        raise RuntimeError("wedged")

    runner.programs[1] = dict(runner.programs[1], fwd=wedged)
    with pytest.raises(RuntimeError, match="stage 0 failed: stage 0 waited"):
        runner.train_step(*_batches(1, SMALL["seq_len"])[0])


# ----------------------------------------------------------------------
# The transfer plane.


def _pair():
    a, b = socket.socketpair()
    return a, b


def test_f32_frames_are_the_reference_bytes_and_bf16_round_trips():
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    a, b = _pair()
    try:
        # Each side reads the other's frame.
        mpmd_transfer.send_array(a, torch.from_numpy(arr), tag="t")
        ref_transfer.send_array(a, arr, tag="t")
        from_port = ref_transfer.recv_array(b, 2.0)
        from_ref = mpmd_transfer.recv_array(b, 2.0)
        np.testing.assert_array_equal(from_port, arr)
        np.testing.assert_array_equal(from_ref, arr)
        ca, cb = mpmd_transfer.SocketChannel(a), mpmd_transfer.SocketChannel(b)
        x = torch.randn(3, 5).to(torch.bfloat16)
        t = threading.Thread(target=ca.send, args=(x,))
        t.start()
        got = cb.recv(timeout=5.0)
        t.join()
        assert got.dtype == torch.bfloat16 and torch.equal(got, x)
        with pytest.raises(mpmd.MpmdTransferTimeout):
            cb.recv(timeout=0.1)
        a.sendall(b"JUNKJUNKJUNK")
        with pytest.raises(mpmd.MpmdTransferTimeout, match="bad frame"):
            cb.recv(timeout=1.0)
        ca.close()
        cb.close()
    finally:
        a.close()
        b.close()


def test_large_frames_both_ways_at_once_do_not_block_each_other():
    """Two neighbours each sending a 16 MB frame before reading the
    other's (1F1B's steady state at full width) both complete: each link
    is drained by its reader thread, whatever the socket buffers hold."""
    a, b = _pair()
    ca, cb = mpmd_transfer.SocketChannel(a), mpmd_transfer.SocketChannel(b)
    big = torch.arange(4 << 20, dtype=torch.float32)
    got = {}

    def side(ch, key):
        ch.send(big)
        got[key] = ch.recv(60.0)

    threads = [threading.Thread(target=side, args=(ch, key))
               for ch, key in ((ca, "a"), (cb, "b"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90.0)
    try:
        assert sorted(got) == ["a", "b"]
        for v in got.values():
            np.testing.assert_array_equal(v, big.numpy())
    finally:
        ca.close()
        cb.close()


def test_f32_frame_bytes_equal_the_reference():
    arr = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    blobs = []
    for send in (mpmd_transfer.send_array, ref_transfer.send_array):
        a, b = _pair()
        try:
            send(a, arr, tag="x")
            a.close()
            blobs.append(b.recv(1 << 16))
        finally:
            b.close()
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_stage_links_establish_in_either_order_and_carry(order):
    port_base = _free_port_block()
    out = {}

    def stage(k):
        links = mpmd_transfer.connect_stage_links(
            k, 2, port_base=port_base, timeout=20.0)
        try:
            if k == 0:
                links["act_out"].send(torch.full((2, 2), 7.0))
                out["grad"] = links["grad_in"].recv(10.0)
            else:
                act = torch.as_tensor(links["act_in"].recv(10.0))
                links["grad_out"].send(act * 2.0)
        finally:
            mpmd_transfer.close_links(links)

    threads = [threading.Thread(target=stage, args=(k,)) for k in order]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    np.testing.assert_array_equal(out["grad"], np.full((2, 2), 14.0,
                                                       np.float32))


def _free_port_block(n: int = 3) -> int:
    """A base port whose next ``n`` ports were free a moment ago."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        try:
            socks = []
            for i in range(1, n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


# ----------------------------------------------------------------------
# Checkpoint pivots and refusals.


def _save_mpmd(cfg, runner, epochs=1):
    spec = runner.spec
    for k in range(spec.n_stages):
        mt.stage_checkpointer(cfg.data.models_dir, k).save(
            runner.states[k], mt.stage_meta(cfg, epochs, epochs, stage=k))
    mt.write_manifest(cfg.data.models_dir, mt.manifest_of(cfg, spec, epochs))


def test_adopt_and_split_pivots_are_bitwise(tmp_path):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer
    from dct_tpu_torch.train import steps

    cfg, ref_cfg = _cfgs(tmp_path)
    full, _ = _states(cfg, ref_cfg)
    runner = _port_runner(cfg, full)
    for x, y, w in _batches(2, SMALL["seq_len"]):
        runner.train_step(x, y, w)
    _save_mpmd(cfg, runner)
    in_memory = mpmd.merge_stage_states(
        runner.states, mt.build_full_state(cfg, INPUT_DIM))
    meta = mt.adopt_mpmd_checkpoint(cfg.data.models_dir,
                                    mt.build_full_state(cfg, INPUT_DIM))
    assert meta["epochs_completed"] == 1 and "stage" not in meta
    restored = TrainStateCheckpointer(os.path.join(
        cfg.data.models_dir, "train_state", "p0")).restore(
            mt.build_full_state(cfg, INPUT_DIM))
    for a, b in zip(_tensors(in_memory), _tensors(restored)):
        np.testing.assert_array_equal(a, b)
    assert restored.step == 2

    # SPMD -> MPMD: a plain train_state splits into the stages bitwise.
    spmd_dir = tmp_path / "spmd"
    seq = mt.build_full_state(cfg, INPUT_DIM)
    step = steps.make_train_step()
    for x, y, w in _batches(2, SMALL["seq_len"], seed=3):
        seq, _ = step(seq, x, y, w)
    TrainStateCheckpointer(str(spmd_dir / "train_state" / "p0")).save(
        seq, {"epochs_completed": 1, "target_epochs": 1})
    got, meta = mt._restore_from_spmd(str(spmd_dir),
                                      mt.build_full_state(cfg, INPUT_DIM))
    assert meta["epochs_completed"] == 1
    for k in range(2):
        for a, b in zip(_tensors(mpmd.split_state(got, k, 2)),
                        _tensors(mpmd.split_state(seq, k, 2))):
            np.testing.assert_array_equal(a, b)
    assert mt._restore_from_spmd(str(tmp_path / "none"), seq) == (None, {})

    # A manifest the template cannot tile is refused, naming it.
    man = mt.read_manifest(cfg.data.models_dir)
    man["n_stages"] = 4
    mt.write_manifest(cfg.data.models_dir, man)
    with pytest.raises(mpmd.MpmdSpecError, match="untileable"):
        mt.adopt_mpmd_checkpoint(cfg.data.models_dir,
                                 mt.build_full_state(cfg, INPUT_DIM))


def _fit_cfg(tmp_path, processed_dir, **train):
    cfg, _ = _cfgs(tmp_path)
    cfg.data.processed_dir = processed_dir
    cfg.obs.events_dir = str(tmp_path / "events")
    cfg.train.epochs = 1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _events(tmp_path):
    from dct_tpu_torch.observability.events import read_events

    return read_events(str(tmp_path / "events"))


def test_fit_resumes_pivots_both_ways_and_refuses(tmp_path, processed_dir):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.train.trainer import Trainer

    dim = load_processed_dataset(processed_dir).input_dim

    cfg = _fit_cfg(tmp_path, processed_dir)
    res = mt.MpmdTrainer(cfg, device="cpu").fit()
    assert res.epochs_completed == 1 and len(res.step_losses) > 1
    assert mt.mpmd_checkpoint_present(cfg.data.models_dir)
    reports = [e for e in _events(tmp_path)
               if e["event"] == "mpmd.step_report"]
    assert len(reports) == 1 and len(reports[0]["stages"]) == 2
    assert reports[0]["val_loss"] == pytest.approx(res.val_losses[0])

    # Resumed: the stage files extend the trajectory by one epoch.
    cfg.train.resume = True
    res2 = mt.MpmdTrainer(cfg, device="cpu").fit()
    assert res2.epochs_completed == 2 and len(res2.train_losses) == 1

    # The optimizer-change refusal, then the torn-set refusal.
    changed = _fit_cfg(tmp_path, processed_dir, resume=True,
                       optimizer="adam", momentum=0.0)
    with pytest.raises(RuntimeError, match="Resume refused"):
        mt.MpmdTrainer(changed, device="cpu").fit()
    torn = tmp_path / "torn"
    shutil.copytree(cfg.data.models_dir, torn)
    shutil.rmtree(os.path.join(mt.mpmd_state_root(str(torn)), "stage1"))
    cfg_torn = _fit_cfg(tmp_path, processed_dir, resume=True)
    cfg_torn.data.models_dir = str(torn)
    with pytest.raises(FileNotFoundError, match="torn"):
        mt.MpmdTrainer(cfg_torn, device="cpu").fit()

    # MPMD -> SPMD through Trainer.fit's resume: the adopted state is the
    # stage files merged, bitwise, and the trajectory continues.
    merged = mpmd.merge_stage_states(
        [mt.stage_checkpointer(cfg.data.models_dir, k).restore(
            mpmd.split_state(mt.build_full_state(cfg, dim), k, 2))
         for k in range(2)], mt.build_full_state(cfg, dim))
    spmd = tmp_path / "spmd"
    shutil.copytree(cfg.data.models_dir, spmd)
    cfg_spmd = _fit_cfg(tmp_path, processed_dir, resume=True)
    cfg_spmd.data.models_dir = str(spmd)
    mt.adopt_mpmd_checkpoint(str(spmd), mt.build_full_state(cfg, dim))
    adopted = TrainStateCheckpointer(
        str(spmd / "train_state" / "p0")).restore(
            mt.build_full_state(cfg, dim))
    for a, b in zip(_tensors(merged), _tensors(adopted)):
        np.testing.assert_array_equal(a, b)
    shutil.rmtree(spmd / "train_state")
    result = Trainer(cfg_spmd, device="cpu", tracker=LocalTracking(
        root=str(tmp_path / "mlruns"))).fit()
    assert np.isfinite(result.val_loss)
    pivots = [e for e in _events(tmp_path) if e["event"] == "mpmd.pivot"]
    assert [p["direction"] for p in pivots] == ["mpmd_to_spmd"] * 2
    spmd_meta = TrainStateCheckpointer(
        str(spmd / "train_state" / "p0")).load_meta()
    assert spmd_meta["epochs_completed"] == 3

    # SPMD -> MPMD: MpmdTrainer resumes from the plain train_state.
    shutil.rmtree(mt.mpmd_state_root(str(spmd)))
    res3 = mt.MpmdTrainer(cfg_spmd, device="cpu").fit()
    assert res3.epochs_completed == 4
    assert [p["direction"] for p in _events(tmp_path)
            if p["event"] == "mpmd.pivot"][-1] == "spmd_to_mpmd"


def test_trainer_ignores_a_manifest_of_another_family(tmp_path,
                                                      processed_dir):
    from dct_tpu_torch.train.trainer import Trainer

    cfg = _fit_cfg(tmp_path, processed_dir)
    mt.write_manifest(cfg.data.models_dir, {"n_stages": 2,
                                            "family": "weather_other"})
    cfg.model = ModelConfig(name="weather_mlp")
    cfg.train.resume = True
    assert np.isfinite(Trainer(cfg, device="cpu", tracker=LocalTracking(
        root=str(tmp_path / "mlruns"))).fit().val_loss)
    assert not os.path.exists(os.path.join(cfg.data.models_dir, "train_state",
                                           "p0", "state", "meta.json")) or (
        json.load(open(os.path.join(cfg.data.models_dir, "train_state", "p0",
                                    "state", "meta.json")))
        ["epochs_completed"] == 1)


# ----------------------------------------------------------------------
# The supervised two-process world.


def test_two_process_worker_under_the_supervisor_equals_in_process(
        tmp_path, processed_dir):
    cfg = _fit_cfg(tmp_path, processed_dir)
    cfg.train.epochs = 2
    res = mt.MpmdTrainer(cfg, device="cpu").fit()

    base = tmp_path / "world"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCT_") and k not in (
               "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(
        PYTHONPATH=REPO, OMP_NUM_THREADS="2", DCT_DEVICE="cpu",
        DCT_PROCESSED_DIR=processed_dir,
        DCT_MODELS_DIR=str(base / "models"),
        DCT_EVENTS_DIR=str(base / "events"),
        DCT_HEARTBEAT_DIR=str(base / "hb"),
        DCT_MODEL="weather_transformer_pp", DCT_DROPOUT="0",
        DCT_SEQ_LEN="8", DCT_D_MODEL="16", DCT_N_HEADS="2",
        DCT_N_LAYERS="2", DCT_D_FF="32", DCT_N_STAGES="2",
        DCT_BF16_COMPUTE="0", DCT_EPOCHS="2", DCT_BATCH_SIZE=str(BATCH),
        DCT_LR=str(LR), DCT_OPTIMIZER="sgd", DCT_MOMENTUM="0.9",
        DCT_MPMD_STAGES="1,1", DCT_MPMD_MICROBATCHES="4",
        DCT_MPMD_PORT_BASE=str(_free_port_block()),
        DCT_MPMD_TRANSFER_TIMEOUT_S="60")
    proc = subprocess.run(
        [sys.executable, "-m", "dct_tpu_torch.resilience.supervise",
         "--world-size", "2", "--backoff", "0.2", "--",
         sys.executable, "-m", "dct_tpu_torch.train.mpmd_worker"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from dct_tpu_torch.observability.events import read_events

    events = read_events(str(base / "events"))
    reports = [e for e in events if e["event"] == "mpmd.step_report"]
    assert [r["epoch"] for r in reports] == [0, 1]
    assert [r["train_loss"] for r in reports] == pytest.approx(
        res.train_losses, abs=1e-6)
    assert [r["val_loss"] for r in reports] == pytest.approx(
        res.val_losses, abs=1e-6)
    done = [e for e in events if e["event"] == "mpmd.stage_done"]
    assert sorted(e["stage"] for e in done) == [0, 1]
    assert not any(e["preempted"] for e in done)
    assert mt.read_manifest(str(base / "models"))["epochs_completed"] == 2
    launched = [line for line in proc.stdout.splitlines()
                if "[mpmd_worker s" in line and "launches" in line]
    assert len(launched) == 2
