"""The port's continuous loop (CPU): the always-on loop in ``inline`` mode,
the episodic cycle against the reference's, the ingest watcher, the
evaluator, and ``python -m dct_tpu_torch.loop_job``.

- Two inline rounds of one epoch train what one unbroken 2-epoch
  ``Trainer.fit`` trains (per-epoch losses within 1e-6), with the ingest
  watcher and the evaluator live beside them.
- ``run_episodic_cycle`` of the port and of the reference, on the same CSV
  (appended to between the cycles) and the same initial weights (the
  reference's flax init carried into the port, dropout 0): the same
  generations, the same promote/hold, val_loss within 1e-5.
- A live loop ingests an appended generation through the delta path and
  promotes a model trained on it.
- ``loop_job`` drains on SIGTERM with exit 0, the inline round stopped at
  its trainer's next step with a durable resume snapshot; ``stream`` raises naming ROADMAP item 24, while ``supervised``
  (the default) runs: a round whose world gives up ends ``loop_job`` with
  exit 1 (its healthy rounds are in ``test_torch_supervised.py``).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from dct_tpu.data.synthetic import append_weather_rows, generate_weather_csv
from dct_tpu_torch import convert
from dct_tpu_torch.config import (
    DataConfig,
    LoopConfig,
    ModelConfig,
    RunConfig,
    StreamConfig,
    TrainConfig,
)
from dct_tpu_torch.continuous.evaluator import PromotionEvaluator
from dct_tpu_torch.continuous.ingest import IngestWatcher
from dct_tpu_torch.continuous.loop import AlwaysOnLoop, run_episodic_cycle
from dct_tpu_torch.deploy.local import LocalEndpointClient
from dct_tpu_torch.etl.preprocess import (
    preprocess_csv_to_parquet,
    read_etl_state,
)
from dct_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _sandboxed(monkeypatch, tmp_path):
    # Tracking stores, event logs and lineage of both packages land under
    # tmp_path, never in the working copy.
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DCT_TRACKING_DIR", str(tmp_path / "mlruns"))
    monkeypatch.setenv("DCT_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("DCT_LINEAGE", "0")
    for var in ("DCT_GATE", "DCT_GATE_ENGINE", "DCT_MIRROR_CAPTURE"):
        monkeypatch.delenv(var, raising=False)


def _cfg(base, *, rounds=2, epochs_per_round=1, model=None, train=None,
         poll=0.1, soak=0.0):
    return RunConfig(
        data=DataConfig(processed_dir=os.path.join(base, "processed"),
                        raw_csv=os.path.join(base, "raw", "weather.csv"),
                        models_dir=os.path.join(base, "models")),
        model=model or ModelConfig(),
        train=train or TrainConfig(batch_size=16),
        loop=LoopConfig(poll_s=poll, eval_poll_s=poll,
                        epochs_per_round=epochs_per_round,
                        train_mode="inline", soak_s=soak,
                        packages_dir=os.path.join(base, "packages"),
                        max_rounds=rounds),
    )


def test_two_inline_rounds_train_what_one_unbroken_fit_trains(tmp_path):
    base = str(tmp_path / "loop")
    cfg = _cfg(base)
    generate_weather_csv(cfg.data.raw_csv, rows=700, seed=21)
    loop = AlwaysOnLoop(cfg, device="cpu")
    summary = loop.run()
    assert summary["rounds"] == 2 and summary["reason"] == "max_rounds"
    assert summary["error"] is None and summary["promotions"] >= 1
    assert summary["ingested_generations"] == 1  # the priming ETL only
    looped = [(t, v) for r in loop.round_results
              for t, v in zip(r["train_losses"], r["val_losses"])]

    serial = str(tmp_path / "serial")
    preprocess_csv_to_parquet(cfg.data.raw_csv, serial)
    one = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, processed_dir=serial,
                                      models_dir=str(tmp_path / "sm")),
        train=dataclasses.replace(cfg.train, epochs=2))
    result = Trainer(one, device="cpu").fit()
    unbroken = [(h["train_loss"], h["val_loss"]) for h in result.history]
    assert len(looped) == len(unbroken) == 2
    np.testing.assert_allclose(looped, unbroken, rtol=1e-6, atol=1e-7)


def _reference_init(monkeypatch, input_dim=5, seed=42):
    """Carry the reference's flax init of the MLP into the port."""
    from dct_tpu.config import ModelConfig as RefModelConfig
    from dct_tpu.models.registry import get_model as ref_get_model
    from dct_tpu.serving.score_gen import _flatten_params
    from dct_tpu.train import state as ref_state

    model = ref_get_model(RefModelConfig(dropout=0.0), input_dim=input_dim,
                          compute_dtype=jax.numpy.float32)
    st = ref_state.create_train_state(model, input_dim=input_dim, lr=0.01,
                                      seed=seed)
    init = _flatten_params(jax.device_get(st.params["params"]))
    monkeypatch.setattr(convert, "init_flax_weights", lambda m, s: init)


def test_episodic_cycles_match_reference(tmp_path, monkeypatch):
    from dct_tpu.config import DataConfig as RefDataConfig
    from dct_tpu.config import LoopConfig as RefLoopConfig
    from dct_tpu.config import MeshConfig as RefMeshConfig
    from dct_tpu.config import ModelConfig as RefModelConfig
    from dct_tpu.config import ObservabilityConfig as RefObsConfig
    from dct_tpu.config import RunConfig as RefRunConfig
    from dct_tpu.config import TrainConfig as RefTrainConfig
    from dct_tpu.continuous.evaluator import (
        PromotionEvaluator as RefEvaluator,
    )
    from dct_tpu.continuous.loop import (
        run_episodic_cycle as ref_run_episodic_cycle,
    )
    from dct_tpu.deploy.local import LocalEndpointClient as RefClient

    raw = str(tmp_path / "raw" / "weather.csv")
    generate_weather_csv(raw, rows=800, seed=5)
    # The reference's batch_size is per data shard: 2 x 8 CPU devices is
    # the port's global batch of 16 on one device.
    port_cfg = _cfg(str(tmp_path / "port"), model=ModelConfig(dropout=0.0),
                    train=TrainConfig(batch_size=16, bf16_compute=False))
    port_cfg.data.raw_csv = raw
    ref_base = str(tmp_path / "ref")
    ref_cfg = RefRunConfig(
        data=RefDataConfig(processed_dir=os.path.join(ref_base, "processed"),
                           raw_csv=raw,
                           models_dir=os.path.join(ref_base, "models")),
        model=RefModelConfig(dropout=0.0),
        train=RefTrainConfig(batch_size=2, bf16_compute=False),
        mesh=RefMeshConfig(data=8),
        obs=RefObsConfig(enabled=False),
        loop=RefLoopConfig(epochs_per_round=1, train_mode="inline",
                           soak_s=0.0),
    )
    _reference_init(monkeypatch)
    port_client, ref_client = LocalEndpointClient(), RefClient()
    port_ev = PromotionEvaluator(
        port_cfg.data.models_dir, str(tmp_path / "port" / "pkgs"),
        client=port_client, endpoint="ep",
        processed_dir=port_cfg.data.processed_dir, soak_s=0.0,
        device="cpu")
    ref_ev = RefEvaluator(
        ref_cfg.data.models_dir, str(tmp_path / "ref" / "pkgs"),
        client=ref_client, endpoint="ep",
        processed_dir=ref_cfg.data.processed_dir, soak_s=0.0,
        sleep_fn=lambda s: None)
    for cycle in range(2):
        if cycle:
            append_weather_rows(raw, rows=300, seed=6)
        got = run_episodic_cycle(port_cfg, client=port_client,
                                 evaluator=port_ev, device="cpu")
        want = ref_run_episodic_cycle(ref_cfg, client=ref_client,
                                      evaluator=ref_ev)
        assert got["generation"] == want["generation"] == cycle + 1
        assert got["promoted"] == want["promoted"]
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
        assert (got["freshness_s"] is None) == (want["freshness_s"] is None)
        assert got["cycle_s"] >= got["train_s"] > 0
    assert read_etl_state(port_cfg.data.processed_dir)["mode"] == "delta"
    assert [h["decision"] for h in port_ev.held] == [
        h["decision"] for h in ref_ev.held]
    assert port_client.get_traffic("ep") == ref_client.get_traffic("ep")


def test_live_loop_ingests_a_delta_and_promotes_it(tmp_path, monkeypatch):
    monkeypatch.setenv("DCT_GATE", "0")  # every new best deploys
    base = str(tmp_path / "live")
    cfg = _cfg(base, rounds=200, train=TrainConfig(batch_size=16, epochs=1))
    generate_weather_csv(cfg.data.raw_csv, rows=600, seed=31)
    loop = AlwaysOnLoop(cfg, device="cpu")

    def fresh():
        return [p for p in loop.evaluator.promotions
                if (p.get("generation") or 0) >= 2]

    def drive():
        # Append once the cold-start model is deployed; stop once a model
        # trained on the appended generation is.
        deadline = time.time() + 90
        while time.time() < deadline and not loop.evaluator.promotions:
            time.sleep(0.02)
        append_weather_rows(cfg.data.raw_csv, rows=200, seed=32)
        while time.time() < deadline and not fresh():
            time.sleep(0.02)
        loop.request_stop("test")

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    summary = loop.run()
    t.join(timeout=90)
    assert not t.is_alive() and summary["reason"] == "test"
    state = read_etl_state(cfg.data.processed_dir)
    assert state["generation"] == 2 and state["rows"] == 800
    assert any(r.get("mode") == "delta" for r in loop.ingest.log)
    assert summary["ingested_generations"] == 2
    assert fresh() and all(p["freshness_s"] > 0 for p in fresh())
    assert summary["mean_freshness_s"] > 0
    out = loop.client.score(cfg.loop.endpoint,
                            {"data": [[0.1, -0.2, 0.3, 0.0, 1.1]]})
    assert len(out["probabilities"]) == 1


def test_evaluator_dedups_holds_numbers_and_parks(tmp_path):
    from dct_tpu_torch.evaluation.gates import GateDecision

    base = str(tmp_path / "ev")
    cfg = _cfg(base, rounds=1)
    generate_weather_csv(cfg.data.raw_csv, rows=300, seed=3)
    preprocess_csv_to_parquet(cfg.data.raw_csv, cfg.data.processed_dir)
    Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1)), device="cpu").fit()

    class HoldGate:
        class cfg:  # noqa: N801 — the PromotionGate.cfg surface
            fail_open = True
            ledger_path = str(tmp_path / "ledger.json")

        def evaluate(self, **kw):
            return GateDecision("hold", kw.get("stage"), "test_hold")

    client = LocalEndpointClient()
    boot = PromotionEvaluator(cfg.data.models_dir, str(tmp_path / "p1"),
                              client=client, endpoint="ep", soak_s=0,
                              gate_factory=lambda: None, device="cpu")
    assert boot.check_once() is not None
    before = client.get_traffic("ep")
    ev = PromotionEvaluator(cfg.data.models_dir, str(tmp_path / "p2"),
                            client=client, endpoint="ep", soak_s=0,
                            gate_factory=HoldGate, device="cpu")
    assert ev.check_once() is None and len(ev.held) == 1
    assert ev.check_once() is None and len(ev.held) == 1  # deduped
    assert client.get_traffic("ep") == before

    (tmp_path / "p3" / "pkg-00003").mkdir(parents=True)
    ev3 = PromotionEvaluator(cfg.data.models_dir, str(tmp_path / "p3"),
                             client=LocalEndpointClient(), endpoint="ep",
                             device="cpu")
    assert ev3._counter == 3

    calls = {"n": 0}
    real = ev3._promote

    def flaky(ckpt):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient disk pressure")
        return real(ckpt)

    ev3._promote = flaky
    ev3._gate_factory = lambda: None
    assert ev3.check_once() is None and not ev3.error_log[-1]["parked"]
    assert ev3.check_once() is not None  # retried, promoted
    ev4 = PromotionEvaluator(cfg.data.models_dir, str(tmp_path / "p4"),
                             client=LocalEndpointClient(), endpoint="ep",
                             device="cpu")

    def broken(ckpt):
        raise ValueError("corrupt checkpoint")

    ev4._promote = broken
    for _ in range(3):
        assert ev4.check_once() is None
    assert ev4.error_log[-1]["parked"] is True
    assert ev4.check_once() is None and ev4.errors == 3


def test_ingest_watcher_retries_then_parks_bad_etl(tmp_path):
    csv = str(tmp_path / "raw.csv")
    with open(csv, "w") as f:
        f.write("not,a,weather,csv\n1,2,3,4\n")
    w = IngestWatcher(csv, str(tmp_path / "proc"))
    for want in (1, 2, 3):
        assert w.check_once() is None and w.errors == want
    assert w.log[-1]["event"] == "ingest.error" and w.log[-1]["parked"]
    assert w.check_once() is None and w.errors == 3
    generate_weather_csv(csv, rows=120, seed=8)
    assert w.check_once() is not None and w.processed == 1


def test_supervised_and_stream_raise_naming_their_items(tmp_path):
    # Since the launcher was ported, only the stream half still raises:
    # supervised mode constructs and names its run.
    cfg = _cfg(str(tmp_path))
    sup = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, train_mode="supervised"))
    loop = AlwaysOnLoop(sup, device="cpu")
    assert loop.loop_cfg.train_mode == "supervised"
    assert loop.run_id == sup.obs.run_id and loop.run_id.startswith("dct-")
    stream = dataclasses.replace(cfg, stream=StreamConfig(mode="stream"))
    with pytest.raises(NotImplementedError, match="item 24"):
        AlwaysOnLoop(stream, device="cpu")
    bad = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, train_mode="thread"))
    with pytest.raises(ValueError, match="DCT_LOOP_TRAIN_MODE"):
        AlwaysOnLoop(bad, device="cpu")
    # The loop config reads the reference's environment and defaults.
    from dct_tpu.config import LoopConfig as RefLoopConfig

    assert dataclasses.asdict(LoopConfig()) == dataclasses.asdict(
        RefLoopConfig())
    assert LoopConfig().train_mode == "supervised"



@pytest.mark.parametrize("launcher_kwargs,want", [
    (None, 45.0), ({"preempt_grace_s": 7.0}, 7.0)])
def test_supervised_round_takes_the_configured_grace_window(
        tmp_path, monkeypatch, launcher_kwargs, want):
    # A rank SIGTERMed mid-span finishes the span before it exits 75: the
    # round's launcher waits the config's grace window (a tenant's own
    # launcher_kwargs win), not the launcher's built-in default.
    from dct_tpu_torch.config import ResilienceConfig
    from dct_tpu_torch.launch import launcher as launcher_mod

    seen = {}

    class _Launcher:
        def __init__(self, **kw):
            seen.update(kw)

        def supervise(self, argv, **kw):
            return launcher_mod.SuperviseResult(
                results=[], success=True, classification="success")

    monkeypatch.setattr(launcher_mod, "LocalProcessLauncher", _Launcher)
    cfg = _cfg(str(tmp_path))
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, train_mode="supervised"),
        resilience=ResilienceConfig(preempt_grace_s=45.0))
    loop = AlwaysOnLoop(cfg, device="cpu", launcher_kwargs=launcher_kwargs)
    rec = loop._run_round_supervised()
    assert rec["classification"] == "success"
    assert seen["preempt_grace_s"] == want

def _job_env(base: str, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(
        PYTHONPATH=REPO, DCT_DEVICE="cpu",
        DCT_RAW_CSV=os.path.join(base, "raw", "weather.csv"),
        DCT_PROCESSED_DIR=os.path.join(base, "processed"),
        DCT_MODELS_DIR=os.path.join(base, "models"),
        DCT_TRACKING_DIR=os.path.join(base, "mlruns"),
        DCT_EVENTS_DIR=os.path.join(base, "events"),
        DCT_LOOP_PACKAGES_DIR=os.path.join(base, "pkgs"),
        DCT_LOOP_TRAIN_MODE="inline", DCT_LOOP_SOAK_S="0",
        DCT_LOOP_POLL_S="0.2", DCT_LOOP_EVAL_POLL_S="0.2",
    )
    env.update(extra)
    return env


def _summary(stdout: str) -> dict:
    line = [x for x in stdout.splitlines()
            if x.startswith("[loop_job] summary ")][-1]
    return json.loads(line[len("[loop_job] summary "):])


def test_loop_job_drains_on_sigterm_after_the_round_in_flight(tmp_path):
    base = str(tmp_path)
    generate_weather_csv(os.path.join(base, "raw", "weather.csv"),
                         rows=1500, seed=41)
    env = _job_env(base, DCT_LOOP_EPOCHS_PER_ROUND="4", DCT_USE_SCAN="0",
                   DCT_BATCH_SIZE="4")
    runs = os.path.join(base, "mlruns", "weather_forecasting")
    proc = subprocess.Popen([sys.executable, "-m", "dct_tpu_torch.loop_job"],
                            env=env, cwd=base, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not (
                os.path.isdir(runs) and os.listdir(runs)):
            time.sleep(0.02)  # the round's fit has started its run
        assert os.path.isdir(runs) and os.listdir(runs)
        signalled = time.time()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    summary = _summary(out)
    # The inline round's PreemptionGuard takes the SIGTERM (as the
    # reference's does): the fit stops at its next step with a durable
    # resume snapshot and the loop drains.
    assert summary["reason"] == "preempted" and summary["error"] is None
    assert summary["rounds"] == 0 and summary["preempted_rounds"] == 0
    events = [json.loads(x) for x in open(os.path.join(base, "events",
                                                       "events.jsonl"))]
    saved = [e for e in events if e["event"] == "preempt.checkpoint_saved"]
    assert len(saved) == 1 and saved[0]["ts"] >= signalled
    with open(os.path.join(base, "models", "train_state", "p0", "state",
                           "meta.json")) as f:
        meta = json.load(f)
    assert meta["epochs_completed"] == saved[0]["epochs_completed"] < 4
    assert meta["target_epochs"] == 4


def test_loop_job_default_supervised_mode_exits_1_naming_item_20(tmp_path):
    """The default mode used to refuse to start (the launcher, item 20, was
    not ported). It runs now; what still exits 1 is a supervised round whose
    world gives up: here a NaN under the halt policy, which the supervisor
    never relaunches."""
    base = str(tmp_path)
    generate_weather_csv(os.path.join(base, "raw", "weather.csv"),
                         rows=600, seed=41)
    env = _job_env(base, DCT_FAULT_SPEC="nan:epoch0", DCT_HALT_ON_NAN="1",
                   DCT_HEARTBEAT_DIR=os.path.join(base, "hb"))
    env.pop("DCT_LOOP_TRAIN_MODE")
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.loop_job"],
                       env=env, cwd=base, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1, r.stderr[-3000:]
    assert "mode=supervised" in r.stdout
    summary = _summary(r.stdout)
    assert summary["reason"] == "train_health_halt" and summary["rounds"] == 0
    assert "supervised round gave up: health_halt" in summary["error"]
