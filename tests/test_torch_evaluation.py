"""The port's evaluation package against the reference's (CPU).

Same inputs from numpy seeds through both: the drift detectors; the
harness's eval split and its numpy engine (equal); the port's ``torch``
engine (``device="cpu"``: the flash path's plain version) against the
reference's ``jax`` engine, within 2e-6 on the MLP (the reference's own
engine tolerance, ``tests/test_evaluation.py:367-372``) and 1e-5 on a small
transformer at T=256; the gate statistics, decisions, cached offline
reports and the decision ledger (equal).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct_tpu.checkpoint.manager import save_checkpoint
from dct_tpu.config import EvaluationConfig as RefEvaluationConfig
from dct_tpu.config import ModelConfig as RefModelConfig
from dct_tpu.continuous.evaluator import package_checkpoint as ref_package
from dct_tpu.evaluation import drift as ref_drift
from dct_tpu.evaluation import gates as ref_gates
from dct_tpu.evaluation import harness as ref_harness
from dct_tpu.models.registry import get_model as ref_get_model
from dct_tpu_torch.config import EvaluationConfig
from dct_tpu_torch.device import DeviceError
from dct_tpu_torch.evaluation import drift, gates, harness
from dct_tpu_torch.tracking.client import LocalTracking
from torch_threads import one_torch_thread  # noqa: F401

FEATURES = [f"f{i}" for i in range(5)]
SMALL_TF = dict(seq_len=256, d_model=32, n_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(autouse=True)
def _quiet_reference(monkeypatch, tmp_path):
    # The reference's lineage and event planes (default on) would write
    # under the working directory; neither is part of what is compared.
    monkeypatch.setenv("DCT_LINEAGE", "0")
    monkeypatch.setenv("DCT_EVENTS_DIR", str(tmp_path / "events"))
    from dct_tpu.observability import events as _events
    from dct_tpu.observability import spans as _spans

    _events.set_default(None)
    _spans.set_default(None)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """A processed dir written by the reference's ETL (rows enough for
    T=256 windows with a validation tail)."""
    from dct_tpu.data.synthetic import generate_weather_csv
    from dct_tpu.etl.preprocess import preprocess_csv_to_parquet

    base = tmp_path_factory.mktemp("eval_data")
    csv = generate_weather_csv(str(base / "raw.csv"), rows=2200, seed=11)
    os.environ["DCT_LINEAGE"] = "0"
    try:
        preprocess_csv_to_parquet(csv, str(base / "proc"))
    finally:
        os.environ.pop("DCT_LINEAGE", None)
    return str(base / "proc")


def _ckpt(tmp_path, family: str, seed: int, name: str) -> str:
    """A reference checkpoint from a flax init (``family`` at the small
    widths), as the trainer would write it."""
    if family == "weather_mlp":
        cfg = RefModelConfig()
        meta = {"model": family, "input_dim": 5, "hidden_dim": 64,
                "num_classes": 2, "dropout": 0.2, "feature_names": FEATURES}
        example = jnp.zeros((1, 5))
    else:
        cfg = RefModelConfig(name=family, dropout=0.0, **SMALL_TF)
        import dataclasses

        meta = {**dataclasses.asdict(cfg), "model": family, "input_dim": 5,
                "feature_names": FEATURES}
        meta.pop("name")
        example = jnp.zeros((1, SMALL_TF["seq_len"], 5))
    model = ref_get_model(cfg, input_dim=5)
    params = model.init(jax.random.PRNGKey(seed), example)
    return save_checkpoint(str(tmp_path / f"{name}.ckpt"), params, meta)


def _package(tmp_path, processed, family, seed, name) -> str:
    """A challenger package as the reference's evaluator builds it (with
    the training-data snapshot and the split in ``run_info.json``)."""
    pkg = str(tmp_path / name)
    ref_package(_ckpt(tmp_path, family, seed, name), pkg,
                processed_dir=processed)
    return pkg


# ----------------------------------------------------------------------
# Drift.

def test_drift_functions_equal_reference():
    rng = np.random.default_rng(0)
    train = rng.normal(0.0, 1.0, (3000, 5)).astype(np.float32)
    train[:, 4] = (rng.random(3000) < 0.3)  # a discrete feature
    train[:, 3] = 2.0  # a constant one
    assert drift.ks_statistic(train[:, 0], train[:, 0] + 0.1) == \
        ref_drift.ks_statistic(train[:, 0], train[:, 0] + 0.1)
    snap = drift.snapshot_features(train, FEATURES, bins=10)
    assert snap == ref_drift.snapshot_features(train, FEATURES, bins=10)
    snap = json.loads(json.dumps(snap))
    for shift in (0.0, 0.3, 1.5):
        cur = rng.normal(shift, 1.0, (1200, 5)).astype(np.float32)
        cur[:, 4] = (rng.random(1200) < 0.3 + shift / 3)
        for names in (FEATURES, FEATURES[:4] + ["g"]):
            assert drift.feature_drift(snap, cur, names) == \
                ref_drift.feature_drift(snap, cur, names)
    live = rng.dirichlet(np.ones(2), 50)
    shadow = rng.dirichlet(np.ones(2), 50)
    assert drift.prediction_disagreement(live, shadow) == \
        ref_drift.prediction_disagreement(live, shadow)
    assert drift.psi([5, 3, 2], [1, 4, 5]) == ref_drift.psi([5, 3, 2],
                                                           [1, 4, 5])


def test_disagreement_report_equal_reference(tmp_path):
    path = str(tmp_path / "mirror.jsonl")
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for i in range(40):
            f.write(json.dumps({
                "live_slot": "blue", "shadow_slot": "green" if i % 3 else
                "blue", "live_probs": rng.dirichlet(np.ones(2), 2).tolist(),
                "shadow_probs": rng.dirichlet(np.ones(2), 2).tolist()}) + "\n")
    for slot in (None, "green"):
        assert drift.disagreement_report(path, shadow_slot=slot) == \
            ref_drift.disagreement_report(path, shadow_slot=slot)
    assert drift.disagreement_report(None) is None


# ----------------------------------------------------------------------
# Harness: split and engines.

@pytest.mark.parametrize("family", ["weather_mlp", "weather_transformer",
                                    "weather_transformer_causal"])
def test_eval_split_and_numpy_engine_equal_reference(tmp_path, processed,
                                                     family):
    pkg = str(tmp_path / "pkg")
    from dct_tpu.serving.score_gen import generate_score_package

    generate_score_package(_ckpt(tmp_path, family, 3, "m"), pkg)
    w, m = harness.load_model(pkg)
    rw, rm = ref_harness.load_model(pkg)
    assert m == rm and sorted(w) == sorted(rw)
    for seed, vf in ((42, 0.2), (7, 0.3)):
        x, y = harness.load_eval_split(processed, m, val_fraction=vf,
                                       seed=seed)
        rx, ry = ref_harness.load_eval_split(processed, rm, val_fraction=vf,
                                             seed=seed)
        assert np.array_equal(x, rx) and np.array_equal(y, ry)
    x = x[:96]
    got = harness.batched_probs(w, m, x, batch_size=40)
    want = ref_harness.batched_probs(rw, rm, x, batch_size=40)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("family,tol", [
    ("weather_mlp", 2e-6),
    ("weather_transformer", 1e-5),
    ("weather_transformer_causal", 1e-5),
])
def test_torch_engine_matches_reference_jax_engine(tmp_path, processed,
                                                   family, tol):
    pkg = str(tmp_path / "pkg")
    from dct_tpu.serving.score_gen import generate_score_package

    generate_score_package(_ckpt(tmp_path, family, 5, "m"), pkg)
    w, m = harness.load_model(pkg)
    x, _ = harness.load_eval_split(processed, m)
    x = x[:70]
    got = harness.batched_probs(w, m, x, batch_size=32, engine="torch",
                                device="cpu")
    want = ref_harness.batched_probs(w, m, x, batch_size=32, engine="jax")
    assert got.shape == want.shape == (len(x), 2)
    err = float(np.abs(got - want).max())
    assert err <= tol, err
    # DCT_GATE_ENGINE=jax (a reference env file) selects the same engine.
    again = harness.batched_probs(w, m, x, batch_size=32, engine="jax",
                                  device="cpu")
    assert np.array_equal(again, got)


def test_torch_engine_takes_the_flash_path_at_t256(tmp_path, processed,
                                                   monkeypatch):
    from dct_tpu_torch.ops import flash_attention as fa

    calls = []
    plain = fa.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", counting)
    pkg = str(tmp_path / "pkg")
    from dct_tpu.serving.score_gen import generate_score_package

    generate_score_package(_ckpt(tmp_path, "weather_transformer", 6, "m"),
                           pkg)
    w, m = harness.load_model(pkg)
    x = np.random.default_rng(0).standard_normal((10, 256, 5)).astype(
        np.float32)
    harness.batched_probs(w, m, x, batch_size=4, engine="torch",
                          device="cpu")
    # layers x chunks: 2 x ceil(10 / 4)
    assert len(calls) == SMALL_TF["n_layers"] * 3
    assert calls[0][-2] == 256


def test_torch_engine_without_cuda_and_without_cpu_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    meta = {"model": "weather_mlp", "input_dim": 5, "hidden_dim": 8}
    w = {"w0": np.zeros((5, 8), np.float32), "b0": np.zeros(8, np.float32),
         "w1": np.zeros((8, 2), np.float32), "b1": np.zeros(2, np.float32)}
    with pytest.raises(DeviceError, match="CUDA is not available"):
        harness.batched_probs(w, meta, np.zeros((2, 5), np.float32),
                              engine="torch")


def test_harness_eval_errors(tmp_path):
    with pytest.raises(harness.EvalError):
        harness.model_from_package(str(tmp_path / "missing"))
    with pytest.raises(harness.EvalError):
        harness.load_eval_split(str(tmp_path / "nodata"),
                                {"model": "weather_mlp"})


def test_evaluate_pair_equal_reference_paired_and_unpaired(tmp_path,
                                                           processed):
    a = harness.load_model(_package(tmp_path, processed, "weather_mlp", 0,
                                    "a"))
    b = harness.load_model(_package(tmp_path, processed, "weather_mlp", 1,
                                    "b"))
    t = harness.load_model(_package(tmp_path, processed,
                                    "weather_transformer", 2, "t"))
    for champ, chall in ((a, b), (b, a), (a, t)):
        got = harness.evaluate_pair(champ, chall, processed).to_dict()
        want = ref_harness.evaluate_pair(champ, chall, processed).to_dict()
        assert got == want


# ----------------------------------------------------------------------
# Gates.

@pytest.mark.parametrize("n", [0, 9, 150, 201, 3000])
def test_bootstrap_and_sign_test_equal_reference(n):
    rng = np.random.default_rng(n)
    d = rng.normal(0.05, 1.0, n)
    d[: n // 7] = 0.0  # ties
    for seed in (42, 7):
        assert gates.paired_bootstrap(d, n_boot=500, seed=seed) == \
            ref_gates.paired_bootstrap(d, n_boot=500, seed=seed)
    assert gates.sign_test(d) == ref_gates.sign_test(d)


def _report(mod, mean_delta, *, n=400, slices=None, drift_rep=None, seed=3):
    rng = np.random.default_rng(seed)
    deltas = rng.normal(mean_delta, 0.5, n)
    rep = {
        "mean_delta": float(deltas.mean()), "paired": True,
        "champion": {"loss_mean": 0.5},
        "challenger": {"loss_mean": 0.5 - float(deltas.mean())},
        "slice_regressions": slices or {},
        "bootstrap": mod.paired_bootstrap(deltas, seed=42),
        "sign_test": mod.sign_test(deltas),
    }
    if drift_rep is not None:
        rep["drift"] = drift_rep
    return rep


def test_decide_equal_reference():
    cases = [
        dict(mean_delta=-0.4), dict(mean_delta=0.0), dict(mean_delta=0.3),
        dict(mean_delta=0.1, slices={"label_rain": 0.5}),
        dict(mean_delta=0.1, drift_rep={"max_psi": 0.4, "any_drift": True}),
        dict(mean_delta=-0.02, n=60, seed=9),
    ]
    configs = [{}, {"require_improvement": True},
               {"min_improvement": 0.05, "confidence": 0.9},
               {"max_regression": 0.5}]
    disagreement = {"rate": 0.5, "exceeded": True}
    for kw in configs:
        mine = gates.PromotionGate(EvaluationConfig(**kw))
        ref = ref_gates.PromotionGate(RefEvaluationConfig(**kw))
        for case in cases:
            rep = _report(gates, **case)
            assert rep == _report(ref_gates, **case)
            for stage, dis in (("canary", disagreement),
                               ("full_rollout", None)):
                got = mine.decide(rep, stage=stage, disagreement=dis)
                want = ref.decide(rep, stage=stage, disagreement=dis)
                assert got.to_dict() == want.to_dict()
    unpaired = {"mean_delta": -0.2, "paired": False,
                "champion": {"loss_mean": 0.4},
                "challenger": {"loss_mean": 0.6}, "slice_regressions": {}}
    assert gates.PromotionGate(EvaluationConfig()).decide(
        unpaired, stage="canary").to_dict() == ref_gates.PromotionGate(
        RefEvaluationConfig()).decide(unpaired, stage="canary").to_dict()


def test_gate_evaluate_reports_decisions_and_ledger_equal_reference(
        tmp_path, processed):
    champion = _package(tmp_path, processed, "weather_mlp", 0, "champ")
    chall = _package(tmp_path, processed, "weather_mlp", 1, "chall")
    # One challenger copy each: the offline report is cached inside it.
    mine_dir, ref_dir = str(tmp_path / "mine"), str(tmp_path / "ref")
    shutil.copytree(chall, mine_dir)
    shutil.copytree(chall, ref_dir)
    cfg = dict(bootstrap_samples=400, seed=3)
    mine = gates.PromotionGate(EvaluationConfig(**cfg),
                               processed_dir=processed, device="cpu")
    ref = ref_gates.PromotionGate(RefEvaluationConfig(**cfg),
                                  processed_dir=processed)
    for stage in ("canary", "full_rollout"):
        got = mine.evaluate(challenger_dir=mine_dir, champion_dir=champion,
                            stage=stage)
        want = ref.evaluate(challenger_dir=ref_dir, champion_dir=champion,
                            stage=stage)
        assert got.to_dict() == want.to_dict()
        gates.record_decision(got, ledger_path=str(tmp_path / "l1.json"))
        ref_gates.record_decision(want, ledger_path=str(tmp_path / "l2.json"))
    with open(os.path.join(mine_dir, "eval_report.json")) as f:
        got_report = json.load(f)
    with open(os.path.join(ref_dir, "eval_report.json")) as f:
        want_report = json.load(f)
    assert got_report == want_report
    assert got_report["drift"] is not None and "bootstrap" in got_report
    with open(tmp_path / "l1.json") as f, open(tmp_path / "l2.json") as g:
        assert json.load(f) == json.load(g)
    # The report CLI renders the cached report as the reference's does.
    from dct_tpu.evaluation import report as ref_report
    from dct_tpu_torch.evaluation import report

    path = os.path.join(mine_dir, "eval_report.json")
    assert report.find_reports(str(tmp_path / "mine")) == [path]
    assert report.render_report(got_report, path) == \
        ref_report.render_report(got_report, path)
    assert report.main([str(tmp_path / "mine")]) == 0
    # No champion, and the champion being the challenger: promote.
    for m_champ, r_champ in ((None, None), (mine_dir, ref_dir)):
        got = mine.evaluate(challenger_dir=mine_dir, champion_dir=m_champ,
                            stage="canary")
        want = ref.evaluate(challenger_dir=ref_dir, champion_dir=r_champ,
                            stage="canary")
        assert got.to_dict() == want.to_dict()
    # No eval data: fail open or closed, as configured.
    for fail_open in (True, False):
        m_dir, r_dir = (str(tmp_path / f"{n}-{fail_open}")
                        for n in ("m", "r"))
        shutil.copytree(chall, m_dir)
        shutil.copytree(chall, r_dir)
        none = str(tmp_path / "none")
        got = gates.PromotionGate(
            EvaluationConfig(fail_open=fail_open), processed_dir=none,
            device="cpu").evaluate(challenger_dir=m_dir,
                                   champion_dir=champion, stage="canary")
        want = ref_gates.PromotionGate(
            RefEvaluationConfig(fail_open=fail_open),
            processed_dir=none).evaluate(challenger_dir=r_dir,
                                         champion_dir=champion,
                                         stage="canary")
        assert got.to_dict() == want.to_dict()
        assert got.promoted == fail_open


def test_gate_torch_engine_decides_as_numpy_engine(tmp_path, processed):
    champion = _package(tmp_path, processed, "weather_transformer", 0, "c")
    chall = _package(tmp_path, processed, "weather_transformer", 1, "h")
    shutil.copytree(chall, str(tmp_path / "h2"))
    decisions = []
    for engine, d in (("numpy", chall), ("torch", str(tmp_path / "h2"))):
        gate = gates.PromotionGate(
            EvaluationConfig(engine=engine, bootstrap_samples=300),
            processed_dir=processed, device="cpu")
        decisions.append(gate.evaluate(challenger_dir=d,
                                       champion_dir=champion, stage="canary"))
    a, b = (dec.evidence for dec in decisions)
    assert decisions[0].decision == decisions[1].decision
    assert abs(a["mean_delta"] - b["mean_delta"]) <= 1e-5


def test_gate_engine_env_and_ledger_path(monkeypatch, tmp_path):
    monkeypatch.setenv("DCT_GATE_ENGINE", "JAX")
    monkeypatch.setenv("DCT_GATE_BOOTSTRAP", "77")
    assert EvaluationConfig.from_env().engine == \
        RefEvaluationConfig.from_env().engine == "jax"
    import dataclasses

    assert dataclasses.asdict(EvaluationConfig.from_env()) == \
        dataclasses.asdict(RefEvaluationConfig.from_env())
    assert gates.gate_ledger_path() == ref_gates.gate_ledger_path() == \
        str(tmp_path / "events" / "gate_ledger.json")
    monkeypatch.setenv("DCT_GATE_LEDGER", "/x/l.json")
    assert gates.gate_ledger_path() == ref_gates.gate_ledger_path()
    assert gates.gate_ledger_path("/y") == "/y"


def test_log_eval_report_opens_its_own_run(tmp_path):
    path = str(tmp_path / "eval_report.json")
    report = {"champion": {"loss_mean": 0.5},
              "challenger": {"loss_mean": 0.4}, "mean_delta": 0.1}
    with open(path, "w") as f:
        json.dump(report, f)
    store = LocalTracking(root=str(tmp_path / "runs"))
    run_id = gates.log_eval_report(store, report, path)
    assert run_id and gates.log_eval_report(store, report, "") is None
    assert store.search_best_run("val_loss", "min") is None
