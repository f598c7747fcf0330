"""The port's rollout against ``tests/test_deploy.py``'s expectations and
the reference's own orchestrator (CPU).

The same sequence of rollouts goes through the port's
``RolloutOrchestrator`` on its ``LocalEndpointClient`` and through the
reference's on its own: the stages with their traffic and mirror maps, the
control-plane calls, first / second / third rollouts, failed-endpoint
recreation, gate-driven rollback and hold, and a control plane that flakes.
Packages come from port checkpoints (numpy-seeded weights); a port-built
package is served by the reference's ``LocalEndpointClient`` within 1e-6 of
the port's, and the port's packaging writes the reference's manifest.
"""

import json
import os

import numpy as np
import pytest
import torch

from dct_tpu.config import EvaluationConfig as RefEvaluationConfig
from dct_tpu.continuous.evaluator import package_checkpoint as ref_package
from dct_tpu.deploy.local import LocalEndpointClient as RefClient
from dct_tpu.deploy.rollout import RolloutOrchestrator as RefOrchestrator
from dct_tpu.evaluation.gates import GateDecision as RefDecision
from dct_tpu.evaluation.gates import GateRejection as RefRejection
from dct_tpu_torch.checkpoint.manager import param_tree, save_checkpoint
from dct_tpu_torch.config import EvaluationConfig, ModelConfig
from dct_tpu_torch.continuous.evaluator import package_checkpoint
from dct_tpu_torch.convert import init_flax_weights, load_flax_weights
from dct_tpu_torch.deploy.local import LocalEndpointClient
from dct_tpu_torch.deploy.rollout import (
    BLUE,
    GREEN,
    RolloutOrchestrator,
    choose_slot,
    package_manifest,
    prepare_package,
)
from dct_tpu_torch.evaluation.gates import GateDecision, GateRejection
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.serving.score_gen import generate_score_package
from dct_tpu_torch.tracking.client import LocalTracking

FEATURES = [f"f{i}" for i in range(5)]
META = {"model": "weather_mlp", "input_dim": 5, "hidden_dim": 64,
        "num_classes": 2, "dropout": 0.2, "feature_names": FEATURES}


@pytest.fixture(autouse=True)
def _quiet_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("DCT_LINEAGE", "0")
    monkeypatch.setenv("DCT_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.delenv("DCT_MIRROR_CAPTURE", raising=False)


def _ckpt(tmp_path, name: str, seed: int) -> str:
    model = get_model(ModelConfig(), input_dim=5, device="cpu")
    load_flax_weights(model, init_flax_weights(model, seed))
    return save_checkpoint(str(tmp_path / f"{name}.ckpt"),
                           param_tree(model), META)


def _package(tmp_path, name="pkg", seed=0) -> str:
    deploy = str(tmp_path / name)
    generate_score_package(_ckpt(tmp_path, name, seed), deploy)
    return deploy


def _stages(events):
    return [(e.stage, e.traffic, e.mirror) for e in events]


def _both(**kwargs):
    soaks = {"port": [], "ref": []}
    port = lambda c: RolloutOrchestrator(  # noqa: E731
        c, "weather-ep", sleep_fn=soaks["port"].append, **kwargs)
    ref = lambda c: RefOrchestrator(  # noqa: E731
        c, "weather-ep", sleep_fn=soaks["ref"].append, **kwargs)
    return port, ref, soaks


def test_choose_slot():
    assert choose_slot({}) == (BLUE, None)
    assert choose_slot({"blue": 0, "green": 0}) == (BLUE, None)
    assert choose_slot({"blue": 100}) == (GREEN, "blue")
    assert choose_slot({"green": 90, "blue": 10}) == (BLUE, "green")


def test_first_second_third_rollouts_match_reference(tmp_path):
    pkgs = [_package(tmp_path, f"v{i}", seed=i) for i in range(3)]
    port_client, ref_client = LocalEndpointClient(), RefClient()
    port, ref, soaks = _both(soak_seconds=30)
    for i, pkg in enumerate(pkgs):
        got = _stages(port(port_client).run(pkg))
        want = _stages(ref(ref_client).run(pkg))
        assert got == want
        if i == 0:  # first: straight to 100%
            assert [s for s, _, _ in got] == ["deploy_new_slot",
                                              "full_rollout"]
            assert port_client.get_traffic("weather-ep") == {BLUE: 100}
        if i == 1:  # second: shadow, canary, full on green
            stages = {s: (t, m) for s, t, m in got}
            assert stages["shadow"] == ({BLUE: 100, GREEN: 0}, {GREEN: 20})
            assert stages["canary"] == ({BLUE: 90, GREEN: 10}, {})
            assert stages["full_rollout"] == ({GREEN: 100}, {})
            assert port_client.list_deployments("weather-ep") == [GREEN]
    # third: back to blue, the old slot deleted
    assert port_client.get_traffic("weather-ep") == {BLUE: 100}
    assert port_client.list_deployments("weather-ep") == [BLUE]
    assert port_client.ops == ref_client.ops
    assert soaks["port"] == soaks["ref"] == [30, 30, 30, 30]


def test_failed_endpoint_recreated_like_reference(tmp_path):
    pkg = _package(tmp_path)
    clients = []
    for client, orch in ((LocalEndpointClient(), RolloutOrchestrator),
                         (RefClient(), RefOrchestrator)):
        client.create_endpoint("ep")
        client.endpoints["ep"].provisioning_state = "Failed"
        orch(client, "ep", sleep_fn=lambda s: None).run(pkg)
        assert ("delete_endpoint", "ep") in client.ops
        assert client.get_traffic("ep") == {BLUE: 100}
        clients.append(client)
    assert clients[0].ops == clients[1].ops


class _StubGate:
    def __init__(self, decision_cls, cfg, decision):
        self.cfg = cfg
        self._cls = decision_cls
        self._decision = decision

    def evaluate(self, *, challenger_dir, champion_dir, stage,
                 mirror_capture=None, shadow_slot=None):
        return self._cls(self._decision, stage, "stub")


@pytest.mark.parametrize("decision", ["rollback", "hold", "promote"])
def test_gated_rollout_and_rollback_match_reference(tmp_path, decision):
    v1, v2 = _package(tmp_path, "v1", 0), _package(tmp_path, "v2", 1)
    results = []
    for client, orch, cls, rej, cfg in (
            (LocalEndpointClient(), RolloutOrchestrator, GateDecision,
             GateRejection, EvaluationConfig()),
            (RefClient(), RefOrchestrator, RefDecision, RefRejection,
             RefEvaluationConfig())):
        orch(client, "ep", sleep_fn=lambda s: None).run(v1)
        ro = orch(client, "ep", sleep_fn=lambda s: None,
                  gate=_StubGate(cls, cfg, decision))
        if decision == "promote":
            ro.run(v2)
        else:
            with pytest.raises(rej) as info:
                ro.run(v2)
            assert info.value.decision.stage == "canary"
        results.append((_stages(ro.events), client.get_traffic("ep"),
                        client.get_mirror_traffic("ep"), client.ops))
    assert results[0] == results[1]
    stages, traffic, mirror, _ = results[0]
    if decision == "promote":
        assert traffic == {GREEN: 100}
        assert [s for s, _, _ in stages] == [
            "deploy_new_slot", "shadow", "gate_canary", "canary",
            "gate_full_rollout", "full_rollout"]
    else:  # reverted to the champion before any live traffic moved
        assert traffic == {BLUE: 100} and mirror == {}
        assert [s for s, _, _ in stages][-2:] == ["gate_canary", "rollback"]


def test_flaky_control_plane_retries_then_reverts_like_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DCT_RETRY_BACKOFF_S", "0")
    v1, v2 = _package(tmp_path, "v1", 0), _package(tmp_path, "v2", 1)

    def flaky(client, fail_on):
        real = client.set_traffic
        seen = {"n": 0}

        def set_traffic(endpoint, traffic):
            seen["n"] += 1
            if seen["n"] in fail_on:
                raise ConnectionError("503 Service Unavailable")
            return real(endpoint, traffic)

        client.set_traffic = set_traffic
        return client

    outcomes = []
    for client, orch in ((LocalEndpointClient(), RolloutOrchestrator),
                         (RefClient(), RefOrchestrator)):
        orch(client, "ep", sleep_fn=lambda s: None).run(v1)
        # One transient failure: retried, the rollout completes.
        flaky(client, {2})
        orch(client, "ep", sleep_fn=lambda s: None).run(v2)
        ok = client.get_traffic("ep")
        # Canary's set_traffic fails on every attempt: reverted, raised.
        flaky(client, set(range(2, 99)))
        ro = orch(client, "ep", sleep_fn=lambda s: None)
        with pytest.raises(ConnectionError):
            ro.run(v1)
        outcomes.append((ok, client.get_traffic("ep"), _stages(ro.events)))
    assert outcomes[0] == outcomes[1]


def test_port_package_served_by_reference_client(tmp_path):
    pkg = _package(tmp_path, "v1", seed=3)
    x = np.random.default_rng(0).standard_normal((16, 5)).astype(np.float32)
    port_client, ref_client = LocalEndpointClient(), RefClient()
    for client, orch in ((port_client, RolloutOrchestrator),
                         (ref_client, RefOrchestrator)):
        orch(client, "ep", sleep_fn=lambda s: None).run(pkg)
    got = np.asarray(port_client.score("ep", {"data": x.tolist()})[
        "probabilities"])
    want = np.asarray(ref_client.score("ep", {"data": x.tolist()})[
        "probabilities"])
    assert got.shape == (16, 2)
    assert float(np.abs(got - want).max()) <= 1e-6
    # ... and both answer what the port's model computes.
    model = get_model(ModelConfig(), input_dim=5, device="cpu")
    from dct_tpu_torch.checkpoint.manager import flatten_tree, load_checkpoint

    params, _ = load_checkpoint(str(tmp_path / "v1.ckpt"))
    load_flax_weights(model, flatten_tree(params["params"]))
    with torch.no_grad():
        direct = torch.softmax(model(torch.from_numpy(x)), -1).numpy()
    assert float(np.abs(got - direct).max()) <= 1e-6


def test_state_persistence_and_mirror_capture_match_reference(
        tmp_path, monkeypatch):
    v1, v2 = _package(tmp_path, "v1", 0), _package(tmp_path, "v2", 1)
    captures = []
    for name, client_cls, orch in (("port", LocalEndpointClient,
                                    RolloutOrchestrator),
                                   ("ref", RefClient, RefOrchestrator)):
        state = str(tmp_path / f"{name}-state.json")
        orch(client_cls(state_path=state), "ep",
             sleep_fn=lambda s: None).run(v1)
        # A new process sees the deployed champion.
        client = client_cls(state_path=state)
        assert client.get_traffic("ep") == {BLUE: 100}
        ro = orch(client, "ep", sleep_fn=lambda s: None)
        new, old = ro.deploy_new_slot(v2)
        ro.start_shadow(new, old)
        x = np.random.default_rng(1).standard_normal((3, 5)).tolist()
        client.score("ep", {"data": x})
        with open(client.mirror_capture_path) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            r.pop("ts")
        captures.append(recs)
        with open(state) as f:
            captures.append(json.load(f))
    assert captures[0] == captures[2] and captures[1] == captures[3]
    assert captures[0][0]["shadow_slot"] == GREEN


def test_packaging_writes_the_reference_manifest(tmp_path, monkeypatch):
    from dct_tpu.data.synthetic import generate_weather_csv
    from dct_tpu.etl.preprocess import preprocess_csv_to_parquet

    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=600, seed=2)
    proc = str(tmp_path / "proc")
    preprocess_csv_to_parquet(csv, proc)
    ckpt = _ckpt(tmp_path, "best", 4)
    got = package_checkpoint(ckpt, str(tmp_path / "port"),
                             processed_dir=proc)
    want = ref_package(ckpt, str(tmp_path / "ref"), processed_dir=proc)
    assert got == want and got["data_snapshot"] is not None
    assert package_manifest(str(tmp_path / "port")) == package_manifest(
        str(tmp_path / "ref"))
    for name in ("model.npz", "model_meta.json", "score.py"):
        assert open(tmp_path / "port" / name, "rb").read() == open(
            tmp_path / "ref" / name, "rb").read(), name


def test_prepare_package_selects_best_run(tmp_path, monkeypatch):
    store = LocalTracking(root=str(tmp_path / "runs"))
    for val_loss, seed in ((0.9, 1), (0.2, 2)):
        d = tmp_path / f"w-{seed}"
        d.mkdir()
        ckpt = _ckpt(d, f"weather-best-00-{val_loss:.2f}", seed)
        store.start_run(params={"seed": seed, "val_fraction": 0.25})
        store.log_metrics({"val_loss": val_loss, "val_acc": 0.5}, step=1)
        store.log_artifact(ckpt, "best_checkpoints")
        store.end_run()
    info = prepare_package(store, str(tmp_path / "deploy"),
                           data_dir=str(tmp_path / "none"))
    assert abs(info["val_loss"] - 0.2) < 1e-9
    for f in ("model.ckpt", "model.npz", "model_meta.json", "score.py",
              "conda.yaml", "run_info.json"):
        assert os.path.exists(tmp_path / "deploy" / f), f
    manifest = package_manifest(str(tmp_path / "deploy"))
    assert manifest["split"] == {"seed": 2, "val_fraction": 0.25}
    assert manifest["data_snapshot"] is None
    RolloutOrchestrator(LocalEndpointClient(), "ep",
                        sleep_fn=lambda s: None).run(str(tmp_path / "deploy"))
    with pytest.raises(RuntimeError, match="No finished runs"):
        prepare_package(LocalTracking(root=str(tmp_path / "empty")),
                        str(tmp_path / "d2"))
