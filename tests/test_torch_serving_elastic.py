"""The port's elastic serving against the reference (CPU): admission
control and the autoscaler decide as the reference's classes do on the
same inputs; the server sheds 429 with ``Retry-After`` and keeps admitted
answers exact; the in-process autoscaler follows the queue; the ServerPool
scales, respawns, circuit-breaks and exports its proc index; the serve CLI
heals a crashed child and drains on SIGTERM; endpoint mode routes, pins,
mirrors and follows a stage flip mid-serve.

Every test that forks runs in its own interpreter with a time limit (a
fork from this multithreaded test process could hang), so a hang fails
one test, not the suite.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from dct_tpu.resilience.retry import Retrier as RefRetrier
from dct_tpu.serving.admission import AdmissionController as RefAdmission
from dct_tpu.serving.autoscale import Autoscaler as RefAutoscaler
from dct_tpu.serving.runtime import score_payload
from dct_tpu_torch.config import ServingConfig
from dct_tpu_torch.deploy.local import LocalEndpointClient
from dct_tpu_torch.observability.metrics import MetricsRegistry
from dct_tpu_torch.resilience import faults
from dct_tpu_torch.resilience.retry import Retrier
from dct_tpu_torch.serving import loadgen
from dct_tpu_torch.serving.admission import (
    CLASS_BUDGET_FRACTIONS,
    AdmissionController,
)
from dct_tpu_torch.serving.autoscale import (
    Autoscaler,
    PoolScaleTarget,
    controller_publisher,
)
from dct_tpu_torch.serving.package import init_package_weights, write_package
from dct_tpu_torch.serving.quant import quantize_weights
from dct_tpu_torch.serving.server import (
    make_endpoint_server,
    make_server_from_weights,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256


@pytest.fixture
def no_default_fault_plan():
    yield
    faults.set_default(None)


def _env(**extra):
    """The child's environment: no ``DCT_*`` of ours, the checkout on the
    path, one intra-op thread (small CPU forwards on a busy machine)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.update(extra)
    return env


# ----------------------------------------------------------------------
# Admission and the autoscaler: the same decisions as the reference.

_DECISIONS = [  # (class, queue rows, est wait s, deadline s)
    ("low", 49, None, None), ("low", 50, None, None), ("low", 60, None, None),
    ("normal", 79, None, None), ("normal", 80, 0.1, None),
    ("high", 99, None, None), ("high", 100, None, None),
    ("low", 0, 0.45, None), ("low", 0, 0.55, None), ("normal", 0, 0.85, None),
    ("high", 0, 0.95, None), ("high", 0, 1.05, None),
    ("high", 0, 0.5, 0.2), ("high", 0, 0.5, 0.9), ("low", 0, None, 0.001),
    ("vip", 85, None, None), ("low", 70, None, None), ("low", 70, None, None),
    ("low", 70, None, None), ("low", 10, None, None), ("low", 70, None, None),
]


@pytest.mark.parametrize("wait_ms", [1000.0, 0.0])
def test_admission_decisions_equal_reference(wait_ms):
    clock = [0.0]
    ours_ev, theirs_ev = [], []
    kw = dict(max_queue_rows=100, wait_budget_ms=wait_ms,
              event_interval_s=1.0, clock=lambda: clock[0])
    registry = MetricsRegistry()
    ours = AdmissionController(
        retrier=Retrier(backoff_s=0.1, jitter=0.25, rng=lambda: 0.5),
        emit=lambda c, e, **f: ours_ev.append((c, e, f)),
        metrics_registry=registry, **kw)
    theirs = RefAdmission(
        retrier=RefRetrier(backoff_s=0.1, jitter=0.25, rng=lambda: 0.5),
        emit=lambda c, e, **f: theirs_ev.append((c, e, f)), **kw)
    decided = []
    for cls, q, wait, deadline in _DECISIONS:
        clock[0] += 0.4
        a = ours.decide(cls, q, wait, deadline_s=deadline)
        b = theirs.decide(cls, q, wait, deadline_s=deadline)
        assert vars(a) == vars(b), (cls, q, wait, deadline)
        decided.append(a)
    assert ours_ev == theirs_ev and ours_ev
    assert ours.shed_total() == theirs.shed_total() > 0
    assert ours.shed_counts() == theirs.shed_counts()
    for headers in ({"x-dct-priority": "HIGH"}, {"x-dct-priority": "vip"},
                    {}, {"x-dct-deadline-ms": "250"},
                    {"x-dct-deadline-ms": "nope"}):
        assert ours.parse_class(headers) == theirs.parse_class(headers)
        assert (ours.parse_deadline_s(headers)
                == theirs.parse_deadline_s(headers))
    text = registry.render()
    low_sheds = sum(not d.admitted for d in decided if d.cls == "low")
    assert f'dct_serve_shed_total{{class="low"}} {low_sheds}' in text
    assert 'dct_serve_admitted_total{class="high"}' in text
    assert set(CLASS_BUDGET_FRACTIONS) == {"high", "normal", "low"}


class _Target:
    gauge_name = "dct_serve_procs"

    def __init__(self, size):
        self.size = size
        self.calls = []

    def current(self):
        return self.size

    def scale_to(self, n):
        self.calls.append(n)
        self.size = n


_SIGNALS = (
    [(50, False, 0.0)] * 3 + [(0, False, 0.0), (20, False, 0.0)] * 4
    + [(0, True, 0.0), (0, False, 5.0)] + [(50, False, 0.0)] * 6
    + [(0, False, 0.0)] * 12 + [(1, False, 0.0), (3, False, 0.0)] * 3
)


@pytest.mark.parametrize("hyst,cooldown", [(2, 5.0), (1, 0.0), (3, 1.5)])
def test_autoscaler_decisions_equal_reference(hyst, cooldown):
    runs = []
    for cls in (Autoscaler, RefAutoscaler):
        clock = [0.0]
        events = []
        t = _Target(2)
        a = cls(t, min_size=1, max_size=4, up_queue_rows=10,
                down_queue_rows=2, hysteresis_polls=hyst,
                cooldown_s=cooldown, clock=lambda: clock[0],
                emit=lambda c, e, **f: events.append((e, f)))
        dirs = []
        for q, slo, shed in _SIGNALS:
            clock[0] += 1.0
            dirs.append(a.observe(q, slo_burning=slo, shed_rate=shed))
        runs.append((dirs, t.calls, events, a.events))
    assert runs[0] == runs[1]
    assert runs[0][3] > 0


def test_autoscaler_gauge_reaches_the_metrics_plane(tmp_path, monkeypatch):
    from dct_tpu_torch.observability.aggregate import aggregate_text

    monkeypatch.setenv("DCT_METRICS_DIR", str(tmp_path / "m"))

    class _FakePool:
        def size(self):
            return 3

    registry = MetricsRegistry()
    Autoscaler(PoolScaleTarget(_FakePool()), registry=registry)
    publisher = controller_publisher(registry, proc="serve-ctl-test")
    try:
        publisher.publish()
        text, merged = aggregate_text(str(tmp_path / "m"), stale_s=0)
        assert merged.value("dct_serve_procs") == 3
        assert 'proc="serve-ctl-test"' in text
    finally:
        publisher.close()


# ----------------------------------------------------------------------
# The live server: sheds, exact admitted answers, in-process autoscaling.


def _serve(serving, weights=None, meta=None):
    if weights is None:
        weights, meta = loadgen.synthetic_mlp()
    server = make_server_from_weights(weights, meta, serving=serving,
                                      device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()


def test_server_sheds_429_with_retry_after_on_one_scrape(
        tmp_path, monkeypatch, no_default_fault_plan):
    monkeypatch.setenv("DCT_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("DCT_METRICS_PUBLISH_S", "0.05")
    serving = ServingConfig(max_batch=1, workers=1, admit=True,
                            admit_max_queue=2, admit_wait_ms=20.0,
                            retry_after_s=0.02, engine="numpy")
    faults.set_default(faults.FaultPlan.parse("slow_score:ms25"))
    server = _serve(serving)
    host, port = server.server_address[:2]
    statuses, headers, bodies = [], [], []

    def one(_):
        import http.client

        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request("POST", "/score",
                         json.dumps({"data": [[0.1] * 5]}).encode(),
                         {"x-dct-priority": "low"})
            resp = conn.getresponse()
            raw = resp.read()
            statuses.append(resp.status)
            if resp.status == 429:
                headers.append(resp.getheader("Retry-After"))
                bodies.append(json.loads(raw))
        finally:
            conn.close()

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(14)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert statuses.count(429) >= 1 and statuses.count(200) >= 1
        assert all(h.isdigit() and int(h) >= 1 for h in headers)
        assert all(b["retry_after_s"] > 0 and b["priority"] == "low"
                   for b in bodies)
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=10).read().decode()
        assert 'dct_serve_shed_total{class="low"}' in text
        assert "dct_serve_admitted_total" in text
        assert f'proc="serve-{os.getpid()}"' in text
    finally:
        _stop(server)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_admitted_answers_equal_the_unarmed_server(engine):
    weights, meta = loadgen.synthetic_mlp()
    rows = np.random.default_rng(11).standard_normal((8, 5)).astype(
        np.float32)
    got = {}
    for armed in (False, True):
        serving = ServingConfig(max_batch=8, workers=2, engine=engine,
                                admit=armed, autoscale=armed, scale_min=1,
                                scale_max=3, scale_poll_s=0.1)
        server = _serve(serving, weights, meta)
        host, port = server.server_address[:2]
        try:
            out = []
            for row in rows:
                client = loadgen._Client(host, port,
                                         headers={"x-dct-priority": "high"})
                try:
                    status, body = client.post(
                        json.dumps({"data": [row.tolist()]}).encode())
                finally:
                    client.close()
                assert status == 200
                out.append(json.loads(body)["probabilities"])
            got[armed] = np.asarray(out, np.float32)
        finally:
            _stop(server)
    assert np.array_equal(got[False], got[True])
    if engine == "numpy":
        want = np.asarray([score_payload(weights, meta, [r.tolist()])
                           ["probabilities"] for r in rows], np.float32)
        assert np.array_equal(got[True], want)


def test_in_process_autoscaler_follows_the_queue(no_default_fault_plan):
    serving = ServingConfig(max_batch=1, workers=1, engine="numpy",
                            autoscale=True, scale_min=1, scale_max=3,
                            scale_poll_s=0.05, scale_up_queue=2,
                            scale_down_queue=0, scale_hysteresis=1,
                            scale_cooldown_s=0.1)
    faults.set_default(faults.FaultPlan.parse("slow_score:ms40"))
    server = _serve(serving)
    host, port = server.server_address[:2]
    peak = [1]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            peak[0] = max(peak[0], server.batcher.workers)
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        out = loadgen.run_closed_loop(
            host, port, json.dumps({"data": [[0.0] * 5]}).encode(),
            concurrency=8, total_requests=60, duration_s=20.0)
        assert out["errors"] == 0 and out["requests"] == 60
        assert peak[0] > 1
        deadline = time.time() + 10
        while server.batcher.workers > 1 and time.time() < deadline:
            time.sleep(0.05)
        assert server.batcher.workers == 1
        text = server.slot_metrics.registry.render()
        assert "dct_serve_workers" in text
    finally:
        stop.set()
        _stop(server)


def test_unported_planes_answer_or_raise(monkeypatch):
    server = _serve(ServingConfig(workers=1, engine="numpy"))
    host, port = server.server_address[:2]
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://{host}:{port}/debug/profile",
                                   timeout=10)
        assert e.value.code == 501 and "item 19" in e.value.read().decode()
    finally:
        _stop(server)
    monkeypatch.setenv("DCT_SLO_SPEC", "availability:0.999")
    with pytest.raises(NotImplementedError, match="item 27"):
        make_server_from_weights(*loadgen.synthetic_mlp(), device="cpu",
                                 serving=ServingConfig(engine="numpy"))


# ----------------------------------------------------------------------
# The pool, each drill in its own interpreter.

_POOL_PRELUDE = '''
import json, os, signal, sys, threading, time
from dct_tpu_torch.resilience.supervisor import RestartPolicy
from dct_tpu_torch.serving.server import ServerPool

class SleepServer:
    def serve_forever(self):
        out = os.environ.get("IDX_DIR")
        if out:  # published whole: the parent lists, then reads
            path = os.path.join(out, os.environ["DCT_SERVE_PROC_INDEX"])
            with open(path + ".tmp", "w") as f:
                f.write(os.environ["DCT_PROCESS_ID"])
            os.replace(path + ".tmp", path)
        while True:
            time.sleep(3600)
    def shutdown(self):
        os._exit(0)
    def server_close(self):
        pass

events = []
def pool(processes=2, policy=None):
    return ServerPool(lambda h, p, reuse_port: SleepServer(),
                      processes=processes, restart_policy=policy,
                      emit=lambda c, e, **f: events.append((e, f)))

def wait_in_thread(p):
    rc = [None]
    t = threading.Thread(target=lambda: rc.__setitem__(0, p.wait()),
                         daemon=True)
    t.start()
    return rc, t

def eventually(cond, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()

def names():
    return [e for e, _ in events]
'''

_POOL_DRILLS = {
    "scale_down_is_not_child_death": '''
out = {}
for label, policy in (("none", None),
                      ("policy", RestartPolicy(max_restarts=2, backoff_s=0.05))):
    events.clear()
    p = pool(3, policy)
    rc, t = wait_in_thread(p)
    victims = p.scale_down(1)
    shrunk = eventually(lambda: p.size() == 2)
    time.sleep(0.2)
    still = rc[0] is None
    drained = eventually(lambda: "serve.pool_drained" in names())
    p.close()
    t.join(10)
    out[label] = [len(victims), shrunk, still, drained,
                  "serve.pool_child_death" in names(), rc[0]]
print(json.dumps(out))
''',
    "scale_down_never_drains_the_last_child": '''
p = pool(2)
first = len(p.scale_down(5))
one = eventually(lambda: p.size() == 1)
again = p.scale_down(1)
p.close()
print(json.dumps([first, one, again]))
''',
    "scale_up_adds_capacity": '''
p = pool(2)
rc, t = wait_in_thread(p)
pids = p.scale_up(2)
size = p.size()
p.close()
t.join(10)
print(json.dumps([len(pids), size, names().count("serve.pool_spawn"), rc[0]]))
''',
    "respawn_with_backoff_then_circuit_break": '''
p = pool(2, RestartPolicy(max_restarts=1, backoff_s=0.05, jitter=0.0))
rc, t = wait_in_thread(p)
os.kill(p.pids[0], signal.SIGKILL)
healed = eventually(lambda: "serve.pool_respawn" in names())
size, alive = p.size(), rc[0] is None
respawn = [f for e, f in events if e == "serve.pool_respawn"][0]
os.kill(p.pids[0], signal.SIGKILL)
t.join(10)
p.close()
print(json.dumps([healed, size, alive, respawn["backoff_s"],
                  respawn["classification"], rc[0],
                  "serve.pool_circuit_open" in names(), p.circuit_open]))
''',
    "without_policy_first_death_is_fatal": '''
p = pool(2)
rc, t = wait_in_thread(p)
os.kill(p.pids[0], signal.SIGKILL)
t.join(10)
p.close()
print(json.dumps([rc[0], "serve.pool_child_death" in names()]))
''',
    "child_exports_proc_index": '''
out = os.environ["IDX_DIR"]
p = pool(2)
ok = eventually(lambda: sorted(n for n in os.listdir(out)
                               if not n.endswith(".tmp")) == ["0", "1"])
vals = [open(os.path.join(out, n)).read() for n in ("0", "1")]
p.close()
print(json.dumps([ok, vals]))
''',
}

_POOL_EXPECT = {
    "scale_down_is_not_child_death": {"none": [1, True, True, True, False, 0],
                                      "policy": [1, True, True, True, False,
                                                 0]},
    "scale_down_never_drains_the_last_child": [1, True, []],
    "scale_up_adds_capacity": [2, 4, 2, 0],
    "respawn_with_backoff_then_circuit_break": [True, 2, True, 0.05, "crash",
                                                1, True, True],
    "without_policy_first_death_is_fatal": [1, True],
    "child_exports_proc_index": [True, ["0", "1"]],
}


@pytest.mark.parametrize("drill", sorted(_POOL_DRILLS))
def test_pool_drill(drill, tmp_path):
    idx = tmp_path / "idx"
    idx.mkdir()
    r = subprocess.run([sys.executable, "-c",
                        _POOL_PRELUDE + _POOL_DRILLS[drill]],
                       env=_env(IDX_DIR=str(idx)), capture_output=True,
                       text=True, timeout=90)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == _POOL_EXPECT[drill]


def test_pool_close_drains_a_child_sigtermed_before_its_handler(tmp_path):
    """A child forked with SIGTERM ignored (inherited from the pool's
    process) and slow to install its drain handler gets ``close()``'s
    SIGTERM before the handler is there: the child holds SIGTERM blocked
    until then, so the signal waits and drains it, and the pool neither
    hangs nor needs SIGKILL."""
    drill = _POOL_PRELUDE + '''
signal.signal(signal.SIGTERM, signal.SIG_IGN)
os.register_at_fork(after_in_child=lambda: time.sleep(0.5))
p = pool(2)
rc, t = wait_in_thread(p)
pids = p.scale_up(2)
size = p.size()
t0 = time.monotonic()
p.close()
took = time.monotonic() - t0
t.join(10)
print(json.dumps([len(pids), size, rc[0], "serve.pool_kill" in names(),
                  took < 10]))
'''
    r = subprocess.run([sys.executable, "-c", drill], env=_env(),
                       capture_output=True, text=True, timeout=90)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        [2, 4, 0, False, True]


def _post(port, data, path="/score", timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps({"data": data}).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _events(path):
    try:
        with open(path) as f:
            return [json.loads(line) for line in f]
    except OSError:
        return []


def test_serve_cli_pool_heals_a_crashed_child_and_drains(tmp_path):
    """``DCT_SERVE_PROCS=2`` on the CPU: both procs answer (two ``proc``
    series on one scrape), ``crash_worker@proc1`` kills child 1 at its
    second scored request, the pool respawns it and traffic continues,
    and SIGTERM drains to exit 0."""
    meta = dict(model="weather_transformer", name="weather_transformer",
                input_dim=5, seq_len=S, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, num_classes=2, horizon=1)
    pkg = str(tmp_path / "pkg")
    write_package(pkg, init_package_weights(meta, 0), meta)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    events_dir = tmp_path / "events"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.serve"],
        env=_env(DCT_DEVICE="cpu", DCT_PACKAGE_DIR=pkg,
                 DCT_SERVE_HOST="127.0.0.1", DCT_SERVE_PORT=str(port),
                 DCT_SERVE_PROCS="2", DCT_SERVE_WORKERS="1",
                 DCT_METRICS_DIR=str(tmp_path / "metrics"),
                 DCT_METRICS_PUBLISH_S="0.1", DCT_EVENTS_DIR=str(events_dir),
                 DCT_FAULT_SPEC="crash_worker@proc1:req2",
                 DCT_SERVE_MAX_RESTARTS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path))
    try:
        x = np.random.default_rng(0).standard_normal((1, S, 5)).tolist()
        deadline = time.time() + 120
        answered = 0
        while time.time() < deadline:
            ev = [e["event"] for e in _events(events_dir / "events.jsonl")]
            if "serve.pool_respawn" in ev and answered >= 12:
                break
            try:
                out = _post(port, x)
                assert np.isfinite(out["probabilities"]).all()
                answered += 1
            except (OSError, ValueError):
                time.sleep(0.1)  # not bound yet, or the torn connection
        ev = _events(events_dir / "events.jsonl")
        names = [e["event"] for e in ev]
        assert "fault.injected" in names
        assert "serve.pool_child_death" in names, names
        assert "serve.pool_respawn" in names, names
        death = [e for e in ev if e["event"] == "serve.pool_child_death"][0]
        assert death["index"] == 1 and death["classification"] == "crash"
        for _ in range(4):
            _post(port, x)
        procs = set()
        deadline = time.time() + 60
        while len(procs) < 2 and time.time() < deadline:
            _post(port, x)
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
            procs = {line.split('proc="')[1].split('"')[0]
                     for line in text.splitlines()
                     if line.startswith("dct_requests_total{") and "proc=" in line}
        assert len(procs) >= 2, text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# ----------------------------------------------------------------------
# Endpoint mode.


def test_endpoint_routes_pins_mirrors_and_follows_a_flip(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("DCT_MIRROR_CAPTURE", raising=False)
    meta = dict(model="weather_transformer_causal",
                name="weather_transformer_causal", input_dim=5, seq_len=S,
                d_model=32, n_heads=2, n_layers=2, d_ff=64, num_classes=2,
                horizon=1)
    weights = init_package_weights(meta, 1)
    blue, green = str(tmp_path / "blue"), str(tmp_path / "green")
    write_package(blue, weights, meta)
    write_package(green, *quantize_weights(weights, meta, "int8"))
    state = str(tmp_path / "state.json")
    client = LocalEndpointClient(state_path=state)
    client.create_endpoint("ep")
    client.deploy("ep", "blue", blue)
    client.deploy("ep", "green", green)
    client.set_traffic("ep", {"blue": 50, "green": 50})
    client.set_mirror_traffic("ep", {"green": 100})
    server = make_endpoint_server("ep", state_path=state, device="cpu",
                                  serving=ServingConfig(workers=2))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    x = np.random.default_rng(5).standard_normal((2, S, 5)).astype(np.float32)
    try:
        slots = [_post(port, x.tolist())["slot"] for _ in range(24)]
        assert set(slots) == {"blue", "green"}
        pinned = _post(port, x.tolist(), path="/score?slot=green")
        assert pinned["slot"] == "green"
        ref = np.asarray(score_payload(weights, meta, x.tolist())
                         ["probabilities"])
        pb = _post(port, x.tolist(), path="/score?slot=blue")
        np.testing.assert_allclose(pb["probabilities"], ref, atol=1e-5)
        assert np.abs(np.asarray(pinned["probabilities"]) - ref).max() < 0.05
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, x.tolist(), path="/score?slot=red")
        assert e.value.code == 404
        # A stage flip written to the state JSON applies to the next request.
        flip = LocalEndpointClient(state_path=state)
        flip.set_traffic("ep", {"blue": 0, "green": 100})
        assert {_post(port, x.tolist())["slot"] for _ in range(6)} == {"green"}
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert 'dct_requests_total{slot="blue"}' in text
        assert 'dct_requests_total{slot="green"}' in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["traffic"] == {"blue": 0, "green": 100}
        assert health["metrics"]["green"]["requests"] >= 7
    finally:
        _stop(server)
    with open(state + "_mirror.jsonl") as f:
        mirrored = [json.loads(line) for line in f]
    # Every blue-served request shadowed to green, after its reply.
    assert mirrored and all(m["live_slot"] == "blue"
                            and m["shadow_slot"] == "green" for m in mirrored)
    assert len(mirrored) == slots.count("blue") + 1


@pytest.mark.parametrize("mode", ["checkpoint", "endpoint"])
def test_serve_cli_checkpoint_and_endpoint_modes(mode, tmp_path):
    """``python -m dct_tpu_torch.serve`` over ``DCT_CKPT`` (the newest
    checkpoint rule is pinned in ``tests/test_torch_predict.py``) and over
    a rollout endpoint (``DCT_ENDPOINT_NAME``): answers equal the numpy
    runtime's within 1e-5, SIGTERM exits 0 with the launch counts."""
    import socket

    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.score_gen import generate_score_package

    meta = dict(model="weather_transformer", name="weather_transformer",
                input_dim=5, seq_len=S, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, num_classes=2, horizon=1)
    ckpt = save_checkpoint(str(tmp_path / "last.ckpt"),
                           get_model(config_from_meta(meta), device="cpu"),
                           meta)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = dict(DCT_DEVICE="cpu", DCT_SERVE_HOST="127.0.0.1",
                 DCT_SERVE_PORT=str(port), DCT_METRICS_DIR="")
    if mode == "checkpoint":
        extra["DCT_CKPT"] = ckpt
    else:
        pkg = str(tmp_path / "pkg")
        generate_score_package(ckpt, pkg)
        state = str(tmp_path / "state.json")
        client = LocalEndpointClient(state_path=state)
        client.create_endpoint("ep")
        client.deploy("ep", "blue", pkg)
        client.set_traffic("ep", {"blue": 100})
        extra.update(DCT_ENDPOINT_NAME="ep", DCT_LOCAL_ENDPOINT_STATE=state)
    proc = subprocess.Popen([sys.executable, "-m", "dct_tpu_torch.serve"],
                            env=_env(**extra), cwd=str(tmp_path), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    x = np.random.default_rng(4).standard_normal((2, S, 5)).astype(np.float32)
    try:
        deadline = time.time() + 120
        while True:
            try:
                got = _post(port, x.tolist())
                break
            except OSError:
                assert time.time() < deadline and proc.poll() is None
                time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    weights, _ = weights_from_checkpoint(ckpt)
    ref = np.asarray(score_payload(weights, meta, x.tolist())["probabilities"])
    np.testing.assert_allclose(got["probabilities"], ref, atol=1e-5)
    assert got.get("slot") == ("blue" if mode == "endpoint" else None)
    assert f"({mode})" in out and "[serve] launches" in out
