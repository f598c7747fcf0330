"""Local endpoint client: the test/local-platform deployment target
(counterpart of ``dct_tpu/deploy/local.py``).

Implements the full :class:`~dct_tpu_torch.deploy.rollout.EndpointClient` surface
with real serving semantics — ``score()`` actually loads the deployed
package's model.npz and answers inference requests — so the whole
train->track->package->rollout->infer path runs hermetically (the reference
can only exercise this against a live Azure subscription).

With ``state_path`` set (or ``DCT_LOCAL_ENDPOINT_STATE`` in the env), the
control-plane state (endpoints, traffic maps, slot->package bindings) is
persisted as JSON after every mutation and reloaded on construction, so the
rollout DAG's stages see each other's state even when the orchestrator runs
every task in a fresh process (as real Airflow does). Deployment weights are
not serialized — they reload lazily from the deployed package directory.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class _Deployment:
    package_dir: str
    _weights: dict | None = None
    _meta: dict | None = None

    def load(self) -> tuple[dict, dict]:
        if self._weights is None:
            import numpy as np

            from dct_tpu_torch.serving.numpy_runtime import assemble_weights

            npz = np.load(os.path.join(self.package_dir, "model.npz"))
            # Quantized packages reconstitute (::q8/::scale/::bf16 key
            # pairs -> QuantTensor / widened f32); plain packages pass
            # through unchanged.
            self._weights = assemble_weights({k: npz[k] for k in npz.files})
            with open(os.path.join(self.package_dir, "model_meta.json")) as f:
                self._meta = json.load(f)
        return self._weights, self._meta


@dataclass
class _Endpoint:
    provisioning_state: str = "Succeeded"
    traffic: dict = field(default_factory=dict)
    mirror_traffic: dict = field(default_factory=dict)
    deployments: dict = field(default_factory=dict)


class LocalEndpointClient:
    def __init__(self, state_path: str | None = None):
        self.state_path = state_path or os.environ.get("DCT_LOCAL_ENDPOINT_STATE")
        self.endpoints: dict[str, _Endpoint] = {}
        self.ops: list[tuple] = []  # audit log of control-plane calls
        self._load()

    # -- persistence ---------------------------------------------------
    def _load(self) -> None:
        if not (self.state_path and os.path.exists(self.state_path)):
            return
        with open(self.state_path) as f:
            raw = json.load(f)
        for name, ep in raw.items():
            self.endpoints[name] = _Endpoint(
                provisioning_state=ep["provisioning_state"],
                traffic=dict(ep["traffic"]),
                mirror_traffic=dict(ep["mirror_traffic"]),
                deployments={
                    slot: _Deployment(package_dir=pkg)
                    for slot, pkg in ep["deployments"].items()
                },
            )

    def _save(self) -> None:
        if not self.state_path:
            return
        raw = {
            name: {
                "provisioning_state": ep.provisioning_state,
                "traffic": ep.traffic,
                "mirror_traffic": ep.mirror_traffic,
                "deployments": {
                    slot: dep.package_dir for slot, dep in ep.deployments.items()
                },
            }
            for name, ep in self.endpoints.items()
        }
        os.makedirs(os.path.dirname(os.path.abspath(self.state_path)), exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f, indent=2)
        os.replace(tmp, self.state_path)

    # -- control plane -------------------------------------------------
    def endpoint_exists(self, endpoint: str) -> bool:
        return endpoint in self.endpoints

    def create_endpoint(self, endpoint: str) -> None:
        self.ops.append(("create_endpoint", endpoint))
        self.endpoints[endpoint] = _Endpoint()
        self._save()

    def delete_endpoint(self, endpoint: str) -> None:
        self.ops.append(("delete_endpoint", endpoint))
        self.endpoints.pop(endpoint, None)
        self._save()

    def provisioning_state(self, endpoint: str) -> str:
        return self.endpoints[endpoint].provisioning_state

    def get_traffic(self, endpoint: str) -> dict:
        if endpoint not in self.endpoints:
            return {}
        return dict(self.endpoints[endpoint].traffic)

    def set_traffic(self, endpoint: str, traffic: dict) -> None:
        self.ops.append(("set_traffic", endpoint, dict(traffic)))
        ep = self.endpoints[endpoint]
        unknown = set(k for k, v in traffic.items() if v > 0) - set(ep.deployments)
        if unknown:
            raise ValueError(f"Traffic to nonexistent deployments: {unknown}")
        ep.traffic = dict(traffic)
        self._save()

    def get_mirror_traffic(self, endpoint: str) -> dict:
        return dict(self.endpoints[endpoint].mirror_traffic)

    def set_mirror_traffic(self, endpoint: str, traffic: dict) -> None:
        self.ops.append(("set_mirror_traffic", endpoint, dict(traffic)))
        self.endpoints[endpoint].mirror_traffic = dict(traffic)
        self._save()

    def deploy(self, endpoint: str, slot: str, package_dir: str) -> None:
        self.ops.append(("deploy", endpoint, slot, package_dir))
        dep = _Deployment(package_dir=package_dir)
        dep.load()  # fail fast if the package is incomplete
        self.endpoints[endpoint].deployments[slot] = dep
        self._save()

    def delete_deployment(self, endpoint: str, slot: str) -> None:
        self.ops.append(("delete_deployment", endpoint, slot))
        self.endpoints[endpoint].deployments.pop(slot, None)
        self._save()

    def list_deployments(self, endpoint: str) -> list[str]:
        return list(self.endpoints[endpoint].deployments)

    def deployment_package_dir(self, endpoint: str, slot: str) -> str | None:
        """The package dir backing a deployed slot (None for an unknown
        endpoint/slot) — how the promotion gate locates the champion's
        and challenger's artifacts."""
        ep = self.endpoints.get(endpoint)
        dep = ep.deployments.get(slot) if ep else None
        return dep.package_dir if dep else None

    # -- mirror capture (evaluation.drift's shadow-stage evidence) -----
    @property
    def mirror_capture_path(self) -> str | None:
        """Where mirrored request/response pairs are captured as JSONL:
        ``DCT_MIRROR_CAPTURE`` wins; with persistent state the default
        is a sibling of the state file; in-memory clients don't capture
        unless told to."""
        explicit = os.environ.get("DCT_MIRROR_CAPTURE")
        if explicit:
            return explicit
        if self.state_path:
            return self.state_path + "_mirror.jsonl"
        return None

    def append_mirror_record(self, record: dict) -> None:
        """Append one mirrored-pair record (single-line JSON, O_APPEND-
        atomic under PIPE_BUF like the event log). Best-effort: capture
        is evaluation telemetry, never a serving failure."""
        path = self.mirror_capture_path
        if not path:
            return
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except (OSError, ValueError, TypeError):
            pass

    # -- data plane (what Azure's scoring URI does) --------------------
    def load_slot(self, endpoint: str, slot: str) -> tuple[dict, dict]:
        """(weights, meta) of a deployed slot; KeyError for an unknown
        endpoint/slot (callers map that to a client-facing 404)."""
        return self.endpoints[endpoint].deployments[slot].load()

    def score(self, endpoint: str, payload: dict, *, slot: str | None = None) -> dict:
        """Route a request like the live endpoint would: to the given slot,
        or to the max-live-traffic slot. With mirror traffic configured
        and a capture path set, the request is ALSO scored against each
        shadow slot and the paired responses land in the mirror-capture
        JSONL (the shadow-stage disagreement evidence). Unlike the HTTP
        endpoint server, this in-process surface captures EVERY request
        (no percent sampling): it is the test/local path, and the
        evaluation wants deterministic evidence."""
        from dct_tpu_torch.serving.numpy_runtime import score_payload

        ep = self.endpoints[endpoint]
        if slot is None:
            live = {k: v for k, v in ep.traffic.items() if v > 0}
            if not live:
                raise RuntimeError(f"Endpoint {endpoint} has no live traffic")
            slot = max(live, key=live.get)
        weights, meta = ep.deployments[slot].load()
        result = score_payload(weights, meta, payload["data"])
        if self.mirror_capture_path:
            import time as _time

            for shadow, pct in ep.mirror_traffic.items():
                if pct <= 0 or shadow == slot or shadow not in ep.deployments:
                    continue
                try:
                    w_s, m_s = ep.deployments[shadow].load()
                    shadow_result = score_payload(w_s, m_s, payload["data"])
                except Exception:  # noqa: BLE001 — a broken shadow is itself
                    continue  # a signal, but never a live-path failure
                self.append_mirror_record({
                    "ts": round(_time.time(), 6),
                    "endpoint": endpoint,
                    "live_slot": slot,
                    "shadow_slot": shadow,
                    "live_probs": result["probabilities"],
                    "shadow_probs": shadow_result["probabilities"],
                })
        return result
