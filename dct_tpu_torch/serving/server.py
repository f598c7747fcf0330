"""HTTP scoring server (counterpart of ``dct_tpu/serving/server.py``'s
single-model mode).

The contract is the reference's:
- ``POST /score`` with ``{"data": [...]}`` -> 200 ``{"probabilities": ...}``;
  400 ``{"error": ...}`` for a malformed or invalid payload; 500 for a
  scoring fault;
- ``GET /healthz`` -> 200 ``{"status": "ok", "model", "input_dim",
  "horizon", "device"}``.

HTTP/1.1 keep-alive with Nagle off, one thread per connection, scoring
through the shared :class:`~dct_tpu_torch.serving.batching.MicroBatcher`
over a :class:`~dct_tpu_torch.serving.batching.TorchScorer` on the card
(``device=None`` resolves to ``cuda:0`` and raises without CUDA). The
metrics, admission, autoscaling and lineage planes are not ported yet.
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dct_tpu_torch.serving.batching import MicroBatcher, ScoringError, TorchScorer
from dct_tpu_torch.serving.runtime import parse_envelope_array, validate_payload


class ScoreHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def _reply(self, code: int, payload: dict) -> None:
        try:
            body = json.dumps(payload, allow_nan=False).encode()
        except ValueError:
            code = 500
            body = b'{"error": "non-finite values in response"}'
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet unless DCT_SERVE_LOG is set
        if os.environ.get("DCT_SERVE_LOG"):
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path != "/healthz":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        meta = self.server.model_meta
        self._reply(200, {
            "status": "ok",
            "model": meta.get("model", "weather_mlp"),
            "input_dim": int(meta.get("input_dim", 0)),
            "horizon": int(meta.get("horizon", 1)),
            "device": str(self.server.scorer.device),
        })

    def do_POST(self):  # noqa: N802 (http.server API)
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) or b"{}"
        except (ValueError, TypeError):
            body = b"{}"
        if self.path != "/score":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            data = parse_envelope_array(body) if self.server.fast_parse else None
            if data is None:
                payload = json.loads(body)
                if not isinstance(payload, dict) or payload.get("data") is None:
                    raise ValueError('payload must be {"data": [...]}')
                data = payload["data"]
            x = validate_payload(self.server.model_meta, data)
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            probs = self.server.batcher.score(x)
        except ScoringError as e:
            self._reply(500, {"error": str(e)})
            return
        self._reply(200, {"probabilities": probs.tolist()})


class ScoreServer(ThreadingHTTPServer):
    """Owns the scorer and the micro-batcher; ``server_close`` drains and
    joins the batcher's workers."""

    daemon_threads = True

    def server_close(self):  # noqa: N802 (http.server API)
        super().server_close()
        self.batcher.close()


def make_server_from_weights(weights: dict, meta: dict, *,
                             host: str = "127.0.0.1", port: int = 0,
                             device=None, serving=None) -> ScoreServer:
    """A ready (unstarted) server over in-memory serving weights (flax
    keys -> f32 arrays) and their meta. ``port=0`` binds an ephemeral
    port (``server.server_address[1]``); ``serving`` is a
    :class:`~dct_tpu_torch.config.ServingConfig` (default: from env)."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.device import resolve_device

    serving = serving or ServingConfig.from_env()
    scorer = TorchScorer(weights, meta, resolve_device(device))
    server = ScoreServer((host, port), ScoreHandler)
    server.model_meta = meta
    server.scorer = scorer
    server.fast_parse = serving.fast_parse
    server.batcher = MicroBatcher(
        scorer, max_batch=serving.max_batch,
        window_ms=serving.batch_window_ms, workers=serving.workers,
    )
    return server


def make_server(package_dir: str, *, host: str = "127.0.0.1", port: int = 0,
                device=None, serving=None) -> ScoreServer:
    """Load the package in ``package_dir`` and return a ready server."""
    from dct_tpu_torch.serving.package import load_package

    weights, meta = load_package(package_dir)
    return make_server_from_weights(
        weights, meta, host=host, port=port, device=device, serving=serving
    )
