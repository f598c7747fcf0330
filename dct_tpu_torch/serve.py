"""Serve over HTTP on the card (counterpart of ``jobs/serve.py``).

    python -m dct_tpu_torch.serve

What it serves, first match wins:
  DCT_ENDPOINT_NAME   a local rollout endpoint (traffic-weighted routing,
                      ``?slot=`` pinning, mirror shadowing) whose state is
                      ``DCT_LOCAL_ENDPOINT_STATE``; stage flips apply live
  DCT_PACKAGE_DIR     a package (model.npz + model_meta.json): f32, bf16 or
                      int8 (``python -m dct_tpu_torch.serving.quant``)
  DCT_CKPT            a checkpoint file
  DCT_MODELS_DIR      the newest ``weather-best-*.ckpt`` there, else
                      ``last.ckpt`` (default ``data/models``)

Environment:
  DCT_SERVE_HOST / DCT_SERVE_PORT   bind address (0.0.0.0, 8901)
  DCT_DEVICE          ``cpu`` to serve on the CPU; default ``cuda:0``,
                      which refuses to start without a capability-9.0 card
  DCT_SERVE_*         :class:`dct_tpu_torch.config.ServingConfig`: the
                      micro-batcher, ``DCT_SERVE_ENGINE`` (torch | numpy),
                      admission (``DCT_SERVE_ADMIT``), the autoscaler
                      (``DCT_SERVE_AUTOSCALE``), ``DCT_SERVE_PROCS``
  DCT_METRICS_DIR     the metrics plane (default ``logs/metrics``; set it
                      empty to turn it off), so that one ``GET /metrics`` of
                      any pool process reports the fleet

``DCT_SERVE_PROCS > 1`` runs a :class:`~dct_tpu_torch.serving.server.
ServerPool`: forked children on one port, respawned under
``RestartPolicy(max_restarts=DCT_SERVE_MAX_RESTARTS)``, with the process
autoscaler under ``DCT_SERVE_AUTOSCALE=1``. Forking, not fresh
interpreters: a child starts in well under a second where an interpreter
with torch takes seconds, and the parent keeps CUDA untouched (it builds
the kernel libraries with ``nvcc``, which needs no context, so that every
child only loads them) while each child resolves its own device.

Each torch-engine server warms up before it binds its port (one forward,
which loads the kernel libraries). SIGTERM drains in-flight requests and
exits 0 (one process prints ``[serve] launches {...}``, its kernel
launches; a pool's children publish theirs on ``GET /metrics`` as
``dct_kernel_launches``); a pool whose restart budget ran out exits 1.
"""

from __future__ import annotations

import os
import signal
import sys
import threading


def _target() -> tuple[str, str] | None:
    """(mode, what) from the environment, or None when nothing names a
    model: ``("endpoint", name)``, ``("package", dir)`` or
    ``("checkpoint", path)``."""
    endpoint = os.environ.get("DCT_ENDPOINT_NAME")
    if endpoint:
        return "endpoint", endpoint
    package_dir = os.environ.get("DCT_PACKAGE_DIR")
    if package_dir:
        return "package", package_dir
    from dct_tpu_torch.predict_job import find_checkpoint

    try:
        return "checkpoint", find_checkpoint(
            os.environ.get("DCT_MODELS_DIR", "data/models"))
    except FileNotFoundError as e:
        print(f"{e}; or set DCT_PACKAGE_DIR (a package directory) or "
              "DCT_ENDPOINT_NAME (a rollout endpoint)", file=sys.stderr)
        return None


def _server_factory(mode: str, what: str, serving, device, warm: bool):
    from dct_tpu_torch.serving.server import make_endpoint_server, make_server

    if mode == "endpoint":
        return lambda h, p, reuse_port=False: make_endpoint_server(
            what, host=h, port=p, device=device, serving=serving,
            reuse_port=reuse_port, warm=warm)
    return lambda h, p, reuse_port=False: make_server(
        what, host=h, port=p, device=device, serving=serving,
        reuse_port=reuse_port, warm=warm)


def _serve_pool(build, what: str, serving, device, host: str,
                port: int) -> int:
    """Run the pool until SIGTERM (0) or until its restart budget runs out
    (1)."""
    from dct_tpu_torch.config import ObservabilityConfig
    from dct_tpu_torch.resilience.supervisor import RestartPolicy
    from dct_tpu_torch.serving.server import ServerPool

    if serving.engine == "torch" and device != "cpu":
        import torch

        from dct_tpu_torch.device import DeviceError
        from dct_tpu_torch.ops import build as kernel_build

        # device_count reads NVML and leaves CUDA uninitialized, which the
        # forked children need.
        if torch.cuda.device_count() < 1:
            raise DeviceError("DCT_SERVE_PROCS > 1 on the card, but CUDA is "
                              "not available; set DCT_DEVICE=cpu for the CPU")
        kernel_build.build_kernels("flash_fwd")
    pool = ServerPool(build, processes=serving.processes, host=host,
                      port=port,
                      restart_policy=RestartPolicy(
                          max_restarts=serving.max_restarts))
    autoscaler = publisher = None
    obs = ObservabilityConfig.from_env()
    if serving.autoscale and not obs.metrics_dir:
        print("[serving] DCT_SERVE_AUTOSCALE=1 needs DCT_METRICS_DIR (the "
              "fleet's queue and shed signals); autoscaler disabled",
              file=sys.stderr, flush=True)
    elif serving.autoscale:
        from dct_tpu_torch.observability.metrics import MetricsRegistry
        from dct_tpu_torch.serving import autoscale

        registry = MetricsRegistry()
        publisher = autoscale.controller_publisher(registry)
        autoscaler = autoscale.Autoscaler.from_config(
            autoscale.PoolScaleTarget(pool), serving,
            signal_fn=autoscale.pool_signal_fn(
                obs.metrics_dir, stale_s=obs.metrics_stale_s),
            emit=autoscale.emit_default, registry=registry,
        ).start()

    def _term(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    print(f"serving {what} with {serving.processes} processes on "
          f"http://{host}:{pool.port} (POST /score, GET /healthz, "
          "GET /metrics)", flush=True)
    try:
        rc = pool.wait()
        if rc:
            print("serving pool: worker deaths exhausted the restart budget; "
                  "shutting down", file=sys.stderr, flush=True)
        return rc
    finally:
        if autoscaler is not None:
            autoscaler.close()
        if publisher is not None:
            publisher.close()
        pool.close()


def main(warm: bool = True) -> int:
    """The entry point; ``warm=False`` skips the warm start (it exists to
    measure the warm start)."""
    from dct_tpu_torch.config import ServingConfig

    target = _target()
    if target is None:
        return 2
    mode, what = target
    host = os.environ.get("DCT_SERVE_HOST", "0.0.0.0")
    port = int(os.environ.get("DCT_SERVE_PORT", "8901"))
    os.environ.setdefault("DCT_METRICS_DIR", "logs/metrics")
    serving = ServingConfig.from_env()
    device = os.environ.get("DCT_DEVICE") or None
    build = _server_factory(mode, what, serving, device, warm)
    label = f"rollout endpoint {what!r}" if mode == "endpoint" else what
    if serving.processes > 1:
        return _serve_pool(build, label, serving, device, host, port)
    server = build(host, port)

    def _term(signum, frame):
        # shutdown() blocks until serve_forever returns: call it off the
        # main thread, which is the one running serve_forever.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(f"serving {label} ({mode}) on {server.device} at "
          f"http://{host}:{server.server_address[1]} "
          "(POST /score, GET /healthz, GET /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        from dct_tpu_torch.ops.flash_attention import launch_counts

        print(f"[serve] launches {launch_counts()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
