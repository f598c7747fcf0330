"""Serve a score package over HTTP on the card (counterpart of ``jobs/serve.py``).

    DCT_PACKAGE_DIR=<dir with model.npz + model_meta.json> \\
        python -m dct_tpu_torch.serve

Environment:
  DCT_PACKAGE_DIR  the package to serve (required)
  DCT_SERVE_HOST   bind host (default 0.0.0.0)
  DCT_SERVE_PORT   bind port (default 8901)
  DCT_SERVE_MAX_BATCH, DCT_SERVE_BATCH_WINDOW_MS, DCT_SERVE_WORKERS,
  DCT_SERVE_FAST_PARSE  the micro-batcher (dct_tpu_torch.config.ServingConfig)

The server runs on ``cuda:0`` and refuses to start without CUDA. SIGTERM
drains in-flight requests and exits 0.
"""

from __future__ import annotations

import os
import signal
import sys
import threading


def main() -> int:
    package_dir = os.environ.get("DCT_PACKAGE_DIR")
    if not package_dir:
        print("DCT_PACKAGE_DIR must name a package directory "
              "(model.npz + model_meta.json)", file=sys.stderr)
        return 2
    host = os.environ.get("DCT_SERVE_HOST", "0.0.0.0")
    port = int(os.environ.get("DCT_SERVE_PORT", "8901"))

    from dct_tpu_torch.serving.server import make_server

    server = make_server(package_dir, host=host, port=port)

    def _term(signum, frame):
        # shutdown() blocks until serve_forever returns: call it off the
        # main thread, which is the one running serve_forever.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(
        f"serving {server.model_meta.get('model')} from {package_dir} on "
        f"{server.scorer.device} at http://{host}:{server.server_address[1]} "
        "(POST /score, GET /healthz)", flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
