"""MPMD inter-stage transfer plane (copy of
``dct_tpu/parallel/mpmd_transfer.py``): explicit cross-process send/recv.

Inside one process the stages exchange tensors through
:class:`dct_tpu_torch.parallel.mpmd.QueueChannel` (the sender moves each
to the consumer's card). Across processes — one process per stage, never
joined in one collective world — the plane is a framed-array protocol
over TCP:

    frame := MAGIC(4) | header_len(u32 be) | header json | raw bytes
    header := {"dtype": str, "shape": [..], "tag": str}

Tensors become numpy at the channel's edge (``send`` takes a tensor or an
array; ``recv`` returns an array, which the stage's ``place_in`` moves to
its device). numpy has no bfloat16, so a bf16 tensor crosses as its
``uint16`` view with ``"dtype": "bfloat16"`` in the header and comes back
as a ``torch.bfloat16`` tensor (a view of the received bytes). Each link
is drained by a reader thread, so two neighbours sending large frames to
each other at once never block each other (the reference's channel reads
only when its stage asks). Timeouts, a torn frame and foreign traffic
raise
:class:`dct_tpu_torch.parallel.mpmd.MpmdTransferTimeout`, never hang, so
the supervised launcher's exit-code classifier can heal the world.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from dct_tpu_torch.parallel.mpmd import MpmdTransferTimeout

_MAGIC = b"DCTX"
BF16 = "bfloat16"

# ----------------------------------------------------------------------
# Transfer accounting: byte/latency histograms per link direction on the
# metrics plane's registry, armed by the worker when DCT_METRICS_DIR is
# set; unarmed, every note is one None check.

#: Frame-size buckets, bytes (part of the metric identity).
TRANSFER_BYTE_BUCKETS = (
    1e3, 1e4, 1e5, 1e6, 4e6, 1.6e7, 6.4e7, 2.56e8,
)
#: Per-frame wall buckets, seconds.
TRANSFER_LATENCY_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)

_transfer_metrics: dict | None = None


def arm_transfer_metrics(registry) -> None:
    """Install the transfer histograms/counters on ``registry`` (a
    :class:`~dct_tpu_torch.observability.metrics.MetricsRegistry`) and
    record every frame this process sends or receives."""
    global _transfer_metrics
    _transfer_metrics = {
        "bytes_h": registry.histogram(
            "dct_mpmd_transfer_bytes",
            "Framed bytes per inter-stage transfer, by direction.",
            buckets=TRANSFER_BYTE_BUCKETS,
        ),
        "seconds_h": registry.histogram(
            "dct_mpmd_transfer_seconds",
            "Wall seconds per inter-stage transfer frame, by "
            "direction (recv includes the wait for the peer's send).",
            buckets=TRANSFER_LATENCY_BUCKETS,
        ),
        "frames_c": registry.counter(
            "dct_mpmd_transfer_frames_total",
            "Inter-stage transfer frames, by direction.",
        ),
        "bytes_c": registry.counter(
            "dct_mpmd_transfer_bytes_total",
            "Cumulative inter-stage transfer bytes, by direction.",
        ),
    }


def disarm_transfer_metrics() -> None:
    global _transfer_metrics
    _transfer_metrics = None


def _note_transfer(direction: str, nbytes: int, seconds: float) -> None:
    m = _transfer_metrics
    if m is None:
        return
    try:
        labels = {"direction": direction}
        m["bytes_h"].observe(nbytes, labels)
        m["seconds_h"].observe(seconds, labels)
        m["frames_c"].inc(1.0, labels)
        m["bytes_c"].inc(float(nbytes), labels)
    except Exception:  # noqa: BLE001 — telemetry never fails a transfer
        pass


def _recv_exact(sock: socket.socket, n: int, timeout: float) -> bytes:
    deadline = time.monotonic() + timeout
    chunks = []
    remaining = n
    while remaining > 0:
        left = deadline - time.monotonic()
        if left <= 0:
            raise MpmdTransferTimeout(
                f"socket recv starved: {remaining}/{n} bytes outstanding"
            )
        sock.settimeout(min(left, 5.0))
        try:
            chunk = sock.recv(min(remaining, 1 << 20))
        except socket.timeout:
            continue
        if not chunk:
            raise MpmdTransferTimeout(
                "peer closed the transfer link mid-frame"
            )
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def to_wire(payload) -> tuple[np.ndarray, str]:
    """(a contiguous host array, its header dtype) of a tensor or array:
    a bf16 tensor as its uint16 view tagged ``bfloat16``."""
    if isinstance(payload, torch.Tensor):
        t = payload.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(payload)
    return arr, str(arr.dtype)


def send_array(sock: socket.socket, payload, tag: str = "") -> int:
    """One frame of ``payload``; returns its payload bytes."""
    arr, dtype = to_wire(payload)
    header = json.dumps(
        {"dtype": dtype, "shape": list(arr.shape), "tag": tag}
    ).encode()
    sock.sendall(
        _MAGIC + struct.pack(">I", len(header)) + header + arr.tobytes()
    )
    return arr.nbytes


def _parse_frame(read):
    """One frame through ``read(n) -> bytes``: its array (a
    ``torch.bfloat16`` tensor for a bf16 frame)."""
    magic = read(4)
    if magic != _MAGIC:
        raise MpmdTransferTimeout(
            f"bad frame magic {magic!r} on the transfer link "
            "(foreign traffic or a torn stream)"
        )
    (hlen,) = struct.unpack(">I", read(4))
    header = json.loads(read(hlen).decode())
    bf16 = header["dtype"] == BF16
    dtype = np.dtype(np.uint16 if bf16 else header["dtype"])
    shape = tuple(int(s) for s in header["shape"])
    n = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
    arr = np.frombuffer(read(n), dtype=dtype).reshape(shape).copy()
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def recv_array(sock: socket.socket, timeout: float):
    """The next frame's array, read within ``timeout`` seconds."""
    return _parse_frame(lambda n: _recv_exact(sock, n, timeout))


def _read_blocking(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise MpmdTransferTimeout(
                "peer closed the transfer link mid-frame" if got else
                "peer closed the transfer link")
        got += k
    return bytes(buf)


class SocketChannel:
    """One neighbour link carrying framed host arrays both ways; the
    :class:`~dct_tpu_torch.parallel.mpmd.StageExecutor` channel protocol
    (``send`` / ``recv``).

    A reader thread drains the socket into a queue from the start, so a
    stage blocked in a send never stops its own side from being read:
    with both directions of a link carrying frames larger than the socket
    buffers (a full-width f32 activation is 8 MB), two stages each blocked
    in ``sendall`` would wait on each other for good. ``recv`` takes the
    next frame within its timeout; a torn or foreign frame, or a failed
    link, raises there (and at every later ``recv``). The socket stays in
    blocking mode, so a large frame's ``sendall`` never stops mid-write.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        try:
            self._sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        except OSError:
            pass  # non-TCP transports (AF_UNIX test rigs) have no Nagle
        self._sock.settimeout(None)
        self._frames: queue.Queue = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        try:
            while True:
                self._frames.put(_parse_frame(
                    lambda n: _read_blocking(self._sock, n)))
        except MpmdTransferTimeout as e:
            self._frames.put(e)
        except (OSError, ValueError) as e:
            self._frames.put(MpmdTransferTimeout(
                f"the transfer link failed: {e}"))

    def send(self, payload) -> None:
        t0 = time.monotonic()
        try:
            nbytes = send_array(self._sock, payload)
        except OSError as e:
            raise MpmdTransferTimeout(
                f"send on the transfer link failed: {e}"
            ) from e
        _note_transfer("send", nbytes, time.monotonic() - t0)

    def recv(self, timeout: float):
        t0 = time.monotonic()
        try:
            item = self._frames.get(timeout=timeout)
        except queue.Empty:
            raise MpmdTransferTimeout(
                f"no frame within {timeout}s on the transfer link"
            ) from None
        if isinstance(item, MpmdTransferTimeout):
            self._frames.put(item)
            raise item
        nbytes = item.nbytes if isinstance(item, np.ndarray) else (
            item.numel() * item.element_size())
        _note_transfer("recv", nbytes, time.monotonic() - t0)
        return item

    def close(self) -> None:
        for end in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                    self._sock.close):
            try:
                end()
            except OSError:
                pass
        self._reader.join(timeout=5)


def connect_stage_links(
    stage: int, n_stages: int, *, port_base: int,
    host: str = "127.0.0.1", timeout: float = 120.0,
) -> dict:
    """Stage ``stage``'s neighbor links: each neighbor pair shares ONE
    TCP connection, opened by the lower stage toward the higher one's
    listener on ``port_base + k+1``; activations flow down it, gradients
    back up. Returns ``{"act_out"/"grad_in", "act_in"/"grad_out":
    SocketChannel}`` as applicable; raises
    :class:`MpmdTransferTimeout` when a neighbor never shows up."""
    links: dict = {}
    server = None
    if stage > 0:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((host, port_base + stage))
        server.listen(1)
        server.settimeout(timeout)
    # Listener up BEFORE dialing upward, so the chain establishes in any
    # start order.
    if stage < n_stages - 1:
        deadline = time.monotonic() + timeout
        last_err = None
        while time.monotonic() < deadline:
            try:
                up = socket.create_connection(
                    (host, port_base + stage + 1), timeout=2.0
                )
                break
            except OSError as e:
                last_err = e
                time.sleep(0.2)
        else:
            if server is not None:
                server.close()
            raise MpmdTransferTimeout(
                f"stage {stage} could not reach stage {stage + 1} on "
                f"port {port_base + stage + 1} within {timeout}s "
                f"({last_err})"
            )
        ch = SocketChannel(up)
        links["act_out"] = ch
        links["grad_in"] = ch
    if server is not None:
        try:
            conn, _addr = server.accept()
        except socket.timeout:
            server.close()
            close_links(links)
            raise MpmdTransferTimeout(
                f"stage {stage} never heard from stage {stage - 1} on "
                f"port {port_base + stage} within {timeout}s"
            ) from None
        server.close()
        ch = SocketChannel(conn)
        links["act_in"] = ch
        links["grad_out"] = ch
    return links


def close_links(links: dict) -> None:
    seen = set()
    for ch in links.values():
        if id(ch) in seen:
            continue
        seen.add(id(ch))
        ch.close()
