"""Socket transport for the serving fleet: length-prefixed binary frames.

Counterpart of ``photon_tpu/serving/transport.py``, with the same wire
format byte for byte: a request packed by either package unpacks in the
other, and a client of either package scores against a server of the
other.  Stdlib only (``socket`` + ``socketserver``).  One TCP connection
carries a sequence of request/response exchanges:

    frame    := u32_be payload_len | payload
    payload  := u32_be header_len | header_json_utf8 | array_bytes...

The JSON header describes the frame kind and its array manifest — each
entry ``{"slot", "name", "dtype", "shape"}`` names one contiguous
little-endian buffer concatenated (in manifest order) after the header.
Request slots: ``feat`` (dense features per shard), ``ids``/``vals``
(padded-COO sparse pair per shard), ``col`` (raw entity keys per id
column — numpy fixed-width strings ride as their ``<U*`` buffers),
``offset``.  ``deadline_ms`` in the header is a RELATIVE budget: the
server stamps the absolute deadline at ingest, so client/server clocks
never need to agree.  Response kinds: ``scores`` (one float32 array),
``shed`` (admission fast-fail, with the reason), ``error``.

Fault surface: every frame read declares the ``transport:read`` fault
site (an injected transient read error behaves like a flaky network).
Scoring requests are idempotent, so :class:`ScoringClient` retries the
whole exchange through ``retry_call`` — reconnect + resend — and a
recovered fault is counted as ``io.retries{site=transport:read}``.

Residency contract (``tools/check_host_sync.py`` guards this module): the
transport is pure host IO — it never sees a tensor; the coercions below
operate on wire bytes and caller-owned numpy only.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_tpu_torch.fault.injection import fault_point
from photon_tpu_torch.serving.router import RequestShedError
from photon_tpu_torch.serving.scorer import ScoringRequest
from photon_tpu_torch.telemetry.distributed import (
    TraceContext,
    attach_trace,
    trace_of,
)

MAX_FRAME_BYTES = 1 << 28  # 256 MB: far past any sane micro-batch


class TransportError(RuntimeError):
    """A malformed frame or a remote-side serving failure."""


# -- frame IO ----------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes (the fault-injectable transport read edge).
    A peer close mid-frame is a ConnectionError — an OSError, so the
    client's retry layer treats it like any transient network fault."""
    fault_point("transport:read")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("!I", _read_exact(sock, 4))
    if n > MAX_FRAME_BYTES:
        raise TransportError(f"frame of {n} bytes exceeds the "
                             f"{MAX_FRAME_BYTES}-byte cap")
    return _read_exact(sock, n)


def write_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("!I", len(payload)) + payload)


# -- payload encode/decode ---------------------------------------------------

def _pack(header: dict) -> bytes:
    manifest = []
    bufs = []
    for slot, name, arr in header.pop("_arrays"):
        a = np.ascontiguousarray(arr)
        manifest.append({
            "slot": slot, "name": name,
            "dtype": a.dtype.str, "shape": list(a.shape),
        })
        bufs.append(a.tobytes())
    header["arrays"] = manifest
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([struct.pack("!I", len(head)), head, *bufs])


def _unpack(payload: bytes) -> Tuple[dict, List[np.ndarray]]:
    (hlen,) = struct.unpack("!I", payload[:4])
    header = json.loads(payload[4: 4 + hlen].decode("utf-8"))
    pos = 4 + hlen
    arrays = []
    for entry in header.get("arrays", []):
        dtype = np.dtype(entry["dtype"])
        count = int(np.prod(entry["shape"], dtype=np.int64))
        nbytes = count * dtype.itemsize
        if pos + nbytes > len(payload):
            raise TransportError("truncated frame: array bytes short")
        arrays.append(
            np.frombuffer(payload[pos: pos + nbytes], dtype=dtype)
            .reshape(entry["shape"])
        )
        pos += nbytes
    if pos != len(payload):
        raise TransportError("trailing bytes after the array manifest")
    return header, arrays


def payload_kind(payload: bytes) -> str:
    """The frame kind without decoding the array bytes (header-only
    parse) — the subprocess replica's per-connection dispatch peek."""
    (hlen,) = struct.unpack("!I", payload[:4])
    header = json.loads(payload[4: 4 + hlen].decode("utf-8"))
    return header.get("kind", "")


def pack_control(kind: str, **fields) -> bytes:
    """A small array-less control frame (ping/pong/swap/ok/shutdown — the
    replica-supervision vocabulary rides the same length-prefixed wire as
    scoring)."""
    header = {"v": 1, "kind": kind, "_arrays": []}
    header.update(fields)
    return _pack(header)


def unpack_control(payload: bytes) -> dict:
    """Decode a control frame to its header dict; a remote ``error`` frame
    raises like any other response."""
    header, _ = _unpack(payload)
    if header.get("kind") == "error":
        raise TransportError(f"remote control failed: {header.get('message')}")
    return header


def pack_request(request: ScoringRequest,
                 deadline_s: Optional[float] = None,
                 seq: Optional[int] = None,
                 gen: Optional[int] = None) -> bytes:
    """One scoring request as a wire payload.  Array order is pinned
    (sorted shard names, then sorted id columns, then offset) so the same
    request always produces the same bytes.  ``seq`` tags the frame for
    the PIPELINED client mode: the server scores tagged requests
    concurrently and echoes the tag on each response, so one connection
    can carry open-loop offered load instead of a serial exchange.
    ``gen`` stamps the sender's membership generation: the replica child
    adopts the max it has seen and echoes it on responses, so a parent
    can fence answers produced by a stale generation."""
    entries = []
    for shard in sorted(request.features):
        leaf = request.features[shard]
        if isinstance(leaf, tuple):
            entries.append(("ids", shard, leaf[0]))
            entries.append(("vals", shard, leaf[1]))
        else:
            entries.append(("feat", shard, leaf))
    for col in sorted(request.entity_ids):
        entries.append(("col", col, request.entity_ids[col]))
    if request.offset is not None:
        entries.append(("offset", "", request.offset))
    model = getattr(request, "model", None)
    if model is not None and not isinstance(model, str):
        # A coalesced mixed-tenant batch: per-row ids ride as a fixed-
        # width string array (object arrays have no wire form).
        # host-sync: model-id vectors live on host; this is a dtype cast.
        entries.append(("model", "", np.asarray(model).astype(str)))
        model = None
    header = {
        "v": 1, "kind": "score",
        "deadline_ms": None if deadline_s is None else deadline_s * 1e3,
        "_arrays": entries,
    }
    if model is not None:
        # Single-tenant request: the model id rides the header — the
        # frame-level routing field.
        header["model"] = model
    if seq is not None:
        header["seq"] = int(seq)
    if gen is not None:
        header["gen"] = int(gen)
    ctx = trace_of(request)
    if ctx is not None:
        # Distributed-trace propagation: the context rides the frame header
        # so the receiving hop parents its span under the sender's.
        header["trace"] = ctx.to_wire()
    return _pack(header)


def unpack_request_hx(
    payload: bytes,
) -> Tuple[ScoringRequest, Optional[float], Optional[int], dict]:
    """Decode a request frame to ``(request, deadline_s, seq, header)``
    — the header-retaining variant for receivers that need the frame's
    membership stamp (``header["gen"]``) besides the request itself.
    ``seq`` is None for plain serial-exchange clients."""
    header, arrays = _unpack(payload)
    if header.get("kind") != "score":
        raise TransportError(f"unexpected request kind {header.get('kind')!r}")
    features: Dict[str, object] = {}
    sparse: Dict[str, dict] = {}
    entity_ids: Dict[str, np.ndarray] = {}
    offset = None
    model = header.get("model")
    for entry, arr in zip(header.get("arrays", []), arrays):
        slot, name = entry["slot"], entry["name"]
        if slot == "feat":
            features[name] = arr
        elif slot in ("ids", "vals"):
            sparse.setdefault(name, {})[slot] = arr
        elif slot == "col":
            entity_ids[name] = arr
        elif slot == "offset":
            offset = arr
        elif slot == "model":
            model = arr.astype(object)
        else:
            raise TransportError(f"unknown array slot {slot!r}")
    for name, pair in sparse.items():
        if "ids" not in pair or "vals" not in pair:
            raise TransportError(f"sparse shard {name!r} missing ids/vals")
        features[name] = (pair["ids"], pair["vals"])
    deadline_ms = header.get("deadline_ms")
    request = ScoringRequest(features=features, entity_ids=entity_ids,
                             offset=offset, model=model)
    ctx = TraceContext.from_wire(header.get("trace"))
    if ctx is not None:
        attach_trace(request, ctx)
    return (
        request,
        None if deadline_ms is None else deadline_ms / 1e3,
        header.get("seq"),
        header,
    )


def unpack_request_ex(
    payload: bytes,
) -> Tuple[ScoringRequest, Optional[float], Optional[int]]:
    """Decode a request frame to ``(request, deadline_s, seq)`` —
    ``seq`` is None for plain serial-exchange clients."""
    request, deadline_s, seq, _ = unpack_request_hx(payload)
    return request, deadline_s, seq


def unpack_request(payload: bytes) -> Tuple[ScoringRequest, Optional[float]]:
    request, deadline_s, _ = unpack_request_ex(payload)
    return request, deadline_s


def _seqed(header: dict, seq: Optional[int]) -> dict:
    if seq is not None:
        header["seq"] = int(seq)
    return header


def pack_scores(scores: np.ndarray, seq: Optional[int] = None,
                meta: Optional[dict] = None) -> bytes:
    """``meta`` piggybacks observability on the response header — the
    child replica ships its completed span dicts (``spans``) and served
    model version (``version``) inline, so trace merge needs no extra
    round-trip on the hot path."""
    header = {"v": 1, "kind": "scores",
              # host-sync: response egress — wire serialization of the host
              # scores array the scorer already fetched (its ONE d2h).
              "_arrays": [("scores", "", np.asarray(scores, np.float32))]}
    if meta:
        header.update(meta)
    return _pack(_seqed(header, seq))


def pack_shed(reason: str, detail: str = "",
              seq: Optional[int] = None) -> bytes:
    return _pack(_seqed({"v": 1, "kind": "shed", "reason": reason,
                         "detail": detail, "_arrays": []}, seq))


def pack_error(message: str, seq: Optional[int] = None) -> bytes:
    return _pack(_seqed({"v": 1, "kind": "error", "message": message[:2000],
                         "_arrays": []}, seq))


def _decode_response(payload: bytes):
    """``(seq, scores, exception, header)`` from a response frame — exactly
    one of scores/exception is set; the header carries any piggybacked
    observability metadata (child spans, served version)."""
    header, arrays = _unpack(payload)
    kind = header.get("kind")
    seq = header.get("seq")
    if kind == "scores":
        return seq, arrays[0], None, header
    if kind == "shed":
        return seq, None, RequestShedError(header.get("reason", "unknown"),
                                           header.get("detail", "")), header
    if kind == "error":
        return seq, None, TransportError(
            f"remote scoring failed: {header.get('message')}"
        ), header
    return (seq, None,
            TransportError(f"unexpected response kind {kind!r}"), header)


def unpack_response(payload: bytes) -> np.ndarray:
    _, scores, exc, _ = _decode_response(payload)
    if exc is not None:
        raise exc
    return scores


def unpack_response_ex(payload: bytes):
    """``(scores, header)`` — the header-aware decode for callers that
    consume the piggybacked span/version metadata (raises like
    :func:`unpack_response` on shed/error frames)."""
    _, scores, exc, header = _decode_response(payload)
    if exc is not None:
        raise exc
    return scores, header


# -- server ------------------------------------------------------------------

class ScoringServer:
    """Threaded TCP ingest in front of a fleet router (or anything with a
    ``submit(request, deadline_s=None) -> Future``).  One handler thread
    per connection; a serial connection is one request/response stream,
    a pipelined one (seq-tagged frames) carries many in flight.
    Admission sheds and scoring errors travel back as typed frames, never
    as dropped connections."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 telemetry=None):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.service = service
        self.telemetry = telemetry or NULL_SESSION
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: D102 — per-connection loop
                outer._serve_connection(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="serving-transport", daemon=True,
        )
        self._thread.start()

    def _serve_connection(self, sock: socket.socket) -> None:
        t = self.telemetry
        t.counter("serving.transport_connections").inc()
        # Request/response frames are latency-critical small writes: Nagle
        # + delayed-ACK on a chatty exchange stream adds tens of ms per
        # roundtrip — disable batching.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Bound response SENDS (not reads — idle persistent connections
        # must keep blocking in read_frame): pipelined responses run on
        # batcher/router callback threads, and a client that stops
        # reading (full TCP receive window) would otherwise wedge that
        # thread — the replica's whole scoring path — inside sendall.
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", 30, 0))
        # Pipelined (seq-tagged) responses resolve on batcher/router
        # callback threads while this thread keeps reading: one write lock
        # per connection keeps frames whole on the wire.
        write_lock = threading.Lock()

        def send(out: bytes) -> bool:
            try:
                with write_lock:
                    write_frame(sock, out)
                t.counter("serving.transport_bytes", direction="out").inc(
                    len(out) + 4
                )
                return True
            except OSError:
                t.counter("serving.transport_drops").inc()
                return False

        while True:
            try:
                payload = read_frame(sock)
            except (OSError, TransportError):
                # Peer gone or a (possibly injected) transport fault: drop
                # the connection; the client reconnects and resends.
                t.counter("serving.transport_drops").inc()
                return
            t.counter("serving.transport_bytes", direction="in").inc(
                len(payload) + 4
            )
            seq = None
            try:
                request, deadline_s, seq = unpack_request_ex(payload)
                fut = self.service.submit(request, deadline_s=deadline_s)
                if seq is None:
                    # Serial exchange: one request in flight per connection.
                    out = pack_scores(fut.result())
                else:
                    # Pipelined: admission already ran (a synchronous shed
                    # raised above); the response rides a done-callback so
                    # the read loop keeps ingesting the offered stream.
                    def respond(f, seq=seq):
                        exc = f.exception()
                        if exc is None:
                            send(pack_scores(f.result(), seq=seq))
                        elif isinstance(exc, RequestShedError):
                            send(pack_shed(exc.reason, str(exc), seq=seq))
                        else:
                            send(pack_error(
                                f"{type(exc).__name__}: {exc}", seq=seq
                            ))

                    fut.add_done_callback(respond)
                    continue
            except RequestShedError as e:
                out = pack_shed(e.reason, str(e), seq=seq)
            except BaseException as e:  # surfaced to the caller, not fatal
                out = pack_error(f"{type(e).__name__}: {e}", seq=seq)
            if not send(out):
                return

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


# -- client ------------------------------------------------------------------

class ScoringClient:
    """One persistent connection to a :class:`ScoringServer`.

    ``score()`` is a synchronous request/response exchange; it retries
    transient transport failures (reconnect + resend — scoring is
    idempotent) through ``retry_call``, and raises
    :class:`~photon_tpu_torch.serving.router.RequestShedError` when
    admission fast-failed the request remotely.  NOT thread-safe: use one
    client per concurrent caller (a connection is a serial exchange
    stream)."""

    def __init__(self, address, telemetry=None, timeout_s: float = 30.0):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.address = tuple(address)
        self.telemetry = telemetry or NULL_SESSION
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def score(self, request: ScoringRequest,
              deadline_s: Optional[float] = None) -> np.ndarray:
        from photon_tpu_torch.fault.retry import retry_call

        payload = pack_request(request, deadline_s)

        def attempt() -> np.ndarray:
            if self._sock is None:
                self._sock = socket.create_connection(
                    self.address, timeout=self.timeout_s
                )
                # See the server side: Nagle stalls a chatty exchange.
                self._sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            try:
                write_frame(self._sock, payload)
                return unpack_response(read_frame(self._sock))
            except OSError:
                # Drop the wedged connection so the NEXT attempt starts
                # from a fresh connect instead of a half-written stream.
                self._drop()
                raise

        return retry_call(
            attempt, site="transport:read", telemetry=self.telemetry
        )

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "ScoringClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncScoringClient:
    """Pipelined multi-connection client: ``submit()`` returns a Future and
    NEVER blocks on a response — request frames carry a sequence id, ride
    one of ``connections`` persistent sockets, and the server scores them
    concurrently, echoing the id on each response frame (scores, shed, or
    error) so a reader thread can resolve futures out of order.

    This is the open-loop load generator's transport
    (``traffic.replay_open_loop(client.submit, ...)``): the arrival
    schedule drives the SOCKET itself, so framing cost and socket
    backpressure sit inside the overload measurement.  Admission sheds
    come back as typed frames and surface as ``RequestShedError`` through
    the future.

    No retry/resend: a transport failure fails the connection's in-flight
    futures with :class:`TransportError` (an open-loop replay records
    them; resending mid-pipeline would reorder the offered schedule)."""

    @staticmethod
    def _settle(fut, value=None, exc: Optional[BaseException] = None):
        """Resolve a future exactly once — three paths can race to fail
        the same future on a dying connection (the submit-side send
        failure, the reader's decode, and _fail_pending's sweep); the
        shared ``resolve_once`` guard makes the loser's write a no-op."""
        from photon_tpu_torch.serving.batcher import resolve_once

        resolve_once(fut, value, exc)

    def __init__(self, address, connections: int = 2, telemetry=None,
                 timeout_s: float = 60.0, observer=None):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.address = tuple(address)
        self.telemetry = telemetry or NULL_SESSION
        # Optional FleetObserver: when set, sampled requests originate a
        # client-side span whose context rides the request frame, so the
        # server-side trace links under the caller's clock.
        self.observer = observer
        self._seq = 0
        self._lock = threading.Lock()
        self._closed = False
        self._conns = []
        for i in range(max(1, int(connections))):
            sock = socket.create_connection(self.address, timeout=timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = {
                "sock": sock,
                "wlock": threading.Lock(),
                "pending": {},  # seq -> Future (this connection's)
                "spans": {},  # seq -> client-side SpanRecord (traced only)
            }
            conn["reader"] = threading.Thread(
                target=self._read_loop, args=(conn,),
                name=f"async-scoring-client-{i}", daemon=True,
            )
            self._conns.append(conn)
        for conn in self._conns:
            conn["reader"].start()

    def submit(self, request: ScoringRequest,
               deadline_s: Optional[float] = None):
        """Send one request frame; the returned future resolves to the
        scores, or raises the remote shed/error."""
        from concurrent.futures import Future

        with self._lock:
            if self._closed:
                raise RuntimeError("client is closed")
            self._seq += 1
            seq = self._seq
        conn = self._conns[seq % len(self._conns)]
        fut = Future()
        span = (self.observer.client_span(request)
                if self.observer is not None else None)
        payload = pack_request(request, deadline_s, seq=seq)
        if span is not None:
            span.event("send", seq=seq, nbytes=len(payload))
            conn["spans"][seq] = span
        conn["pending"][seq] = fut
        try:
            with conn["wlock"]:
                write_frame(conn["sock"], payload)
        except OSError as e:
            conn["pending"].pop(seq, None)
            self._finish_span(conn, seq, status="error")
            self._settle(fut, exc=TransportError(f"send failed: {e}"))
            return fut
        dead = conn.get("dead")
        if dead is not None:
            # The reader died around this submit (the first send after a
            # peer FIN can still succeed into the socket buffer): nothing
            # will ever match this seq — fail it now, not at timeout.
            conn["pending"].pop(seq, None)
            self._finish_span(conn, seq, status="error")
            self._settle(fut, exc=TransportError(
                f"connection lost with request in flight: {dead}"
            ))
        return fut

    def _finish_span(self, conn, seq, status: str = "ok",
                     header: Optional[dict] = None) -> None:
        span = conn["spans"].pop(seq, None)
        if span is None:
            return
        version = None if header is None else header.get("version")
        span.event("response", seq=seq, version=version)
        if version is not None:
            span.attrs["version"] = version
        span.finish(status=status)
        if self.observer is not None:
            self.observer.collector.add(span)

    def _read_loop(self, conn) -> None:
        while True:
            try:
                payload = read_frame(conn["sock"])
            except (OSError, TransportError) as e:
                # Mark the connection dead BEFORE sweeping: a submit that
                # registers its future after the sweep sees the flag and
                # self-fails instead of waiting forever on a reader that
                # already exited.
                conn["dead"] = e
                self._fail_pending(conn, e)
                return
            seq, scores, exc, header = _decode_response(payload)
            fut = conn["pending"].pop(seq, None)
            if isinstance(exc, RequestShedError):
                status = "shed"
            elif exc is not None:
                status = "error"
            else:
                status = "ok"
            self._finish_span(conn, seq, status=status, header=header)
            if fut is None:
                continue  # unknown tag: a late frame after a local failure
            self._settle(fut, scores, exc)

    def _fail_pending(self, conn, error: BaseException) -> None:
        pending, conn["pending"] = conn["pending"], {}
        if not self._closed and pending:
            self.telemetry.counter("serving.transport_drops").inc()
        for seq in list(conn["spans"]):
            self._finish_span(conn, seq, status="error")
        for fut in pending.values():
            self._settle(fut, exc=TransportError(
                f"connection lost with request in flight: {error}"
            ))

    def close(self) -> None:
        with self._lock:
            self._closed = True
        for conn in self._conns:
            try:
                # A shutdown wakes the reader blocked in recv; a close
                # alone leaves it there until the join times out.
                conn["sock"].shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn["sock"].close()
            except OSError:
                pass
        for conn in self._conns:
            conn["reader"].join(timeout=5)
            self._fail_pending(conn, ConnectionError("client closed"))

    def __enter__(self) -> "AsyncScoringClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
