"""HTTP(S) extender server: routing, middleware and mTLS.

The port's copy of ``platform_aware_scheduling_tpu/extender/server.py``,
with the routes and middleware of the reference extender:

  * ``/scheduler/{prioritize,filter,bind}`` plus a 404 catch-all;
  * middleware content-type -> length -> method: a ``Content-Type`` other
    than exactly ``application/json`` gets 404, a body over 1 GB gets
    500, a non-POST gets 405;
  * TLS >= 1.2 with the ECDHE-{RSA,ECDSA}-AES256-GCM-SHA384 suites pinned,
    client certificates required and verified against a CA pool, 5 s
    read-header and 10 s write timeouts;
  * the observability surface: ``/healthz``, ``/readyz``, ``/metrics``,
    ``/debug/traces``, ``/debug/decisions``, ``/debug/explain``,
    ``/debug/leader`` (the elector's state, when one is wired),
    ``/debug/forecast`` (the forecaster's fits, when one is wired),
    ``/debug/wire`` (the wire path's caches, when the scheduler has a
    device fastpath) and the ``/debug`` index.

The JAX server's other ``/debug/*`` endpoints belong to planes the port
does not have yet; each answers here exactly as the JAX server does with
its plane off (:data:`PLANE_OFF`), as ``/debug/leader`` does with no
elector wired, ``/debug/forecast`` with no forecaster and ``/debug/wire``
with no fastpath.
"""

from __future__ import annotations

import json
import socket
import socketserver
import ssl
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Optional

from platform_aware_scheduling_tpu_torch.utils import decisions, events, health, klog, trace

if TYPE_CHECKING:  # pragma: no cover
    from platform_aware_scheduling_tpu_torch.extender.types import Scheduler

MAX_CONTENT_LENGTH = 1 * 1000 * 1000 * 1000  # 1 GB (scheduler.go:30)
# request-head ceiling (status line + all headers); net/http's default is
# 1 MB, http.server enforced 64 KiB lines — without a cap a client that
# streams endless header bytes grows the buffer without bound
MAX_HEAD_LENGTH = 64 * 1024
READ_HEADER_TIMEOUT_S = 5.0
WRITE_TIMEOUT_S = 10.0


@dataclass
class HTTPRequest:
    method: str
    path: str
    headers: Dict[str, str]
    body: bytes
    # the request's trace span (utils/trace.py), attached by whichever
    # front-end accepted the connection; excluded from equality/repr so
    # request objects still compare by wire content alone
    span: Optional[object] = field(default=None, compare=False, repr=False)

    def header(self, name: str) -> str:
        # HTTP header names are case-insensitive
        for k, v in self.headers.items():
            if k.lower() == name.lower():
                return v
        return ""


@dataclass
class HTTPResponse:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    @classmethod
    def json(cls, body: bytes, status: int = 200) -> "HTTPResponse":
        return cls(status=status, headers={"Content-Type": "application/json"}, body=body)


#: the debug/observability surface; ``GET /debug`` renders this index
DEBUG_ENDPOINTS = [
    {"path": "/healthz", "description": "process liveness (200 = alive)"},
    {"path": "/readyz", "description": "composite readiness: 503 + condition list until warm/fresh/synced"},
    {"path": "/metrics", "description": "Prometheus exposition: verb histograms, path attribution, pas_* families"},
    {"path": "/debug/traces", "description": "recent + slowest request traces; filters: ?verb=<verb>&min_ms=<float>"},
    {"path": "/debug/decisions", "description": "scheduling decision provenance records; filters: ?pod=<name>&verb=<verb>&limit=<n> (404 when --decisionLog=off)"},
    {"path": "/debug/forecast", "description": "per-metric forecast fits: slopes, horizons, uncertainty bands (404 when --forecast=off)"},
    {"path": "/debug/leader", "description": "leader-election state: role, lease holder, fencing token (404 when --leaderElect is off)"},
    {"path": "/debug/wire", "description": "wire-path caches: interned node-name universes, intern hit/miss/eviction counts, response-skeleton keys (404 without a device fastpath)"},
    {"path": "/debug/explain", "description": "causal event spine: the ordered event chain + narrative for one entity; filters: ?pod=<ns/name>&gang=<id>&request_id=<id>&node=<name> (404 when --events=off)"},
]

#: path -> (method, 404 body) of the JAX server's debug endpoints whose
#: planes are not ported, or not wired: the bytes it answers with each
#: plane off
PLANE_OFF: Dict[str, tuple] = {
    "/debug/rebalance": ("GET", b'{"error": "rebalancer not configured"}\n'),
    "/debug/gangs": ("GET", b'{"error": "gang scheduling not configured"}\n'),
    "/debug/admission": ("GET", b'{"error": "admission plane not configured"}\n'),
    "/debug/forecast": ("GET", b'{"error": "forecasting not configured"}\n'),
    "/debug/leader": ("GET", b'{"error": "leader election not configured"}\n'),
    "/debug/slo": ("GET", b'{"error": "slo engine not configured"}\n'),
    "/debug/control": ("GET", b'{"error": "budget controller not configured"}\n'),
    "/debug/solve": ("GET", b'{"error": "solve observatory not configured"}\n'),
    "/debug/shard": ("GET", b'{"error": "shard plane not configured"}\n'),
    "/debug/wire": ("GET", b'{"error": "no device fastpath (host-only mode)"}\n'),
    "/debug/record": ("GET", b'{"error": "flight recorder not configured"}\n'),
    "/debug/whatif": ("POST", b'{"error": "flight recorder not configured"}\n'),
    "/debug/profile": ("GET", b'{"error": "profiler unavailable"}\n'),
}


def parse_query(path: str) -> Dict[str, str]:
    """The ``?k=v&k2=v2`` tail of a request path as a dict with standard
    percent-decoding (a client sending ``?pod=default%2Fmy-pod`` must
    match the record keyed ``default/my-pod``); last occurrence of a
    repeated key wins."""
    from urllib.parse import unquote_plus

    _, _, query = path.partition("?")
    params: Dict[str, str] = {}
    for pair in query.split("&"):
        if not pair:
            continue
        key, _, value = pair.partition("=")
        params[unquote_plus(key)] = unquote_plus(value)
    return params


def not_found_handler(request: HTTPRequest) -> HTTPResponse:
    """404 catch-all for unknown paths (scheduler.go:79-84)."""
    klog.v(2).info_s(
        f"Requested resource: '{request.path}' not found", component="extender"
    )
    return HTTPResponse(status=404, headers={"Content-Type": "application/json"})


def apply_middleware(handler, request: HTTPRequest) -> HTTPResponse:
    """content-type -> content-length -> POST-only prechecks (scheduler.go:69-75).

    The content-type check is an exact string comparison, as in the reference
    (so ``application/json; charset=utf-8`` is rejected)."""
    if request.header("Content-Type") != "application/json":
        klog.v(2).info_s("request content type not application/json", component="extender")
        return HTTPResponse(status=404)
    if len(request.body) > MAX_CONTENT_LENGTH:
        klog.v(2).info_s("request size too large", component="extender")
        return HTTPResponse(status=500)
    if request.method != "POST":
        klog.v(2).info_s("method Type not POST", component="extender")
        return HTTPResponse(status=405)
    return handler(request)


_STATUS_REASON = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class HeadParseError(Exception):
    """A request head that must be answered with a simple error response
    and a closed connection; ``status`` is the response status."""

    def __init__(self, status: int):
        super().__init__(f"bad request head ({status})")
        self.status = status


def parse_request_head(head: bytes):
    """Sans-IO parse of one request head (the bytes before ``CRLFCRLF``):
    returns ``(method, path, version, headers, lowered, body_length)`` or
    raises :class:`HeadParseError`.  The framing rules: strict
    Content-Length validation, duplicate-CL and Transfer-Encoding
    rejection, the 1 GB body refusal."""
    lines = head.split(b"\r\n")
    parts = lines[0].split(b" ")
    if len(parts) != 3:
        raise HeadParseError(400)
    try:
        method = parts[0].decode("ascii")
        path = parts[1].decode("ascii")
        version = parts[2].decode("ascii")
    except UnicodeDecodeError:
        raise HeadParseError(400) from None
    headers: Dict[str, str] = {}
    content_lengths = []
    for line in lines[1:]:
        name, sep, value = line.partition(b":")
        if not sep:
            continue
        if name != name.rstrip(b" \t"):
            # whitespace before the colon lets 'Transfer-Encoding :'
            # dodge the checks below (RFC 7230 §3.2.4 says reject)
            raise HeadParseError(400)
        key = name.decode("latin-1")
        headers[key] = value.strip().decode("latin-1")
        if key.lower() == "content-length":
            content_lengths.append(headers[key])
    lowered = {k.lower(): v for k, v in headers.items()}
    if "transfer-encoding" in lowered:
        # chunked bodies aren't deframed here; leaving one in the
        # keep-alive buffer would desync pipelining (request
        # smuggling surface behind a proxy) — reject outright
        raise HeadParseError(400)
    if len(set(content_lengths)) > 1:
        # differing duplicates MUST 400 (RFC 7230 §3.3.2): a
        # first-wins proxy in front would frame differently
        raise HeadParseError(400)
    raw_length = content_lengths[0] if content_lengths else "0"
    # strict framing: ASCII digits only (int() would accept '+5',
    # '5_0', whitespace — all desync vectors)
    if not (raw_length.isascii() and raw_length.isdigit()):
        raise HeadParseError(400)
    length = int(raw_length)
    if length > MAX_CONTENT_LENGTH:
        # parity with the ContentLength middleware check: refuse to
        # slurp oversized bodies
        raise HeadParseError(500)
    return method, path, version, headers, lowered, length


def render_response(response: HTTPResponse, close: bool) -> bytes:
    """Status line + headers + body as one buffer (one sendall/write)."""
    reason = _STATUS_REASON.get(response.status, "Unknown")
    out = [f"HTTP/1.1 {response.status} {reason}\r\n".encode("ascii")]
    for k, v in response.headers.items():
        out.append(f"{k}: {v}\r\n".encode("latin-1"))
    out.append(f"Content-Length: {len(response.body)}\r\n".encode())
    if close:
        out.append(b"Connection: close\r\n")
    out.append(b"\r\n")
    out.append(response.body)
    return b"".join(out)


def render_simple(
    status: int, close: bool = False, request_id: str = ""
) -> bytes:
    """An empty-body status response (the head-framing error answers).
    ``request_id`` rides as ``X-Request-ID`` so even framing rejections
    are correlatable — for an unparseable head it is freshly generated
    (nothing client-sent survived the parse to echo)."""
    reason = _STATUS_REASON.get(status, "Unknown")
    extra = b"Connection: close\r\n" if close else b""
    if request_id:
        extra += f"X-Request-ID: {request_id}\r\n".encode("latin-1")
    return (
        f"HTTP/1.1 {status} {reason}\r\nContent-Length: 0\r\n".encode()
        + extra
        + b"\r\n"
    )


class _FastHTTPHandler(socketserver.BaseRequestHandler):
    """Minimal HTTP/1.1 connection handler for the extender hot path.

    Reads each request with a single rolling buffer (no per-line reads),
    dispatches through ``route`` (set by the enclosing Server), and writes
    status line + headers + body with one ``sendall``.  Supports
    keep-alive, pipelined requests, and ``Expect: 100-continue``.  Read
    and write timeouts mirror the reference server's 5 s / 10 s
    (scheduler.go:136-137)."""

    route = staticmethod(lambda request: HTTPResponse(status=500))
    rbufsize = 1 << 16

    def handle(self) -> None:  # noqa: C901 — one tight loop, deliberately
        sock = self.request
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        buf = bytearray()
        while True:
            # -- read the request head --------------------------------------
            # span timing starts at the request's FIRST byte (leftover
            # pipelined bytes count as already-arrived): stamping at loop
            # entry would charge keep-alive idle time between requests to
            # the next request's read stage (utils/trace.py)
            t_accept = time.perf_counter() if buf else None
            sock.settimeout(READ_HEADER_TIMEOUT_S)
            head_end = buf.find(b"\r\n\r\n")
            while head_end < 0:
                if len(buf) > MAX_HEAD_LENGTH:
                    self._send_simple(sock, 431, close=True)
                    return
                try:
                    chunk = sock.recv(self.rbufsize)
                except (TimeoutError, OSError):
                    return
                if not chunk:
                    return
                if t_accept is None:
                    t_accept = time.perf_counter()
                buf += chunk
                head_end = buf.find(b"\r\n\r\n")
            if head_end > MAX_HEAD_LENGTH:
                self._send_simple(sock, 431, close=True)
                return
            head = bytes(buf[:head_end])
            del buf[: head_end + 4]
            try:
                method, path, version, headers, lowered, length = (
                    parse_request_head(head)
                )
            except HeadParseError as exc:
                self._send_simple(sock, exc.status, close=True)
                return
            if lowered.get("expect", "").lower() == "100-continue":
                try:
                    sock.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
                except OSError:
                    return
            # -- read the body ----------------------------------------------
            while len(buf) < length:
                try:
                    chunk = sock.recv(self.rbufsize)
                except (TimeoutError, OSError):
                    return
                if not chunk:
                    return
                buf += chunk
            body = bytes(buf[:length])
            del buf[:length]
            # -- dispatch + respond ------------------------------------------
            request_id = lowered.get("x-request-id") or trace.new_request_id()
            span = trace.Span(f"{method} {path}", request_id, t0=t_accept)
            span.add_stage("read", time.perf_counter() - t_accept)
            request = HTTPRequest(
                method=method, path=path, headers=headers, body=body,
                span=span,
            )
            try:
                response = type(self).route(request)
            except Exception as exc:
                klog.error("handler raised: %r", exc)
                span.set("error", repr(exc))
                response = HTTPResponse(status=500)
            response.headers.setdefault("X-Request-ID", request_id)
            close = (
                version == "HTTP/1.0"
                or lowered.get("connection", "").lower() == "close"
            )
            sock.settimeout(WRITE_TIMEOUT_S)
            t_write = time.perf_counter()
            try:
                sock.sendall(render_response(response, close))
            except OSError:
                span.set("error", "write failed")
                return
            finally:
                span.add_stage("write", time.perf_counter() - t_write)
                trace.TRACES.add(span.finish(response.status))
            if close:
                return

    @staticmethod
    def _send_simple(sock, status: int, close: bool = False) -> None:
        try:
            sock.sendall(
                render_simple(status, close, request_id=trace.new_request_id())
            )
        except OSError:
            pass


class Server:
    """Wraps a Scheduler implementation with the HTTP(S) extender endpoint."""

    def __init__(self, scheduler: "Scheduler", metrics_provider=None):
        """``metrics_provider``: optional zero-arg callable returning
        Prometheus exposition text, served on GET /metrics.  /readyz
        evaluates the scheduler's ``readiness_conditions()``
        (utils/health.py)."""
        self.scheduler = scheduler
        self.metrics_provider = metrics_provider
        self.probe = health.probe_for(scheduler)
        self._httpd: Optional[socketserver.ThreadingTCPServer] = None
        self._ready = threading.Event()

    # -- routing -------------------------------------------------------------

    def route(self, request: HTTPRequest) -> HTTPResponse:
        # log lines emitted while serving carry the request's X-Request-ID
        rid = getattr(trace.of(request), "trace_id", "")
        with klog.request_context(rid):
            return self._route(request)

    def _route(self, request: HTTPRequest) -> HTTPResponse:  # noqa: C901 — one flat route table
        bare_path = request.path.partition("?")[0]
        if bare_path == "/healthz":
            if request.method != "GET":
                return HTTPResponse(status=405)
            return HTTPResponse.json(health.HEALTHZ_BODY)
        if bare_path == "/readyz":
            if request.method != "GET":
                return HTTPResponse(status=405)
            status, body = self.probe.readyz_response()
            return HTTPResponse.json(body, status=status)
        if bare_path == "/debug/leader" and request.method == "GET":
            # leader-election state (kube/lease.py); with no elector wired
            # (--leaderElect off) the plane-off 404 below answers
            leadership = getattr(self.scheduler, "leadership", None)
            if leadership is not None:
                return HTTPResponse.json(leadership.to_json())
        if bare_path == "/debug/forecast" and request.method == "GET":
            # the forecast fits and extrapolation state (forecast/engine.py);
            # with no forecaster wired (--forecast=off, GAS) the plane-off
            # 404 below answers
            forecaster = getattr(self.scheduler, "forecaster", None)
            if forecaster is not None:
                return HTTPResponse.json(forecaster.to_json())
        if bare_path == "/debug/wire" and request.method == "GET":
            # the wire path's caches (tas/fastpath.wire_debug); without a
            # device fastpath (host-only TAS, GAS) the 404 below answers
            fastpath = getattr(self.scheduler, "fastpath", None)
            if fastpath is not None:
                return HTTPResponse.json(json.dumps(fastpath.wire_debug()).encode() + b"\n")
        if bare_path in PLANE_OFF:
            method, body = PLANE_OFF[bare_path]
            if request.method != method:
                return HTTPResponse(status=405)
            return HTTPResponse.json(body, status=404)
        if bare_path == "/debug/traces":
            # recent + slowest completed request traces; always on
            if request.method != "GET":
                return HTTPResponse(status=405)
            params = parse_query(request.path)
            min_ms = None
            if "min_ms" in params:
                try:
                    min_ms = float(params["min_ms"])
                except ValueError:
                    return HTTPResponse.json(b'{"error": "min_ms must be a number"}\n', status=400)
            return HTTPResponse.json(trace.TRACES.to_json(verb=params.get("verb"), min_ms=min_ms))
        if bare_path == "/debug/decisions":
            # decision provenance; 404 while the log is off (--decisionLog=off)
            if request.method != "GET":
                return HTTPResponse(status=405)
            if not decisions.DECISIONS.enabled:
                return HTTPResponse.json(b'{"error": "decision log disabled"}\n', status=404)
            params = parse_query(request.path)
            try:
                limit = int(params.get("limit", "64"))
            except ValueError:
                return HTTPResponse.json(b'{"error": "limit must be an integer"}\n', status=400)
            return HTTPResponse.json(
                decisions.DECISIONS.to_json(
                    pod=params.get("pod"), verb=params.get("verb"), limit=limit
                )
            )
        if bare_path == "/debug/explain":
            # causal event spine; 404 while the journal is off (--events=off)
            if request.method != "GET":
                return HTTPResponse(status=405)
            if not events.JOURNAL.enabled:
                return HTTPResponse.json(b'{"error": "event journal disabled"}\n', status=404)
            params = parse_query(request.path)
            query = {key: params.get(key, "") for key in ("request_id", "pod", "gang", "node")}
            if not any(query.values()):
                return HTTPResponse.json(
                    b'{"error": "one of ?pod= ?gang= ?request_id= ?node= is required"}\n',
                    status=400,
                )
            return HTTPResponse.json(events.JOURNAL.to_json(**query))
        if bare_path in ("/debug", "/debug/"):
            if request.method != "GET":
                return HTTPResponse(status=405)
            return HTTPResponse.json(json.dumps({"endpoints": DEBUG_ENDPOINTS}).encode() + b"\n")
        if request.path == "/metrics" and self.metrics_provider is not None:
            # outside the POST/JSON middleware
            if request.method != "GET":
                return HTTPResponse(status=405)
            return HTTPResponse(
                status=200,
                headers={"Content-Type": "text/plain; version=0.0.4"},
                body=self.metrics_provider().encode(),
            )
        routes = {
            "/scheduler/prioritize": self.scheduler.prioritize,
            "/scheduler/filter": self.scheduler.filter,
            "/scheduler/bind": self.scheduler.bind,
        }
        handler = routes.get(request.path, not_found_handler)
        return apply_middleware(handler, request)

    # -- serving -------------------------------------------------------------

    def start_server(
        self,
        port: str,
        cert_file: str = "",
        key_file: str = "",
        ca_file: str = "",
        unsafe: bool = False,
        host: str = "",
        block: bool = True,
    ) -> None:
        """Start serving; mirrors ``Server.StartServer`` (scheduler.go:86-108).

        With ``unsafe=True`` serves plain HTTP; otherwise mutual-TLS with the
        pinned configuration.  ``block=False`` serves on a daemon thread
        (callers use :meth:`wait_ready` / :meth:`shutdown`).

        The connection loop is a slim hand-rolled HTTP/1.1 handler
        (keep-alive, single-buffer header parse, one sendall per response,
        TCP_NODELAY) rather than http.server's per-line machinery — at 10k
        nodes this layer runs on every request and its cost lands straight
        in p99 (the Go reference gets the equivalent from net/http's
        optimized server for free)."""
        server = self

        class Handler(_FastHTTPHandler):
            route = staticmethod(server.route)

        httpd = socketserver.ThreadingTCPServer(
            (host, int(port)), Handler, bind_and_activate=False
        )
        httpd.allow_reuse_address = True
        httpd.daemon_threads = True
        httpd.server_bind()
        httpd.server_activate()

        if unsafe:
            klog.v(2).info_s(f"Extender Listening on HTTP {port}", component="extender")
        else:
            context = configure_secure_context(cert_file, key_file, ca_file)
            httpd.socket = context.wrap_socket(httpd.socket, server_side=True)
            klog.v(2).info_s(f"Extender Listening on HTTPS {port}", component="extender")

        self._httpd = httpd
        self._ready.set()
        if block:
            httpd.serve_forever()
        else:
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def wait_ready(self, timeout: float = 10.0) -> bool:
        return self._ready.wait(timeout)

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._ready.clear()


def configure_secure_context(
    cert_file: str, key_file: str, ca_file: str
) -> ssl.SSLContext:
    """The mTLS configuration of ``configureSecureServer`` (scheduler.go:110-143):
    TLS >= 1.2, pinned AES-256-GCM ECDHE suites, client certs required and
    verified against the CA pool."""
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    context.minimum_version = ssl.TLSVersion.TLSv1_2
    context.verify_mode = ssl.CERT_REQUIRED
    try:
        context.load_verify_locations(cafile=ca_file)
    except (OSError, ssl.SSLError) as exc:
        klog.v(2).info_s(f"caCert read failed: {exc}", component="extender")
    context.load_cert_chain(certfile=cert_file, keyfile=key_file)
    # TLS 1.2 suites pinned as in the reference; TLS 1.3 suites are not
    # configurable (same stance as Go's CipherSuites field).
    context.set_ciphers("ECDHE-RSA-AES256-GCM-SHA384:ECDHE-ECDSA-AES256-GCM-SHA384")
    return context
