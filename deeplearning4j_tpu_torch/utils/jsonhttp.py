"""Tiny shared HTTP scaffolding for the port's servers (the model
inference server first). The port of the JAX package's
utils/jsonhttp.py: one place for the Content-Length / parse / respond /
error boilerplate.

Robustness contract: every socket read on a handler thread carries a
per-connection timeout (`request_timeout`, default 30s). Without it a
single slowloris client — open the connection, send headers, then
trickle or stall the body — pins one `dl4j-http-*` thread forever and,
repeated, starves the ThreadingHTTPServer. Timed-out connections are
dropped (no response: the peer is by definition not reading) and
counted under `http_request_timeout_total`.

Distributed tracing (utils/tracing, W3C trace-context): with tracing
enabled, every dispatched request runs under an `http/server` span that
JOINS the caller's trace when the request carries a valid `traceparent`
header (every server on this scaffold inherits it), and roots a fresh
trace when it doesn't — a malformed header is treated as absent, never as a
half-empty context. On the client side, `traced_headers()` merges the
active context into an outbound header dict. Both hooks degrade to one
flag check when tracing is off.

Tenant identity (utils/tenancy) rides the same rails: `_dispatch`
attaches the `X-Tenant` header's value for the handler's duration and
`traced_headers()` injects the ambient tenant outbound, so a request's
tenant crosses process boundaries next to its traceparent.
"""

from __future__ import annotations

import json
import math
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy
from deeplearning4j_tpu_torch.utils import tracing as _tracing

# handler contract: fn(path, body_bytes, headers) ->
#   (status, content_type, payload_bytes)            or
#   (status, content_type, payload_bytes, extra_headers_dict)  or
#   None for "no such route"
# A payload that is an ITERATOR of byte chunks (not bytes) streams back
# as a chunked HTTP/1.1 response — each chunk is flushed as produced
# (the decode engine's /generate token stream rides this).
Handler = Callable[[str, bytes, dict], Optional[Tuple]]


def _finite(obj):
    """Replace non-finite floats with None, recursively. json.dumps
    serializes float("nan") as bare `NaN`, which is NOT JSON — strict
    parsers (and most non-Python clients) reject the whole body. An
    idle endpoint's percentile fields are the canonical trigger: a
    /metrics scrape before the first request must still parse."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def json_response(obj, code: int = 200,
                  headers: Optional[dict] = None) -> Tuple:
    # common case (all-finite payloads, e.g. large /predict bodies) stays
    # on the C-speed serializer; only a non-finite payload pays the
    # Python-level _finite walk
    try:
        payload = json.dumps(obj, allow_nan=False)
    except ValueError:
        payload = json.dumps(_finite(obj), allow_nan=False)
    if headers:
        return code, "application/json", payload.encode(), dict(headers)
    return code, "application/json", payload.encode()


def html_response(text: str, code: int = 200) -> Tuple[int, str, bytes]:
    return code, "text/html", text.encode()


def traced_headers(headers: Optional[dict] = None) -> dict:
    """Outbound header dict with the active span context injected as a
    W3C `traceparent` — the client half of cross-process propagation
    One flag check when tracing is off; the input dict is never
    mutated."""
    out = dict(headers) if headers else {}
    tp = _tracing.current_traceparent()
    if tp is not None:
        out["traceparent"] = tp
    # the tenant identity rides next to the traceparent (one
    # thread-local read when no tenant is attached): a request made from
    # a metered fit carries the same identity serving books under
    t = _tenancy.current_tenant()
    if t is not None:
        out[_tenancy.HEADER] = t
    return out


class JsonHttpServer:
    """Threaded HTTP server with pluggable GET/POST handlers.

    Handlers may raise: the error is returned as a 400 JSON body and the
    server keeps serving (a malformed request must never kill a serving
    process)."""

    def __init__(self, *, get: Optional[Handler] = None,
                 post: Optional[Handler] = None, port: int = 0,
                 request_timeout: float = 30.0):
        self._get = get
        self._post = post
        self.port = int(port)
        # <= 0 means "no timeout" (the repo-wide 0-disables convention);
        # passing 0.0 through would make socketserver settimeout(0.0)
        # the connection NON-BLOCKING and drop every request
        self.request_timeout = (None if request_timeout is None
                                or float(request_timeout) <= 0
                                else float(request_timeout))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._m_timeouts = _metrics.get_registry().counter(
            "http_request_timeout_total",
            "connections dropped because a read exceeded the "
            "per-connection timeout (slowloris protection)").labels()

    def start(self) -> int:
        outer = self

        class _H(BaseHTTPRequestHandler):
            # socketserver.StreamRequestHandler.setup() applies this to
            # the connection: EVERY read (request line, headers, body)
            # has a deadline — one stalled client cannot pin the thread
            timeout = outer.request_timeout

            def log_message(self, *a):
                pass

            def log_error(self, fmt, *a):
                # the base handler's request-line/header timeout path
                # ("Request timed out: ...") reports only through
                # log_error — hook it so those drops are counted too
                if "timed out" in fmt:
                    outer._m_timeouts.inc()

            def _dispatch(self, handler: Optional[Handler]):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n) if n else b""
                except (socket.timeout, TimeoutError):
                    # slowloris body: drop the connection without a
                    # response — the peer is, by definition, not reading
                    outer._m_timeouts.inc()
                    self.close_connection = True
                    return
                # trace join: a valid traceparent header makes this
                # request's spans part of the caller's trace; absent or
                # malformed -> attach(None), a clean fresh root. The
                # whole block is one flag check when tracing is off.
                traced = _tracing.is_enabled()
                if traced:
                    tok = _tracing.attach(_tracing.parse_traceparent(
                        self.headers.get("traceparent")))
                    span = _tracing.span("http/server",
                                         method=self.command,
                                         path=self.path)
                else:
                    span = _tracing.NULL_SPAN
                # tenant identity rides NEXT TO the traceparent: attach
                # the X-Tenant header (if any) for the handler's
                # duration, so books/spend/exemplars on this thread
                # carry the caller's identity. Always-on — attach(None)
                # is one thread-local store; handlers that extract a
                # JSON-field tenant themselves still win (explicit args
                # override the ambient value downstream).
                ten_tok = _tenancy.attach(
                    _tenancy.from_headers(self.headers))
                try:
                    with span:
                        try:
                            # chaos hook: an `error` fault here is a
                            # handler crash (500, connection survives); a
                            # `latency`/`hang` is a stalled handler thread
                            _faults.fault_point("http_handler",
                                                path=self.path)
                            out = handler(self.path, body,
                                          dict(self.headers)) \
                                if handler else None
                            if out is None:
                                out = json_response(
                                    {"error": "not found"}, 404)
                        except _faults.FaultInjected as e:
                            out = json_response(
                                {"error": f"{type(e).__name__}: {e}"}, 500)
                        except Exception as e:  # keep serving
                            out = json_response(
                                {"error": f"{type(e).__name__}: {e}"}, 400)
                        code, ctype, payload = out[:3]
                        extra = out[3] if len(out) > 3 else None
                        if isinstance(payload, (bytes, bytearray)):
                            self.send_response(code)
                            self.send_header("Content-Type", ctype)
                            self.send_header("Content-Length",
                                             str(len(payload)))
                            if extra:
                                for k, v in extra.items():
                                    self.send_header(k, str(v))
                            self.end_headers()
                            self.wfile.write(payload)
                        else:
                            # streaming payload. A client that spoke
                            # HTTP/1.1 gets chunked framing (per-request
                            # protocol upgrade; the Content-Length path
                            # above stays 1.0); an HTTP/1.0 client
                            # cannot de-frame chunks, so it gets the raw
                            # flushed body with read-to-close framing.
                            chunked = self.request_version != "HTTP/1.0"
                            if chunked:
                                self.protocol_version = "HTTP/1.1"
                            self.send_response(code)
                            self.send_header("Content-Type", ctype)
                            if chunked:
                                self.send_header("Transfer-Encoding",
                                                 "chunked")
                            if extra:
                                for k, v in extra.items():
                                    self.send_header(k, str(v))
                            self.end_headers()
                            for chunk in payload:
                                if not chunk:
                                    continue
                                chunk = bytes(chunk)
                                if chunked:
                                    chunk = (b"%x\r\n" % len(chunk)
                                             + chunk + b"\r\n")
                                self.wfile.write(chunk)
                                self.wfile.flush()
                            if chunked:
                                self.wfile.write(b"0\r\n\r\n")
                            # one response per connection for streamed
                            # bodies: the peer reads to the terminal
                            # chunk (or to close); keep-alive buys
                            # nothing here
                            self.close_connection = True
                finally:
                    _tenancy.detach(ten_tok)
                    if traced:
                        _tracing.detach(tok)

            def do_GET(self):
                self._dispatch(outer._get)

            def do_POST(self):
                self._dispatch(outer._post)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), _H)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"dl4j-http-{self.port}")
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def join(self):
        if self._thread is not None:
            self._thread.join()
