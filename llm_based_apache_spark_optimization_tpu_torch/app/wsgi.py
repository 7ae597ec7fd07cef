"""In-tree WSGI micro-framework: routing, JSON, multipart, signed sessions.

The reference's web layer is Flask + FastAPI/uvicorn (reference
`Flask/app.py`, `FastAPI/app.py`); neither is installed in this image, so the
HTTP capability is built in-tree on the stdlib WSGI contract. Scope is
deliberately exactly what the product needs: static routes, query strings,
JSON bodies, multipart file upload, HMAC-signed cookie sessions, and a
threaded dev server. No magic globals — handlers take (Request) and return
(Response), so the layer is trivially unit-testable without sockets.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import io
import json as jsonlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, make_server

# --- request ----------------------------------------------------------------


@dataclass
class UploadedFile:
    filename: str
    content: bytes


class Request:
    def __init__(self, environ: Dict[str, Any]):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"].upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query: Dict[str, str] = {
            k: v[0] for k, v in parse_qs(environ.get("QUERY_STRING", "")).items()
        }
        self._body: Optional[bytes] = None
        self.form: Dict[str, str] = {}
        self.files: Dict[str, UploadedFile] = {}
        self.session: Dict[str, Any] = {}
        # Correlation id, assigned by App.__call__ when the app was built
        # with a request_id_factory — handlers read it instead of minting
        # their own, and the dispatch layer echoes it on EVERY response.
        self.request_id: str = ""
        ctype = environ.get("CONTENT_TYPE", "")
        if ctype.startswith("multipart/form-data"):
            self._parse_multipart(ctype)
        elif ctype.startswith("application/x-www-form-urlencoded"):
            self.form = {
                k: v[0] for k, v in parse_qs(self.body.decode("utf-8")).items()
            }

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
            self._body = self.environ["wsgi.input"].read(length) if length else b""
        return self._body

    def json(self) -> Any:
        return jsonlib.loads(self.body.decode("utf-8"))

    def _parse_multipart(self, ctype: str) -> None:
        boundary = None
        for part in ctype.split(";"):
            part = part.strip()
            if part.startswith("boundary="):
                boundary = part[len("boundary="):].strip('"')
        if not boundary:
            return
        delim = b"--" + boundary.encode()
        for chunk in self.body.split(delim)[1:]:  # [0] is the preamble
            if chunk.startswith(b"--"):
                break  # closing boundary
            # Multipart framing owes exactly one CRLF on each side of the
            # part; stripping more would corrupt payload bytes that happen
            # to end in newlines (e.g. CSVs with trailing blank lines).
            if chunk.startswith(b"\r\n"):
                chunk = chunk[2:]
            if chunk.endswith(b"\r\n"):
                chunk = chunk[:-2]
            if not chunk:
                continue
            header_blob, _, content = chunk.partition(b"\r\n\r\n")
            headers = {}
            for line in header_blob.split(b"\r\n"):
                name, _, value = line.partition(b":")
                headers[name.decode().lower().strip()] = value.decode().strip()
            disp = headers.get("content-disposition", "")
            attrs = {}
            for item in disp.split(";")[1:]:
                k, _, v = item.strip().partition("=")
                attrs[k] = v.strip('"')
            fname = attrs.get("name", "")
            if "filename" in attrs:
                self.files[fname] = UploadedFile(
                    filename=attrs["filename"], content=content
                )
            else:
                self.form[fname] = content.decode("utf-8")


# --- response ---------------------------------------------------------------

_STATUS = {200: "200 OK", 302: "302 Found", 400: "400 Bad Request",
           404: "404 Not Found", 405: "405 Method Not Allowed",
           429: "429 Too Many Requests", 500: "500 Internal Server Error",
           503: "503 Service Unavailable", 504: "504 Gateway Timeout"}


@dataclass
class Response:
    body: bytes = b""
    status: int = 200
    headers: List[Tuple[str, str]] = field(default_factory=list)
    # Streaming body: an iterable of byte chunks written (and flushed by the
    # WSGI server) as they are produced. Mutually exclusive with `body`; no
    # Content-Length is set, so the connection delivers chunks live.
    stream: Any = None

    @classmethod
    def json(cls, obj: Any, status: int = 200,
             headers: Optional[List[Tuple[str, str]]] = None) -> "Response":
        return cls(
            body=jsonlib.dumps(obj).encode(),
            status=status,
            headers=[("Content-Type", "application/json")]
            + list(headers or []),
        )

    @classmethod
    def ndjson_stream(cls, chunks) -> "Response":
        """Newline-delimited JSON streaming (the Ollama wire shape): each
        element of `chunks` is dumped as one line and flushed immediately."""
        def gen():
            for obj in chunks:
                yield (jsonlib.dumps(obj) + "\n").encode()

        return cls(
            stream=gen(),
            headers=[("Content-Type", "application/x-ndjson")],
        )

    @classmethod
    def html(cls, text: str, status: int = 200) -> "Response":
        return cls(
            body=text.encode(), status=status,
            headers=[("Content-Type", "text/html; charset=utf-8")],
        )

    @classmethod
    def redirect(cls, location: str) -> "Response":
        return cls(status=302, headers=[("Location", location)])


# --- signed cookie sessions -------------------------------------------------


class SessionCodec:
    """HMAC-SHA256-signed base64 JSON cookie — stateless server-side."""

    def __init__(self, secret: str):
        self._key = secret.encode()

    def encode(self, data: Dict[str, Any]) -> str:
        payload = base64.urlsafe_b64encode(jsonlib.dumps(data).encode()).decode()
        sig = hmac.new(self._key, payload.encode(), hashlib.sha256).hexdigest()
        return f"{payload}.{sig}"

    def decode(self, cookie: str) -> Dict[str, Any]:
        try:
            payload, sig = cookie.rsplit(".", 1)
            want = hmac.new(self._key, payload.encode(), hashlib.sha256).hexdigest()
            if not hmac.compare_digest(sig, want):
                return {}
            return jsonlib.loads(base64.urlsafe_b64decode(payload.encode()))
        except Exception:
            return {}


# --- app --------------------------------------------------------------------

Handler = Callable[[Request], Response]


class App:
    """Route table + WSGI callable."""

    SESSION_COOKIE = "session"

    def __init__(self, secret_key: str = "dev",
                 request_id_factory: Optional[Callable[[], str]] = None):
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._codec = SessionCodec(secret_key)
        self._before: List[Callable[[Request], Optional[Response]]] = []
        # When set, every request gets an id at DISPATCH (req.request_id)
        # and every response — before-gate answers, 404/405, handler
        # results, and the last-resort 500 guard alike — carries it as
        # X-Request-Id. Structural: a handler cannot forget the header,
        # and the 500s a user reports by id are exactly the ones that
        # must have one.
        self._rid_factory = request_id_factory

    def route(self, path: str, methods: Tuple[str, ...] = ("GET",)):
        def deco(fn: Handler) -> Handler:
            for m in methods:
                self._routes[(m.upper(), path)] = fn
            return fn
        return deco

    def before_request(
        self, fn: Callable[[Request], Optional[Response]]
    ) -> Callable[[Request], Optional[Response]]:
        """Register a gate that runs before routing: returning a Response
        short-circuits the request (None lets it through). The drain gate
        (app/health.py) uses this to answer 503 + Retry-After for new work
        during graceful shutdown without touching every handler."""
        self._before.append(fn)
        return fn

    def __call__(self, environ, start_response):
        req = Request(environ)
        if self._rid_factory is not None:
            req.request_id = self._rid_factory()
        cookie_header = environ.get("HTTP_COOKIE", "")
        had_cookie = False
        for part in cookie_header.split(";"):
            name, _, value = part.strip().partition("=")
            if name == self.SESSION_COOKIE and value:
                req.session = self._codec.decode(value)
                had_cookie = True
        session_before = jsonlib.dumps(req.session, sort_keys=True)
        resp = None
        for gate in self._before:
            try:
                resp = gate(req)
            except Exception as e:  # a broken gate must not take the app down
                resp = Response.json(
                    {"error": "internal server error", "detail": str(e)},
                    status=500,
                )
            if resp is not None:
                break
        handler = self._routes.get((req.method, req.path))
        if resp is not None:
            pass  # a before-request gate answered (e.g. drain mode)
        elif handler is None:
            if any(p == req.path for (_, p) in self._routes):
                resp = Response.json({"error": "method not allowed"}, status=405)
            else:
                resp = Response.json({"error": "not found"}, status=404)
        else:
            try:
                resp = handler(req)
            except Exception as e:  # last-resort guard: never leak a traceback page
                resp = Response.json(
                    {"error": "internal server error", "detail": str(e)}, status=500
                )
        headers = list(resp.headers)
        if req.request_id and not any(h[0] == "X-Request-Id"
                                      for h in headers):
            headers.append(("X-Request-Id", req.request_id))
        # Only set the cookie when this request changed the session: a
        # concurrent read-only poll (e.g. /status during a long
        # /process-data/) must not clobber the session another response
        # just wrote (it would race away the stored result).
        if (not had_cookie
                or jsonlib.dumps(req.session, sort_keys=True) != session_before):
            headers.append(
                ("Set-Cookie",
                 f"{self.SESSION_COOKIE}={self._codec.encode(req.session)}; "
                 f"Path=/; HttpOnly")
            )
        if resp.stream is not None:
            # Streaming responses carry no Content-Length; the WSGI server
            # writes/flushes each yielded chunk (wsgiref flushes per write).
            start_response(
                _STATUS.get(resp.status, f"{resp.status} Unknown"), headers
            )
            return resp.stream
        headers.append(("Content-Length", str(len(resp.body))))
        start_response(_STATUS.get(resp.status, f"{resp.status} Unknown"), headers)
        return [resp.body]

    # --- test client (no sockets) ------------------------------------------

    def test_client(self) -> "TestClient":
        return TestClient(self)

    # --- dev server ---------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False, ready_cb=None):
        """`ready_cb(server)` runs with the bound server BEFORE requests
        flow — on the main thread, so callers can install signal handlers
        (the SIGTERM graceful-drain wiring in app/__main__.py) against the
        live server instance even in foreground mode."""
        import socketserver
        from wsgiref.simple_server import WSGIServer

        class QuietHandler(WSGIRequestHandler):
            def log_message(self, *a):  # noqa: N802
                pass

        class ThreadingServer(socketserver.ThreadingMixIn, WSGIServer):
            # Threaded: the UI polls /status while /process-data/ runs.
            daemon_threads = True

        server = make_server(
            host, port, self, server_class=ThreadingServer,
            handler_class=QuietHandler,
        )
        if ready_cb is not None:
            ready_cb(server)
        if background:
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            return server
        server.serve_forever()


class TestClient:
    """Drives the WSGI app in-process; keeps cookies across requests."""

    def __init__(self, app: App):
        self.app = app
        self.cookies: Dict[str, str] = {}

    def request(self, method: str, path: str, body: bytes = b"",
                content_type: str = "", query: str = "",
                headers: Optional[Dict[str, str]] = None) -> "TestResponse":
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "QUERY_STRING": query,
            "CONTENT_TYPE": content_type,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "HTTP_COOKIE": "; ".join(f"{k}={v}" for k, v in self.cookies.items()),
        }
        # Extra request headers (e.g. X-Lsot-Tenant) in WSGI environ form.
        for name, value in (headers or {}).items():
            environ["HTTP_" + name.upper().replace("-", "_")] = value
        captured: Dict[str, Any] = {}

        def start_response(status, headers):
            captured["status"] = int(status.split()[0])
            captured["headers"] = headers

        chunks = self.app(environ, start_response)
        for name, value in captured["headers"]:
            if name == "Set-Cookie":
                cookie = value.split(";")[0]
                k, _, v = cookie.partition("=")
                self.cookies[k] = v
        return TestResponse(
            status=captured["status"],
            headers=dict(captured["headers"]),
            body=b"".join(chunks),
        )

    def get(self, path: str, query: str = "") -> "TestResponse":
        return self.request("GET", path, query=query)

    def post_json(self, path: str, obj: Any,
                  headers: Optional[Dict[str, str]] = None) -> "TestResponse":
        return self.request(
            "POST", path, jsonlib.dumps(obj).encode(), "application/json",
            headers=headers,
        )

    def post_multipart(self, path: str, fields: Dict[str, str],
                       files: Dict[str, Tuple[str, bytes]]) -> "TestResponse":
        boundary = "graftboundary123"
        parts = []
        for k, v in fields.items():
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
                f"\r\n\r\n{v}\r\n".encode()
            )
        for k, (fname, content) in files.items():
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                f'filename="{fname}"\r\nContent-Type: text/csv\r\n\r\n'.encode()
                + content + b"\r\n"
            )
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        return self.request(
            "POST", path, body, f"multipart/form-data; boundary={boundary}"
        )


@dataclass
class TestResponse:
    status: int
    headers: Dict[str, str]
    body: bytes

    def json(self) -> Any:
        return jsonlib.loads(self.body.decode())

    @property
    def text(self) -> str:
        return self.body.decode()
