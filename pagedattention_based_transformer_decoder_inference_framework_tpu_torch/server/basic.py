"""Dependency-free HTTP server (stdlib) over :class:`ServerCore` (the
JAX package's ``server/basic.py``).

A ``ThreadingHTTPServer`` serving the same endpoints with the same JSON
bodies and streaming framings as the FastAPI app (``app.py``), chunked
newline-JSON by default and SSE with ``?sse=1``; an unknown path answers
404 and an invalid payload 422.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..config import FrameworkConfig
from .core import ServerCore
from .schema import (BatchGenerateRequest, BeamStreamRequest,
                     GenerateRequest, StreamChatRequest)

_ROUTES = {
    "/generate": ("generate", GenerateRequest, False),
    "/generate_batch": ("generate_batch", BatchGenerateRequest, False),
    "/stream_generate": ("stream_generate", GenerateRequest, True),
    "/stream_chat": ("stream_chat", StreamChatRequest, True),
    "/stream_chat_beam": ("stream_chat_beam", BeamStreamRequest, True),
}


def _make_handler(core: ServerCore):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet; metrics cover it
            if core.config.runtime.enable_logging:
                super().log_message(fmt, *args)

        def _json(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                return self._json(200, core.healthz())
            if path == "/metrics":
                return self._json(200, core.get_metrics())
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            # the body is read before routing, so that an unknown path
            # leaves no unread bytes on a kept-alive connection
            try:
                raw = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
            except ValueError:
                raw = None
            route = _ROUTES.get(url.path)
            if route is None:
                return self._json(404, {"error": "not found"})
            method, schema, streaming = route
            try:
                if raw is None:
                    raise ValueError("bad Content-Length")
                payload = json.loads(raw or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("the body must be a JSON object")
                req = schema(**payload)
            except Exception as e:             # validation error -> 422
                return self._json(422, {"error": str(e)})
            try:
                if not streaming:
                    return self._json(200, getattr(core, method)(req))
                sse = parse_qs(url.query).get("sse", ["0"])[0] in (
                    "1", "true")
                frames = getattr(core, method)(req, sse)
                self.send_response(200)
                ctype = ("text/event-stream" if sse
                         else "application/x-ndjson")
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for frame in frames:
                    data = frame.encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:
                # ServerCore records the failure (with real token
                # counts) before raising; recording here again would
                # double-count requests_failed
                try:
                    self._json(500, {"error": str(e)})
                except Exception:
                    pass

    return Handler


class BasicServer:
    """Threaded stdlib HTTP server; ``serve_forever`` or background.
    ``shutdown`` also stops the core's scheduler."""

    def __init__(self, config: Optional[FrameworkConfig] = None,
                 engine=None, reranker=None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 core: Optional[ServerCore] = None):
        self.core = core or ServerCore(config, engine=engine,
                                       reranker=reranker)
        cfg = self.core.config
        self.httpd = ThreadingHTTPServer(
            (host or cfg.server.host, port if port is not None
             else cfg.server.port),
            _make_handler(self.core))
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.core.close()
