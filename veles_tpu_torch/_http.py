"""Stdlib-HTTP scaffolding (trimmed counterpart of ``veles_tpu/_http.py``):
the JSON reply/request helpers and the daemon-thread serve/shutdown
lifecycle."""

from __future__ import annotations

import json
import threading
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional


def json_reply(handler, code: int, payload: Any,
               headers: Optional[Dict[str, str]] = None) -> None:
    data = json.dumps(payload).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    for name, value in (headers or {}).items():
        handler.send_header(name, value)
    handler.end_headers()
    handler.wfile.write(data)


def read_json_object(handler) -> Dict[str, Any]:
    """Parse the request body as a JSON *object*; raises ValueError on
    malformed JSON and on valid-JSON non-objects."""
    length = int(handler.headers.get("Content-Length", 0))
    body = json.loads(handler.rfile.read(length) or b"{}")
    if not isinstance(body, dict):
        raise ValueError("JSON object expected, got %s" %
                         type(body).__name__)
    return body


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of concurrent
    # clients overflows it while the accept thread waits for the
    # interpreter lock, and the overflowing connections are reset
    request_queue_size = 128


class HTTPService:
    """Owns a ThreadingHTTPServer + daemon thread."""

    def __init__(self, handler_cls, port: int = 0,
                 thread_name: str = "http",
                 host: str = "127.0.0.1") -> None:
        self._httpd = _Server((host, port), handler_cls)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None
        self._thread_name = thread_name

    def start_serving(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=self._thread_name)
        self._thread.start()

    def stop_serving(self) -> None:
        if self._thread is not None:
            # shutdown() waits on an event only serve_forever() sets —
            # calling it on a never-started server deadlocks
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
