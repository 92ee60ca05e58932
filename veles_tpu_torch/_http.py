"""Stdlib-HTTP scaffolding (trimmed counterpart of ``veles_tpu/_http.py``):
the JSON and bytes reply helpers, the SSE framing of token streaming,
the request parser, the ``GET /trace/spans`` pull and the daemon-thread
serve/shutdown lifecycle."""

from __future__ import annotations

import json
import threading
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional


def json_reply(handler, code: int, payload: Any,
               headers: Optional[Dict[str, str]] = None) -> None:
    bytes_reply(handler, code, json.dumps(payload).encode(),
                "application/json", headers=headers)


def bytes_reply(handler, code: int, data: bytes, ctype: str,
                headers: Optional[Dict[str, str]] = None) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    for name, value in (headers or {}).items():
        handler.send_header(name, value)
    handler.end_headers()
    handler.wfile.write(data)


def sse_headers(handler) -> None:
    """Commit a 200 ``text/event-stream`` response. An HTTP/1.1 client
    gets it chunked (each event one chunk, :func:`sse_end` the last);
    an HTTP/1.0 client gets the events until the connection closes.
    The connection closes after the stream either way."""
    handler._sse_chunked = handler.request_version == "HTTP/1.1"
    if handler._sse_chunked:
        # the status line carries the handler's protocol version
        handler.protocol_version = "HTTP/1.1"
    handler.send_response(200)
    handler.send_header("Content-Type", "text/event-stream")
    handler.send_header("Cache-Control", "no-store")
    if handler._sse_chunked:
        handler.send_header("Transfer-Encoding", "chunked")
    handler.send_header("Connection", "close")
    handler.end_headers()
    handler.close_connection = True


def _sse_write(handler, data: bytes) -> None:
    if handler._sse_chunked:
        data = b"%x\r\n%s\r\n" % (len(data), data)
    handler.wfile.write(data)
    handler.wfile.flush()


def sse_event(handler, payload: Any) -> None:
    """Write one ``data: <json>`` SSE event and flush. Write errors (the
    client went away) propagate to the caller."""
    _sse_write(handler, b"data: " + json.dumps(payload).encode()
               + b"\n\n")


def sse_end(handler) -> None:
    """End a stream :func:`sse_headers` opened (the last chunk)."""
    if handler._sse_chunked:
        handler.wfile.write(b"0\r\n\r\n")
        handler.wfile.flush()


def handle_trace_spans(handler, path: str, name: str = "") -> bool:
    """Serve ``GET /trace/spans[?since=CURSOR]``, the span-ring pull:
    a JSONL body (a header line, then one line per span appended after
    the cursor) so a torn read salvages per record. Returns True when
    the path was this one."""
    if path.split("?", 1)[0] != "/trace/spans":
        return False
    since = 0
    if "?" in path:
        from urllib.parse import parse_qs
        try:
            since = int(parse_qs(path.split("?", 1)[1]
                                 ).get("since", ["0"])[0])
        except (TypeError, ValueError):
            json_reply(handler, 400,
                       {"error": "since must be an integer cursor"})
            return True
    from .telemetry.spans import pull_payload
    bytes_reply(handler, 200, pull_payload(since, name=name).encode(),
                "application/x-ndjson")
    return True


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
