"""REST serving of the generation stack (counterpart of
``veles_tpu/restful_api.py`` ``GenerationAPI``).

POST ``/generate`` with ``{"prompt": [ids], "n_new": N}`` (+ optional
``mode``: ``greedy`` | ``sample``, ``temperature``, ``seed``,
``eos_id``, ``request_id``) → ``{"tokens": [...], "batched_with": k,
"request_id": ...}``. ``GET /healthz`` answers while the service runs.

The decode plane is the reference's **window plane**: a worker thread
coalesces the queue for ``batch_window`` seconds and runs the requests
that share a shape key (:meth:`GenerationAPI._batch_key`) as ONE
batched ``nn.sampling.generate`` call. Per-row generator streams keep
every row's tokens equal to its solo decode, so batching never changes
answers. A ticket past its ``request_timeout`` deadline is answered
503 + Retry-After when the worker dequeues it.

Not ported yet, and answered 400 "not ported yet": ``mode=speculative``
and ``mode=beam``, and a service built with ``engine="continuous"``
(the reference's continuous-batching slot pool).
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional

from ._http import HTTPService, json_reply, read_json_object
from .backends import device_for
from .config import root
from .error import VelesError
from .logger import Logger
from .nn import sampling
from .serving.scheduler import Ticket, shed_expired, split_expired


class GenerationAPI(Logger):
    """Generation over HTTP for a :class:`~veles_tpu_torch.nn.
    standard_workflow.Forwards` stack. ``device`` defaults to the card
    (``backends.device_for``); the model is moved there. ``initialize``
    starts the HTTP service and the worker, ``stop`` drains them; the
    bound port is ``self.port``."""

    MODES = ("greedy", "sample", "speculative", "beam")
    PORTED_MODES = ("greedy", "sample")

    def __init__(self, model, port: int = 0, path: str = "/generate",
                 max_new: int = 512, batch_window: float = 0.02,
                 request_timeout: float = 120.0,
                 max_queue: Optional[int] = None,
                 engine: Optional[str] = None, device=None,
                 name: str = "generation_api") -> None:
        self.device = device_for(device)
        self.model = model.to(self.device)
        self.name = name
        self.port = port
        self.path = path
        self.max_new = int(max_new)
        self.batch_window = float(batch_window)
        self.request_timeout = float(request_timeout)
        self.max_queue = int(max_queue if max_queue is not None
                             else root.common.resilience.get(
                                 "max_queue", 256))
        self.engine_kind = str(engine or root.common.serving.get(
            "engine", "window"))
        self._service: Optional[HTTPService] = None
        self._queue: list = []
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closing = False
        self.batches_run = 0
        self.max_batch = 0

    # -- request intake ------------------------------------------------------
    def _parse(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of "
                             "token ids")
        n_new = body.get("n_new", 16)
        if not isinstance(n_new, int) or not 1 <= n_new <= self.max_new:
            raise ValueError("'n_new' must be an int in [1, %d]"
                             % self.max_new)
        mode = body.get("mode", "greedy")
        if mode not in self.MODES:
            raise ValueError("'mode' must be one of %s" % (self.MODES,))
        if mode not in self.PORTED_MODES:
            raise ValueError("mode=%s is not ported yet" % mode)
        try:
            temperature = float(body.get("temperature", 0.0))
            seed = int(body.get("seed", 0))
        except (TypeError, ValueError) as e:
            raise ValueError("non-numeric knob: %s" % e) from None
        if mode == "greedy":
            temperature = 0.0
        elif temperature <= 0:
            raise ValueError("mode=sample needs temperature > 0")
        eos_id = body.get("eos_id")
        if eos_id is not None and (isinstance(eos_id, bool)
                                   or not isinstance(eos_id, int)):
            raise ValueError("'eos_id' must be an int token id")
        request_id = body.get("request_id")
        if request_id is not None and (
                not isinstance(request_id, str)
                or not 1 <= len(request_id) <= 200):
            raise ValueError("'request_id' must be a non-empty string "
                             "of at most 200 chars")
        return {"prompt": [int(t) for t in prompt], "n_new": n_new,
                "mode": mode, "temperature": temperature, "seed": seed,
                "eos_id": eos_id, "request_id": request_id}

    @staticmethod
    def _batch_key(req):
        """Requests sharing this key ride one batched decode — greedy and
        sample alike (per-row generator streams make every row equal to
        its solo decode)."""
        return (req["mode"], len(req["prompt"]), req["n_new"],
                req["temperature"], req["seed"])

    # -- worker --------------------------------------------------------------
    @staticmethod
    def _trim_eos(tokens, eos_id):
        """Truncate through the first ``eos_id`` (inclusive). The decode
        itself runs the requested n_new, so a per-request eos never
        fragments a batch."""
        if eos_id is None:
            return list(tokens)
        out = []
        for t in tokens:
            out.append(t)
            if t == eos_id:
                break
        return out

    def _serve_group(self, reqs, tickets) -> None:
        try:
            rows = sampling.generate(
                self.model, [req["prompt"] for req in reqs],
                reqs[0]["n_new"], temperature=reqs[0]["temperature"],
                seed=reqs[0]["seed"])
        except Exception as e:        # noqa: BLE001 — answer, don't die
            # a decoder-raised ValueError/VelesError on a parsed request
            # is the client's shape problem — 400, not a server fault
            client = isinstance(e, (ValueError, VelesError))
            if not client:
                self.exception("%s: decode failed", self.name)
            for ticket in tickets:
                ticket.fail("%s: %s" % (type(e).__name__, e),
                            code=400 if client else 500)
            return
        for row, req, ticket in zip(rows, reqs, tickets):
            ticket.succeed({"tokens": self._trim_eos(row, req["eos_id"]),
                            "batched_with": len(reqs) - 1})

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait()
                if self._closing and not self._queue:
                    return
            # coalesce: let near-simultaneous requests join the batch
            if self.batch_window > 0:
                time.sleep(self.batch_window)
            with self._cv:
                pending, self._queue = self._queue, []
            pending, expired = split_expired(pending)
            shed_expired(expired)
            groups: Dict[Any, list] = {}
            for req, ticket in pending:
                groups.setdefault(self._batch_key(req),
                                  []).append((req, ticket))
            for group in groups.values():
                reqs = [r for r, _ in group]
                self._serve_group(reqs, [t for _, t in group])
                with self._cv:
                    self.batches_run += 1
                    self.max_batch = max(self.max_batch, len(reqs))

    # -- lifecycle -----------------------------------------------------------
    def _handler_class(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                api.debug("http: " + fmt, *args)

            def do_GET(self):
                if self.path != "/healthz":
                    self.send_error(404)
                    return
                json_reply(self, 200, {"status": "ok",
                                       "engine": api.engine_kind,
                                       "device": str(api.device)})

            def do_POST(self):
                if self.path != api.path:
                    self.send_error(404)
                    return
                if api.engine_kind != "window":
                    json_reply(self, 400, {
                        "error": "engine=%s is not ported yet (the port "
                                 "serves engine=window)" % api.engine_kind})
                    return
                try:
                    req = api._parse(read_json_object(self))
                except ValueError as e:
                    json_reply(self, 400, {"error": "bad request: %s" % e})
                    return
                ticket = Ticket(deadline=time.time() + api.request_timeout,
                                request_id=req["request_id"])
                with api._cv:
                    if api._closing:
                        reason = "server shutting down"
                    elif len(api._queue) >= api.max_queue:
                        reason = "generation queue full (%d/%d)" % (
                            len(api._queue), api.max_queue)
                    else:
                        reason = None
                        api._queue.append((req, ticket))
                        api._cv.notify()
                if reason is not None:
                    json_reply(self, 503, {"error": reason,
                                           "request_id": ticket.request_id},
                               headers={"Retry-After": "1"})
                    return
                # slack past the deadline: the worker's expiry answer
                # (503 + Retry-After) wins the race against this 504
                if not ticket.event.wait(api.request_timeout + 1.0):
                    json_reply(self, 504, {"error": "generation timed out",
                                           "request_id": ticket.request_id})
                    return
                if ticket.error is not None:
                    headers = None
                    if ticket.retry_after:
                        headers = {"Retry-After":
                                   str(max(1, int(ticket.retry_after)))}
                    json_reply(self, ticket.code, ticket.error_payload(),
                               headers=headers)
                    return
                json_reply(self, 200, ticket.result)

        return Handler

    def initialize(self) -> "GenerationAPI":
        """Start the worker and the HTTP service (idempotent)."""
        if self._service is not None:
            return self
        self._closing = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        daemon=True,
                                        name=self.name + ".genworker")
        self._worker.start()
        self._service = HTTPService(self._handler_class(), self.port,
                                    self.name + ".http")
        self.port = self._service.port
        self._service.start_serving()
        self.info("%s: generation API on http://127.0.0.1:%d%s (%s, "
                  "engine=%s)", self.name, self.port, self.path,
                  self.device, self.engine_kind)
        return self

    def stop(self) -> None:
        """Stop the HTTP service, let the worker finish the queue, and
        join it."""
        if self._service is not None:
            self._service.stop_serving()
            self._service = None
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
