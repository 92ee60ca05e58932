"""REST serving of the generation stack (counterpart of
``veles_tpu/restful_api.py`` ``GenerationAPI``).

POST ``/generate`` with ``{"prompt": [ids], "n_new": N}`` (+ optional
``mode``: ``greedy`` | ``sample``, ``temperature``, ``seed``,
``eos_id``, ``request_id``) → ``{"tokens": [...], "batched_with": k,
"request_id": ...}`` (+ ``"engine": "continuous"`` when the slot pool
answered). ``GET /healthz`` answers while the service runs; ``GET
/stats`` is the engine's occupancy as JSON and
``GET /metrics`` the counters and serving gauges as plain text.

Three decode planes, as in the reference:

- the **continuous-batching engine** (``serving/engine.py``, the
  default ``engine="continuous"``): a paged KV slot pool, bucketed
  prefill, one batched decode step for every live row. A stack that is
  not a transformer generation stack tries the O(1)-state lane next,
  then falls back to the window plane with a warning; knob geometry
  that cannot work raises ValueError;
- the **O(1)-state lane** (``serving/recurrent.py``; pinned with
  ``engine="recurrent"``, which degrades to the window plane on a
  stack that is not recurrent): a fixed per-slot state pool for
  ``Embedding`` → LSTM/RNN/SSM → ``LMHead`` stacks. ``/stats`` and
  ``/metrics`` then report its state pool (``slot_kind`` "state",
  ``pages_total`` 0, no page gauges);
- the **window plane**, which takes every request the pool cannot hold
  (a prompt longer than the largest bucket, a window past
  ``max_context``, too cold a temperature): a worker thread coalesces
  the queue for ``batch_window`` seconds and runs the requests that
  share a shape key (:meth:`GenerationAPI._batch_key`) as ONE batched
  ``nn.sampling.generate`` call. Per-row generator streams keep every
  row's tokens equal to its solo decode.

A ticket past its ``request_timeout`` deadline is answered 503 +
Retry-After when a plane dequeues it. Not ported yet, and answered 400
"not ported yet": ``mode=speculative`` and ``mode=beam``.
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
from .serving import ContinuousEngine, RecurrentEngine
from .serving.scheduler import Ticket, shed_expired, split_expired
from .telemetry.counters import METRICS_CONTENT_TYPE, metrics_text

ENGINES = ("continuous", "recurrent", "window")


class GenerationAPI(Logger):
    """Generation over HTTP for a :class:`~veles_tpu_torch.nn.
    standard_workflow.Forwards` stack. ``device`` defaults to the card
    (``backends.device_for``); the model is moved there. ``engine``
    (default ``root.common.serving.engine``, "continuous") picks the
    decode plane; the slot-pool knobs default to
    ``root.common.serving``. ``initialize`` starts the engine, the
    window worker and the HTTP service, ``stop`` drains them; the bound
    port is ``self.port``."""

    MODES = ("greedy", "sample", "speculative", "beam")
    PORTED_MODES = ("greedy", "sample")

    def __init__(self, model, port: int = 0, path: str = "/generate",
                 max_new: int = 512, batch_window: float = 0.02,
                 request_timeout: float = 120.0,
                 max_queue: Optional[int] = None,
                 engine: Optional[str] = None,
                 max_slots: Optional[int] = None, buckets=None,
                 max_context: Optional[int] = None,
                 decode_block: Optional[int] = None,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None, device=None,
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
        cfg = root.common.serving
        self.engine_kind = str(engine or cfg.get("engine", "continuous"))
        if self.engine_kind not in ENGINES:
            raise ValueError("engine=%s is not ported yet (have: %s)"
                             % (self.engine_kind, ", ".join(ENGINES)))

        def knob(value, key, default):
            return cfg.get(key, default) if value is None else value

        self.max_slots = int(knob(max_slots, "max_slots", 8))
        self.buckets = knob(buckets, "buckets", (16, 32, 64, 128))
        self.max_context = int(knob(max_context, "max_context", 640))
        self.decode_block = int(knob(decode_block, "decode_block", 1))
        self.page_size = page_size
        self.pages = pages
        #: the ContinuousEngine or RecurrentEngine; None = the window plane
        self._engine = None
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
                engine = api._engine       # stop() may null it mid-GET
                if self.path == "/healthz":
                    json_reply(self, 200, {
                        "status": "ok",
                        "engine": ("continuous" if engine is not None
                                   else "window"),
                        "device": str(api.device)})
                elif self.path == "/stats":
                    stats = {"engine": ("continuous" if engine is not None
                                        else "window"),
                             "batches_run": api.batches_run,
                             "max_batch": api.max_batch,
                             "queue_depth": len(api._queue)}
                    if engine is not None:
                        stats["continuous"] = engine.stats()
                    json_reply(self, 200, stats)
                elif self.path == "/metrics":
                    data = metrics_text(api._metrics_gauges()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", METRICS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self.send_error(404)

            def _shed(self, reason, ticket, retry_after):
                json_reply(self, 503, {"error": reason,
                                       "request_id": ticket.request_id},
                           headers={"Retry-After": str(retry_after)})

            def do_POST(self):
                if self.path != api.path:
                    self.send_error(404)
                    return
                try:
                    req = api._parse(read_json_object(self))
                except ValueError as e:
                    json_reply(self, 400, {"error": "bad request: %s" % e})
                    return
                ticket = Ticket(deadline=time.time() + api.request_timeout,
                                request_id=req["request_id"])
                engine = api._engine
                if engine is not None and engine.accepts(req) is None:
                    # the slot pool: admitted at the next step boundary
                    if api._closing:
                        self._shed("server shutting down", ticket, 5)
                        return
                    if not engine.submit(req, ticket,
                                         max_queue=api.max_queue,
                                         checked=True):
                        if engine.closing:
                            self._shed("server shutting down", ticket, 5)
                        else:
                            self._shed("generation queue full (%d/%d)" % (
                                engine.scheduler.queue_depth(),
                                api.max_queue), ticket, 1)
                        return
                else:
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
                        self._shed(reason, ticket, 1)
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

    def _metrics_gauges(self) -> Dict[str, float]:
        """The serving gauges behind ``GET /metrics``."""
        gauges = {"veles_generate_batches_run": self.batches_run,
                  "veles_generate_max_batch": self.max_batch,
                  "veles_generate_queue_depth": len(self._queue),
                  "veles_generate_queue_bound": self.max_queue}
        engine = self._engine
        if engine is not None:
            st = engine.stats()
            gauges.update({
                "veles_serving_slots": st["slots"],
                "veles_serving_slots_busy": st["slots_busy"],
                "veles_serving_peak_slots": st["peak_slots"],
                "veles_serving_queue_depth": st["queue_depth"],
                "veles_serving_kv_pool_bytes": st["kv_pool_bytes"]})
            if st.get("slot_kind", "paged") == "state":
                # the O(1)-state pool: no page rows, its per-slot state
                gauges.update({
                    "veles_o1_state_bytes_per_slot":
                        st["state_bytes_per_slot"],
                    "veles_o1_state_cache_blocks":
                        st["state_cache_blocks"],
                    "veles_o1_state_cache_bytes": st["state_cache_bytes"],
                    "veles_o1_checkpoint_interval": st["page_size"]})
            else:
                gauges.update({
                    "veles_serving_pages_total": st["pages_total"],
                    "veles_serving_pages_in_use": st["pages_in_use"],
                    "veles_serving_page_size": st["page_size"],
                    "veles_serving_page_fragmentation":
                        st["page_fragmentation"]})
        return gauges

    def _build_engine(self):
        """The slot-pool engine ``engine_kind`` asks for, or None (with a
        warning) when the model cannot ride it. "continuous" tries the
        paged engine, then the O(1)-state lane; "recurrent" the lane
        only. Knob geometry that cannot work raises ValueError: an
        operator who asked for a slot pool must not silently get the
        window plane instead."""
        if self.engine_kind == "continuous":
            try:
                return ContinuousEngine(
                    self.model, max_slots=self.max_slots,
                    buckets=self.buckets, max_context=self.max_context,
                    decode_block=self.decode_block,
                    page_size=self.page_size, pages=self.pages,
                    device=self.device, name=self.name).start()
            except VelesError as e:
                paged_said = e
        try:
            engine = RecurrentEngine(
                self.model, max_slots=self.max_slots,
                max_context=self.max_context,
                decode_block=self.decode_block, page_size=self.page_size,
                device=self.device, name=self.name).start()
        except VelesError as e:
            self.warning("%s: slot-pool serving unavailable (%s); serving "
                         "via the window worker", self.name, e)
            return None
        if self.engine_kind == "continuous":
            self.info("%s: recurrent stack (paged pool said: %s); serving "
                      "via the O(1)-state slot pool", self.name, paged_said)
        return engine

    def initialize(self) -> "GenerationAPI":
        """Start the engine, the worker and the HTTP service
        (idempotent)."""
        if self._service is not None:
            return self
        if self.engine_kind != "window" and self._engine is None:
            self._engine = self._build_engine()
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
                  self.device, type(self._engine).__name__
                  if self._engine is not None else "window")
        return self

    def stop(self) -> None:
        """Stop the HTTP service, stop the engine (answering what it
        still holds), let the worker finish the queue, and join it."""
        if self._service is not None:
            self._service.stop_serving()
            self._service = None
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        engine, self._engine = self._engine, None
        if engine is not None:
            engine.stop()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
