"""REST serving (counterpart of ``veles_tpu/restful_api.py``): the
classic serving unit of a trained classifier, :class:`RESTfulAPI`, and
the generation stack's :class:`GenerationAPI`.

:class:`RESTfulAPI` is VELES's original serving path, a unit of a
forward workflow wired ``Repeater → RestfulLoader → forwards →
RESTfulAPI``: POST ``/api`` with ``{"input": [...]}`` (or, through an
image loader, ``{"image": base64}``) → ``{"result": [...], "request_id":
...}``, the forward's row for that sample. The HTTP handler feeds the
sample with a ticket to the loader and waits on it; the loader batches
every request queued at its run into one minibatch (dynamic batching);
the forwards run on the workflow's device; the unit's ``run`` answers
row i's ticket from the forward's output. A bad body or shape answers
400, a closed loader or a full ``max_pending`` bound 503 (+ Retry-After
for the bound), a timeout 504. ``GET /healthz``, ``/readyz``,
``/trace/spans`` and ``/metrics`` (``veles_rest_requests_served``,
``veles_rest_pending``) as the reference's; its ``/metrics/history`` and
``/alerts`` (the timeseries and alerts planes, not ported) answer 404.

:class:`GenerationAPI`:

POST ``/generate`` with ``{"prompt": [ids], "n_new": N}`` (+ optional
``mode``: ``greedy`` | ``sample`` | ``speculative`` | ``beam``,
``temperature``, ``seed``, ``gamma``, ``beam``, ``eos_id``, ``stream``,
``request_id``, ``resume_tokens``, ``priority``: ``interactive`` |
``batch``, ``deadline_ms``) → ``{"tokens": [...], "batched_with": k,
"request_id": ...}`` (+ ``"engine": "continuous"`` when the slot pool
answered; ``rounds`` and ``acceptance`` for ``mode=speculative``, the
ranked hypotheses' ``scores`` for ``mode=beam``); a ``trace_id`` and a
1-based ``attempt`` tag the request's spans. ``mode=speculative`` needs
a ``draft`` stack on the server; ``gamma`` and ``beam`` default to the
engine's fixed ``spec_gamma`` and ``beam_width``. ``"stream": true``
answers with HTTP/1.1 chunked server-sent events instead of one body:
one ``data: {"tokens": [...], "i": k}`` event per step boundary (the
window plane bursts its tokens once, before the terminal event), then
``data: {..., "done": true}`` carrying the whole answer or the error;
``root.common.serving.stream = False`` answers every request buffered.
``GET /healthz`` and ``GET /readyz`` are the health plane's liveness and
readiness probes (``resilience/health.py``: ``/readyz`` says
"draining" from :meth:`GenerationAPI.begin_drain` on); ``GET /stats`` is
the engine's kind, device, modes (``speculative_enabled``: a draft is
configured) and occupancy as JSON, ``GET
/metrics`` the counters, the serving SLO histograms with their
p50/p90/p99 and the serving gauges as plain text, and ``GET
/trace/spans[?since=CURSOR]`` the span ring as JSONL.

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
  ``max_context``, too cold a temperature, a ``gamma`` or ``beam`` other
  than the pool's): a worker thread coalesces the queue for
  ``batch_window`` seconds and runs the requests that share a shape key
  (:meth:`GenerationAPI._batch_key`) as ONE batched
  ``nn.sampling.generate`` or ``nn.speculative.generate_speculative``
  call, and each beam request as its own ``nn.beam.beam_generate``.
  Per-row generator streams keep every row's tokens equal to its solo
  decode; a sampled speculative request is never coalesced.

A ticket past its deadline (``request_timeout``, or the request's
tighter ``deadline_ms``) is answered 503 + Retry-After when a plane
dequeues it. ``priority`` (default ``interactive``) is the request's QoS
class: with ``root.common.serving.qos`` on, the slot pools admit
interactive requests first and preempt batch rows for them without loss
(``serving/engine.py``).

The lossless request plane, as the reference's: a request cut short
mid-decode (an injected ``serve.decode_step`` or ``serve.replica_death``
fault, a drain) is answered 503 with ``{"resume": {"tokens": [...],
"tokens_done": k}}``; a retry that sends those tokens as
``resume_tokens`` with the remaining ``n_new`` continues the decode
exactly. A greedy resume the pool cannot hold rides the window plane on
its folded prompt; a sampled one is answered 409 (its generator's stream
lives on the pool only), which tells a router to retry from scratch.
:meth:`GenerationAPI.drain` (SIGTERM under ``--serve-generate``) stops
admission and, with ``root.common.serving.drain_handoff`` (default on),
hands every in-flight request back at the next step boundary with its
progress; window-plane stragglers (and every request when it is off)
get up to the grace to finish before :meth:`GenerationAPI.stop`.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional

import numpy

from ._http import (HTTPService, bytes_reply, handle_trace_spans,
                    json_reply, read_json_object, sse_end, sse_event,
                    sse_headers)
from .backends import device_for
from .config import root
from .error import VelesError
from .logger import Logger
from .nn import beam as beam_mod
from .nn import sampling
from .nn.speculative import generate_speculative
from .resilience import health
from .resilience.faults import FaultInjected, fire as fire_fault
from .serving import ContinuousEngine, RecurrentEngine
from .serving.overload import QOS_PRIORITIES
from .serving.scheduler import (Ticket, new_request_id, shed_expired,
                                split_expired)
from .telemetry.counters import METRICS_CONTENT_TYPE, metrics_text
from .units import Unit

ENGINES = ("continuous", "recurrent", "window")


class RESTfulAPI(Unit):
    """The serving endpoint unit of a forward workflow:

        api = RESTfulAPI(wf, loader=rest_loader, port=0)
        api.link_attrs(last_forward, ("input", "output"))
        api.link_from(last_forward); repeater.link_from(api)

    ``max_pending`` (default ``root.common.resilience.max_pending``)
    bounds the requests in flight: one beyond it is shed 503 +
    Retry-After. ``initialize`` starts the HTTP service (the bound port
    is ``self.port``); ``stop`` ends it and answers every request still
    waiting 503 + Retry-After."""

    MAPPING = "restful_api"
    hide_from_registry = False

    def __init__(self, workflow, loader=None, port: int = 0,
                 path: str = "/api", request_timeout: float = 60.0,
                 max_pending: Optional[int] = None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.loader = loader
        self.port = port
        self.path = path
        self.request_timeout = request_timeout
        self.max_pending = int(max_pending if max_pending is not None
                               else root.common.resilience.get(
                                   "max_pending", 64) or 64)
        self._pending = 0
        self._pending_lock = threading.Lock()
        #: tickets fed and not yet answered, which stop() settles
        self._outstanding: set = set()
        #: the forward output answered from (link_attrs)
        self.input = None
        self._service: Optional[HTTPService] = None
        self.requests_served = 0
        self.demand("loader")

    # -- lifecycle ----------------------------------------------------------
    def _handler_class(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                api.debug("http: " + fmt, *args)

            def do_GET(self):
                if health.handle_health(self, self.path):
                    return
                if handle_trace_spans(self, self.path,
                                      name="rest.%s" % api.name):
                    return
                if self.path != "/metrics":
                    self.send_error(404)
                    return
                text = metrics_text({
                    "veles_rest_requests_served": api.requests_served,
                    "veles_rest_pending": api._pending})
                bytes_reply(self, 200, text.encode(),
                            METRICS_CONTENT_TYPE)

            def do_POST(self):
                if self.path != api.path:
                    self.send_error(404)
                    return
                try:
                    fire_fault("serve.request")
                except FaultInjected as e:
                    health.shed(self, retry_after=1.0, reason=str(e),
                                request_id=new_request_id())
                    return
                with api._pending_lock:
                    if api._pending >= api.max_pending:
                        health.shed(
                            self, retry_after=1.0,
                            reason="%d requests in flight (bound %d)"
                            % (api._pending, api.max_pending),
                            request_id=new_request_id())
                        return
                    api._pending += 1
                try:
                    self._serve()
                finally:
                    with api._pending_lock:
                        api._pending -= 1

            def _serve(self):
                from .loader.stream import LoaderClosed
                try:
                    body = read_json_object(self)
                    sample = api.loader.parse_request(body)
                except (ValueError, KeyError, VelesError) as e:
                    # the client's fault only: a server-side bug must
                    # surface as a 5xx
                    json_reply(self, 400, {"error": "bad request: %s" % e})
                    return
                ticket = Ticket()
                try:
                    api.loader.feed(sample, ticket=ticket)
                except VelesError as e:
                    # a bad shape is the client's fault, a closed loader
                    # the server shutting down
                    code = 503 if isinstance(e, LoaderClosed) else 400
                    json_reply(self, code, {"error": str(e)})
                    return
                except Exception as e:
                    json_reply(self, 503, {"error": str(e)})
                    return
                with api._pending_lock:
                    api._outstanding.add(ticket)
                try:
                    settled = ticket.event.wait(api.request_timeout)
                finally:
                    with api._pending_lock:
                        api._outstanding.discard(ticket)
                if not settled:
                    json_reply(self, 504, {"error": "inference timed out",
                                           "request_id": ticket.request_id})
                    return
                if ticket.error is not None:
                    headers = None
                    if ticket.retry_after:
                        headers = {"Retry-After": str(max(1, int(
                            ticket.retry_after)))}
                    json_reply(self, ticket.code, ticket.error_payload(),
                               headers=headers)
                    return
                json_reply(self, 200, {"result": ticket.result,
                                       "request_id": ticket.request_id})

        return Handler

    def initialize(self, **kwargs):
        res = super().initialize(**kwargs)
        if res:
            return res
        if self._service is not None:
            return None
        self._service = HTTPService(self._handler_class(), self.port,
                                    self.name + ".http")
        self.port = self._service.port
        self._service.start_serving()
        health.mark_ready("rest.%s" % self.name)
        health.heartbeats.beat("rest.%s" % self.name)
        self.info("%s: REST API on http://127.0.0.1:%d%s", self.name,
                  self.port, self.path)
        return None

    # -- graph side ---------------------------------------------------------
    def run(self) -> None:
        """Answer each ticket of the loader's minibatch from its row of
        the linked forward output (read from the device once), exactly
        once through ``Ticket.succeed``; a failure answers them all 500."""
        health.heartbeats.beat("rest.%s" % self.name)
        tickets = list(getattr(self.loader, "current_tickets", ()))
        real = [(i, t) for i, t in enumerate(tickets)
                if isinstance(t, Ticket)]
        if not real:
            return      # samples from elsewhere (a warm-up feed)
        try:
            out = self.input
            if out is None:
                raise VelesError("%s: no forward output linked" % self.name)
            if hasattr(out, "map_read"):
                out = out.map_read()
            out = numpy.asarray(out)
            served = 0
            for i, ticket in real:
                ticket.mark_admitted()
                if ticket.succeed(numpy.asarray(out[i]).tolist()):
                    served += 1
            self.requests_served += served
        except Exception as e:
            for _, ticket in real:
                ticket.mark_admitted()
                ticket.fail("%s: %s" % (type(e).__name__, e), code=500)
        finally:
            self.loader.current_tickets = []

    def stop(self) -> None:
        """End the HTTP service and settle every fed, unanswered ticket
        503 + Retry-After through the first-terminal ``fail`` (a second
        sweep changes nothing)."""
        health.forget("rest.%s" % self.name)
        if self._service is not None:
            self._service.stop_serving()
            self._service = None
        with self._pending_lock:
            stragglers = list(self._outstanding)
        for ticket in stragglers:
            ticket.fail("server shutting down", code=503,
                        retry_after=5.0)


class GenerationAPI(Logger):
    """Generation over HTTP for a :class:`~veles_tpu_torch.nn.
    standard_workflow.Forwards` stack. ``device`` defaults to the card
    (``backends.device_for``); the model is moved there. ``engine``
    (default ``root.common.serving.engine``, "continuous") picks the
    decode plane; the slot-pool knobs default to
    ``root.common.serving``. ``draft`` (a smaller generation stack,
    moved to the same device) enables ``mode=speculative`` on both
    planes; ``spec_gamma`` and ``beam_width`` fix the pool's round and
    group widths; ``state_cache`` turns the O(1)-state lane's prefix cache
    on; ``quant_weights`` and ``quant_kv`` (default ``root.common.quant``'s)
    the paged engine's int8 weights and int8 KV pool; ``artifact``
    (default ``root.common.serving.artifact``) a serve artifact directory
    whose programs either engine serves from (a bad one falls back to
    live serving, counted). ``initialize``
    starts the engine, the window worker
    and the HTTP service, ``stop`` drains them; the bound port is
    ``self.port``."""

    MODES = ("greedy", "sample", "speculative", "beam")

    def __init__(self, model, port: int = 0, path: str = "/generate",
                 max_new: int = 512, batch_window: float = 0.02,
                 request_timeout: float = 120.0,
                 max_queue: Optional[int] = None,
                 engine: Optional[str] = None,
                 max_slots: Optional[int] = None, buckets=None,
                 max_context: Optional[int] = None,
                 decode_block: Optional[int] = None,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None, draft=None,
                 spec_gamma: Optional[int] = None,
                 beam_width: Optional[int] = None,
                 state_cache: Optional[bool] = None,
                 quant_weights: Optional[bool] = None,
                 quant_kv: Optional[bool] = None,
                 artifact: Optional[str] = None, device=None,
                 name: str = "generation_api") -> None:
        self.device = device_for(device)
        self.model = model.to(self.device)
        self.draft = None if draft is None else draft.to(self.device)
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
        self.spec_gamma = int(knob(spec_gamma, "spec_gamma", 4))
        self.beam_width = int(knob(beam_width, "beam_width", 4))
        #: the O(1)-state lane's prefix cache; None defers to
        #: root.common.serving.state_cache
        self.state_cache = state_cache
        #: the int8 planes of the paged engine; None defers to
        #: root.common.quant inside the engine
        self.quant_weights = quant_weights
        self.quant_kv = quant_kv
        #: the serve artifact; None defers to root.common.serving.artifact
        #: inside the engine
        self.artifact = artifact
        #: the ContinuousEngine or RecurrentEngine; None = the window plane
        self._engine = None
        self._service: Optional[HTTPService] = None
        self._queue: list = []
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closing = False
        #: serialises stop(): a drain and a replica death may both call it
        self._lifecycle = threading.RLock()
        #: admission stopped by begin_drain; requests awaiting an answer
        self._draining = False
        self._inflight = 0
        #: the tags that keep sampled speculative requests apart
        self._uniq = 0
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
        if mode == "speculative" and self.draft is None:
            raise ValueError("mode=speculative needs a draft model "
                             "configured on the server")
        try:
            temperature = float(body.get("temperature", 0.0))
            seed = int(body.get("seed", 0))
            # the engine's fixed shapes are the defaults, so a request
            # that names neither lands on the pool
            gamma = int(body.get("gamma", self.spec_gamma))
            beam = int(body.get("beam", self.beam_width))
        except (TypeError, ValueError) as e:
            raise ValueError("non-numeric knob: %s" % e) from None
        if gamma < 1:
            raise ValueError("'gamma' must be >= 1")
        if beam < 1:
            raise ValueError("'beam' must be >= 1")
        if mode == "greedy":
            temperature = 0.0
        elif mode == "sample" and temperature <= 0:
            raise ValueError("mode=sample needs temperature > 0")
        eos_id = body.get("eos_id")
        if eos_id is not None and (isinstance(eos_id, bool)
                                   or not isinstance(eos_id, int)):
            raise ValueError("'eos_id' must be an int token id")
        ids = {}
        for key in ("request_id", "trace_id"):
            ids[key] = body.get(key)
            if ids[key] is not None and (
                    not isinstance(ids[key], str)
                    or not 1 <= len(ids[key]) <= 200):
                raise ValueError("'%s' must be a non-empty string of at "
                                 "most 200 chars" % key)
        attempt = body.get("attempt", 1)
        if isinstance(attempt, bool) or not isinstance(attempt, int) \
                or attempt < 1:
            raise ValueError("'attempt' must be an int >= 1")
        stream = body.get("stream", False)
        if not isinstance(stream, bool):
            raise ValueError("'stream' must be a boolean")
        # root.common.serving.stream = False answers every request
        # buffered, whatever the client asked
        stream = stream and bool(root.common.serving.get("stream", True))
        # token-level resume: a retry of a request cut short mid-decode
        # carries the tokens it emitted, and n_new is the remaining
        # budget; they fold into the prompt (one bucketed prefill, never
        # a re-decode) and resume_k advances a sampled row's generator
        resume_tokens = body.get("resume_tokens")
        if resume_tokens is not None:
            if (not isinstance(resume_tokens, list)
                    or not all(isinstance(t, int)
                               and not isinstance(t, bool)
                               for t in resume_tokens)):
                raise ValueError("'resume_tokens' must be a list of int "
                                 "token ids")
            if mode not in ("greedy", "sample"):
                raise ValueError(
                    "resume_tokens serve mode=greedy/sample only "
                    "(speculative/beam retries restart from scratch)")
        resume_tokens = [int(t) for t in (resume_tokens or ())]
        # the QoS class (unlabeled requests are interactive) and the
        # request's own deadline, which can only tighten request_timeout
        priority = body.get("priority", "interactive")
        if priority not in QOS_PRIORITIES:
            raise ValueError("'priority' must be one of %s"
                             % (QOS_PRIORITIES,))
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            if isinstance(deadline_ms, bool) \
                    or not isinstance(deadline_ms, (int, float)) \
                    or deadline_ms <= 0:
                raise ValueError("'deadline_ms' must be a positive number "
                                 "of milliseconds")
            deadline_ms = float(deadline_ms)
        req = {"prompt": [int(t) for t in prompt] + resume_tokens,
               "n_new": n_new, "resume_k": len(resume_tokens),
               "mode": mode, "temperature": temperature, "seed": seed,
               "gamma": gamma, "beam": beam, "eos_id": eos_id,
               "attempt": attempt, "stream": stream,
               "priority": priority, "deadline_ms": deadline_ms, **ids}
        if mode == "speculative" and temperature > 0:
            # a sampled speculative request is never coalesced: its
            # window-plane decode is its own, as on the pool
            with self._cv:
                self._uniq += 1
                req["_solo"] = self._uniq
        return req

    @staticmethod
    def _batch_key(req):
        """Requests sharing this key ride one batched decode — greedy,
        sample and greedy speculative alike (per-row generator streams
        make every row equal to its solo decode); a sampled speculative
        request's unique ``_solo`` tag keeps it alone."""
        return (req["mode"], len(req["prompt"]), req["n_new"],
                req["temperature"], req["gamma"], req["seed"],
                req.get("_solo"))

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
        mode = reqs[0]["mode"]
        try:
            if mode == "beam":
                # one search a request (frozen eos lanes: no trimming)
                for req, ticket in zip(reqs, tickets):
                    toks, stats = beam_mod.beam_generate(
                        self.model, req["prompt"], req["n_new"],
                        beam=req["beam"], eos_id=req["eos_id"])
                    ticket.succeed({"tokens": toks,
                                    "scores": stats["scores"]})
                return
            prompts = [req["prompt"] for req in reqs]
            if mode == "speculative":
                rows, stats = generate_speculative(
                    self.model, self.draft, prompts, reqs[0]["n_new"],
                    gamma=reqs[0]["gamma"],
                    temperature=reqs[0]["temperature"],
                    seed=reqs[0]["seed"])
                for i, (req, ticket) in enumerate(zip(reqs, tickets)):
                    ticket.succeed({
                        "tokens": self._trim_eos(rows[i], req["eos_id"]),
                        "acceptance": stats["acceptance"][i],
                        "rounds": stats["rounds"][i],
                        "batched_with": len(reqs) - 1})
                return
            rows = sampling.generate(
                self.model, prompts, reqs[0]["n_new"],
                temperature=reqs[0]["temperature"], seed=reqs[0]["seed"])
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
        hb_name = "serve.%s" % self.name
        try:
            self._worker_iterations(hb_name)
        finally:
            # a beat after stop()'s forget() would age into a permanent
            # /healthz failure
            health.heartbeats.unregister(hb_name)

    def _worker_iterations(self, hb_name: str) -> None:
        while True:
            if not self._closing:
                health.heartbeats.beat(hb_name)
            with self._cv:
                while not self._queue and not self._closing:
                    # bounded wait: the idle worker still beats
                    self._cv.wait(timeout=10.0)
                    if not self._closing:
                        health.heartbeats.beat(hb_name)
                if self._closing and not self._queue:
                    return
            # coalesce: let near-simultaneous requests join the batch
            if self.batch_window > 0:
                time.sleep(self.batch_window)
            with self._cv:
                pending, self._queue = self._queue, []
            pending, expired = split_expired(pending)
            shed_expired(expired)
            # queue exit is the window plane's admission boundary
            for _req, ticket in pending:
                ticket.mark_admitted()
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
                if health.handle_health(self, self.path):
                    return
                if handle_trace_spans(self, self.path,
                                      name="serve.%s" % api.name):
                    return
                engine = api._engine       # stop() may null it mid-GET
                if self.path == "/stats":
                    stats = {"engine": ("continuous" if engine is not None
                                        else "window"),
                             "speculative_enabled": api.draft is not None,
                             "modes": list(api.MODES),
                             "device": str(api.device),
                             "batches_run": api.batches_run,
                             "max_batch": api.max_batch,
                             "queue_depth": len(api._queue)}
                    if engine is not None:
                        stats["continuous"] = engine.stats()
                    json_reply(self, 200, stats)
                elif self.path == "/metrics":
                    bytes_reply(self, 200,
                                metrics_text(api._metrics_gauges()).encode(),
                                METRICS_CONTENT_TYPE)
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
                    fire_fault("serve.request")
                except FaultInjected as e:
                    # an injected intake fault is shed 503 + Retry-After
                    # (counted) with an id of its own, never a traceback
                    health.shed(self, retry_after=1.0, reason=str(e),
                                request_id=new_request_id())
                    return
                try:
                    req = api._parse(read_json_object(self))
                except ValueError as e:
                    json_reply(self, 400, {"error": "bad request: %s" % e})
                    return
                # the request's own deadline replaces request_timeout for
                # the queue sweep and this handler's wait, capped by it
                budget = api.request_timeout
                if req["deadline_ms"]:
                    budget = min(budget, req["deadline_ms"] / 1000.0)
                ticket = Ticket(deadline=time.time() + budget,
                                request_id=req["request_id"],
                                mode=req["mode"], trace_id=req["trace_id"],
                                attempt=req["attempt"],
                                stream=req["stream"])
                # admission and the in-flight count move together, so a
                # drain never misses a request it let in
                with api._cv:
                    draining = api._draining
                    if not draining:
                        api._inflight += 1
                if draining:
                    self._shed("server draining", ticket, 5)
                    return
                try:
                    if self._admit(req, ticket):
                        if self._replica_died(ticket):
                            return
                        if ticket.stream:
                            self._stream_reply(ticket, budget)
                        else:
                            self._await_and_reply(ticket, budget)
                finally:
                    with api._cv:
                        api._inflight -= 1
                        api._cv.notify_all()

            def _admit(self, req, ticket) -> bool:
                """Hand the request to the slot pool or the window queue;
                False (answered 503, or 409 for a sampled resume the pool
                cannot hold) when neither takes it."""
                engine = api._engine
                reject = ("no slot pool" if engine is None
                          else engine.accepts(req))
                if req["resume_k"] and reject is not None \
                        and req["mode"] != "greedy":
                    # a sampled row's generator stream lives on the pool
                    # only; a greedy resume is deterministic and rides
                    # the window plane on its folded prompt
                    json_reply(self, 409, {
                        "error": "resume not servable here (%s); retry "
                                 "without resume_tokens" % reject,
                        "request_id": ticket.request_id})
                    return False
                if reject is None:
                    # the slot pool: admitted at the next step boundary
                    if api._closing:
                        self._shed("server shutting down", ticket, 5)
                        return False
                    if not engine.submit(req, ticket,
                                         max_queue=api.max_queue,
                                         checked=True):
                        if engine.closing:
                            self._shed("server shutting down", ticket, 5)
                        else:
                            self._shed("generation queue full (%d/%d)" % (
                                engine.scheduler.queue_depth(),
                                api.max_queue), ticket, 1)
                        return False
                    return True
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
                    return False
                return True

            def _replica_died(self, ticket) -> bool:
                """The request-path ``serve.replica_death`` point: the
                request is in flight when it fires. The front is torn down
                on another thread, whose abort settles every live ticket
                with its progress, and this handler answers with that
                dying gasp (503 + ``resume``); a ticket not settled within
                10 s leaves the client a dead peer. True when it fired."""
                try:
                    fire_fault("serve.replica_death")
                except FaultInjected:
                    api.warning("%s: injected replica death; tearing the "
                                "serving front down mid-request", api.name)
                    api._on_replica_death()
                    self.close_connection = True
                    if ticket.event.wait(10.0) and ticket.error is not None:
                        json_reply(self, ticket.code,
                                   ticket.error_payload(),
                                   headers={"Retry-After": "1"})
                    return True
                return False

            def _await_and_reply(self, ticket, budget):
                # slack past the deadline: the worker's expiry answer
                # (503 + Retry-After) wins the race against this 504
                if not ticket.event.wait(budget + 1.0):
                    json_reply(self, 504, {"error": "generation timed out",
                                           "request_id": ticket.request_id})
                    return
                if ticket.error is not None:
                    headers = None
                    # scaled by queue pressure while a QoS engine runs
                    retry_after = ticket.retry_after_hint()
                    if retry_after:
                        headers = {"Retry-After": str(max(1, int(
                            math.ceil(retry_after))))}
                    json_reply(self, ticket.code, ticket.error_payload(),
                               headers=headers)
                    return
                json_reply(self, 200, ticket.result)

            def _stream_reply(self, ticket, budget):
                """``stream=true``: one SSE event per batch of tokens the
                plane pushed, the tokens no push covered (the window
                plane's, a beam's) in one event, then the terminal
                event: the whole answer with ``done``, or the error
                payload with ``done`` and its ``code``. A client that
                goes away mid-stream only ends this handler: the decode
                settles its ticket on its own."""
                rid = ticket.request_id
                sent = 0
                deadline = time.time() + budget + 1.0
                try:
                    sse_headers(self)
                    while True:
                        budget = deadline - time.time()
                        if budget <= 0:
                            sse_event(self, {"done": True, "code": 504,
                                             "error": "generation timed "
                                                      "out",
                                             "request_id": rid})
                            sse_end(self)
                            return
                        try:
                            item = ticket.next_stream_item(
                                timeout=min(budget, 2.0))
                        except queue.Empty:
                            continue
                        if item is None:
                            break
                        sse_event(self, {"tokens": item, "i": sent,
                                         "request_id": rid})
                        sent += len(item)
                    if ticket.error is not None:
                        sse_event(self, dict(ticket.error_payload(),
                                             done=True, code=ticket.code))
                    else:
                        tail = list(ticket.result.get("tokens")
                                    or ())[sent:]
                        if tail:
                            sse_event(self, {"tokens": tail, "i": sent,
                                             "request_id": rid})
                        sse_event(self, dict(ticket.result, done=True))
                    sse_end(self)
                except OSError:     # broken pipe, reset: the client left
                    api.debug("%s: streaming client %s disconnected",
                              api.name, rid)

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
                # 1 = the int8 plane is on: whether a throughput number
                # is float or int8 (the O(1)-state lane reports 0)
                "veles_quant_weights_mode": st["quant_weights"],
                "veles_quant_kv_mode": st["quant_kv"],
                # 1 = served from the serve artifact's programs
                "veles_serving_artifact_mode": st["artifact_mode"],
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
        # the elastic training plane's generation and world-size gauges
        # ride this surface too; no rows while the plane is off
        from .resilience import elastic
        gauges.update(elastic.gauges())
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
                engine = ContinuousEngine(
                    self.model, max_slots=self.max_slots,
                    buckets=self.buckets, max_context=self.max_context,
                    decode_block=self.decode_block,
                    page_size=self.page_size, pages=self.pages,
                    spec_gamma=self.spec_gamma,
                    beam_width=self.beam_width, draft=self.draft,
                    quant_weights=self.quant_weights,
                    quant_kv=self.quant_kv, artifact=self.artifact,
                    device=self.device, name=self.name)
                engine.on_death = self._on_replica_death
                return engine.start()
            except VelesError as e:
                paged_said = e
        try:
            engine = RecurrentEngine(
                self.model, max_slots=self.max_slots,
                max_context=self.max_context,
                decode_block=self.decode_block, page_size=self.page_size,
                state_cache=self.state_cache, artifact=self.artifact,
                device=self.device, name=self.name)
            engine.on_death = self._on_replica_death
            engine.start()
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
        self._draining = False
        self._inflight = 0
        self._worker = threading.Thread(target=self._worker_loop,
                                        daemon=True,
                                        name=self.name + ".genworker")
        self._worker.start()
        self._service = HTTPService(self._handler_class(), self.port,
                                    self.name + ".http")
        self.port = self._service.port
        self._service.start_serving()
        health.mark_ready("serve.%s" % self.name)
        self.info("%s: generation API on http://127.0.0.1:%d%s (%s, "
                  "engine=%s)", self.name, self.port, self.path,
                  self.device, type(self._engine).__name__
                  if self._engine is not None else "window")
        return self

    # -- graceful drain ------------------------------------------------------
    def begin_drain(self) -> bool:
        """Stop admission (new requests are answered 503 + Retry-After)
        and flip ``/readyz`` to draining while in-flight requests go on
        decoding; ``/healthz`` stays green. True when this call started
        the drain."""
        with self._cv:
            if self._draining:
                return False
            self._draining = True
        health.mark_draining("serve.%s" % self.name)
        self.info("%s: draining — admission stopped, %d in flight",
                  self.name, self._inflight)
        return True

    def _on_replica_death(self) -> None:
        """An injected ``serve.replica_death``: the engine has settled
        every live ticket with its progress (or the request path fired);
        tear the front down on a thread of its own, never the tick
        thread, which ``engine.stop()`` joins."""
        threading.Thread(target=self.stop, daemon=True,
                         name=self.name + ".death").start()

    def drain(self, grace: Optional[float] = None,
              handoff: Optional[bool] = None) -> bool:
        """:meth:`begin_drain`; then, with ``handoff`` (default
        ``root.common.serving.drain_handoff``, True), the slot pool hands
        every in-flight request back at its next step boundary, answered
        503 + Retry-After with its emitted tokens as ``resume`` (the
        engine's ``handoff``), so the drain takes one step, not the
        longest generation. Window-plane requests (and every request
        with ``handoff`` off) get up to ``grace`` seconds (default
        ``root.common.serving.drain_grace``, 30) to finish, then
        :meth:`stop` answers the stragglers. True when nothing was in
        flight at the teardown."""
        self.begin_drain()
        if handoff is None:
            handoff = bool(root.common.serving.get("drain_handoff", True))
        engine = self._engine
        if handoff and engine is not None:
            handed = engine.handoff()
            if handed:
                self.info("%s: drain handed %d in-flight request(s) back "
                          "with resume progress", self.name, handed)
        if grace is None:
            # no falsy-zero rewrite: a grace of 0 means "stop now"
            grace = float(root.common.serving.get("drain_grace", 30.0))
        deadline = time.time() + grace
        with self._cv:
            while self._inflight and time.time() < deadline:
                self._cv.wait(timeout=min(
                    0.2, max(0.01, deadline - time.time())))
            drained = self._inflight == 0
        self.info("%s: drain %s (%d still in flight)", self.name,
                  "complete" if drained else "grace expired",
                  self._inflight)
        self.stop()
        return drained

    def stop(self) -> None:
        """Stop the HTTP service, stop the engine (answering what it
        still holds), let the worker finish the queue, and join it.
        Serialised: a drain and a replica death may both call it."""
        with self._lifecycle:
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
            # after the worker is down, so no late beat re-registers
            health.forget("serve.%s" % self.name)

