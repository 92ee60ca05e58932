"""Continuous-batching decode engine over a paged KV pool (counterpart
of ``veles_tpu/serving/engine.py``: its greedy, sampled, speculative
and beam planes).

Replaces the window plane's coalescing (one batched decode per exact
shape key, every member riding to the longest ``n_new``) with
iteration-level scheduling:

- K/V live in one pool of fixed-size PAGES per block, each tensor
  ``(pages + 1, page_size, n_kv_heads, head_dim)`` on the engine's
  device (row 0 is the sink); every slot owns a page-table row, and the
  decode step reads a slot's cache view through it. Admission reserves
  each request's own worst case, ``ceil(max(bucket, prompt + n_new) /
  page_size)`` pages, and frees them when the row retires;
- an admission runs ONE monolithic prefill of the prompt padded to its
  bucket: on the card each block's attention is one launch of the
  flash-forward kernel (``nn/attention.attention_core``). Causal
  masking hides the pad keys from every real query. The K/V rows are
  scattered page by page into the slot's pages, and the first token
  comes from the last real position's logits;
- ONE fixed-shape decode step advances all ``max_slots`` rows
  (``nn/sampling._block_step_rows``): rows masked out write to the
  sink page, each live row reads only its own pages up to its
  position. Only the newly computed position is written;
- a row retires the moment it reaches its ``n_new`` or emits its
  ``eos_id``, and the next queued request takes its slot and pages at
  the next step boundary;
- each sampled slot draws from its own ``torch.Generator``, seeded from
  the request's seed as ``nn/sampling.generate`` seeds a solo row, one
  draw a token in the same order, so a pooled row's tokens equal its
  solo ``generate`` whatever shares the pool;
- ``mode=speculative`` rows (given a ``draft`` stack) advance by one
  draft/verify round a tick (``nn/speculative``'s arithmetic): the
  draft proposes ``spec_gamma`` tokens over its own K/V pool, indexed by
  the SAME page-table row as the target's, and the target verifies the
  whole window in one multi-position pass; each row advances by its own
  accepted length, and equals its solo ``generate_speculative``;
- ``mode=beam`` requests take ``beam_width`` slots, one per hypothesis:
  the lead row's prefill is copied page by page into its siblings, the
  first top-W expansion comes from the prefill logits, and each tick
  runs one row step for every hypothesis, the group's top-k
  (``nn/beam``'s arithmetic) and the cache reorder by surviving parent
  as a page copy that gathers every source page before it writes;
- streamed tickets get their tokens at every step boundary;
- **token-level resume**: a request whose decode was cut short carries
  its emitted tokens (``Ticket.set_progress``, the ``resume`` record of
  its 503). A retry folds them into the prompt (:func:`fold_resume`):
  the resumed prefill re-runs them in one bucketed pass through the
  flash kernel, and a sampled row's generator is advanced by one draw
  per emitted token (``nn/sampling.advanced_generator``) so it samples
  its next token from the uninterrupted row's stream;
- **the QoS plane** (``root.common.serving.qos``): interactive requests
  are admitted ahead of queued batch work, and when more of them wait
  than slots are free, batch rows are preempted at the step boundary
  through the same resume path: the same ticket requeues with its
  tokens folded into its prompt, and its answer equals an uninterrupted
  decode (one terminal, one admission, however often it was preempted);
- **drain by handoff** (:meth:`ContinuousEngine.handoff`): at the next
  step boundary every in-flight request is answered 503 + Retry-After
  with its emitted tokens as ``resume``, so a drain takes one step, not
  the longest generation;
- fault points ``serve.decode_step`` (before each decode, speculative
  and beam dispatch: the live rows are shed 503 with their progress),
  ``serve.replica_death`` (at a busy step boundary: every live row is
  settled with its progress, then ``on_death`` runs) and
  ``serve.handoff`` (per handed-off request: that one leaves without
  progress);
- **int8 serving** (``quant/``, ``root.common.quant``): under
  ``quant_weights`` the stack's 2-D matmul weights are calibrated once
  to per-channel int8 (again only when the weights changed, checked at
  an idle step boundary) and each is rebuilt as ``q · s`` in the
  model's float dtype just before its own product, in the prefill
  (still the flash kernel's attention), the decode step, the
  speculative verify and the beam step; the draft stays float. Under
  ``quant_kv`` the pool holds int8 K/V with one float32 scale a
  position: the prefill quantizes its float rows once, the decode step
  reads a dequantized view with its own new row unquantized and
  quantizes only that row. Speculative and beam requests on the int8
  pool ride the window plane. A resumed or preempted row's prefill
  re-quantizes the emitted tokens' rows from the prefill's K/V, as the
  reference's does.

Not ported yet: prefix sharing and chunked prefill (ROADMAP Queue 1
item 4.1), the serve artifact (4.5) and tensor-parallel serving (4.6);
asking for them raises :class:`VelesError`. Requests the pool cannot
hold ride the window plane (:meth:`ContinuousEngine.accepts`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy
import torch

from ..backends import device_for
from ..config import root
from ..error import VelesError
from ..logger import Logger
from ..nn.beam import _beam_topk, _expand_first
from ..nn.sampling import (_block_step_rows, _block_step_rows_int8, _draw,
                           _embed_prompt, _embed_rows, _head_logits,
                           _prefill_blocks, advanced_generator, params_of,
                           split_stack)
from ..nn.speculative import (_accept_rows, _block_span_rows,
                              _draft_pick, _embed_span, _emission)
from ..ops.flash_attention import choose_flash
from ..quant import (DequantView, block_page_pool, pool_nbytes,
                     quantize_params, quantize_rows_int8)
from ..resilience.faults import FaultInjected, fire as fire_fault
from ..telemetry.counters import inc
from ..telemetry.spans import span
from .overload import (clear_pressure_provider, qos_preempt_enabled,
                       request_priority, set_pressure_provider)
from .pages import PagePool, pages_for
from .scheduler import RESUME_MODES, SlotScheduler, Ticket, shed_expired

#: floor of the sampling temperature on the pool (the reference's
#: clamp); a colder sampled request rides the window plane, which
#: divides exactly
_TEMP_EPS = 1e-3

#: the decode modes the pool's decode step advances, the only ones that
#: resume
_STEP_MODES = RESUME_MODES

#: the ROADMAP Queue 1 item of each engine knob not ported yet
_NOT_PORTED = {"prefix_cache": "4.1", "prefill_chunk": "4.1",
               "artifact": "4.5"}


def make_request(prompt, n_new, temperature=0.0, seed=0, eos_id=None,
                 mode="greedy", gamma=4, beam=4) -> Dict:
    """Normalized request dict (the subset of GenerationAPI's parsed
    request the engine consumes), for tests and benchmarks."""
    return {"prompt": [int(t) for t in prompt], "n_new": int(n_new),
            "temperature": float(temperature), "seed": int(seed),
            "eos_id": eos_id, "mode": str(mode), "gamma": int(gamma),
            "beam": int(beam)}


def fold_resume(req: Dict, resume_tokens) -> Dict:
    """Fold a retry's already-emitted tokens into an engine request:
    they become prompt suffix (the resumed prefill runs them in one
    bucketed pass, never a re-decode), ``n_new`` drops to the remaining
    budget, and ``resume_k`` records how many draws a sampled row's
    generator must advance by before its first new token. ``req`` is
    the original request (full ``n_new``); the wire form a router sends,
    ``resume_tokens`` + the remaining ``n_new``, is folded the same way
    by ``GenerationAPI``'s parse. Raises ValueError when the tokens
    leave nothing to generate."""
    resume = [int(t) for t in resume_tokens]
    if not resume:
        return dict(req, resume_k=0)
    remaining = int(req["n_new"]) - len(resume)
    if remaining < 1:
        raise ValueError(
            "resume_tokens (%d) leave no remaining n_new (%d)"
            % (len(resume), int(req["n_new"])))
    return dict(req,
                prompt=[int(t) for t in req["prompt"]] + resume,
                n_new=remaining, resume_k=len(resume))


def _version(t) -> int:
    try:
        return t._version
    except RuntimeError:      # an inference tensor tracks no version
        return 0


def _leaf_key(params) -> Tuple:
    """Each leaf of a ``params_of`` tree by identity and in-place version:
    unchanged weights give the same key, so the int8 twin is calibrated
    again only when a weight was replaced or written in place."""
    return tuple((u, k, id(t), _version(t)) for u, tree in params.items()
                 for k, t in tree.items())


def _layers_of(wf):
    """The layers of the stack ``wf``; anything that is not a sequence of
    layers is not a generation stack."""
    try:
        return list(wf)
    except TypeError:
        raise VelesError("not a generation stack: %s"
                         % type(wf).__name__) from None


class ResumePlane:
    """Token-level resume, the QoS plane's preemption and drain by
    handoff, shared by :class:`ContinuousEngine` and the O(1)-state lane
    (``serving/recurrent.py``), as the reference's two engines share
    them. The engine provides ``scheduler``, ``max_slots``, ``name``,
    ``_thread``, ``_closing``, ``_retire_slot`` and ``_abort_active``,
    calls :meth:`_init_resume_plane` from its constructor and
    :meth:`_step_boundary` first thing in every tick."""

    def _init_resume_plane(self, serving_cfg) -> None:
        #: the QoS plane: priority admission and lossless preemption
        self.qos = bool(serving_cfg.get("qos", False))
        self.scheduler.qos = self.qos
        #: the queue-pressure source of dynamic Retry-After hints,
        #: registered while a QoS engine runs (stored: the clear is by
        #: identity)
        self._pressure_fn = lambda: (self.scheduler.queue_depth(),
                                     max(8, self.max_slots * 8))
        #: batch rows preempted, and the tokens they had emitted then
        self.preemptions = 0
        self.preempted_tokens = 0
        #: a pending drain by handoff: (reason, done event, count box),
        #: taken by the tick thread at the next step boundary
        self._handoff: Optional[Tuple] = None
        #: called after an injected ``serve.replica_death`` has settled
        #: the live tickets with their progress (GenerationAPI tears its
        #: front down there)
        self.on_death = None

    def _step_boundary(self) -> bool:
        """A pending handoff, or an injected replica death while rows
        are live; True when either ended this tick."""
        pending = self._handoff
        if pending is not None:
            # on the tick thread: a progress snapshot never races a
            # dispatch
            self._handoff = None
            reason, done, box = pending
            try:
                box["count"] = self._do_handoff(reason)
            finally:
                done.set()
            return True
        if self.scheduler.busy_count():
            try:
                fire_fault("serve.replica_death")
            except FaultInjected:
                self.warning("%s: injected replica death mid-decode; "
                             "settling the live tickets with their "
                             "progress", self.name)
                self._abort_active("replica died mid-decode", code=503,
                                   retry_after=1.0, count_shed=False)
                death = self.on_death
                if death is not None:
                    death()
                return True
        return False

    # -- QoS preemption -----------------------------------------------------
    @staticmethod
    def _emitted(slot) -> List[int]:
        """Every token the request has emitted since its client sent it:
        the tokens a preemption folded into the prompt (``_qos_prefix``)
        and this admission's. Progress and answers are built from it, so
        a preemption never shows on the wire; a router's own
        ``resume_tokens`` are not in it."""
        return list(slot.req.get("_qos_prefix", ())) + list(slot.tokens)

    def _resumable(self, slot) -> bool:
        """Whether ``slot`` may be preempted beyond the common rules
        (every row of the lane may)."""
        return True

    def _preempt_victims(self, need: int) -> List:
        """Up to ``need`` batch rows to preempt: decode-step modes only
        (their generators resume exactly), at least one token emitted
        and one still to go, and :meth:`_resumable`. Fewest emitted
        tokens first: the smallest re-prefill."""
        victims = [s for s in self.scheduler.active(_STEP_MODES)
                   if s.group is None and request_priority(s.req) == "batch"
                   and s.tokens and len(s.tokens) < s.n_new
                   and self._resumable(s)]
        victims.sort(key=lambda s: (len(s.tokens), s.idx))
        return victims[:max(0, need)]

    def _preempt_for_interactive(self) -> None:
        """When more interactive requests wait than slots are free,
        preempt batch rows: each one's emitted tokens fold into its
        prompt (:func:`fold_resume`), ``resume_k`` accumulates over
        preemptions (the generator advances by every token ever
        emitted), and the same un-answered ticket requeues. No terminal
        fires and no histogram samples twice."""
        if not qos_preempt_enabled():
            return
        with self.scheduler.cv:
            waiting = sum(1 for req, _t in self.scheduler._queue
                          if request_priority(req) == "interactive")
            free = len(self.scheduler._free)
        if waiting <= free:
            return
        for slot in self._preempt_victims(waiting - free):
            emitted = self._emitted(slot)
            resumed = fold_resume(slot.req, slot.tokens)
            resumed["resume_k"] = (int(slot.req.get("resume_k", 0) or 0)
                                   + len(slot.tokens))
            resumed["_qos_prefix"] = emitted
            resumed["_requeued"] = True
            # a failure before it finishes still answers with the whole
            # resume record
            slot.ticket.set_progress(emitted)
            self._retire_slot(slot)
            self.scheduler.push(resumed, slot.ticket)
            self.preemptions += 1
            self.preempted_tokens += len(slot.tokens)
            inc("veles_qos_preemptions_total")
            inc("veles_qos_preempted_tokens_total", len(slot.tokens))
            self.debug("%s: preempted batch request %s at %d tokens",
                       self.name, slot.ticket.request_id, len(emitted))

    # -- drain by handoff ----------------------------------------------------
    def handoff(self, reason: str = "server draining; request handed off "
                                    "with resume progress",
                timeout: float = 30.0) -> int:
        """Hand every in-flight request back to its caller: at the next
        step boundary each live ticket is answered 503 + Retry-After with
        its emitted tokens as ``resume`` (a router re-dispatches it
        elsewhere with ``resume_tokens``), and queued tickets are shed
        the same 503 without progress. Runs on the tick thread; returns
        the number handed back with progress (0 on an idle or closing
        engine)."""
        done = threading.Event()
        box = {"count": 0}
        with self.scheduler.cv:
            if self._closing or self._thread is None:
                return 0
            self._handoff = (reason, done, box)
            self.scheduler.cv.notify_all()
        if not done.wait(timeout):
            self.warning("%s: handoff timed out after %.1f s; the drain "
                         "goes on to the abort", self.name, timeout)
        return box["count"]

    def _do_handoff(self, reason: str) -> int:
        """The tick thread's half of :meth:`handoff`. ``serve.handoff``
        fires once per live ticket: an injected raise sends that ticket
        off as a plain 503 without progress (its retry starts over) and
        never blocks the drain."""
        handed = 0
        answered = set()
        for slot in self.scheduler.active():
            ticket = slot.ticket
            if id(ticket) not in answered:
                answered.add(id(ticket))
                snapshot_ok = True
                try:
                    fire_fault("serve.handoff")
                except FaultInjected as e:
                    snapshot_ok = False
                    self.warning("%s: progress snapshot failed mid-drain "
                                 "for %s (%s); handing off without resume",
                                 self.name, ticket.request_id, e)
                if snapshot_ok and slot.mode in _STEP_MODES:
                    ticket.set_progress(self._emitted(slot))
                if ticket.fail(reason, code=503, retry_after=1.0,
                               outcome="handoff"):
                    if ticket.progress:
                        handed += 1
                        inc("veles_handoff_requests_total")
                    else:
                        inc("veles_shed_requests_total")
            self._retire_slot(slot)
        shed = self.scheduler.drain(reason, code=503, retry_after=1.0)
        if shed:
            inc("veles_shed_requests_total", shed)
        return handed


class ContinuousEngine(ResumePlane, Logger):
    """In-flight batching over a persistent paged KV pool.

    ``wf`` is a generation stack (``Embedding`` → [``PositionalEmbedding``]
    → ``TransformerBlock``×N → ``LMHead``, validated here: anything else
    raises :class:`VelesError`). ``device`` defaults to the stack's.
    ``draft`` is an optional smaller stack of the same shape, on the same
    device, that enables ``mode=speculative`` on the pool (an unusable
    one is warned about and speculation rides the window plane);
    ``spec_gamma`` and ``beam_width`` (default ``root.common.serving``'s,
    4 each) fix the round width and the group width.
    ``decode_block`` runs that many decode steps per tick before the
    tokens come back to the host; ``page_size`` must be a positive
    multiple of it. ``quant_weights`` and ``quant_kv`` (default
    ``root.common.quant``'s, off) turn on int8 weights and the int8 KV
    pool. Knob geometry that cannot work raises ValueError; a knob of a
    plane not ported yet raises :class:`VelesError` naming its ROADMAP
    item. ``root.common.serving.qos`` turns the QoS plane on.
    """

    def __init__(self, wf, max_slots: int = 8,
                 buckets=(16, 32, 64, 128), max_context: int = 640,
                 decode_block: int = 1, page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 spec_gamma: Optional[int] = None,
                 beam_width: Optional[int] = None, draft=None,
                 quant_weights: Optional[bool] = None,
                 quant_kv: Optional[bool] = None,
                 artifact: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 tp: Optional[int] = None, device=None,
                 name: str = "serving") -> None:
        super().__init__()
        for knob, value in (("artifact", artifact),
                            ("prefix_cache", prefix_cache),
                            ("prefill_chunk", prefill_chunk)):
            if value:
                raise VelesError(
                    "serving knob %s=%r is not ported yet (ROADMAP Queue 1 "
                    "item %s)" % (knob, value, _NOT_PORTED[knob]))
        if tp is not None and int(tp) > 1:
            raise VelesError("tensor-parallel serving (tp=%d) is not "
                             "ported yet (ROADMAP Queue 1 item 4.6)"
                             % int(tp))
        from . import parse_buckets
        self.name = name
        # the int8 planes (root.common.quant, --quant-weights/--quant-kv);
        # both off = the float engine
        self.quant_weights = bool(
            root.common.quant.get("weights", False)
            if quant_weights is None else quant_weights)
        self.quant_kv = bool(root.common.quant.get("kv", False)
                             if quant_kv is None else quant_kv)
        self.stack = split_stack(_layers_of(wf))
        stack_device = self.stack["stem"].table.device
        self.device = (stack_device if device is None
                       else device_for(device))
        if self.device != stack_device:
            raise ValueError("the stack lives on %s, not on %s"
                             % (stack_device, self.device))
        serving_cfg = root.common.serving
        self.max_slots = int(max_slots)
        self.max_context = int(max_context)
        self.decode_block = max(1, int(decode_block))
        self.page_size = int(serving_cfg.get("page_size", 16)
                             if page_size is None else page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.page_size % self.decode_block:
            raise ValueError(
                "page_size %d must be a multiple of decode_block %d "
                "(a decode chunk may never outrun its page-growth "
                "check by more than one page)"
                % (self.page_size, self.decode_block))
        #: page-table entries per slot; the gathered view is
        #: pages_per_slot * page_size >= max_context positions
        self.pages_per_slot = pages_for(self.max_context, self.page_size)
        cfg_pages = serving_cfg.get("pages", None) \
            if pages is None else pages
        #: usable pages; default = the dense-equivalent capacity
        self.pages = int(self.max_slots * self.pages_per_slot
                         if cfg_pages in (None, 0) else cfg_pages)
        if self.pages < 1:
            raise ValueError("pages must be >= 1")
        self.spec_gamma = int(serving_cfg.get("spec_gamma", 4)
                              if spec_gamma is None else spec_gamma)
        if self.spec_gamma < 1:
            raise ValueError("spec_gamma must be >= 1")
        self.beam_width = int(serving_cfg.get("beam_width", 4)
                              if beam_width is None else beam_width)
        if self.beam_width < 1:
            raise ValueError("beam_width must be >= 1")
        self.buckets = parse_buckets(buckets)
        self.page_pool = PagePool(self.pages, self.page_size)
        self.scheduler = SlotScheduler(self.max_slots, self.buckets,
                                       self.max_context,
                                       page_pool=self.page_pool,
                                       beam_width=self.beam_width,
                                       spec_gamma=self.spec_gamma)
        self._init_resume_plane(serving_cfg)
        #: the draft's split stack (None: no pooled speculation)
        self.draft_stack = None
        if draft is not None:
            try:
                self.draft_stack = split_stack(_layers_of(draft))
                where = self.draft_stack["stem"].table.device
                if where != self.device:
                    raise VelesError("the draft lives on %s, not on %s"
                                     % (where, self.device))
            except VelesError as e:
                self.draft_stack = None
                self.warning("%s: draft model unusable for pooled "
                             "speculation (%s); mode=speculative rides "
                             "the window plane", name, e)
        pos_emb = self.stack["pos_emb"]
        self._table_len = None if pos_emb is None else pos_emb.max_len
        #: per block (K pool, V pool) of the target and of the draft,
        #: built at the first tick; the draft's pages are the target's
        #: page ids
        self._caches: Optional[List] = None
        self._draft_caches: Optional[List] = None
        #: the target's parameters for this burst: None (each layer's
        #: own) or, under quant_weights, a DequantView a layer
        self._params: Optional[Dict] = None
        #: (leaf key of the float tree, its calibrated int8 twin)
        self._quant_cache: Optional[Tuple] = None
        self._page_table = numpy.zeros(
            (self.max_slots, self.pages_per_slot), numpy.int64)
        self._tok = numpy.zeros(self.max_slots, numpy.int64)
        self._pos = numpy.zeros(self.max_slots, numpy.int64)
        #: each sampled slot's private generator (None for greedy rows)
        self._gens: List[Optional[torch.Generator]] = \
            [None] * self.max_slots
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        self.admitted = 0
        self.retired = 0
        self.peak_slots = 0
        self.peak_pages = 0
        #: target prefills run, by bucket length, and the draft's
        self.prefills_by_bucket: Dict[int, int] = {}
        self.draft_prefills_by_bucket: Dict[int, int] = {}
        #: host ms of the most recent decode ticks, each ending in the
        #: tokens' copy to the host, and the most recent requests' time
        #: to first token (ticket stamps: enqueued → first token); the
        #: speculative rounds' and beam steps' ms beside them
        self.decode_ms: collections.deque = collections.deque(maxlen=4096)
        self.spec_ms: collections.deque = collections.deque(maxlen=4096)
        self.beam_ms: collections.deque = collections.deque(maxlen=4096)
        self.ttft_ms: collections.deque = collections.deque(maxlen=4096)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ContinuousEngine":
        if self._thread is not None:
            return self
        self._closing = False
        if self.qos:
            set_pressure_provider(self._pressure_fn)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name + ".engine")
        self._thread.start()
        from . import register_engine
        register_engine(self)
        self.info("%s: continuous batching up (slots=%d buckets=%s "
                  "max_context=%d decode_block=%d pages=%dx%d "
                  "spec_gamma=%d beam_width=%d draft=%s qos=%s "
                  "quant_weights=%s quant_kv=%s, %s)",
                  self.name, self.max_slots, list(self.buckets),
                  self.max_context, self.decode_block, self.pages,
                  self.page_size, self.spec_gamma, self.beam_width,
                  self.draft_stack is not None, self.qos,
                  self.quant_weights, self.quant_kv, self.device)
        return self

    def stop(self) -> None:
        with self.scheduler.cv:
            self._closing = True
            self.scheduler.cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # a handoff the loop never took (stop racing a drain): release
        # its waiter; the abort below settles the tickets with progress
        pending, self._handoff = self._handoff, None
        if pending is not None:
            pending[1].set()
        self.scheduler.drain("server shutting down")
        self._abort_active("server shutting down", code=503,
                           retry_after=5.0, count_shed=False)
        clear_pressure_provider(self._pressure_fn)
        from . import unregister_engine
        unregister_engine(self)

    @property
    def closing(self) -> bool:
        """True once :meth:`stop` has begun."""
        return self._closing

    # -- intake --------------------------------------------------------------
    def accepts(self, req: Dict) -> Optional[str]:
        """None when the slot pool can serve ``req``; otherwise the
        reason (the caller falls back to the window plane)."""
        t_p, n_new = len(req["prompt"]), int(req["n_new"])
        mode = str(req.get("mode", "greedy"))
        if mode not in _STEP_MODES + ("speculative", "beam"):
            # fail CLOSED: no tick would ever advance an unknown mode,
            # and its slot and pages would leak
            return "unknown decode mode %r" % mode
        if t_p < 1:
            return "empty prompt"
        if int(req.get("resume_k", 0) or 0) and mode not in _STEP_MODES:
            # only a decode-step row's generator re-enters its stream
            # mid-decode; speculative and beam retry from scratch
            return ("token-level resume serves greedy/sample only "
                    "(mode=%s retries from scratch)" % mode)
        gamma = int(req.get("gamma", self.spec_gamma))
        if mode == "speculative":
            if self.draft_stack is None:
                return ("no pooled draft model (speculation rides the "
                        "window plane)")
            if gamma != self.spec_gamma:
                return ("gamma %d differs from the pool's fixed-shape "
                        "round (spec_gamma=%d)" % (gamma, self.spec_gamma))
            if self.quant_kv:
                return ("int8 KV pool serves greedy/sample only; "
                        "speculation rides the window plane")
        if mode == "beam":
            beam = int(req.get("beam", self.beam_width))
            if beam != self.beam_width:
                return ("beam %d differs from the pool's fixed-shape "
                        "group (beam_width=%d)" % (beam, self.beam_width))
            if self.quant_kv:
                return ("int8 KV pool serves greedy/sample only; beam "
                        "rides the window plane")
            vocab = int(self.stack["head"].vocab_size)
            if self.beam_width > vocab:
                return ("beam %d exceeds the head's vocab size %d"
                        % (self.beam_width, vocab))
        reason = self.scheduler.reject_reason(t_p, n_new, mode=mode,
                                              gamma=gamma)
        if reason:
            return reason
        worst = self.scheduler._worst_positions(t_p, n_new, mode, gamma)
        if self._table_len is not None and worst > self._table_len:
            return ("generation to %d positions exceeds the trained "
                    "PositionalEmbedding table (%d rows)"
                    % (worst, self._table_len))
        if mode == "speculative":
            dpe = self.draft_stack["pos_emb"]
            if dpe is not None and worst > dpe.max_len:
                return ("speculation to %d positions exceeds the "
                        "draft's PositionalEmbedding table" % worst)
        if mode != "beam" and \
                0 < float(req.get("temperature", 0.0)) < _TEMP_EPS:
            return ("temperature %g below the engine's %g resolution"
                    % (req["temperature"], _TEMP_EPS))
        bucket = self.scheduler.bucket_for(t_p)
        if self._kernel_straddle(t_p, bucket, self.stack):
            # padding would flip attention_core's kernel choice against
            # the exact-length solo prefill, and the two drift in the
            # last bits
            return ("prompt %d pads to bucket %d across the "
                    "flash-attention crossover" % (t_p, bucket))
        if mode == "speculative" and self._kernel_straddle(
                t_p, bucket, self.draft_stack):
            return ("prompt %d pads to bucket %d across the draft's "
                    "flash-attention crossover" % (t_p, bucket))
        return None

    def _resumable(self, slot) -> bool:
        """A row is preempted only when its folded prompt (prompt +
        emitted tokens) has a bucket, prefilled by the same attention
        kernel as at that exact length."""
        folded = slot.t_p + len(slot.tokens)
        bucket = self.scheduler.bucket_for(folded)
        return bucket is not None and not self._kernel_straddle(folded,
                                                                bucket)

    def _kernel_straddle(self, t_p: int, bucket: int, stack=None) -> bool:
        """True when any block of ``stack`` (default the target's) would
        pick another attention kernel for the padded bucket length than
        for the exact prompt length (``ops.flash_attention.choose_flash``)."""
        if t_p == bucket:
            return False
        for blk in (stack or self.stack)["blocks"]:
            hd = blk.head_dim
            if choose_flash(bucket, hd, self.device) != choose_flash(
                    t_p, hd, self.device):
                return True
        return False

    def submit(self, req: Dict, ticket, max_queue: Optional[int] = None,
               checked: bool = False) -> bool:
        """Enqueue one request; False = queue bound hit or the engine is
        closing (the caller sheds 503). ``checked=True`` skips
        :meth:`accepts`, for callers that just routed on its verdict;
        otherwise a request the pool cannot hold is answered 400."""
        if not checked:
            reason = self.accepts(req)
            if reason is not None:
                ticket.fail(reason, code=400)
                return True
        # the closing check and the enqueue share the scheduler's lock:
        # stop() flips _closing under it before draining
        with self.scheduler.cv:
            if self._closing:
                return False
            return self.scheduler.push(req, ticket, max_queue)

    def serve(self, reqs: List[Dict], timeout: float = 300.0
              ) -> List[List[int]]:
        """Synchronous convenience (tests, benchmarks): submit every
        request, wait, return each token list; raises on any error."""
        return [r["tokens"] for r in self.serve_results(reqs, timeout)]

    def serve_results(self, reqs: List[Dict], timeout: float = 300.0
                      ) -> List[Dict]:
        """:meth:`serve`, returning each request's whole answer (with
        ``rounds``/``acceptance`` or ``scores`` by mode)."""
        tickets = [Ticket(mode=req.get("mode", "greedy")) for req in reqs]
        for req, ticket in zip(reqs, tickets):
            if not self.submit(req, ticket):
                raise VelesError("serving queue full")
        out = []
        for req, ticket in zip(reqs, tickets):
            if not ticket.event.wait(timeout):
                raise VelesError("serving timed out for %r" % (req,))
            if ticket.error is not None:
                raise VelesError("serving failed: %s" % ticket.error)
            out.append(ticket.result)
        return out

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        in_use = self.page_pool.in_use()
        occupied = 0
        for slot in self.scheduler.active():
            pos = int(self._pos[slot.idx])
            for j in range(len(slot.pages)):
                occupied += max(0, min(pos - j * self.page_size,
                                       self.page_size))
        frag = (0.0 if in_use == 0 else
                max(0.0, 1.0 - occupied / (in_use * self.page_size)))
        return {
            "slots": self.max_slots,
            "slots_busy": self.scheduler.busy_count(),
            "peak_slots": self.peak_slots,
            "queue_depth": self.scheduler.queue_depth(),
            "admitted": self.admitted,
            "retired": self.retired,
            "pages_total": self.pages,
            "pages_in_use": in_use,
            "page_size": self.page_size,
            "page_fragmentation": round(frag, 4),
            # payloads and, on the int8 pool, the scales
            "kv_pool_bytes": pool_nbytes(self._caches)
            + pool_nbytes(self._draft_caches),
            "quant_weights": int(self.quant_weights),
            "quant_kv": int(self.quant_kv),
            "spec_gamma": self.spec_gamma,
            "beam_width": self.beam_width,
            # the QoS plane, all 0 with the knob off
            "qos": int(self.qos),
            "preemptions": self.preemptions,
            "preempted_tokens": self.preempted_tokens,
        }

    def invalidate_quant_cache(self) -> None:
        """Drop the calibrated int8 twin, so the next idle step boundary
        calibrates from the live weights again."""
        self._quant_cache = None
        self._params = None

    # -- worker --------------------------------------------------------------
    def _loop(self) -> None:
        fail_streak = 0
        # inference mode belongs to the thread that enters it
        with torch.inference_mode():
            while True:
                with self.scheduler.cv:
                    while (not self.scheduler._queue
                           and self.scheduler.busy_count() == 0
                           and self._handoff is None
                           and not self._closing):
                        self.scheduler.cv.wait(timeout=5.0)
                    if self._closing:
                        return
                try:
                    self._tick()
                    fail_streak = 0
                except Exception:     # noqa: BLE001 — serve, don't die
                    fail_streak += 1
                    self.exception("%s: serving tick failed", self.name)
                    self._abort_active("internal serving error",
                                       code=500, count_shed=False)
                    # rebuilt at the next tick
                    self._caches = self._draft_caches = None
                    # deadlines hold while ticks cannot run; back off
                    # instead of spinning while the failure persists
                    shed_expired(self.scheduler.expire_queued())
                    if not self._closing:
                        time.sleep(min(1.0, 0.05 * (2 ** fail_streak)))

    def _tick(self) -> None:
        """One step boundary: a pending handoff, else preempt for
        waiting interactive requests (QoS), admit into free slots, then
        advance each decode mode's live rows by one dispatch: the decode
        step, the speculative round, the beam step."""
        if self._step_boundary():
            return
        if self._params is None or self.scheduler.busy_count() == 0:
            # at an idle boundary only: no row decodes on half-old,
            # half-new weights
            self._params = self._prepare_params()
        self._ensure_pool()
        if self.qos:
            # before admission, so the freed slots go to the waiting
            # interactive requests in this same tick
            self._preempt_for_interactive()
        admissions, expired = self.scheduler.take_admissions()
        shed_expired(expired)
        for slot in admissions:
            if self.scheduler.slots[slot.idx] is not slot:
                # retired within this loop: an n_new=1 beam group is
                # answered (every hypothesis row freed) by its lead's
                # admission
                continue
            try:
                self._admit(slot)
            except Exception as e:    # noqa: BLE001 — answer, don't die
                # the prefill wrote only this request's pages: answer it
                # (every hypothesis row of a beam group) and keep the
                # co-tenants decoding
                self.exception("%s: admission failed", self.name)
                for victim in (slot.group.slots if slot.group is not None
                               else [slot]):
                    self._retire_slot(victim)
                slot.ticket.fail("%s: %s" % (type(e).__name__, e),
                                 code=500)
        self.peak_slots = max(self.peak_slots,
                              self.scheduler.busy_count())
        self.peak_pages = max(self.peak_pages, self.page_pool.in_use())
        try:
            if self.scheduler.active(_STEP_MODES):
                self._decode()
            if self.scheduler.active(("speculative",)):
                self._spec_tick()
            if self.scheduler.active_beams():
                self._beam_tick()
        except FaultInjected as e:
            # an injected decode fault fires before its dispatch: the
            # live rows are shed 503 with their progress, the pool stays
            # consistent
            self._abort_active(str(e), code=503, retry_after=1.0)

    def _prepare_params(self) -> Optional[Dict]:
        """The target's parameters for the next burst: None (the float
        engine reads each layer's own), or the int8 twin read through a
        :class:`~veles_tpu_torch.quant.DequantView` a layer, in the
        model's float dtype. The twin is calibrated again only when a
        weight was replaced or written in place since
        (:func:`_leaf_key`); :meth:`invalidate_quant_cache` forces it."""
        if not self.quant_weights:
            return None
        stack = self.stack
        layers = ([stack["stem"]]
                  + ([stack["pos_emb"]] if stack["pos_emb"] is not None
                     else []) + stack["blocks"] + [stack["head"]])
        params = params_of(layers)
        key = _leaf_key(params)
        cached = self._quant_cache
        if cached is None or cached[0] != key:
            qparams, _report = quantize_params(params)
            cached = self._quant_cache = (key, qparams)
        dtype = stack["stem"].table.dtype
        return {name: DequantView(unit, dtype)
                for name, unit in cached[1].items()}

    def _pools(self, stack, quantized: bool) -> List:
        return [block_page_pool(self.page_pool.device_rows, self.page_size,
                                blk.n_kv_heads, blk.head_dim,
                                stack["stem"].table.dtype, quantized,
                                self.device)
                for blk in stack["blocks"]]

    def _ensure_pool(self) -> None:
        if self._caches is None:
            self._caches = self._pools(self.stack, self.quant_kv)
        # under quant_kv every speculative request rides the window
        # plane, so a draft pool would be dead memory
        if (self._draft_caches is None and self.draft_stack is not None
                and not self.quant_kv):
            self._draft_caches = self._pools(self.draft_stack, False)

    def _refresh_table_row(self, slot) -> None:
        """Sync the host page-table row with the slot's page list."""
        row = self._page_table[slot.idx]
        row[:] = 0
        row[:len(slot.pages)] = slot.pages

    # -- admission: the bucketed prefill --------------------------------------
    def _scatter_prompt(self, pool, rows, pages) -> None:
        """Write a bucket's prefill rows (bucket, ...) — K or V rows
        (bucket, KV, Dh), or their int8 scales (bucket,) — page by page
        into ``pool`` at ``pages``, padded up to whole pages."""
        n_pages = pages.shape[0]
        pad = n_pages * self.page_size - rows.shape[0]
        if pad:
            rows = torch.nn.functional.pad(
                rows, (0, 0) * (rows.dim() - 1) + (0, pad))
        pool[pages] = rows.reshape((n_pages, self.page_size)
                                   + tuple(rows.shape[1:]))

    def _prefill_into(self, stack, pools, ids, bucket, pages, params=None):
        """One stack's bucketed prefill of ``ids`` (1, bucket), its K/V
        rows scattered into ``pools`` at ``pages`` → the hidden rows.
        Pad rows land in the pages too: the causal mask hides them from
        every real query, and each decode step writes position p before
        any read can reach it. On the int8 pool the float rows are
        quantized once, one scale a position, and the payloads and
        scales go through the same page ids."""
        x = _embed_prompt(stack["stem"], stack["pos_emb"], ids)
        x, caches = _prefill_blocks(stack["blocks"], x, bucket, params)
        for (ck, cv), pool in zip(caches, pools):
            if len(pool) == 4:
                for rows, pool_q, pool_s in ((ck, pool[0], pool[2]),
                                             (cv, pool[1], pool[3])):
                    q, scale = quantize_rows_int8(rows[0])
                    self._scatter_prompt(pool_q, q, pages)
                    self._scatter_prompt(pool_s, scale, pages)
            else:
                self._scatter_prompt(pool[0], ck[0], pages)
                self._scatter_prompt(pool[1], cv[0], pages)
        inc("veles_serving_prefill_dispatches_total")
        return x

    def _admit(self, slot) -> None:
        t_p, bucket = slot.t_p, slot.bucket
        group = slot.group
        self._refresh_table_row(slot)
        if group is not None and slot is not group.slots[0]:
            # a sibling hypothesis row starts as a copy of the lead
            # row's prompt cache: one page copy instead of a prefill
            # (the lead admits first)
            n = pages_for(bucket, self.page_size)
            src = torch.as_tensor(group.slots[0].pages[:n],
                                  dtype=torch.int64, device=self.device)
            dst = torch.as_tensor(slot.pages[:n], dtype=torch.int64,
                                  device=self.device)
            for pair in self._caches:
                for pool in pair:
                    pool[dst] = pool[src]
            self._pos[slot.idx] = t_p
            return
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :t_p] = torch.as_tensor(slot.req["prompt"],
                                       dtype=torch.int64)
        ids = ids.to(self.device)
        ticket = slot.ticket
        resume_k = int(slot.req.get("resume_k", 0) or 0)
        if resume_k:
            inc("veles_resume_tokens_total", resume_k)
        pages = torch.as_tensor(
            slot.pages[:pages_for(bucket, self.page_size)],
            dtype=torch.int64, device=self.device)
        with span("serving.prefill", bucket=bucket, slot=slot.idx,
                  t_p=t_p, mode=slot.mode,
                  request_id=ticket.request_id, trace_id=ticket.trace_id,
                  attempt=ticket.attempt):
            x = self._prefill_into(self.stack, self._caches, ids, bucket,
                                   pages, self._params)
            if slot.mode == "speculative":
                self._prefill_into(self.draft_stack, self._draft_caches,
                                   ids, bucket, pages)
                self.draft_prefills_by_bucket[bucket] = \
                    self.draft_prefills_by_bucket.get(bucket, 0) + 1
            logits = _head_logits(self.stack["head"], x[:, t_p - 1],
                                  self._params)
            if group is not None:
                scores, cur, finished = _expand_first(
                    logits[0], self.beam_width,
                    -1 if slot.eos_id is None else int(slot.eos_id))
                group.cur = cur.cpu().numpy()
                group.scores = scores.cpu().numpy()
                group.finished = finished.cpu().numpy()
                first = None
            elif slot.temperature > 0:
                # a resumed row re-enters its stream after resume_k draws
                gen = advanced_generator(
                    slot.req.get("seed", 0), resume_k,
                    self.stack["head"].vocab_size, self.device)
                self._gens[slot.idx] = gen
                first = int(_draw(logits[0], slot.temperature, gen)[0])
            else:
                first = int(torch.argmax(logits[0]))
        inc("veles_decode_dispatches_total")
        self.prefills_by_bucket[bucket] = \
            self.prefills_by_bucket.get(bucket, 0) + 1
        # the host copy above synced the prefill: this step boundary IS
        # prefill-done and first-token time (the first stamp wins)
        ticket.mark_prefill_done()
        ticket.mark_first_token()
        if not slot.req.get("_requeued"):
            # a preempted request was admitted and counted once already
            inc("veles_serving_admitted_total")
            inc("veles_serving_queue_wait_seconds_total",
                max(0.0, (ticket.admitted or time.time())
                    - ticket.enqueued))
            self.admitted += 1
            self.ttft_ms.append((ticket.first_token - ticket.enqueued)
                                * 1e3)
        self._pos[slot.idx] = t_p
        if group is not None:
            group.toks = numpy.zeros((self.beam_width, slot.n_new),
                                     numpy.int64)
            group.toks[:, 0] = group.cur
            group.step = 0
            if slot.n_new == 1:
                self._finish_beam(group)
            return
        self._tok[slot.idx] = first
        done = slot.record(first)
        ticket.push_tokens([first])
        if done:
            self._finish(slot)

    # -- the row step -----------------------------------------------------------
    def _grow_or_shed(self, slots: List, need_fn) -> List:
        """Extend each slot's pages to cover ``need_fn(slot)`` positions
        before the next dispatch. Admission reserved every row's own
        worst case, so this normally allocates nothing; a slot the
        allocator cannot cover is shed 503 + Retry-After (pages freed;
        a beam request's every hypothesis row, answered once) while the
        survivors keep decoding."""
        alive: List = []
        dead = set()
        for slot in slots:
            if id(slot) in dead:
                continue
            if self.scheduler.grow(slot, need_fn(slot)):
                self._refresh_table_row(slot)
                alive.append(slot)
                continue
            victims = (slot.group.slots if slot.group is not None
                       else [slot])
            for v in victims:
                dead.add(id(v))
                if v in alive:
                    alive.remove(v)
                self._retire_slot(v)
            if slot.mode in _STEP_MODES:
                slot.ticket.set_progress(self._emitted(slot))
            if slot.ticket.fail("serving page pool exhausted mid-decode",
                                code=503, retry_after=1.0):
                inc("veles_shed_requests_total")
        return alive

    def _row_targets(self, pos, mask):
        """Per-row (page id, in-page offset) where position ``pos`` is
        written; masked rows, and positions past a row's table, target
        the sink page."""
        rows = numpy.arange(self.max_slots)
        last = self.pages_per_slot * self.page_size
        page = self._page_table[rows, numpy.minimum(
            pos // self.page_size, self.pages_per_slot - 1)]
        page = numpy.where(mask & (pos < last), page, 0)
        return (torch.as_tensor(page, device=self.device),
                torch.as_tensor(pos % self.page_size, device=self.device))

    def _step_logits(self, stack, pools, tok, pos, mask, tables,
                     params=None):
        """One position of every row through ``stack`` over its paged
        ``pools`` → (S, V) logits: each masked-in row writes its new K/V
        at ``pos`` and reads its own pages (the decode step, a draft
        step of the speculative round, the beam step). ``params``
        overrides the layers' own (the int8 twin's views)."""
        targets = self._row_targets(pos, mask)
        x = _embed_rows(stack["stem"], stack["pos_emb"], tok, pos)
        for blk, pool in zip(stack["blocks"], pools):
            p = None if params is None else params[blk.name]
            if len(pool) == 4:
                x = _block_step_rows_int8(blk, x, pool, tables, pos,
                                          targets, p)
            else:
                x = _block_step_rows(blk, x, pool[0], pool[1], tables, pos,
                                     targets, p)
        return _head_logits(stack["head"], x[:, 0], params)

    def _mask(self, slots) -> numpy.ndarray:
        mask = numpy.zeros(self.max_slots, bool)
        for slot in slots:
            mask[slot.idx] = True
        return mask

    def _decode(self) -> None:
        active = self._grow_or_shed(
            self.scheduler.active(_STEP_MODES),
            lambda s: min(s.t_p + s.n_new,
                          int(self._pos[s.idx]) + self.decode_block))
        if not active:
            return
        fire_fault("serve.decode_step")
        t0 = time.perf_counter()
        mask = self._mask(active)
        sampled = [s for s in active if s.temperature > 0]
        live = torch.as_tensor(mask, device=self.device)
        tables = torch.as_tensor(self._page_table, device=self.device)
        tok = torch.as_tensor(self._tok, device=self.device)
        pos = self._pos.copy()
        out = []
        with span("serving.decode_step", active=len(active),
                  chunk=self.decode_block):
            for _ in range(self.decode_block):
                logits = self._step_logits(self.stack, self._caches, tok,
                                           pos, mask, tables,
                                           self._params)        # (S, V)
                nxt = torch.argmax(logits, dim=-1)
                for slot in sampled:
                    nxt[slot.idx] = _draw(logits[slot.idx],
                                          slot.temperature,
                                          self._gens[slot.idx])[0]
                tok = torch.where(live, nxt, tok)
                out.append(tok)
                pos = pos + mask
            toks = torch.stack(out).cpu().numpy()   # (decode_block, S)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        inc("veles_serving_decode_dispatches_total")
        inc("veles_decode_dispatches_total")
        base = {slot.idx: len(slot.tokens) for slot in active}
        finished: List = []
        for h in range(toks.shape[0]):
            for slot in active:
                if slot in finished:
                    continue
                token = int(toks[h, slot.idx])
                self._tok[slot.idx] = token
                self._pos[slot.idx] += 1
                if slot.record(token):
                    finished.append(slot)
        for slot in active:
            # this chunk's tokens reach a streamed ticket before its
            # terminal sentinel
            slot.ticket.push_tokens(slot.tokens[base[slot.idx]:])
        for slot in finished:
            self._finish(slot)

    # -- the speculative round --------------------------------------------------
    def _spec_tick(self) -> None:
        """One draft/verify round for every speculative row: the draft
        proposes ``spec_gamma`` tokens (single-row steps over its paged
        pool), the target verifies the whole window in one
        multi-position pass, and the accept rule emits up to gamma
        tokens per row (greedy prefix match, or the rejection rule for a
        sampled row). Rejected positions leave stale page rows behind;
        every read masks strictly by position and the next round
        overwrites from the accepted head."""
        gamma = self.spec_gamma
        active = self._grow_or_shed(
            self.scheduler.active(("speculative",)),
            lambda s: min(s.t_p + s.n_new + gamma + 1,
                          int(self._pos[s.idx]) + gamma))
        if not active:
            return
        fire_fault("serve.decode_step")
        t0 = time.perf_counter()
        mask = self._mask(active)
        rows = [s.idx for s in active]
        gens: List[Optional[torch.Generator]] = [None] * self.max_slots
        taus = [1.0] * self.max_slots
        for slot in active:
            if slot.temperature > 0:
                gens[slot.idx] = self._gens[slot.idx]
                taus[slot.idx] = slot.temperature
        tables = torch.as_tensor(self._page_table, device=self.device)
        tok = torch.as_tensor(self._tok, device=self.device)
        pos = self._pos.copy()
        stack = self.stack
        with span("serving.spec_round", active=len(active), gamma=gamma):
            cur, d_cols, pd_rows = tok, [], {}
            for j in range(gamma):
                cur, probs = _draft_pick(self._step_logits(
                    self.draft_stack, self._draft_caches, cur, pos + j,
                    mask, tables), taus, gens)
                d_cols.append(cur)
                for r, pr in probs.items():
                    pd_rows.setdefault(r, []).append(pr)
            d_toks = torch.stack(d_cols, dim=1)             # (S, gamma)
            window = torch.cat([tok[:, None], d_toks[:, :-1]], dim=1)
            targets = [self._row_targets(pos + j, mask)
                       for j in range(gamma)]
            targets = (torch.stack([t[0] for t in targets], dim=1),
                       torch.stack([t[1] for t in targets], dim=1))
            x = _embed_span(stack["stem"], stack["pos_emb"], window, pos)
            params = self._params
            for blk, (kp, vp) in zip(stack["blocks"], self._caches):
                x = _block_span_rows(
                    blk, x, kp, vp, tables, pos, targets,
                    None if params is None else params[blk.name])
            t_logits = _head_logits(stack["head"], x,
                                    params)             # (S, gamma, V)
            verdicts = _accept_rows(
                t_logits, d_toks, rows, taus, gens,
                {r: torch.stack(v) for r, v in pd_rows.items()})
            d_host = d_toks.cpu().numpy()
        self.spec_ms.append((time.perf_counter() - t0) * 1e3)
        inc("veles_serving_decode_dispatches_total")
        inc("veles_decode_dispatches_total")
        inc("veles_serving_spec_rounds_total", len(active))
        finished: List = []
        for slot in active:
            i = slot.idx
            a, fix = verdicts[i]
            emitted, self._tok[i] = _emission(a, fix, d_host[i])
            slot.rounds += 1
            slot.acc += a
            self._pos[i] += len(emitted)
            base = len(slot.tokens)
            for t in emitted:
                if slot.record(t):
                    finished.append(slot)
                    break
            slot.ticket.push_tokens(slot.tokens[base:])
        for slot in finished:
            self._finish(slot)

    # -- the beam step -------------------------------------------------------
    def _beam_tick(self) -> None:
        """One top-k step for every live beam group: one row step for
        every hypothesis over its own pages, the group's top-W of the
        W·V joint scores (``nn/beam._beam_topk``), and the cache reorder
        by surviving parent (:meth:`_reorder_pages`)."""
        groups = self.scheduler.active_beams()
        hyps = [s for g in groups for s in g.slots]
        alive = self._grow_or_shed(
            hyps, lambda s: min(s.t_p + max(s.n_new - 1, 1),
                                int(self._pos[s.idx]) + 1))
        groups = [g for g in groups if all(s in alive for s in g.slots)]
        if not groups:
            return
        fire_fault("serve.decode_step")
        t0 = time.perf_counter()
        slots = [s for g in groups for s in g.slots]
        tok = self._tok.copy()
        for g in groups:
            for w, slot in enumerate(g.slots):
                tok[slot.idx] = g.cur[w]
        dev = self.device
        with span("serving.beam_step", groups=len(groups),
                  width=self.beam_width):
            logits = self._step_logits(
                self.stack, self._caches, torch.as_tensor(tok, device=dev),
                self._pos.copy(), self._mask(slots),
                torch.as_tensor(self._page_table, device=dev), self._params)
            idx = torch.as_tensor([[s.idx for s in g.slots]
                                   for g in groups], device=dev)
            nxt, parent, scores, fin = _beam_topk(
                logits[idx],
                torch.as_tensor(numpy.stack([g.scores for g in groups]),
                                device=dev),
                torch.as_tensor(numpy.stack([g.finished for g in groups]),
                                device=dev),
                torch.as_tensor([-1 if g.slots[0].eos_id is None
                                 else int(g.slots[0].eos_id)
                                 for g in groups], device=dev))
            nxt, parent = nxt.cpu().numpy(), parent.cpu().numpy()
            scores, fin = scores.cpu().numpy(), fin.cpu().numpy()
            self._reorder_pages(groups, parent)
        self.beam_ms.append((time.perf_counter() - t0) * 1e3)
        inc("veles_serving_decode_dispatches_total")
        inc("veles_decode_dispatches_total")
        inc("veles_serving_beam_steps_total", len(groups))
        for gi, group in enumerate(groups):
            i = group.step + 1
            group.toks = group.toks[parent[gi]]
            group.toks[:, i] = nxt[gi]
            group.cur = nxt[gi]
            group.scores = scores[gi]
            group.finished = fin[gi]
            group.step = i
            for slot in group.slots:
                self._pos[slot.idx] += 1
            if i >= group.slots[0].n_new - 1:
                self._finish_beam(group)

    def _reorder_pages(self, groups, parent) -> None:
        """Each hypothesis row whose surviving parent is another row
        takes that parent's pages up to the step's position, in every
        block of the target's pool. Every source page is gathered before
        any is written: parents that form a cycle would otherwise read a
        page the copy already overwrote."""
        src: List[int] = []
        dst: List[int] = []
        for gi, group in enumerate(groups):
            n = pages_for(int(self._pos[group.slots[0].idx]) + 1,
                          self.page_size)
            for w, child in enumerate(group.slots):
                pw = int(parent[gi, w])
                if pw != w:
                    src.extend(self._page_table[group.slots[pw].idx, :n])
                    dst.extend(self._page_table[child.idx, :n])
        if not dst:
            return
        src_t = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        dst_t = torch.as_tensor(dst, dtype=torch.int64, device=self.device)
        for pair in self._caches:
            for pool in pair:
                pool[dst_t] = pool[src_t]

    # -- retirement -------------------------------------------------------------
    def _retire_slot(self, slot) -> None:
        """Clear a row's host state and free its slot and pages. The
        page-table row is zeroed, so a retired row's stale view can
        never alias pages the allocator hands to the next admission."""
        self._tok[slot.idx] = 0
        self._pos[slot.idx] = 0
        self._gens[slot.idx] = None
        self._page_table[slot.idx, :] = 0
        self.scheduler.retire(slot)

    def _finish(self, slot) -> None:
        """Retire a finished row and answer its ticket."""
        # co-resident rows at retirement: the window plane's
        # batched_with key, so the schema does not depend on the plane
        batched_with = max(0, self.scheduler.busy_count() - 1)
        self._retire_slot(slot)
        # the tokens a preemption folded into the prompt come first: the
        # answer covers the whole generation
        tokens = self._emitted(slot)
        result = {"tokens": tokens,
                  "batched_with": batched_with,
                  "engine": "continuous"}
        if slot.mode == "speculative":
            rounds = max(slot.rounds, 1)
            result["rounds"] = rounds
            result["acceptance"] = slot.acc / (rounds * self.spec_gamma)
        # count only a first-terminal answer, like every shed path
        slot.ticket.succeed(result, counted=lambda: self._count_retired(
            len(tokens)))

    def _finish_beam(self, group) -> None:
        """Answer a beam request: hypotheses ranked as ``beam_generate``
        ranks them (descending float64 score; eos freezing already
        shaped the scores), every hypothesis row retired."""
        order = numpy.argsort(-group.scores.astype(numpy.float64))
        best = int(order[0])
        for slot in group.slots:
            self._retire_slot(slot)
        batched_with = max(0, self.scheduler.busy_count() - 1)
        group.ticket.succeed(
            {"tokens": [int(t) for t in group.toks[best]],
             "scores": [float(group.scores[i]) for i in order],
             "batched_with": batched_with, "engine": "continuous"},
            counted=lambda: self._count_retired(group.toks.shape[1]))

    def _count_retired(self, n_tokens: int) -> None:
        """A first-terminal answer's counting (``Ticket.succeed`` runs it
        before the answer is visible)."""
        inc("veles_serving_retired_total")
        inc("veles_serving_tokens_total", n_tokens)
        self.retired += 1

    def _abort_active(self, reason: str, code: int = 500,
                      retry_after: Optional[float] = None,
                      count_shed: bool = True) -> None:
        """Retire every live row and answer its ticket with ``code``,
        once per request (a beam request holds several rows). A
        decode-step row hands its emitted tokens to the ticket first, so
        the answer carries ``resume`` and a retry continues from them."""
        answered = set()
        for slot in self.scheduler.active():
            if slot.mode in _STEP_MODES and (
                    slot.tokens or slot.req.get("_qos_prefix")):
                slot.ticket.set_progress(self._emitted(slot))
            self._retire_slot(slot)
            if id(slot.ticket) in answered:
                continue
            answered.add(id(slot.ticket))
            if slot.ticket.fail(reason, code=code,
                                retry_after=retry_after) and count_shed:
                inc("veles_shed_requests_total")
