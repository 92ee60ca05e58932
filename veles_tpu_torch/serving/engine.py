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
- streamed tickets get their tokens at every step boundary.

Not ported yet: prefix sharing, chunked prefill, QoS preemption and
resume, drain by handoff, int8 weights and KV, the serve artifact and
tensor-parallel serving; requests the pool cannot hold ride the window
plane (:meth:`ContinuousEngine.accepts`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy
import torch

from ..backends import device_for
from ..config import root
from ..error import VelesError
from ..logger import Logger
from ..nn.beam import _beam_topk, _expand_first
from ..nn.sampling import (_block_step_rows, _draw, _embed_prompt,
                           _embed_rows, _head_logits, _prefill_blocks,
                           _row_generators, split_stack)
from ..nn.speculative import (_accept_rows, _block_span_rows,
                              _draft_pick, _embed_span, _emission)
from ..ops.flash_attention import choose_flash
from ..telemetry.counters import inc
from ..telemetry.spans import span
from .pages import PagePool, pages_for
from .scheduler import SlotScheduler, Ticket, shed_expired

#: floor of the sampling temperature on the pool (the reference's
#: clamp); a colder sampled request rides the window plane, which
#: divides exactly
_TEMP_EPS = 1e-3

#: the decode modes the pool advances
_STEP_MODES = ("greedy", "sample")


def make_request(prompt, n_new, temperature=0.0, seed=0, eos_id=None,
                 mode="greedy", gamma=4, beam=4) -> Dict:
    """Normalized request dict (the subset of GenerationAPI's parsed
    request the engine consumes), for tests and benchmarks."""
    return {"prompt": [int(t) for t in prompt], "n_new": int(n_new),
            "temperature": float(temperature), "seed": int(seed),
            "eos_id": eos_id, "mode": str(mode), "gamma": int(gamma),
            "beam": int(beam)}


def _layers_of(wf):
    """The layers of the stack ``wf``; anything that is not a sequence of
    layers is not a generation stack."""
    try:
        return list(wf)
    except TypeError:
        raise VelesError("not a generation stack: %s"
                         % type(wf).__name__) from None


class ContinuousEngine(Logger):
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
    multiple of it. Knob geometry that cannot work raises ValueError.
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
        for knob, value in (("quant_weights", quant_weights),
                            ("quant_kv", quant_kv), ("artifact", artifact),
                            ("prefix_cache", prefix_cache),
                            ("prefill_chunk", prefill_chunk)):
            if value:
                raise ValueError("serving knob %s=%r is not ported yet"
                                 % (knob, value))
        if tp is not None and int(tp) > 1:
            raise ValueError("tensor-parallel serving (tp=%d) is not "
                             "ported yet" % int(tp))
        from . import parse_buckets
        self.name = name
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
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name + ".engine")
        self._thread.start()
        from . import register_engine
        register_engine(self)
        self.info("%s: continuous batching up (slots=%d buckets=%s "
                  "max_context=%d decode_block=%d pages=%dx%d "
                  "spec_gamma=%d beam_width=%d draft=%s, %s)",
                  self.name, self.max_slots, list(self.buckets),
                  self.max_context, self.decode_block, self.pages,
                  self.page_size, self.spec_gamma, self.beam_width,
                  self.draft_stack is not None, self.device)
        return self

    def stop(self) -> None:
        with self.scheduler.cv:
            self._closing = True
            self.scheduler.cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.scheduler.drain("server shutting down")
        self._abort_active("server shutting down", code=503,
                           retry_after=5.0, count_shed=False)
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
        gamma = int(req.get("gamma", self.spec_gamma))
        if mode == "speculative":
            if self.draft_stack is None:
                return ("no pooled draft model (speculation rides the "
                        "window plane)")
            if gamma != self.spec_gamma:
                return ("gamma %d differs from the pool's fixed-shape "
                        "round (spec_gamma=%d)" % (gamma, self.spec_gamma))
        if mode == "beam":
            beam = int(req.get("beam", self.beam_width))
            if beam != self.beam_width:
                return ("beam %d differs from the pool's fixed-shape "
                        "group (beam_width=%d)" % (beam, self.beam_width))
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
        pools = (self._caches or []) + (self._draft_caches or [])
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
            "kv_pool_bytes": sum(t.numel() * t.element_size()
                                 for pair in pools for t in pair),
            "spec_gamma": self.spec_gamma,
            "beam_width": self.beam_width,
        }

    # -- worker --------------------------------------------------------------
    def _loop(self) -> None:
        fail_streak = 0
        # inference mode belongs to the thread that enters it
        with torch.inference_mode():
            while True:
                with self.scheduler.cv:
                    while (not self.scheduler._queue
                           and self.scheduler.busy_count() == 0
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
        """One step boundary: admit into free slots, then advance each
        decode mode's live rows by one dispatch: the decode step, the
        speculative round, the beam step."""
        self._ensure_pool()
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
        if self.scheduler.active(_STEP_MODES):
            self._decode()
        if self.scheduler.active(("speculative",)):
            self._spec_tick()
        if self.scheduler.active_beams():
            self._beam_tick()

    def _pools(self, stack) -> List:
        dtype = stack["stem"].table.dtype
        # zeros, not empty: a masked position's weight is an exact 0,
        # and 0 times a NaN left in fresh memory would still be NaN
        return [tuple(
            torch.zeros((self.page_pool.device_rows, self.page_size,
                         blk.n_kv_heads, blk.head_dim), dtype=dtype,
                        device=self.device) for _ in range(2))
            for blk in stack["blocks"]]

    def _ensure_pool(self) -> None:
        if self._caches is None:
            self._caches = self._pools(self.stack)
        if self._draft_caches is None and self.draft_stack is not None:
            self._draft_caches = self._pools(self.draft_stack)

    def _refresh_table_row(self, slot) -> None:
        """Sync the host page-table row with the slot's page list."""
        row = self._page_table[slot.idx]
        row[:] = 0
        row[:len(slot.pages)] = slot.pages

    # -- admission: the bucketed prefill --------------------------------------
    def _scatter_prompt(self, pool, rows, pages) -> None:
        """Write a bucket's prefill K or V rows (bucket, KV, Dh) page by
        page into ``pool`` at ``pages``, padded up to whole pages."""
        n_pages = pages.shape[0]
        pad = n_pages * self.page_size - rows.shape[0]
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
        pool[pages] = rows.reshape((n_pages, self.page_size)
                                   + tuple(rows.shape[1:]))

    def _prefill_into(self, stack, pools, ids, bucket, pages):
        """One stack's bucketed prefill of ``ids`` (1, bucket), its K/V
        rows scattered into ``pools`` at ``pages`` → the hidden rows.
        Pad rows land in the pages too: the causal mask hides them from
        every real query, and each decode step writes position p before
        any read can reach it."""
        x = _embed_prompt(stack["stem"], stack["pos_emb"], ids)
        x, caches = _prefill_blocks(stack["blocks"], x, bucket)
        for (ck, cv), (kp, vp) in zip(caches, pools):
            self._scatter_prompt(kp, ck[0], pages)
            self._scatter_prompt(vp, cv[0], pages)
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
        pages = torch.as_tensor(
            slot.pages[:pages_for(bucket, self.page_size)],
            dtype=torch.int64, device=self.device)
        with span("serving.prefill", bucket=bucket, slot=slot.idx,
                  t_p=t_p, mode=slot.mode,
                  request_id=ticket.request_id, trace_id=ticket.trace_id,
                  attempt=ticket.attempt):
            x = self._prefill_into(self.stack, self._caches, ids, bucket,
                                   pages)
            if slot.mode == "speculative":
                self._prefill_into(self.draft_stack, self._draft_caches,
                                   ids, bucket, pages)
                self.draft_prefills_by_bucket[bucket] = \
                    self.draft_prefills_by_bucket.get(bucket, 0) + 1
            logits = _head_logits(self.stack["head"], x[:, t_p - 1])
            if group is not None:
                scores, cur, finished = _expand_first(
                    logits[0], self.beam_width,
                    -1 if slot.eos_id is None else int(slot.eos_id))
                group.cur = cur.cpu().numpy()
                group.scores = scores.cpu().numpy()
                group.finished = finished.cpu().numpy()
                first = None
            elif slot.temperature > 0:
                gen = _row_generators(slot.req.get("seed", 0), 1,
                                      self.device)[0]
                self._gens[slot.idx] = gen
                first = int(_draw(logits[0], slot.temperature, gen)[0])
            else:
                first = int(torch.argmax(logits[0]))
        inc("veles_decode_dispatches_total")
        self.prefills_by_bucket[bucket] = \
            self.prefills_by_bucket.get(bucket, 0) + 1
        inc("veles_serving_admitted_total")
        inc("veles_serving_queue_wait_seconds_total",
            max(0.0, (ticket.admitted or time.time()) - ticket.enqueued))
        self.admitted += 1
        # the host copy above synced the prefill: this step boundary IS
        # prefill-done and first-token time
        ticket.mark_prefill_done()
        ticket.mark_first_token()
        self.ttft_ms.append((ticket.first_token - ticket.enqueued) * 1e3)
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

    def _step_logits(self, stack, pools, tok, pos, mask, tables):
        """One position of every row through ``stack`` over its paged
        ``pools`` → (S, V) logits: each masked-in row writes its new K/V
        at ``pos`` and reads its own pages (the decode step, a draft
        step of the speculative round, the beam step)."""
        targets = self._row_targets(pos, mask)
        x = _embed_rows(stack["stem"], stack["pos_emb"], tok, pos)
        for blk, (kp, vp) in zip(stack["blocks"], pools):
            x = _block_step_rows(blk, x, kp, vp, tables, pos, targets)
        return _head_logits(stack["head"], x[:, 0])

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
                                           pos, mask, tables)   # (S, V)
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
            for blk, (kp, vp) in zip(stack["blocks"], self._caches):
                x = _block_span_rows(blk, x, kp, vp, tables, pos, targets)
            t_logits = _head_logits(stack["head"], x)   # (S, gamma, V)
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
                torch.as_tensor(self._page_table, device=dev))
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
        result = {"tokens": list(slot.tokens),
                  "batched_with": batched_with,
                  "engine": "continuous"}
        if slot.mode == "speculative":
            rounds = max(slot.rounds, 1)
            result["rounds"] = rounds
            result["acceptance"] = slot.acc / (rounds * self.spec_gamma)
        # count only a first-terminal answer, like every shed path
        slot.ticket.succeed(result, counted=lambda: self._count_retired(
            len(slot.tokens)))

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
        once per request (a beam request holds several rows)."""
        answered = set()
        for slot in self.scheduler.active():
            self._retire_slot(slot)
            if id(slot.ticket) in answered:
                continue
            answered.add(id(slot.ticket))
            if slot.ticket.fail(reason, code=code,
                                retry_after=retry_after) and count_shed:
                inc("veles_shed_requests_total")
