"""Continuous-batching decode engine over a paged KV pool (counterpart
of ``veles_tpu/serving/engine.py``, its greedy and sampled plane).

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
  solo ``generate`` whatever shares the pool.

Not ported yet: prefix sharing, chunked prefill, streaming, speculative
and beam decoding on the pool, QoS preemption and resume, drain by
handoff, int8 weights and KV, the serve artifact and tensor-parallel
serving; requests in other modes ride the window plane
(:meth:`ContinuousEngine.accepts`).
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
from ..nn.sampling import (_block_step_rows, _draw, _embed_prompt,
                           _embed_rows, _head_logits, _prefill_blocks,
                           _row_generators, split_stack)
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
                 mode="greedy") -> Dict:
    """Normalized request dict (the subset of GenerationAPI's parsed
    request the engine consumes), for tests and benchmarks."""
    return {"prompt": [int(t) for t in prompt], "n_new": int(n_new),
            "temperature": float(temperature), "seed": int(seed),
            "eos_id": eos_id, "mode": str(mode)}


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
    ``decode_block`` runs that many decode steps per tick before the
    tokens come back to the host; ``page_size`` must be a positive
    multiple of it. Knob geometry that cannot work raises ValueError.
    """

    def __init__(self, wf, max_slots: int = 8,
                 buckets=(16, 32, 64, 128), max_context: int = 640,
                 decode_block: int = 1, page_size: Optional[int] = None,
                 pages: Optional[int] = None, draft=None,
                 quant_weights: Optional[bool] = None,
                 quant_kv: Optional[bool] = None,
                 artifact: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 tp: Optional[int] = None, device=None,
                 name: str = "serving") -> None:
        super().__init__()
        for knob, value in (("draft", draft),
                            ("quant_weights", quant_weights),
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
        self.buckets = parse_buckets(buckets)
        self.page_pool = PagePool(self.pages, self.page_size)
        self.scheduler = SlotScheduler(self.max_slots, self.buckets,
                                       self.max_context,
                                       page_pool=self.page_pool)
        pos_emb = self.stack["pos_emb"]
        self._table_len = None if pos_emb is None else pos_emb.max_len
        #: per block (K pool, V pool), built at the first tick
        self._caches: Optional[List] = None
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
        #: prefills run, by bucket length
        self.prefills_by_bucket: Dict[int, int] = {}
        #: host ms of the most recent decode ticks, each ending in the
        #: tokens' copy to the host, and the most recent requests' time
        #: to first token (ticket stamps: enqueued → first token)
        self.decode_ms: collections.deque = collections.deque(maxlen=4096)
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
                  "max_context=%d decode_block=%d pages=%dx%d, %s)",
                  self.name, self.max_slots, list(self.buckets),
                  self.max_context, self.decode_block, self.pages,
                  self.page_size, self.device)
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
        if mode not in _STEP_MODES:
            return ("mode=%s is not ported to the slot pool yet (it "
                    "rides the window plane)" % mode)
        reason = self.scheduler.reject_reason(t_p, n_new, mode=mode)
        if reason:
            return reason
        worst = self.scheduler._worst_positions(t_p, n_new)
        if self._table_len is not None and worst > self._table_len:
            return ("generation to %d positions exceeds the trained "
                    "PositionalEmbedding table (%d rows)"
                    % (worst, self._table_len))
        if 0 < float(req.get("temperature", 0.0)) < _TEMP_EPS:
            return ("temperature %g below the engine's %g resolution"
                    % (req["temperature"], _TEMP_EPS))
        bucket = self.scheduler.bucket_for(t_p)
        if self._kernel_straddle(t_p, bucket):
            # padding would flip attention_core's kernel choice against
            # the exact-length solo prefill, and the two drift in the
            # last bits
            return ("prompt %d pads to bucket %d across the "
                    "flash-attention crossover" % (t_p, bucket))
        return None

    def _kernel_straddle(self, t_p: int, bucket: int) -> bool:
        """True when any block's attention would pick another kernel
        for the padded bucket length than for the exact prompt length
        (``ops.flash_attention.choose_flash``)."""
        if t_p == bucket:
            return False
        for blk in self.stack["blocks"]:
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
            out.append(ticket.result["tokens"])
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
        caches = self._caches or ()
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
                                 for pair in caches for t in pair),
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
                    self._caches = None        # rebuilt at the next tick
                    # deadlines hold while ticks cannot run; back off
                    # instead of spinning while the failure persists
                    shed_expired(self.scheduler.expire_queued())
                    if not self._closing:
                        time.sleep(min(1.0, 0.05 * (2 ** fail_streak)))

    def _tick(self) -> None:
        """One step boundary: admit into free slots, then advance every
        live row by one fixed-shape decode dispatch."""
        self._ensure_pool()
        admissions, expired = self.scheduler.take_admissions()
        shed_expired(expired)
        for slot in admissions:
            try:
                self._admit(slot)
            except Exception as e:    # noqa: BLE001 — answer, don't die
                # the prefill wrote only this slot's pages: answer it
                # and keep the co-tenants decoding
                self.exception("%s: admission failed", self.name)
                self._retire_slot(slot)
                slot.ticket.fail("%s: %s" % (type(e).__name__, e),
                                 code=500)
        self.peak_slots = max(self.peak_slots,
                              self.scheduler.busy_count())
        self.peak_pages = max(self.peak_pages, self.page_pool.in_use())
        if self.scheduler.active():
            self._decode()

    def _ensure_pool(self) -> None:
        if self._caches is not None:
            return
        rows = self.page_pool.device_rows
        dtype = self.stack["stem"].table.dtype
        # zeros, not empty: a masked position's weight is an exact 0,
        # and 0 times a NaN left in fresh memory would still be NaN
        self._caches = [tuple(
            torch.zeros((rows, self.page_size, blk.n_kv_heads,
                         blk.head_dim), dtype=dtype, device=self.device)
            for _ in range(2)) for blk in self.stack["blocks"]]

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

    def _admit(self, slot) -> None:
        stack = self.stack
        t_p, bucket = slot.t_p, slot.bucket
        self._refresh_table_row(slot)
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :t_p] = torch.as_tensor(slot.req["prompt"],
                                       dtype=torch.int64)
        ids = ids.to(self.device)
        ticket = slot.ticket
        with span("serving.prefill", bucket=bucket, slot=slot.idx,
                  t_p=t_p, mode=slot.req.get("mode", "greedy"),
                  request_id=ticket.request_id, trace_id=ticket.trace_id,
                  attempt=ticket.attempt):
            # pad rows land in the pages too: the causal mask hides them
            # from every real query, and each decode step writes position
            # p before any read can reach it
            x = _embed_prompt(stack["stem"], stack["pos_emb"], ids)
            x, caches = _prefill_blocks(stack["blocks"], x, bucket)
            pages = torch.as_tensor(
                slot.pages[:pages_for(bucket, self.page_size)],
                dtype=torch.int64, device=self.device)
            for (ck, cv), (kp, vp) in zip(caches, self._caches):
                self._scatter_prompt(kp, ck[0], pages)
                self._scatter_prompt(vp, cv[0], pages)
            logits = _head_logits(stack["head"], x[:, t_p - 1])  # (1, V)
            if slot.temperature > 0:
                gen = _row_generators(slot.req.get("seed", 0), 1,
                                      self.device)[0]
                self._gens[slot.idx] = gen
                first = int(_draw(logits[0], slot.temperature, gen)[0])
            else:
                first = int(torch.argmax(logits[0]))
        inc("veles_serving_prefill_dispatches_total")
        inc("veles_decode_dispatches_total")
        self.prefills_by_bucket[bucket] = \
            self.prefills_by_bucket.get(bucket, 0) + 1
        inc("veles_serving_admitted_total")
        inc("veles_serving_queue_wait_seconds_total",
            max(0.0, (slot.ticket.admitted or time.time())
                - slot.ticket.enqueued))
        self.admitted += 1
        # the int() above synced the prefill: this step boundary IS
        # prefill-done and first-token time
        slot.ticket.mark_prefill_done()
        slot.ticket.mark_first_token()
        self.ttft_ms.append(
            (slot.ticket.first_token - slot.ticket.enqueued) * 1e3)
        self._tok[slot.idx] = first
        self._pos[slot.idx] = t_p
        if slot.record(first):
            self._finish(slot)

    # -- the decode step --------------------------------------------------------
    def _grow_or_shed(self, slots: List, need_fn) -> List:
        """Extend each slot's pages to cover ``need_fn(slot)`` positions
        before the next dispatch. Admission reserved every row's own
        worst case, so this normally allocates nothing; a slot the
        allocator cannot cover is shed 503 + Retry-After (pages freed)
        while the survivors keep decoding."""
        alive: List = []
        for slot in slots:
            if self.scheduler.grow(slot, need_fn(slot)):
                self._refresh_table_row(slot)
                alive.append(slot)
                continue
            self._retire_slot(slot)
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

    def _decode(self) -> None:
        stack = self.stack
        active = self._grow_or_shed(
            self.scheduler.active(),
            lambda s: min(s.t_p + s.n_new,
                          int(self._pos[s.idx]) + self.decode_block))
        if not active:
            return
        t0 = time.perf_counter()
        mask = numpy.zeros(self.max_slots, bool)
        for slot in active:
            mask[slot.idx] = True
        sampled = [s for s in active if s.temperature > 0]
        live = torch.as_tensor(mask, device=self.device)
        tables = torch.as_tensor(self._page_table, device=self.device)
        tok = torch.as_tensor(self._tok, device=self.device)
        pos = self._pos.copy()
        out = []
        with span("serving.decode_step", active=len(active),
                  chunk=self.decode_block):
            for _ in range(self.decode_block):
                targets = self._row_targets(pos, mask)
                x = _embed_rows(stack["stem"], stack["pos_emb"], tok, pos)
                for blk, (kp, vp) in zip(stack["blocks"], self._caches):
                    x = _block_step_rows(blk, x, kp, vp, tables, pos,
                                         targets)
                logits = _head_logits(stack["head"], x[:, 0])   # (S, V)
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
        for slot in finished:
            self._finish(slot)

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
        # count only a first-terminal answer, like every shed path
        slot.ticket.succeed(result, counted=lambda: self._count_retired(
            len(slot.tokens)))

    def _count_retired(self, n_tokens: int) -> None:
        """A first-terminal answer's counting (``Ticket.succeed`` runs it
        before the answer is visible)."""
        inc("veles_serving_retired_total")
        inc("veles_serving_tokens_total", n_tokens)
        self.retired += 1

    def _abort_active(self, reason: str, code: int = 500,
                      retry_after: Optional[float] = None,
                      count_shed: bool = True) -> None:
        """Retire every live row and answer its ticket with ``code``."""
        for slot in self.scheduler.active():
            self._retire_slot(slot)
            if slot.ticket.fail(reason, code=code,
                                retry_after=retry_after) and count_shed:
                inc("veles_shed_requests_total")
