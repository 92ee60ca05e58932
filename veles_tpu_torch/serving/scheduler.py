"""Request tickets, deadline enforcement and the continuous-batching
slot scheduler (counterpart of ``veles_tpu/serving/scheduler.py``).

Pure host-side bookkeeping: a bounded FIFO request queue, the
``max_slots`` slot table, the page-pool admission ledger, prefill-bucket
selection and deadlines. The engine calls
:meth:`SlotScheduler.take_admissions` at every step boundary: a queued
request moves into a free slot (``beam_width`` slots for ``mode=beam``)
the moment one opens AND the page pool can reserve its own worst case
per row (``ceil(max(bucket, prompt + n_new [+ gamma + 1]) /
page_size)`` pages, never ``max_context``); a ticket older than its
deadline is answered 503 + Retry-After. Each ticket is its request's SLO
record (:meth:`Ticket._account`): the four serving histograms, the
request's lifecycle spans and its flight-recorder events; a
``stream=True`` ticket also carries the queue its tokens are streamed
through.

Not ported yet: QoS promotion.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..telemetry.counters import inc, observe
from .pages import PagePool, pages_for

_request_ids = itertools.count(1)


def new_request_id() -> str:
    """Process-unique serving request id, assigned at API admission."""
    return "req-%d-%d" % (os.getpid(), next(_request_ids))


def request_tracing_enabled() -> bool:
    """THE per-request tracing switch (``root.common.trace.requests``,
    default on). Gates only the host-side span and flight emission at a
    ticket's terminal — never device work, so launches and tokens are
    the same on and off. The SLO histograms record regardless."""
    try:
        from ..config import root
        return bool(root.common.trace.get("requests", True))
    except Exception:        # noqa: BLE001 — config not importable
        return True


class Ticket:
    """One request's rendezvous between an HTTP handler thread and the
    serving worker. The worker fills ``result`` (or ``error`` + ``code``)
    and sets ``event``; ``retry_after`` asks the handler for a
    ``Retry-After`` header; ``deadline`` is the absolute wall time after
    which the request must no longer be served from the queue.
    Host-side lifecycle stamps (``enqueued`` → ``admitted`` →
    ``prefill_done`` → ``first_token``) are taken at step boundaries.

    The ticket is also the request's SLO record. :meth:`succeed`/
    :meth:`fail` are exactly-once: the first terminal call records the
    histograms (queue wait, TTFT, TPOT, end to end — telemetry/
    counters.py HISTOGRAMS), emits the request's lifecycle spans tagged
    with its ids and notes a terminal flight-recorder event; any later
    call returns False, so a ticket swept twice never double-counts.
    ``trace_id`` (default the request id) and ``attempt`` are the
    reference's fleet correlation pair.

    ``stream=True``: the serving plane pushes emitted tokens at step
    boundaries (:meth:`push_tokens`) and the HTTP handler drains them
    as SSE events (:meth:`next_stream_item`); every terminal call
    enqueues a ``None`` sentinel, so the drain ends the moment the
    answer exists."""

    __slots__ = ("event", "result", "error", "code", "retry_after",
                 "deadline", "request_id", "trace_id", "attempt", "mode",
                 "enqueued", "admitted", "prefill_done", "first_token",
                 "n_tokens", "outcome", "_terminal_lock", "stream",
                 "_stream_q")

    def __init__(self, deadline: Optional[float] = None,
                 request_id: Optional[str] = None, mode: str = "greedy",
                 trace_id: Optional[str] = None,
                 attempt: int = 1, stream: bool = False) -> None:
        self._terminal_lock = threading.Lock()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.code: int = 500
        self.retry_after: Optional[float] = None
        self.deadline = deadline
        self.request_id = request_id or new_request_id()
        self.trace_id = trace_id or self.request_id
        self.attempt = max(1, int(attempt or 1))
        self.mode = str(mode)
        self.enqueued = time.time()
        self.admitted: Optional[float] = None
        self.prefill_done: Optional[float] = None
        self.first_token: Optional[float] = None
        self.n_tokens = 0
        self.outcome: Optional[str] = None
        self.stream = bool(stream)
        self._stream_q: Optional[queue.SimpleQueue] = (
            queue.SimpleQueue() if self.stream else None)

    # -- lifecycle stamps (host-side, step boundaries only) ------------------
    def mark_admitted(self) -> None:
        """Stamp queue exit (slot admission, or the window plane's batch
        pop); the first stamp wins."""
        if self.admitted is not None:
            return
        self.admitted = time.time()
        if request_tracing_enabled():
            try:
                from ..telemetry.recorder import flight
                flight.note("request", request_id=self.request_id,
                            trace_id=self.trace_id, attempt=self.attempt,
                            phase="admitted", mode=self.mode)
            except Exception:       # noqa: BLE001 — observers only
                pass

    def mark_prefill_done(self) -> None:
        if self.prefill_done is None:
            self.prefill_done = time.time()

    def mark_first_token(self) -> None:
        if self.first_token is None:
            self.first_token = time.time()

    # -- token streaming -------------------------------------------------------
    def push_tokens(self, tokens) -> None:
        """Hand freshly emitted tokens to the streaming drain (a no-op
        for a buffered ticket). Stamps first-token time: a token in
        this queue is one hop from the client's socket, so a streamed
        request's TTFT is the one its client sees."""
        if self._stream_q is None:
            return
        toks = [int(t) for t in tokens]
        if not toks:
            return
        self.mark_first_token()
        self._stream_q.put(toks)

    def next_stream_item(self, timeout: float):
        """The streaming handler's blocking drain step: a token list,
        the ``None`` terminal sentinel, or ``queue.Empty`` raised on
        timeout."""
        assert self._stream_q is not None
        return self._stream_q.get(timeout=timeout)

    def fail(self, error: str, code: int = 500,
             retry_after: Optional[float] = None,
             outcome: Optional[str] = None) -> bool:
        """Answer with an error; True only on the first terminal call
        (callers count sheds on that True). ``outcome`` (default "shed"
        for a 503, else "error") tags the accounting."""
        with self._terminal_lock:
            if self.event.is_set():
                return False
            self.error = error
            self.code = code
            self.retry_after = retry_after
            self._account(outcome or ("shed" if code == 503 else "error"))
            self.event.set()
            if self._stream_q is not None:
                self._stream_q.put(None)
        return True

    def succeed(self, result, counted=None) -> bool:
        """Answer with a result; True only on the first terminal call.
        Dict results are stamped with the ``request_id``. ``counted``
        (the engine's own retirement counting) runs on the first
        terminal call before the answer is visible, so a caller woken by
        the answer reads counters that already hold it."""
        with self._terminal_lock:
            if self.event.is_set():
                return False
            if isinstance(result, dict):
                result.setdefault("request_id", self.request_id)
                self.n_tokens = len(result.get("tokens") or ())
            self.result = result
            self._account("retired")
            if counted is not None:
                counted()
            self.event.set()
            if self._stream_q is not None:
                self._stream_q.put(None)
        return True

    def _account(self, outcome: str) -> None:
        """Terminal SLO accounting, the reference's: the histograms
        always, the lifecycle spans (``request.queue``,
        ``request.prefill``, ``request.decode``, ``request``) and the
        terminal flight event under :func:`request_tracing_enabled`.
        Runs inside the terminal lock, before ``event.set()``: answered
        implies accounted. Never raises: a broken observer must not lose
        the request's answer."""
        now = time.time()
        self.outcome = outcome
        try:
            if self.admitted is not None:
                observe("veles_serving_queue_wait_seconds",
                        max(0.0, self.admitted - self.enqueued))
            elif outcome in ("expired", "shed"):
                # died in the queue: its whole life WAS queue wait
                observe("veles_serving_queue_wait_seconds",
                        max(0.0, now - self.enqueued))
            if self.first_token is not None:
                observe("veles_serving_ttft_seconds",
                        max(0.0, self.first_token - self.enqueued))
                if outcome == "retired" and self.n_tokens > 1:
                    observe("veles_serving_tpot_seconds",
                            max(0.0, now - self.first_token)
                            / (self.n_tokens - 1))
            if outcome == "retired":
                observe("veles_serving_e2e_seconds",
                        max(0.0, now - self.enqueued))
            if not request_tracing_enabled():
                return
            from ..telemetry.recorder import flight
            from ..telemetry.spans import emit
            tags = {"request_id": self.request_id,
                    "trace_id": self.trace_id, "attempt": self.attempt}
            if self.admitted is not None:
                emit("request.queue", self.enqueued,
                     self.admitted - self.enqueued, **tags)
                if self.prefill_done is not None:
                    emit("request.prefill", self.admitted,
                         self.prefill_done - self.admitted, **tags)
            if self.first_token is not None:
                emit("request.decode", self.first_token,
                     now - self.first_token, tokens=self.n_tokens,
                     **tags)
            emit("request", self.enqueued, now - self.enqueued,
                 outcome=outcome, mode=self.mode, tokens=self.n_tokens,
                 **tags)
            flight.note("request", request_id=self.request_id,
                        trace_id=self.trace_id, attempt=self.attempt,
                        phase="done", outcome=outcome, mode=self.mode,
                        tokens=self.n_tokens,
                        dur=round(now - self.enqueued, 6))
        except Exception:       # noqa: BLE001 — observability only
            pass

    def error_payload(self) -> Dict:
        """The failure response body: the error plus this request's id
        (and the ``retry_after`` hint when one was set)."""
        body: Dict = {"error": self.error, "request_id": self.request_id}
        if self.retry_after is not None:
            body["retry_after"] = self.retry_after
        return body


def split_expired(pairs: List[Tuple[Dict, Ticket]],
                  now: Optional[float] = None
                  ) -> Tuple[List[Tuple[Dict, Ticket]], List[Ticket]]:
    """Partition ``(req, ticket)`` pairs into (still live, expired
    tickets) by deadline — the check every dequeue point applies."""
    now = time.time() if now is None else now
    live, expired = [], []
    for req, ticket in pairs:
        if ticket.deadline is not None and now > ticket.deadline:
            expired.append(ticket)
        else:
            live.append((req, ticket))
    return live, expired


def shed_expired(tickets: List[Ticket]) -> None:
    """THE deadline answer of both decode planes: 503 + Retry-After,
    counted on the first terminal answer only — a ticket never rots in
    a queue past its useful life."""
    for ticket in tickets:
        if ticket.fail("request expired in serving queue", code=503,
                       retry_after=1.0, outcome="expired"):
            inc("veles_serving_expired_total")
            inc("veles_shed_requests_total")


class BeamGroup:
    """Host state shared by the ``beam_width`` hypothesis slots of one
    beam request. The engine fills the search state (current tokens,
    scores, finished flags, the token matrix) at the prefill expansion
    and advances it one top-k step a tick; the group retires as a
    unit."""

    __slots__ = ("req", "ticket", "slots", "live", "cur", "scores",
                 "finished", "toks", "step", "t_p")

    def __init__(self, req: Dict, ticket: Ticket) -> None:
        self.req = req
        self.ticket = ticket
        self.slots: List["Slot"] = []
        self.live = 0               # hypothesis slots not yet retired
        self.cur = None             # (W,) current tokens
        self.scores = None          # (W,) float32 total log-probs
        self.finished = None        # (W,) bool: eos frozen
        self.toks = None            # (W, n_new) emitted token matrix
        self.step = 0               # decoded positions past the first
        self.t_p = len(req["prompt"])


class Slot:
    """Host state of one occupied KV-cache row. ``pages`` are the page
    ids this row holds (freed at retirement); ``mode`` selects what
    advances it (``greedy``/``sample`` ride the decode step,
    ``speculative`` the draft/verify round, ``beam`` the group's top-k
    step); ``group`` links a beam request's hypothesis rows; ``rounds``
    and ``acc`` count a speculative row's rounds and accepted draft
    tokens."""

    __slots__ = ("idx", "req", "ticket", "t_p", "bucket", "tokens",
                 "n_new", "eos_id", "temperature", "mode", "pages",
                 "group", "rounds", "acc")

    def __init__(self, idx: int, req: Dict, ticket: Ticket,
                 bucket: int, pages: Optional[List[int]] = None,
                 group: Optional[BeamGroup] = None) -> None:
        self.idx = idx
        self.req = req
        self.ticket = ticket
        self.t_p = len(req["prompt"])
        self.bucket = bucket
        self.tokens: List[int] = []
        self.n_new = int(req["n_new"])
        self.eos_id = req.get("eos_id")
        self.temperature = float(req.get("temperature", 0.0))
        self.mode = str(req.get("mode", "greedy"))
        self.pages = list(pages or [])
        self.group = group
        self.rounds = 0
        self.acc = 0

    def record(self, token: int) -> bool:
        """Append one emitted token; True when the row is finished (its
        own ``n_new`` reached, or ``eos_id`` emitted, inclusive): the
        moment the slot frees for the next request."""
        self.tokens.append(int(token))
        if self.eos_id is not None and int(token) == self.eos_id:
            return True
        return len(self.tokens) >= self.n_new


class SlotScheduler:
    """Bounded queue + slot table + page ledger. All methods are
    thread-safe; the engine's worker waits on :attr:`cv` and the HTTP
    threads notify it on :meth:`push`. ``page_pool=None`` keeps
    slots-only admission (unit tests of the queue geometry)."""

    def __init__(self, max_slots: int, buckets: Tuple[int, ...],
                 max_context: int,
                 page_pool: Optional[PagePool] = None,
                 beam_width: int = 4, spec_gamma: int = 4) -> None:
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = int(max_slots)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_context = int(max_context)
        if self.buckets[-1] > self.max_context:
            raise ValueError(
                "largest prefill bucket %d exceeds max_context %d"
                % (self.buckets[-1], self.max_context))
        self.page_pool = page_pool
        self.beam_width = max(1, int(beam_width))
        #: the engine's speculation round width, the default of a
        #: request that names no ``gamma``
        self.spec_gamma = max(1, int(spec_gamma))
        #: concurrent beam groups the pool holds
        self.beam_groups = self.max_slots // self.beam_width
        self._beams_active = 0
        self.cv = threading.Condition()
        self._queue: deque = deque()
        self._free: List[int] = list(range(self.max_slots))
        self.slots: List[Optional[Slot]] = [None] * self.max_slots

    # -- admission geometry --------------------------------------------------
    def bucket_for(self, t_p: int) -> Optional[int]:
        """Smallest prefill bucket holding a ``t_p``-token prompt."""
        for b in self.buckets:
            if t_p <= b:
                return b
        return None

    def _worst_positions(self, t_p: int, n_new: int, mode: str = "greedy",
                         gamma: Optional[int] = None) -> int:
        """Cache positions a request can ever touch: what the page
        ledger must hold for it to complete (a speculation round writes
        up to ``gamma`` positions past its last emitted token; a beam
        row never writes its last token)."""
        if mode == "speculative":
            return t_p + n_new + int(self.spec_gamma if gamma is None
                                     else gamma) + 1
        if mode == "beam":
            return t_p + max(n_new - 1, 1)
        return t_p + n_new

    def reject_reason(self, t_p: int, n_new: int, mode: str = "greedy",
                      gamma: Optional[int] = None) -> Optional[str]:
        """None when the request fits the slot pool; otherwise why not
        (the caller falls back to the window plane, which has no
        context ceiling)."""
        bucket = self.bucket_for(t_p)
        if bucket is None:
            return ("prompt length %d exceeds the largest serving "
                    "bucket %d" % (t_p, self.buckets[-1]))
        worst = self._worst_positions(t_p, n_new, mode, gamma)
        if worst > self.max_context:
            return ("prompt %d + generation window %d exceeds "
                    "max_context %d (mode=%s)"
                    % (t_p, worst - t_p, self.max_context, mode))
        width = self.beam_width if mode == "beam" else 1
        if width > self.max_slots:
            return ("beam width %d exceeds the pool's %d slots"
                    % (width, self.max_slots))
        if self.page_pool is not None:
            need = width * pages_for(max(bucket, worst),
                                     self.page_pool.page_size)
            if need > self.page_pool.pages:
                return ("request needs %d pages at worst, the pool "
                        "holds %d" % (need, self.page_pool.pages))
        return None

    # -- queue ----------------------------------------------------------------
    def push(self, req: Dict, ticket: Ticket,
             max_queue: Optional[int] = None) -> bool:
        """Enqueue; False when the bound is hit (caller sheds 503)."""
        with self.cv:
            if max_queue is not None and len(self._queue) >= max_queue:
                return False
            self._queue.append((req, ticket))
            self.cv.notify_all()
        return True

    def queue_depth(self) -> int:
        with self.cv:
            return len(self._queue)

    def busy_count(self) -> int:
        with self.cv:
            return self.max_slots - len(self._free)

    def expire_queued(self, now: Optional[float] = None) -> List[Ticket]:
        """Remove every expired ticket from the queue (any position):
        the failure-path sweep, so deadlines hold while ticks cannot
        run."""
        with self.cv:
            live, expired = split_expired(list(self._queue), now)
            self._queue = deque(live)
        return expired

    # -- page ledger -----------------------------------------------------------
    def grow(self, slot: Slot, positions: int) -> bool:
        """Extend ``slot``'s page list to cover ``positions`` cache rows.
        True when covered (possibly without allocating); False on
        exhaustion — the engine sheds the row with 503 + Retry-After
        while the rest of the pool keeps decoding."""
        if self.page_pool is None:
            return True
        need = pages_for(positions, self.page_pool.page_size) \
            - len(slot.pages)
        if need <= 0:
            return True
        got = self.page_pool.alloc(need)
        if got is None:
            return False
        slot.pages.extend(got)
        return True

    # -- step-boundary transitions -------------------------------------------
    def take_admissions(self, now: Optional[float] = None
                        ) -> Tuple[List[Slot], List[Ticket]]:
        """Move queued requests into free slots (FIFO), dropping expired
        tickets. Admission is on page availability: the head request
        waits, FIFO kept, while the allocator cannot hold its worst
        case. A ``mode=beam`` request takes ``beam_width`` slots, one
        page set each, lead hypothesis first, while fewer than
        ``beam_groups`` groups are live. Returns (newly filled slots,
        which the engine prefills; expired tickets, which the engine
        answers 503)."""
        now = time.time() if now is None else now
        admissions: List[Slot] = []
        expired: List[Ticket] = []
        with self.cv:
            while self._queue:
                req, ticket = self._queue[0]
                if ticket.deadline is not None and now > ticket.deadline:
                    self._queue.popleft()
                    expired.append(ticket)
                    continue
                mode = str(req.get("mode", "greedy"))
                width = self.beam_width if mode == "beam" else 1
                if len(self._free) < width:
                    break
                if mode == "beam" and \
                        self._beams_active >= max(1, self.beam_groups):
                    break
                bucket = self.bucket_for(len(req["prompt"]))
                if bucket is None:
                    # a poisoned head (a raw push bypassing accepts())
                    # is answered and dropped, never crash-looped
                    self._queue.popleft()
                    ticket.fail("prompt length %d exceeds the largest "
                                "serving bucket %d"
                                % (len(req["prompt"]),
                                   self.buckets[-1]), code=400)
                    continue
                rows_pages: List[List[int]] = [[] for _ in range(width)]
                if self.page_pool is not None:
                    worst = max(bucket, self._worst_positions(
                        len(req["prompt"]), int(req["n_new"]), mode,
                        req.get("gamma")))
                    per_row = pages_for(worst, self.page_pool.page_size)
                    got = self.page_pool.alloc(per_row * width)
                    if got is None:
                        # real exhaustion: keep FIFO order and wait for
                        # retirements to free pages
                        break
                    rows_pages = [got[w * per_row:(w + 1) * per_row]
                                  for w in range(width)]
                self._queue.popleft()
                ticket.mark_admitted()
                group = BeamGroup(req, ticket) if mode == "beam" else None
                for pages in rows_pages:
                    idx = self._free.pop(0)
                    slot = Slot(idx, req, ticket, bucket, pages=pages,
                                group=group)
                    self.slots[idx] = slot
                    if group is not None:
                        group.slots.append(slot)
                        group.live += 1
                    admissions.append(slot)
                if group is not None:
                    self._beams_active += 1
            # purge expired tickets from ANY queue position: a dead
            # ticket behind a waiting head must not rot while the pool
            # is full
            live, exp = split_expired(list(self._queue), now)
            self._queue = deque(live)
            expired.extend(exp)
        return admissions, expired

    def retire(self, slot: Slot) -> None:
        """Free the row: the very next :meth:`take_admissions` can hand
        it (and its pages) to a queued request. Idempotent: a slot
        already retired is left alone, so an index never enters the
        free list twice."""
        with self.cv:
            if self.slots[slot.idx] is not slot:
                return
            self.slots[slot.idx] = None
            self._free.append(slot.idx)
            self._free.sort()
            if self.page_pool is not None and slot.pages:
                self.page_pool.free(slot.pages)
                slot.pages = []
            if slot.group is not None:
                slot.group.live -= 1
                if slot.group.live == 0:
                    self._beams_active -= 1
            self.cv.notify_all()

    def active(self, modes: Optional[Tuple[str, ...]] = None
               ) -> List[Slot]:
        """The occupied slots (of ``modes`` only, when given)."""
        with self.cv:
            return [s for s in self.slots if s is not None
                    and (modes is None or s.mode in modes)]

    def active_beams(self) -> List[BeamGroup]:
        """The live beam groups, in the order of their first slot."""
        with self.cv:
            seen: List[BeamGroup] = []
            for s in self.slots:
                if s is not None and s.group is not None \
                        and s.group not in seen:
                    seen.append(s.group)
            return seen

    def drain(self, reason: str, code: int = 503,
              retry_after: Optional[float] = 5.0) -> int:
        """Fail every queued ticket (shutdown); returns the number of
        first-terminal settles."""
        with self.cv:
            pending = list(self._queue)
            self._queue.clear()
        settled = 0
        for _req, ticket in pending:
            if ticket.fail(reason, code=code, retry_after=retry_after):
                settled += 1
        return settled
