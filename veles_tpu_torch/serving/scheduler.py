"""Request tickets, deadline enforcement and the continuous-batching
slot scheduler (counterpart of ``veles_tpu/serving/scheduler.py``).

Pure host-side bookkeeping: a bounded FIFO request queue, the
``max_slots`` slot table, the page-pool admission ledger, prefill-bucket
selection and deadlines. The engine calls
:meth:`SlotScheduler.take_admissions` at every step boundary: a queued
request moves into a free slot the moment one opens AND the page pool
can reserve its own worst case (``ceil(max(bucket, prompt + n_new) /
page_size)`` pages, never ``max_context``); a ticket older than its
deadline is answered 503 + Retry-After.

Not ported yet: QoS promotion, beam groups and the speculative and beam
reservations (requests in those modes never reach the pool).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..telemetry.counters import inc
from .pages import PagePool, pages_for

_request_ids = itertools.count(1)


def new_request_id() -> str:
    """Process-unique serving request id, assigned at API admission."""
    return "req-%d-%d" % (os.getpid(), next(_request_ids))


class Ticket:
    """One request's rendezvous between an HTTP handler thread and the
    serving worker. The worker fills ``result`` (or ``error`` + ``code``)
    and sets ``event``; ``retry_after`` asks the handler for a
    ``Retry-After`` header; ``deadline`` is the absolute wall time after
    which the request must no longer be served from the queue.
    Host-side lifecycle stamps (``enqueued`` → ``admitted`` →
    ``prefill_done`` → ``first_token``) are taken at step boundaries.
    :meth:`succeed`/:meth:`fail` are exactly-once: the first terminal
    call wins and any later one returns False."""

    __slots__ = ("event", "result", "error", "code", "retry_after",
                 "deadline", "request_id", "enqueued", "admitted",
                 "prefill_done", "first_token", "_terminal_lock")

    def __init__(self, deadline: Optional[float] = None,
                 request_id: Optional[str] = None) -> None:
        self._terminal_lock = threading.Lock()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.code: int = 500
        self.retry_after: Optional[float] = None
        self.deadline = deadline
        self.request_id = request_id or new_request_id()
        self.enqueued = time.time()
        self.admitted: Optional[float] = None
        self.prefill_done: Optional[float] = None
        self.first_token: Optional[float] = None

    # -- lifecycle stamps (host-side, step boundaries only) ------------------
    def mark_admitted(self) -> None:
        """Stamp queue exit; the first stamp wins."""
        if self.admitted is None:
            self.admitted = time.time()

    def mark_prefill_done(self) -> None:
        if self.prefill_done is None:
            self.prefill_done = time.time()

    def mark_first_token(self) -> None:
        if self.first_token is None:
            self.first_token = time.time()

    def fail(self, error: str, code: int = 500,
             retry_after: Optional[float] = None) -> bool:
        """Answer with an error; True only on the first terminal call."""
        with self._terminal_lock:
            if self.event.is_set():
                return False
            self.error = error
            self.code = code
            self.retry_after = retry_after
            self.event.set()
        return True

    def succeed(self, result) -> bool:
        """Answer with a result; True only on the first terminal call.
        Dict results are stamped with the ``request_id``."""
        with self._terminal_lock:
            if self.event.is_set():
                return False
            if isinstance(result, dict):
                result.setdefault("request_id", self.request_id)
            self.result = result
            self.event.set()
        return True

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
                       retry_after=1.0):
            inc("veles_serving_expired_total")
            inc("veles_shed_requests_total")


class Slot:
    """Host state of one occupied KV-cache row. ``pages`` are the page
    ids this row holds (freed at retirement)."""

    __slots__ = ("idx", "req", "ticket", "t_p", "bucket", "tokens",
                 "n_new", "eos_id", "temperature", "pages")

    def __init__(self, idx: int, req: Dict, ticket: Ticket,
                 bucket: int, pages: Optional[List[int]] = None) -> None:
        self.idx = idx
        self.req = req
        self.ticket = ticket
        self.t_p = len(req["prompt"])
        self.bucket = bucket
        self.tokens: List[int] = []
        self.n_new = int(req["n_new"])
        self.eos_id = req.get("eos_id")
        self.temperature = float(req.get("temperature", 0.0))
        self.pages = list(pages or [])

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
                 page_pool: Optional[PagePool] = None) -> None:
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

    @staticmethod
    def _worst_positions(t_p: int, n_new: int) -> int:
        """Cache positions a request can ever touch: what the page
        ledger must hold for it to complete."""
        return t_p + n_new

    def reject_reason(self, t_p: int, n_new: int,
                      mode: str = "greedy") -> Optional[str]:
        """None when the request fits the slot pool; otherwise why not
        (the caller falls back to the window plane, which has no
        context ceiling)."""
        bucket = self.bucket_for(t_p)
        if bucket is None:
            return ("prompt length %d exceeds the largest serving "
                    "bucket %d" % (t_p, self.buckets[-1]))
        worst = self._worst_positions(t_p, n_new)
        if worst > self.max_context:
            return ("prompt %d + generation window %d exceeds "
                    "max_context %d (mode=%s)"
                    % (t_p, worst - t_p, self.max_context, mode))
        if self.page_pool is not None:
            need = pages_for(max(bucket, worst), self.page_pool.page_size)
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
        case. Returns (newly filled slots, which the engine prefills;
        expired tickets, which the engine answers 503)."""
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
                if not self._free:
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
                pages: List[int] = []
                if self.page_pool is not None:
                    worst = max(bucket, self._worst_positions(
                        len(req["prompt"]), int(req["n_new"])))
                    got = self.page_pool.alloc(
                        pages_for(worst, self.page_pool.page_size))
                    if got is None:
                        # real exhaustion: keep FIFO order and wait for
                        # retirements to free pages
                        break
                    pages = got
                self._queue.popleft()
                ticket.mark_admitted()
                idx = self._free.pop(0)
                slot = Slot(idx, req, ticket, bucket, pages=pages)
                self.slots[idx] = slot
                admissions.append(slot)
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
            self.cv.notify_all()

    def active(self) -> List[Slot]:
        with self.cv:
            return [s for s in self.slots if s is not None]

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
