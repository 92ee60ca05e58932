"""Request tickets and deadline enforcement (trimmed counterpart of
``veles_tpu/serving/scheduler.py``). Pure host-side bookkeeping."""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

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
    :meth:`succeed`/:meth:`fail` are exactly-once: the first terminal
    call wins and any later one returns False."""

    __slots__ = ("event", "result", "error", "code", "retry_after",
                 "deadline", "request_id", "_terminal_lock")

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
    """THE deadline answer: 503 + Retry-After — a ticket never rots in
    a queue past its useful life."""
    for ticket in tickets:
        ticket.fail("request expired in serving queue", code=503,
                    retry_after=1.0)
