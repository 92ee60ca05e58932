"""Fixed-size page allocator of the paged KV pool (counterpart of
``veles_tpu/serving/pages.py`` ``pages_for`` and ``PagePool``).

The engine keeps K/V in one pool of pages of ``page_size`` positions
per block; every slot owns a page-table row of page ids, and the
decode step reads a slot's cache through it. Admission reserves only
the pages a request's own prompt + ``n_new`` can touch, never
``max_context`` worth, so concurrency is bounded by pages actually
reserved.

Pages are refcounted: :meth:`PagePool.share` takes one more reference
and :meth:`PagePool.free` drops one, so a page returns to the free list
only when its last holder lets go; ``in_use`` counts a shared page
once. Page 0 is the SINK: it is never allocated, and masked or retired
rows of the fixed-shape decode step write there. Pure host state.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ..telemetry.counters import inc


def pages_for(positions: int, page_size: int) -> int:
    """Pages needed to hold ``positions`` cache rows (ceil div)."""
    return max(0, (int(positions) + page_size - 1) // page_size)


class PagePool:
    """Refcounted free-list allocator over ``pages`` usable pages
    (device rows ``1..pages``; row 0 is the sink). Thread-safe: the
    scheduler allocates at admission, the engine allocates growth at
    step boundaries and frees at retirement."""

    def __init__(self, pages: int, page_size: int) -> None:
        if pages < 1:
            raise ValueError("page pool needs >= 1 usable page")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.pages = int(pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(1, self.pages + 1))
        #: page id -> holders; a page is on the free list iff it has no
        #: entry here
        self._rc: Dict[int, int] = {}

    @property
    def device_rows(self) -> int:
        """Rows the device tensors carry: the usable pages + the sink."""
        return self.pages + 1

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def in_use(self) -> int:
        """Pages with at least one holder; a shared page counts once."""
        with self._lock:
            return self.pages - len(self._free)

    def ledger(self) -> Dict[int, int]:
        """Snapshot of the refcount ledger: empty, with ``in_use()`` 0,
        once every slot has retired."""
        with self._lock:
            return dict(self._rc)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` page ids (each with refcount 1), or None when the pool
        cannot hold them (exhaustion, counted; the caller waits for
        retirements or sheds)."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                out = None
            else:
                out, self._free = self._free[:n], self._free[n:]
                for page in out:
                    self._rc[page] = 1
        if out is None:
            inc("veles_serving_pages_exhausted_total")
            return None
        inc("veles_serving_pages_alloc_total", n)
        return out

    def share(self, page: int) -> int:
        """Take one more reference on an allocated page. Raises on a
        page nobody holds: sharing a freed page would alias the next
        admission's data."""
        page = int(page)
        with self._lock:
            rc = self._rc.get(page)
            if rc is None:
                raise ValueError(
                    "page %d is not allocated — cannot share" % page)
            self._rc[page] = rc + 1
            return rc + 1

    def free(self, ids: Sequence[int]) -> None:
        """Release one reference per page; a page whose last reference
        dropped returns to the free list (counted). A double free is
        tolerated, like the idempotent slot retire, and not counted."""
        if not ids:
            return
        released = 0
        with self._lock:
            for i in ids:
                page = int(i)
                rc = self._rc.get(page)
                if rc is None:
                    continue
                if rc > 1:
                    self._rc[page] = rc - 1
                    continue
                del self._rc[page]
                self._free.append(page)
                released += 1
            self._free.sort()
        if released:
            inc("veles_serving_pages_free_total", released)
