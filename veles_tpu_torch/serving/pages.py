"""Fixed-size page allocator of the paged KV pool and the O(1)-state
lane's prefix cache (counterpart of ``veles_tpu/serving/pages.py``
``pages_for``, ``PagePool`` and ``StateCache``).

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

:class:`StateCache` is the recurrent lane's prefix cache: a radix tree
over ``page_size``-token blocks whose payload is a host snapshot of the
state after the block, not a page (a recurrent prefix is summed up by
its state).
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Sequence, Tuple

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


class _StateNode:
    """One checkpointed ``page_size``-token block of a recurrent prompt:
    its exact tokens (the match key — token equality is the authority)
    and the host snapshot of the state as it stood after the block."""

    __slots__ = ("tokens", "state", "nbytes", "children", "parent",
                 "last_use")

    def __init__(self, tokens: Tuple[int, ...], state, nbytes: int,
                 parent: Optional["_StateNode"]) -> None:
        self.tokens = tokens
        self.state = state
        self.nbytes = int(nbytes)
        self.children: Dict[Tuple[int, ...], "_StateNode"] = {}
        self.parent = parent
        self.last_use = 0


class StateCache:
    """Prefix cache of the O(1)-state lane: a radix tree over
    ``page_size``-token blocks, each node holding the host snapshot of
    the state pytree after its block (per layer a dict of CPU tensors).

    Admission calls :meth:`match` with the prompt and adopts the deepest
    node's snapshot COPY-ON-WRITE — the caller uploads it into its
    slot's state row and never changes the host copy — then scans only
    the unmatched suffix. After the prefill the slot's own block-boundary
    snapshots are :meth:`insert`-ed. Snapshots own no pool pages:
    eviction is the soft ``max_blocks`` budget, least recently used
    leaves first (``veles_o1_state_evictions_total``). The engine's tick
    thread does every mutation; the lock serves the stats reads."""

    def __init__(self, page_size: int,
                 max_blocks: Optional[int] = None) -> None:
        self.page_size = int(page_size)
        self.max_blocks = int(max_blocks or 0)
        self._lock = threading.Lock()
        self._root = _StateNode((), None, 0, None)
        self._clock = 0
        self._blocks = 0
        self._bytes = 0

    def _blocks_of(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        p = self.page_size
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(len(tokens) // p)]

    @staticmethod
    def _snapshot_bytes(state) -> int:
        total = 0
        stack = [state]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            else:
                total += int(getattr(node, "nbytes", 0))
        return total

    def match(self, tokens: Sequence[int], corrupt=None):
        """Walk the tree over ``tokens``' full blocks: ``(n_tokens_matched,
        snapshot)`` of the DEEPEST matched node, ``(0, None)`` on a miss.
        ``corrupt`` is the armed ``serve.state_restore`` fault acting on
        the index: every candidate block key is damaged (as its 8-byte
        little-endian token words) before the lookup, so a rotten index
        degrades to a shorter or empty match, never to a wrong state:
        the node's tokens must equal the block's."""
        best = None
        depth = 0
        with self._lock:
            node = self._root
            self._clock += 1
            for block in self._blocks_of(tokens):
                key = block
                if corrupt is not None:
                    raw = bytearray()
                    for t in block:
                        raw += int(t).to_bytes(8, "little", signed=True)
                    raw = corrupt.corrupt(bytes(raw))
                    key = tuple(
                        int.from_bytes(raw[i:i + 8], "little", signed=True)
                        for i in range(0, len(raw) - len(raw) % 8, 8))
                child = node.children.get(key)
                if child is None or child.tokens != block:
                    break
                child.last_use = self._clock
                best = child.state
                depth += self.page_size
                node = child
        return depth, best

    def insert(self, tokens: Sequence[int], snapshots) -> int:
        """Record ``tokens``' full blocks with their block-boundary
        ``snapshots`` (``snapshots[i]``: the state after block i). A block
        already present is only touched (the first writer wins; the scan
        is deterministic, so a second writer holds the same bits). A
        ``None`` snapshot marks a block the caller adopted rather than
        scanned: an existing node is touched, a missing one stops the
        walk — a node without a real snapshot never exists. Returns the
        blocks added."""
        blocks = self._blocks_of(tokens)
        added = 0
        with self._lock:
            self._clock += 1
            node = self._root
            for i, block in enumerate(blocks):
                if i >= len(snapshots):
                    break
                child = node.children.get(block)
                if child is None:
                    if snapshots[i] is None:
                        break
                    nbytes = self._snapshot_bytes(snapshots[i])
                    child = _StateNode(block, snapshots[i], nbytes, node)
                    node.children[block] = child
                    self._blocks += 1
                    self._bytes += nbytes
                    added += 1
                child.last_use = self._clock
                node = child
        if self.max_blocks and self._blocks > self.max_blocks:
            self.evict()
        return added

    def _leaves(self) -> List[_StateNode]:
        out: List[_StateNode] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            kids = list(node.children.values())
            if not kids and node is not self._root:
                out.append(node)
            stack.extend(kids)
        return out

    def evict(self) -> int:
        """Drop least recently used LEAF blocks until the block budget
        holds (a block with cached children anchors their prefix and goes
        after them); each dropped block is counted."""
        dropped = 0
        with self._lock:
            if not self.max_blocks:
                return 0
            heap = [(n.last_use, i, n) for i, n in enumerate(self._leaves())]
            heapq.heapify(heap)
            tie = len(heap)
            while heap and self._blocks > self.max_blocks:
                _, _, victim = heapq.heappop(heap)
                parent = victim.parent
                if victim.children or parent is None \
                        or parent.children.get(victim.tokens) is not victim:
                    continue           # a stale heap entry
                parent.children.pop(victim.tokens, None)
                self._blocks -= 1
                self._bytes -= victim.nbytes
                dropped += 1
                if parent is not self._root and not parent.children:
                    heapq.heappush(heap, (parent.last_use, tie, parent))
                    tie += 1
        if dropped:
            inc("veles_o1_state_evictions_total", dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._root = _StateNode((), None, 0, None)
            self._blocks = 0
            self._bytes = 0

    def state_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"blocks": self._blocks, "bytes": self._bytes}
