"""O(1)-state serving lane: a recurrent slot pool for LSTM, RNN and SSM
stacks (counterpart of ``veles_tpu/serving/recurrent.py``, its slot
pool, chunk scan, decode step and solo oracle).

A recurrent stack (``Embedding`` → ``nn/rnn.py``/``nn/ssm.py`` layers →
``LMHead``) carries its whole past in a FIXED per-slot state: an LSTM's
``(h, c)``, per SSM head an ``e x e`` matrix. So a slot costs constant
device memory whatever the context, and the lane needs no page table:

- **pageless slots**: the :class:`SlotScheduler` runs with
  ``page_pool=None`` and one bucket (``max_context``). Admission waits
  for a free slot only, and decode can never shed on page exhaustion;
- **the chunk scan** (prefill): one slot's prompt in ``page_size``-token
  chunks, each a length-masked scan of the layers' step bodies
  (``nn/ssm.recurrent_scan``); the last chunk's final real position
  gives the first token;
- **the decode step**: ``decode_block`` applications of the same step
  bodies over every slot row; rows not decoding keep their state bit
  for bit (``nn/ssm.mask_keep``) and their generator unadvanced.

Every product of the lane runs at one row count, :data:`LANE_ROWS`: the
state pool has a multiple of that many rows, the decode step runs it in
tiles of that many, and a chunk scan runs the tile that holds its slot,
the other rows of the tile length-masked to 0 (their state untouched).
A matrix product's row comes out of a BLAS library in another order of
sums at another row count (on the CPU a one-row product is a matrix-
vector kernel), so without this a pooled decode, a solo decode and a
scanned prompt would part in the last bits. With it, a row's tokens are
a function of its request alone: equal in a pool of any size and in the
solo oracle :func:`generate_recurrent`, greedy and sampled.

Each sampled slot draws from its own ``torch.Generator`` seeded from the
request, one draw a token, as the paged engine's rows do.

Token-level resume, QoS preemption and drain by handoff are the paged
engine's (``engine.ResumePlane``), with the same fault points. A resumed
row's state is rebuilt by scanning ``prompt + emitted tokens`` from
zeros in chunks, at :data:`LANE_ROWS` rows like every product of the
lane, so its state has the bits of the uninterrupted decode's; a
sampled row's generator is advanced by one draw per emitted token
(``nn/sampling.advanced_generator``).

The state-checkpoint prefix cache (``state_cache``, off by default;
``root.common.serving.state_cache`` and ``state_cache_blocks``): each
full chunk of a scanned prompt ends on a ``page_size`` block boundary,
and the row's state there is copied to the host and cached
(:class:`~veles_tpu_torch.serving.pages.StateCache`, under the
``serve.state_checkpoint`` fault point). A later admission matches
``prompt[:t_p - 1]`` against the cache (under ``serve.state_restore``:
raise and corrupt degrade to a shorter match or a re-scan), uploads the
deepest snapshot into its row and scans only the unmatched suffix, in
chunks aligned to the same boundaries and at the same
:data:`LANE_ROWS` rows, so a restored row holds the cold scan's bits.
A resumed row's rebuild adopts a matched snapshot the same way.

The serve artifact (``artifact``, ``export/serve_artifact.py``): the
chunk scan and the 8-row decode tile are tensor functions of (parameter
tree, ids or tokens, lengths or the live mask, the tile's state rows)
(:class:`ScanProgram`, :class:`TileStepProgram`), which return the new
state rows for the engine to write back. Live, the lane calls them as
they are; with an artifact it loads their ``torch.export`` programs
(``rscan``, ``rstep``) at :meth:`RecurrentEngine.start`, at the same
:data:`LANE_ROWS` rows, so a row's bits stay those of the live lane. A
bad artifact is a counted warning and live serving, as on the paged
engine.
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
from ..nn.sampling import (_draw, _head_logits, advanced_generator,
                           params_of)
from ..nn.ssm import RecurrentCell, mask_keep
from ..nn.transformer import Embedding, LMHead, embed
from ..resilience.faults import FaultInjected, fire as fire_fault
from ..telemetry.counters import inc
from ..telemetry.spans import span
from .engine import (_STEP_MODES, _TEMP_EPS, ArtifactPlane, ResumePlane,
                     _layers_of, dtype_name, tree_spec)
from .overload import clear_pressure_provider, set_pressure_provider
from .pages import StateCache
from .scheduler import SlotScheduler, Ticket, shed_expired

#: rows of every product the lane runs (see the module's docstring)
LANE_ROWS = 8


def scan_chunk(stack, params, ids, length, last, states):
    """One chunk of the prefill scan as a tensor function: ids
    (LANE_ROWS, C) through every layer's length-masked scan from the
    tile's ``states`` (a dict of (LANE_ROWS, ...) leaves a layer) →
    ``(logits (LANE_ROWS, V) at column ``last`` (a (1,) tensor), [new
    state leaves a layer])``. Rows past their ``length`` keep their
    state; nothing is written."""
    x = embed(params[stack["stem"].name]["table"], ids)
    new_states = []
    for blk, st in zip(stack["blocks"], states):
        x, new = blk.scan_state(params[blk.name], x, st, length=length)
        new_states.append(new)
    logits = _head_logits(stack["head"], x.index_select(1, last)[:, 0],
                          params)
    return logits, new_states


def step_tile(stack, params, tok, live, states):
    """One decode step of one tile as a tensor function: every layer's
    step body over its LANE_ROWS rows → ``(logits (LANE_ROWS, V), [new
    state leaves a layer])``, a row not in ``live`` keeping its state
    bit for bit; nothing is written."""
    x = embed(params[stack["stem"].name]["table"], tok)
    new_states = []
    for blk, old in zip(stack["blocks"], states):
        x, new = blk.step_state(params[blk.name], x, old)
        new_states.append({k: mask_keep(live, v, old[k])
                           for k, v in new.items()})
    return _head_logits(stack["head"], x, params), new_states


class ScanProgram(torch.nn.Module):
    """:func:`scan_chunk` as a program, ``(tree, ids, length, last,
    states)``; every parameter comes from ``tree``."""

    def __init__(self, stack) -> None:
        super().__init__()
        self._stack = stack

    def forward(self, tree, ids, length, last, states):
        return scan_chunk(self._stack, tree, ids, length, last, states)


class TileStepProgram(torch.nn.Module):
    """:func:`step_tile` as a program, ``(tree, tok, live, states)``."""

    def __init__(self, stack) -> None:
        super().__init__()
        self._stack = stack

    def forward(self, tree, tok, live, states):
        return step_tile(self._stack, tree, tok, live, states)


def split_recurrent_stack(forwards) -> Dict:
    """Partition a stack into ``Embedding`` → one or more recurrent
    layers (anything with the ``state_shapes``/``init_state``/
    ``step_state``/``scan_state`` protocol) → ``LMHead``. Raises
    :class:`VelesError` on any other shape: a transformer, or a
    ``PositionalEmbedding`` anywhere (a fixed-size state knows no
    absolute position)."""
    units = list(forwards or ())
    names = [type(u).__name__ for u in units]
    if (len(units) < 3 or not isinstance(units[0], Embedding)
            or not isinstance(units[-1], LMHead)
            or not all(isinstance(u, RecurrentCell) for u in units[1:-1])):
        raise VelesError("O(1)-state serving supports Embedding → "
                         "(SSMBlock|LSTM|RNN)* → LMHead chains; found %s"
                         % (names or "no layers"))
    return {"stem": units[0], "blocks": units[1:-1], "head": units[-1]}


class RecurrentEngine(ResumePlane, ArtifactPlane, Logger):
    """In-flight batching over a persistent fixed-size state pool.

    ``wf`` is a recurrent generation stack (``Embedding`` → LSTM / RNN /
    SSM layers → ``LMHead``, validated here: anything else raises
    :class:`VelesError`). ``device`` defaults to the stack's.
    ``page_size`` is the prefill's chunk length; ``decode_block`` runs
    that many decode steps per tick before the tokens come back to the
    host. ``root.common.serving.qos`` turns the QoS plane on;
    ``state_cache`` (default ``root.common.serving.state_cache``) the
    state-checkpoint prefix cache, holding at most
    ``root.common.serving.state_cache_blocks`` blocks (None: no bound)."""

    def __init__(self, wf, max_slots: int = 8, max_context: int = 640,
                 decode_block: int = 1, page_size: Optional[int] = None,
                 state_cache: Optional[bool] = None,
                 artifact: Optional[str] = None, device=None,
                 name: str = "serving") -> None:
        super().__init__()
        cfg = root.common.serving
        self.name = name
        self.stack = split_recurrent_stack(_layers_of(wf))
        stack_device = self.stack["stem"].table.device
        self.device = (stack_device if device is None
                       else device_for(device))
        if self.device != stack_device:
            raise ValueError("the stack lives on %s, not on %s"
                             % (stack_device, self.device))
        self.max_slots = int(max_slots)
        self.max_context = int(max_context)
        self.decode_block = max(1, int(decode_block))
        self.page_size = int(cfg.get("page_size", 16)
                             if page_size is None else page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        want_cache = bool(cfg.get("state_cache", False)
                          if state_cache is None else state_cache)
        self.state_cache: Optional[StateCache] = (
            StateCache(self.page_size, cfg.get("state_cache_blocks", None))
            if want_cache else None)
        # one bucket: chunked scanning serves any prompt length
        self.scheduler = SlotScheduler(self.max_slots, (self.max_context,),
                                       self.max_context, page_pool=None)
        self._init_resume_plane(cfg)
        #: rows of the state pool: the slots padded to whole tiles
        self.rows = -(-self.max_slots // LANE_ROWS) * LANE_ROWS
        #: per layer its state leaves, (rows, ...) each; built at the
        #: first tick
        self._states: Optional[List[Dict[str, torch.Tensor]]] = None
        self._tok = numpy.zeros(self.rows, numpy.int64)
        #: each sampled slot's private generator (None for greedy rows)
        self._gens: List[Optional[torch.Generator]] = [None] * self.rows
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        #: the AOT serve artifact, loaded at start(): its rscan and rstep
        #: programs replace the live ones by key
        self.artifact = str(cfg.get("artifact", "") or ""
                            if artifact is None else artifact)
        self._programs: Dict = {("scan", None): ScanProgram(self.stack),
                                ("step", None): TileStepProgram(self.stack)}
        #: calls of each program by its artifact label (rscan, rstep)
        self.program_calls: Dict[str, int] = {}
        self.admitted = 0
        self.retired = 0
        self.peak_slots = 0
        self.chunk_dispatches = 0
        #: requests that adopted a snapshot, and the cache's counters
        #: mirrored for stats()
        self.prefix_requests = 0
        self.state_restores = 0
        self.state_rescans = 0
        self.state_checkpoints = 0
        #: state tensors copied to the host (every layer's leaves, once
        #: a full chunk) in the most recent admission
        self.last_snapshot_copies = 0
        #: host ms of the most recent decode ticks (each ending in the
        #: tokens' copy to the host) and time to first token
        self.decode_ms: collections.deque = collections.deque(maxlen=4096)
        self.ttft_ms: collections.deque = collections.deque(maxlen=4096)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RecurrentEngine":
        if self._thread is not None:
            return self
        if self.artifact and not self.artifact_mode:
            self._load_artifact()
        self._closing = False
        if self.qos:
            set_pressure_provider(self._pressure_fn)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name + ".engine")
        self._thread.start()
        from . import register_engine
        register_engine(self)
        self.info("%s: O(1)-state serving up (slots=%d max_context=%d "
                  "decode_block=%d chunk=%d qos=%s%s%s, %s)", self.name,
                  self.max_slots, self.max_context, self.decode_block,
                  self.page_size, self.qos,
                  " +state_cache" if self.state_cache is not None else "",
                  " +artifact" if self.artifact_mode else "", self.device)
        return self

    # -- programs and the serve artifact -------------------------------------
    def _program(self, key):
        """The program of ``key`` (``("scan", None)`` or ``("step",
        None)``), the artifact's where one was loaded; each call tallied
        by its label (rscan, rstep)."""
        label = "r" + key[0]
        self.program_calls[label] = self.program_calls.get(label, 0) + 1
        return self._programs[key]

    def _tree(self) -> Dict:
        """The programs' parameter tree: the stem's, every layer's and
        the head's own tensors."""
        layers = [self.stack["stem"]] + self.stack["blocks"] + [
            self.stack["head"]]
        return {name: {k: t.detach() for k, t in tree.items()}
                for name, tree in params_of(layers).items()}

    def stack_signature(self) -> Dict:
        """What the lane's exported programs are committed to: the
        parameter tree's shapes and dtypes, every layer's state leaves
        at one tile, the knobs the programs bake in (the reference's
        keys, and the tile's :data:`LANE_ROWS`) and the device type they
        were traced on."""
        params = self._tree()
        return {
            "kind": "recurrent",
            "params": tree_spec(params),
            "states": [{k: list(shape) for k, shape
                        in sorted(blk.state_shapes(LANE_ROWS).items())}
                       for blk in self.stack["blocks"]],
            "pool_dtype": dtype_name(self.stack["stem"].table.dtype),
            "max_slots": self.max_slots,
            "max_context": self.max_context,
            "decode_block": self.decode_block,
            "page_size": self.page_size,
            "state_cache": self.state_cache is not None,
            "lane_rows": LANE_ROWS,
            "device": self.device.type,
        }

    def stop(self) -> None:
        with self.scheduler.cv:
            self._closing = True
            self.scheduler.cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        pending, self._handoff = self._handoff, None
        if pending is not None:
            pending[1].set()
        self.scheduler.drain("server shutting down")
        self._abort_active("server shutting down", code=503,
                           retry_after=5.0, count_shed=False)
        if self.state_cache is not None:
            self.state_cache.clear()
        clear_pressure_provider(self._pressure_fn)
        from . import unregister_engine
        unregister_engine(self)

    @property
    def closing(self) -> bool:
        """True once :meth:`stop` has begun."""
        return self._closing

    # -- intake --------------------------------------------------------------
    def accepts(self, req: Dict) -> Optional[str]:
        """None when the state pool can serve ``req``; otherwise the
        reason (the caller falls back to the window plane)."""
        t_p, n_new = len(req["prompt"]), int(req["n_new"])
        mode = str(req.get("mode", "greedy"))
        if mode not in _STEP_MODES:
            return ("O(1)-state pool serves greedy/sample only (mode=%s)"
                    % mode)
        if t_p < 1:
            return "empty prompt"
        reason = self.scheduler.reject_reason(t_p, n_new, mode=mode)
        if reason:
            return reason
        if 0 < float(req.get("temperature", 0.0)) < _TEMP_EPS:
            return ("temperature %g below the engine's %g resolution"
                    % (req["temperature"], _TEMP_EPS))
        return None

    def submit(self, req: Dict, ticket, max_queue: Optional[int] = None,
               checked: bool = False) -> bool:
        """Enqueue one request; False = queue bound hit or closing (the
        caller sheds 503). ``checked=True`` skips :meth:`accepts`;
        otherwise a request the pool cannot hold is answered 400."""
        if not checked:
            reason = self.accepts(req)
            if reason is not None:
                ticket.fail(reason, code=400)
                return True
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
    def state_bytes_per_slot(self) -> int:
        """Device bytes of one slot's recurrent state: constant in the
        sequence length."""
        itemsize = self.stack["stem"].table.element_size()
        return sum(int(numpy.prod(shape)) * itemsize
                   for blk in self.stack["blocks"]
                   for shape in blk.state_shapes(1).values())

    def stats(self) -> Dict[str, float]:
        pool_bytes = sum(t.numel() * t.element_size()
                         for st in self._states or () for t in st.values())
        cache = (self.state_cache.stats() if self.state_cache is not None
                 else {"blocks": 0, "bytes": 0})
        return {
            "slots": self.max_slots,
            "slots_busy": self.scheduler.busy_count(),
            "peak_slots": self.peak_slots,
            "queue_depth": self.scheduler.queue_depth(),
            "admitted": self.admitted,
            "retired": self.retired,
            # the slot-kind discriminator: /metrics renders page gauges
            # only for paged engines
            "slot_kind": "state",
            "pages_total": 0,
            "pages_in_use": 0,
            "page_size": self.page_size,
            "page_fragmentation": 0.0,
            "chunk_dispatches": self.chunk_dispatches,
            # the state pool (all its rows); constant in token count
            "kv_pool_bytes": pool_bytes,
            "state_bytes_per_slot": self.state_bytes_per_slot(),
            "state_pool_rows": self.rows,
            "prefix_requests": self.prefix_requests,
            "state_cache_blocks": cache["blocks"],
            "state_cache_bytes": cache["bytes"],
            "state_checkpoints": self.state_checkpoints,
            "state_restores": self.state_restores,
            "state_rescans": self.state_rescans,
            # the int8 planes are the paged engine's (the reference's
            # lane reports them 0 too)
            "quant_weights": 0,
            "quant_kv": 0,
            "artifact_mode": int(self.artifact_mode),
            "program_calls": dict(self.program_calls),
            "qos": int(self.qos),
            "preemptions": self.preemptions,
            "preempted_tokens": self.preempted_tokens,
        }

    # -- worker --------------------------------------------------------------
    def _loop(self) -> None:
        fail_streak = 0
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
                    self._states = None        # rebuilt at the next tick
                    shed_expired(self.scheduler.expire_queued())
                    if not self._closing:
                        time.sleep(min(1.0, 0.05 * (2 ** fail_streak)))

    def _tick(self) -> None:
        """One step boundary: a pending handoff, else preempt for waiting
        interactive requests (QoS), admit into free slots (each admission
        scans its whole prompt chunk by chunk), then advance every live
        row by one decode step."""
        if self._step_boundary():
            return
        self._ensure_pool()
        params = self._tree()
        if self.qos:
            self._preempt_for_interactive()
        admissions, expired = self.scheduler.take_admissions()
        shed_expired(expired)
        for slot in admissions:
            try:
                self._admit(params, slot)
            except Exception as e:    # noqa: BLE001 — answer, don't die
                # a failed chunk may have left the slot's tile half
                # written: answer everyone and rebuild the pool
                self.exception("%s: admission failed; resetting the state "
                               "pool", self.name)
                self._retire_slot(slot)
                slot.ticket.fail("%s: %s" % (type(e).__name__, e),
                                 code=500)
                self._abort_active("serving pool reset after a failed "
                                   "admission", code=503, retry_after=1.0)
                self._states = None
                return
        self.peak_slots = max(self.peak_slots, self.scheduler.busy_count())
        try:
            if self.scheduler.active():
                self._decode(params)
        except FaultInjected as e:
            self._abort_active(str(e), code=503, retry_after=1.0)

    def _ensure_pool(self) -> None:
        if self._states is not None:
            return
        dtype = self.stack["stem"].table.dtype
        self._states = [blk.init_state(self.rows, dtype, self.device)
                        for blk in self.stack["blocks"]]

    @staticmethod
    def _tile(row: int) -> slice:
        t0 = row - row % LANE_ROWS
        return slice(t0, t0 + LANE_ROWS)

    # -- admission: the chunk scan --------------------------------------------
    def _scan_chunk(self, params, tile: slice, ids, length, last):
        """One chunk of the prefill through the scan program: a
        length-masked scan of every layer's step body over the tile's
        rows, ids (LANE_ROWS, C); the new state rows are written back
        into the tile. Returns the tile's logits at column ``last``."""
        logits, new_states = self._program(("scan", None))(
            params, ids, length, last,
            [{k: v[tile] for k, v in st.items()} for st in self._states])
        for st, new in zip(self._states, new_states):
            for k, v in new.items():
                st[k][tile] = v
        return logits

    def _restore(self, prompt, t_p: int):
        """The cache's deepest snapshot over ``prompt[:t_p - 1]`` (at
        least one token must scan: the last chunk gives the first token,
        so a whole-prompt match adopts the boundary before it): (matched
        tokens, snapshot or None). An injected ``serve.state_restore``
        raise degrades to a full re-scan (counted); corrupt to a shorter
        match — the node's tokens are the authority."""
        start, snap = 0, None
        if self.state_cache is None:
            return start, snap
        try:
            corrupting = fire_fault("serve.state_restore")
            start, snap = self.state_cache.match(prompt[:t_p - 1],
                                                 corrupt=corrupting)
        except FaultInjected as e:
            self.warning("%s: injected state-restore fault (%s) — "
                         "degrading to a full re-scan", self.name, e)
            start, snap = 0, None
            self.state_rescans += 1
            inc("veles_o1_state_rescans_total")
        if start:
            self.state_restores += 1
            self.prefix_requests += 1
            inc("veles_o1_state_restores_total")
            inc("veles_o1_state_restored_tokens_total", start)
        return start, snap

    def _set_state_row(self, row: int, snap) -> None:
        """A slot's state row: zeros for a cold scan, or an adopted
        snapshot copied in (copy-on-write: the cache's host copy is never
        aliased, so it keeps its bits however the row decodes on)."""
        for st, saved in zip(self._states, snap or [None] * len(
                self._states)):
            for k, leaf in st.items():
                if saved is None:
                    leaf[row].zero_()
                else:
                    leaf[row].copy_(saved[k])

    def _admit(self, params, slot) -> None:
        prompt = slot.req["prompt"]
        t_p, chunk = slot.t_p, self.page_size
        tile = self._tile(slot.idx)
        r = slot.idx - tile.start
        ticket = slot.ticket
        resume_k = int(slot.req.get("resume_k", 0) or 0)
        if resume_k:
            inc("veles_resume_tokens_total", resume_k)
        start, snap = self._restore(prompt, t_p)
        #: block index (1-based) → the row's host state after that block
        snaps: Dict[int, tuple] = {}
        with span("serving.prefill", bucket=chunk, slot=slot.idx,
                  t_p=t_p, mode=slot.req.get("mode", "greedy"),
                  request_id=ticket.request_id, trace_id=ticket.trace_id,
                  attempt=ticket.attempt):
            self._set_state_row(slot.idx, snap)
            # the suffix scans in chunks on the cold scan's boundaries
            p0 = start
            while True:
                n_real = min(chunk, t_p - p0)
                ids = torch.zeros((LANE_ROWS, chunk), dtype=torch.int64)
                ids[r, :n_real] = torch.as_tensor(prompt[p0:p0 + n_real])
                length = torch.zeros(LANE_ROWS, dtype=torch.int64)
                length[r] = n_real
                last = torch.full((1,), n_real - 1, dtype=torch.int64)
                logits = self._scan_chunk(params, tile, ids.to(self.device),
                                          length.to(self.device),
                                          last.to(self.device))
                inc("veles_serving_prefill_dispatches_total")
                inc("veles_decode_dispatches_total")
                self.chunk_dispatches += 1
                p0 += n_real
                if n_real == chunk and self.state_cache is not None:
                    # a full chunk ends on a block boundary: the row's
                    # state there, copied to the host
                    snaps[p0 // chunk] = tuple(
                        {k: v[slot.idx].to("cpu", copy=True)
                         for k, v in st.items()} for st in self._states)
                if p0 >= t_p:
                    break
            # the tile's rows at their last real position, as a decode
            # step holds them: the head's product runs at LANE_ROWS rows
            logits = logits[r]
            if slot.temperature > 0:
                # a resumed row re-enters its stream after resume_k draws
                gen = advanced_generator(
                    slot.req.get("seed", 0), resume_k,
                    self.stack["head"].vocab_size, self.device)
                self._gens[slot.idx] = gen
                first = int(_draw(logits, slot.temperature, gen)[0])
            else:
                first = int(torch.argmax(logits))
        slot.ticket.mark_prefill_done()
        slot.ticket.mark_first_token()
        if not slot.req.get("_requeued"):
            # a preempted request was admitted and counted once already
            inc("veles_serving_admitted_total")
            inc("veles_serving_queue_wait_seconds_total",
                max(0.0, (slot.ticket.admitted or time.time())
                    - slot.ticket.enqueued))
            self.admitted += 1
            self.ttft_ms.append(
                (slot.ticket.first_token - slot.ticket.enqueued) * 1e3)
        self._tok[slot.idx] = first
        self.last_snapshot_copies = sum(len(st) for snap in snaps.values()
                                        for st in snap)
        self._checkpoint_insert(slot, snaps)
        if slot.record(first):
            self._finish(slot)

    def _checkpoint_insert(self, slot, snaps: Dict[int, tuple]) -> None:
        """Cache a scanned prompt's block-boundary snapshots for the next
        admission. An injected ``serve.state_checkpoint`` raise caches
        nothing: the request is answered from its live state already, so
        the fault costs later admissions a re-scan, never an answer."""
        if self.state_cache is None or not snaps:
            return
        n_blocks = slot.t_p // self.page_size
        if not n_blocks:
            return
        try:
            fire_fault("serve.state_checkpoint")
        except FaultInjected as e:
            self.warning("%s: injected state-checkpoint fault (%s) — "
                         "prompt not cached; same-prefix admissions "
                         "re-scan", self.name, e)
            return
        added = self.state_cache.insert(
            slot.req["prompt"][:n_blocks * self.page_size],
            [snaps.get(i + 1) for i in range(n_blocks)])
        if added:
            self.state_checkpoints += added
            inc("veles_o1_state_checkpoints_total", added)

    # -- the decode step ------------------------------------------------------
    def _step_tile(self, params, tile: slice, tok, live, sampled):
        """One decode step of one tile: every layer's step body over its
        LANE_ROWS rows, the state of rows not in ``live`` kept as it
        was; returns the tile's next tokens (a row not live keeps its
        token)."""
        logits, new_states = self._program(("step", None))(
            params, tok, live,
            [{k: v[tile] for k, v in st.items()} for st in self._states])
        for st, new in zip(self._states, new_states):
            for k, v in new.items():
                st[k][tile] = v
        nxt = torch.argmax(logits, dim=-1)
        for slot in sampled:
            r = slot.idx - tile.start
            nxt[r] = _draw(logits[r], slot.temperature,
                           self._gens[slot.idx])[0]
        return torch.where(live, nxt, tok)

    def _decode(self, params) -> None:
        active = self.scheduler.active()
        t0 = time.perf_counter()
        mask = numpy.zeros(self.rows, bool)
        for slot in active:
            mask[slot.idx] = True
        live = torch.as_tensor(mask, device=self.device)
        tok = torch.as_tensor(self._tok, device=self.device)
        tiles = [slice(s, s + LANE_ROWS)
                 for s in range(0, self.rows, LANE_ROWS)
                 if mask[s:s + LANE_ROWS].any()]
        sampled = {tile.start: [s for s in active if s.temperature > 0
                                and tile.start <= s.idx < tile.stop]
                   for tile in tiles}
        fire_fault("serve.decode_step")
        out = []
        with span("serving.decode_step", active=len(active),
                  chunk=self.decode_block):
            for _ in range(self.decode_block):
                tok = tok.clone()
                for tile in tiles:
                    tok[tile] = self._step_tile(params, tile, tok[tile],
                                                live[tile],
                                                sampled[tile.start])
                out.append(tok)
            toks = torch.stack(out).cpu().numpy()   # (decode_block, rows)
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
                if slot.record(token):
                    finished.append(slot)
        for slot in finished:
            self._finish(slot)

    # -- retirement ----------------------------------------------------------
    def _retire_slot(self, slot) -> None:
        """Clear a row's host state and free its slot. The device state
        row stays as it is: the next admission zeroes it before any
        step reads it, and a row not live never updates."""
        self._tok[slot.idx] = 0
        self._gens[slot.idx] = None
        self.scheduler.retire(slot)

    def _finish(self, slot) -> None:
        batched_with = max(0, self.scheduler.busy_count() - 1)
        self._retire_slot(slot)
        tokens = self._emitted(slot)
        result = {"tokens": tokens,
                  "batched_with": batched_with, "engine": "recurrent"}
        slot.ticket.succeed(result, counted=lambda: self._count_retired(
            len(tokens)))

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
        its emitted tokens attached as ``resume``."""
        for slot in self.scheduler.active():
            if slot.tokens or slot.req.get("_qos_prefix"):
                slot.ticket.set_progress(self._emitted(slot))
            self._retire_slot(slot)
            if slot.ticket.fail(reason, code=code,
                                retry_after=retry_after) and count_shed:
                inc("veles_shed_requests_total")


def generate_recurrent(wf, prompt, n_new, temperature: float = 0.0,
                       seed: int = 0, eos_id=None,
                       mode: str = "greedy") -> List[int]:
    """The lane's solo oracle: serve ONE request through a private
    single-slot :class:`RecurrentEngine` and return its tokens. A pooled
    request's tokens must equal these."""
    from .engine import make_request
    eng = RecurrentEngine(
        wf, max_slots=1,
        max_context=max(16, len(list(prompt)) + int(n_new)),
        name="o1_solo").start()
    try:
        return eng.serve([make_request(
            list(prompt), int(n_new), temperature=float(temperature),
            seed=int(seed), eos_id=eos_id, mode=mode)])[0]
    finally:
        eng.stop()
