"""Checkpoint / resume (counterpart of ``veles_tpu/snapshotter.py``).

Every stateful unit gives an explicit state tree (``state_dict()`` /
``load_state_dict()``), and the Snapshotter writes ``{"__units__":
{unit name → state}, "__prng__": {stream → state}, "__meta__": {time,
checksum}}``. The file format is the reference's, both ways:

- a snapshot holds numpy arrays, numpy scalars and builtins only, never
  a torch tensor or an object of the port: the units' state goes out as
  ``.detach().cpu().numpy()`` and comes back as tensors on the resuming
  workflow's device, so a snapshot taken on the card resumes on the CPU
  and the reverse ("resume may change topology/backend");
- units are keyed by the names the reference gives them
  (``"all2all_tanh0"``, ``"TrainStep"``, ``"DecisionGD"``), the
  optimiser state keeps the reference's tree (SGD ``{param: delta}``,
  adam ``{"m", "v", "t"}``), and the prng streams the reference's schema
  (``prng.RandomGenerator.__getstate__``), so either package resumes a
  file the other wrote;
- file names, the ``_current`` link, the sidecar manifest and the sqlite
  row are the reference's (``resilience/checkpoint_chain.py``);
- every file is read through an unpickler that admits numpy's array and
  scalar reconstruction and no other global: a reference snapshot reads
  without JAX, and a file cannot run code.

A CUDA generator's state comes back only on a card: a stream whose
snapshot holds only its card generator's state reseeds its CPU
generator from its seed, with a warning (``prng.py``).

int8 snapshots (``python -m veles_tpu_torch quantize``, or the
reference's ``veles-tpu quantize``) are expanded back to float on every
read (``quant.dequantize_state``), so every consumer sees an ordinary
state tree; a record this build cannot read raises a ``VelesError``.

Refused with a ``VelesError`` naming its ROADMAP item: the asynchronous
commit (``async_mode``, ``root.common.overlap.async_snapshots``; Queue 1
item 11).
Rank agreement on the time gate and the cross-process gathers stay
local to the process until distribution (item 10) is ported: with
``torch.distributed`` initialised only rank 0 writes.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import os
import pickle
import sqlite3
import time
from typing import Any, Dict, Optional

from . import prng
from .config import root
from .error import VelesError
from .mutable import Bool
from .quant.weights import dequantize_state
from .resilience import checkpoint_chain as chain_mod
from .resilience.checkpoint_chain import SnapshotCorruptError, verify
from .resilience.faults import fire as fire_fault
from .resilience.retry import RetryPolicy
from .units import Unit

CODECS = {
    "": (open, ""),
    "gz": (gzip.open, ".gz"),
    "bz2": (bz2.open, ".bz2"),
    "xz": (lzma.open, ".xz"),
}


def _snappy_module():
    try:
        import snappy
        return snappy
    except ImportError:
        return None


if _snappy_module() is not None:
    import snappy as _snappy

    class _SnappyFile:
        """Minimal file-like snappy stream, registered only where
        python-snappy is installed (as in the reference)."""

        def __init__(self, path, mode):
            self._f = open(path, mode)
            if "r" in mode:
                self._buf = _snappy.StreamDecompressor().decompress(
                    self._f.read())
                self._pos = 0
            else:
                self._comp = _snappy.StreamCompressor()

        def write(self, data):
            self._f.write(self._comp.add_chunk(bytes(data)))

        def read(self, n=-1):
            if n < 0:
                n = len(self._buf) - self._pos
            out = self._buf[self._pos:self._pos + n]
            self._pos += len(out)
            return out

        def readline(self):  # pickle never needs it; keep file-like
            raise io.UnsupportedOperation("readline")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self._f.close()

    CODECS["snappy"] = (_SnappyFile, ".snappy")


class StateUnpickler(pickle.Unpickler):
    """Admits what a snapshot may hold: numpy arrays, dtypes and scalars
    (their reconstruction functions under numpy 1's and numpy 2's module
    names, and ``_codecs.encode``, which pickle protocols 0-2 rebuild
    bytes with); the builtin containers and scalars need no global.
    Refuses every other global."""

    ALLOWED = frozenset(
        [("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")]
        + [(mod + suffix, name)
           for mod in ("numpy.core", "numpy._core")
           for suffix, name in ((".multiarray", "_reconstruct"),
                                (".multiarray", "scalar"),
                                (".numeric", "_frombuffer"))])

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                "refusing %s.%s in a snapshot: a snapshot holds numpy "
                "arrays, numpy scalars and builtins only" % (module, name))
        return super().find_class(module, name)


def _loads(fin) -> Dict[str, Any]:
    return StateUnpickler(fin).load()


def collect_state(workflow) -> Dict[str, Any]:
    """{unit name → state_dict} for every stateful unit, the prng
    streams' states and the meta record."""
    state: Dict[str, Any] = {"__units__": {}, "__prng__": {}, "__meta__": {
        "time": time.time(), "checksum": workflow.checksum()}}
    for unit in workflow:
        # owners of device state copy it to their host mirrors first
        hook = getattr(unit, "on_snapshot", None)
        if callable(hook):
            hook()
    for unit in workflow:
        sd = unit.state_dict() if hasattr(unit, "state_dict") else None
        if sd:
            state["__units__"][unit.name] = sd
    with prng._lock:
        for key, gen in prng._generators.items():
            if key in prng._ephemeral:
                continue
            state["__prng__"][key] = gen.__getstate__()
    return state


def apply_state(workflow, state: Dict[str, Any],
                strict: bool = False) -> None:
    """Load ``state`` into an initialised workflow: each unit's state in
    the workflow's own unit order (the forwards before the TrainStep,
    which rebuilds its device tree from them), then the prng streams."""
    saved = state.get("__units__", {})
    names = {u.name for u in workflow}
    unknown = sorted(set(saved) - names)
    if unknown and strict:
        raise KeyError("snapshot unit %r not in workflow" % unknown[0])
    for unit in workflow:
        sd = saved.get(unit.name)
        if sd is None or not hasattr(unit, "load_state_dict"):
            continue
        try:
            unit.load_state_dict(sd)
        except Exception as exc:
            # schema or shape drift must name the unit, not fail deep
            # inside a tensor copy
            raise VelesError(
                "snapshot state for unit %r does not fit the current "
                "workflow (%s: %s) — the snapshot was taken under a "
                "different model/config contract; rebuild it or pin the "
                "old code" % (unit.name, type(exc).__name__, exc)) from exc
    with prng._lock:
        for key, st in state.get("__prng__", {}).items():
            if key in prng._ephemeral:
                continue
            gen = prng._generators.get(key)
            if gen is None:
                gen = prng._generators[key] = object.__new__(
                    prng.RandomGenerator)
            gen.__setstate__(dict(st))


def _refuse(what: str, item: str) -> VelesError:
    return VelesError("%s are not ported yet (ROADMAP Queue 1 item %s)"
                      % (what, item))


class Snapshotter(Unit):
    """Periodic checkpoint writer unit: gates ``interval``,
    ``time_interval`` and ``skip``; ``keep_last`` retention; a forced
    snapshot on stop."""

    MAPPING = "snapshotter"
    hide_from_registry = False

    def __init__(self, workflow, prefix: str = "wf", directory: str = None,
                 compression: str = "gz", interval: int = 1,
                 time_interval: float = 0.0, keep_last: int = None,
                 async_mode: bool = None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        if (root.common.overlap.get("async_snapshots", False)
                if async_mode is None else async_mode):
            raise _refuse("asynchronous snapshots (the overlap plane)",
                          "11")
        self.prefix = prefix
        self.directory = directory or root.common.dirs.snapshots
        if compression not in CODECS:
            raise ValueError("compression %r not in %s" %
                             (compression, sorted(CODECS)))
        self.compression = compression
        self.interval = interval
        self.time_interval = time_interval
        #: bounded retention: prune the chain to this many snapshots
        #: after each export (0 = keep everything)
        self.keep_last = int(keep_last if keep_last is not None
                             else root.common.resilience.get(
                                 "keep_last", 0) or 0)
        self.skip = Bool(False)
        self.suffix = ""            # e.g. current best metric, set by owner
        self.destination: Optional[str] = None
        self._runs = 0
        self._last_time = 0.0

    def run(self) -> None:
        self._runs += 1
        if bool(self.skip):
            return
        if self.interval > 1 and self._runs % self.interval:
            return
        if self.time_interval:
            if time.time() - self._last_time < self.time_interval:
                return
            self._last_time = time.time()
        self.export()

    def _is_writer(self) -> bool:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def export(self) -> str:
        state = collect_state(self.workflow)
        if not self._is_writer():
            return ""
        opener, ext = CODECS[self.compression]
        suffix = ("_" + self.suffix) if self.suffix else ""
        fname = "%s%s_%s_%04d.pickle%s" % (
            self.prefix, suffix, time.strftime("%Y%m%d_%H%M%S"),
            self._runs, ext)
        path = os.path.join(self.directory, fname)
        self._commit(state, path, fname, ext, opener)
        return path

    def _cursor(self) -> Dict[str, int]:
        """{epoch, step, world_size, generation} at export time: the
        manifest cursor (``checkpoint_chain.cursor_of`` reads it)."""
        import torch.distributed as dist
        wf = self.workflow
        decision = getattr(wf, "decision", None)
        step = getattr(wf, "train_step", None)
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        return {
            "epoch": int(getattr(decision, "epoch_number", 0) or 0),
            "step": int(getattr(step, "run_count", 0) or 0),
            "world_size": int(world),
            # the elastic generation (item 10): 0 = a non-elastic run
            "generation": 0,
        }

    def _commit(self, state, path: str, fname: str, ext: str,
                opener) -> None:
        """Serialise + fsync + hash + manifest + link + prune."""
        # a crash injected here leaves the previous snapshot intact; a
        # corrupt one damages the bytes on disk while the manifest keeps
        # the pristine digest (bitrot that verify() catches at restore)
        fault = fire_fault("snapshot.write")
        os.makedirs(self.directory, exist_ok=True)
        tmp = path + ".tmp"
        with opener(tmp, "wb") as fout:
            pickle.dump(state, fout, protocol=pickle.HIGHEST_PROTOCOL)
        digest = chain_mod.file_sha256(tmp)
        if fault is not None:
            with open(tmp, "rb") as fin:
                raw = fin.read()
            with open(tmp, "wb") as fout:
                fout.write(fault.corrupt(raw))
        chain_mod.commit_file(tmp, path)
        chain_mod.write_manifest(
            path, sha256=digest, prefix=self.prefix, runs=self._runs,
            created=time.time(), checksum=state["__meta__"]["checksum"],
            cursor=self._cursor())
        self._update_current_link(fname, ext)
        if self.keep_last:
            chain_mod.prune(self.directory, self.prefix, self.keep_last)
        self.destination = path
        self.info("snapshot → %s (%.1f KiB)", path,
                  os.path.getsize(path) / 1024)

    def _update_current_link(self, fname: str, ext: str) -> None:
        """Atomically repoint the ``_current`` symlink: a symlink under a
        temporary name, then ``os.replace``."""
        link = os.path.join(self.directory, "%s_current.pickle%s" %
                            (self.prefix, ext))
        tmp_link = link + ".tmp"
        try:
            try:
                os.unlink(tmp_link)
            except OSError:
                pass
            os.symlink(fname, tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            pass

    def stop(self) -> None:
        """Forced snapshot on workflow stop."""
        if self._runs and not bool(self.skip):
            self.export()

    def get_metric_values(self) -> Dict[str, Any]:
        return {"snapshot": self.destination}


class SnapshotterToDB(Snapshotter):
    """Checkpoints into a sqlite database, the reference's row schema.
    Resume with ``sqlite://FILE`` (newest row) or ``sqlite://FILE#ID``."""

    MAPPING = "snapshotter_db"
    hide_from_registry = False

    SCHEMA = ("CREATE TABLE IF NOT EXISTS snapshots ("
              "id INTEGER PRIMARY KEY AUTOINCREMENT, prefix TEXT, "
              "suffix TEXT, created REAL, runs INTEGER, checksum TEXT, "
              "state BLOB)")

    def __init__(self, workflow, dsn: str = None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.dsn = dsn

    def _resolve_dsn(self) -> str:
        if self.dsn:
            return self.dsn
        os.makedirs(self.directory, exist_ok=True)
        return os.path.join(self.directory, "snapshots.sqlite3")

    def export(self) -> str:
        state = collect_state(self.workflow)
        if not self._is_writer():
            return ""
        blob = gzip.compress(pickle.dumps(
            state, protocol=pickle.HIGHEST_PROTOCOL))
        dsn = self._resolve_dsn()

        def insert() -> int:
            con = sqlite3.connect(dsn)
            try:
                con.execute(self.SCHEMA)
                cur = con.execute(
                    "INSERT INTO snapshots (prefix, suffix, created, "
                    "runs, checksum, state) VALUES (?, ?, ?, ?, ?, ?)",
                    (self.prefix, self.suffix, time.time(), self._runs,
                     state["__meta__"]["checksum"], blob))
                con.commit()
                return cur.lastrowid
            finally:
                con.close()

        # a store read concurrently answers SQLITE_BUSY: retry it rather
        # than lose the checkpoint
        rowid = RetryPolicy(
            name=self.name + ".db_export", base_delay=0.1, max_delay=2.0,
            retryable=(sqlite3.OperationalError,)).call(insert)
        self.destination = "sqlite://%s#%d" % (dsn, rowid)
        self.info("snapshot → %s (%.1f KiB)", self.destination,
                  len(blob) / 1024)
        return self.destination


def _load_sqlite(path: str) -> Dict[str, Any]:
    """sqlite://FILE[#ID] → state tree (newest row when no #ID)."""
    path = path[len("sqlite://"):] if path.startswith("sqlite://") else path
    path, _, rowid = path.partition("#")
    con = sqlite3.connect(path)
    try:
        if rowid:
            row = con.execute(
                "SELECT state FROM snapshots WHERE id = ?",
                (int(rowid),)).fetchone()
        else:
            row = con.execute(
                "SELECT state FROM snapshots ORDER BY id DESC LIMIT 1"
            ).fetchone()
    finally:
        con.close()
    if row is None:
        raise FileNotFoundError("no snapshot row in %s" % path)
    return _loads(io.BytesIO(gzip.decompress(row[0])))


def load_snapshot(path: str) -> Dict[str, Any]:
    """Read a snapshot state tree; ``path`` may be a ``_current`` link or
    a ``sqlite://FILE[#ID]`` DSN. With a sidecar manifest the file's
    SHA-256 is verified first; a mismatching, truncated or corrupt file
    raises :class:`~veles_tpu_torch.resilience.checkpoint_chain.
    SnapshotCorruptError` (a VelesError). int8 records come back as
    ``q · s`` in their recorded dtype (one read path for every
    consumer)."""
    fire_fault("snapshot.load")
    if path.startswith("sqlite://") or path.endswith(".sqlite3"):
        return dequantize_state(_load_sqlite(path))
    if verify(path) is False:
        raise SnapshotCorruptError(
            "snapshot %s fails its manifest SHA-256 — the file is "
            "corrupt (bitrot or a torn write); quarantine it or resume "
            "from an older snapshot (restore_latest does both)" % path)
    try:
        state = _read_state(path)
    except FileNotFoundError:
        raise
    except (pickle.UnpicklingError, EOFError, OSError, ValueError,
            lzma.LZMAError) as exc:
        raise SnapshotCorruptError(
            "snapshot %s is truncated or corrupt (%s: %s)"
            % (path, type(exc).__name__, exc)) from exc
    return dequantize_state(state)


def _read_state(path: str) -> Dict[str, Any]:
    """Codec by extension, else by the magic bytes; then the load."""
    for opener, ext in CODECS.values():
        if ext and path.endswith(".pickle" + ext):
            with opener(path, "rb") as fin:
                return _loads(fin)
    with open(path, "rb") as fin:
        head = fin.read(6)
    if head[:2] == b"\x1f\x8b":
        opener = gzip.open
    elif head[:3] == b"BZh":
        opener = bz2.open
    elif head[:6] == b"\xfd7zXZ\x00":
        opener = lzma.open
    else:
        opener = open
    with opener(path, "rb") as fin:
        return _loads(fin)


def resume(workflow, path: str, strict: bool = False) -> None:
    """Apply a snapshot to an initialised workflow and mark it restored."""
    apply_state(workflow, load_snapshot(path), strict=strict)
    workflow.restored_from_snapshot = True
