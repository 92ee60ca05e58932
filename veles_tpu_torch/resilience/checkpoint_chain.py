"""Crash-safe checkpoint chain: fsync'd commits, SHA-256 manifests,
quarantine-and-fall-back restore, bounded retention (counterpart of
``veles_tpu/resilience/checkpoint_chain.py``: the same file names,
manifest fields and walk, so either package restores a chain the other
wrote).

The reference called snapshots its disaster-recovery story, but wrote
them as unchecksummed pickles: a crash mid-write or silent bitrot left
a file that LOOKED like a snapshot and exploded (or worse, half-
applied) at resume. This module makes the chain trustworthy:

- **commit**: tmp write → ``fsync(tmp)`` → ``os.replace`` →
  ``fsync(dir)`` — after :func:`commit_file` returns, the snapshot is
  durably on disk under its final name or not at all;
- **manifest**: every snapshot gets a ``<file>.manifest.json`` sidecar
  carrying its SHA-256 (plus size/metadata), written with the same
  atomic commit;
- **verify**: :func:`verify` recomputes the digest;
  ``snapshotter.load_snapshot`` refuses a mismatching file with
  :class:`SnapshotCorruptError` instead of feeding pickle garbage;
- **restore**: :func:`restore_latest` walks the chain newest→oldest,
  quarantining corrupt files (renamed ``*.corrupt``, counted in
  ``veles_snapshots_quarantined_total``) until it finds the newest
  snapshot that both verifies and deserializes;
- **retention**: :func:`prune` keeps the newest ``keep_last`` and
  deletes the rest (with their sidecars) — quarantined files are
  evidence and are never pruned.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..error import VelesError
from ..logger import Logger
from ..telemetry.counters import inc


class SnapshotCorruptError(VelesError):
    """A snapshot file failed its manifest SHA-256 or could not be
    deserialized (truncated / torn write / bitrot)."""


MANIFEST_SUFFIX = ".manifest.json"
CORRUPT_SUFFIX = ".corrupt"


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fin:
        while True:
            block = fin.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def commit_file(tmp: str, path: str) -> None:
    """Durably move ``tmp`` to ``path``: fsync the data, rename, fsync
    the directory entry. A crash at any instant leaves either the old
    state or the complete new file — never a torn ``path``."""
    with open(tmp, "rb") as fin:
        os.fsync(fin.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def manifest_path(path: str) -> str:
    return path + MANIFEST_SUFFIX


def write_manifest(path: str, **meta: Any) -> str:
    """Write the sidecar manifest for ``path`` (atomic commit). The
    SHA-256 defaults to the file's current digest; callers that
    corrupt-inject pass the pristine digest explicitly."""
    meta.setdefault("sha256", file_sha256(path))
    meta.setdefault("bytes", os.path.getsize(path))
    mpath = manifest_path(path)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as fout:
        json.dump(meta, fout, indent=1, sort_keys=True)
        fout.write("\n")
        fout.flush()
        os.fsync(fout.fileno())
    os.replace(tmp, mpath)
    return mpath


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(manifest_path(path)) as fin:
            man = json.load(fin)
        return man if isinstance(man, dict) else None
    except (OSError, ValueError):
        return None


def verify(path: str) -> Optional[bool]:
    """True = digest matches the manifest, False = mismatch (corrupt),
    None = no manifest (pre-manifest snapshot: unverifiable but
    loadable)."""
    man = read_manifest(path)
    if not man or "sha256" not in man:
        return None
    try:
        return file_sha256(path) == man["sha256"]
    except OSError:
        return False


def quarantine(path: str) -> str:
    """Rename a corrupt snapshot (and its sidecar) to ``*.corrupt`` so
    the chain walk never reconsiders it while the evidence survives.
    Any ``<prefix>_current`` symlink that pointed at the quarantined
    file is repointed to the next-newest valid-named snapshot (or
    removed when none is left) — an elastic rerun that resumes via the
    link must skip straight to the older valid entry, never trip over
    a dangling link to evidence."""
    dest = path + CORRUPT_SUFFIX
    os.replace(path, dest)
    man = manifest_path(path)
    if os.path.exists(man):
        os.replace(man, dest + MANIFEST_SUFFIX)
    inc("veles_snapshots_quarantined_total")
    Logger().warning("quarantined corrupt snapshot %s -> %s", path, dest)
    _repair_current_links(os.path.dirname(os.path.abspath(path)))
    return dest


def _repair_current_links(directory: str) -> None:
    """Repoint every dangling ``*_current.pickle*`` symlink in
    ``directory`` at the newest surviving snapshot of its prefix
    (atomic: temp symlink + ``os.replace``), or remove it when the
    chain is empty. Idempotent — healthy links are untouched."""
    for link in glob.glob(os.path.join(directory, "*_current.pickle*")):
        if link.endswith(".tmp"):
            # a crash between symlink() and os.replace() in
            # _update_current_link leaves a *_current.pickle*.tmp —
            # debris, not a current link; repairing it would mint a
            # second never-cleaned pseudo-current link
            continue
        if not os.path.islink(link) or os.path.exists(link):
            continue                       # healthy (or not a link)
        prefix = os.path.basename(link).split("_current.pickle")[0]
        survivors = chain(directory, prefix)
        try:
            if not survivors:
                os.unlink(link)
                Logger().warning(
                    "removed dangling snapshot link %s (chain empty)",
                    link)
                continue
            tmp_link = link + ".tmp"
            try:
                os.unlink(tmp_link)
            except OSError:
                pass
            os.symlink(os.path.basename(survivors[0]), tmp_link)
            os.replace(tmp_link, link)
            Logger().warning("repointed snapshot link %s -> %s", link,
                             os.path.basename(survivors[0]))
        except OSError:
            # link repair is best-effort: the chain walk never follows
            # links, so restore still works either way
            pass


def chain(directory: str, prefix: str = "wf") -> List[str]:
    """Snapshot files for ``prefix`` in ``directory``, newest first.
    The ``_current`` symlink, sidecars, temp files and quarantined
    files are excluded."""
    out = []
    for path in glob.glob(os.path.join(directory, prefix + "*.pickle*")):
        if (path.endswith(CORRUPT_SUFFIX)
                or path.endswith(MANIFEST_SUFFIX)
                or path.endswith(".tmp") or os.path.islink(path)):
            continue
        out.append(path)
    return sorted(out, key=lambda p: (os.path.getmtime(p), p),
                  reverse=True)


def load_latest(directory: str, prefix: str = "wf"
                ) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Walk the chain newest→oldest to the newest snapshot that both
    verifies and deserializes; corrupt files met on the way are
    quarantined. Returns (path, state tree) or None. (load_snapshot
    runs the SHA-256 verification itself — one hash per candidate.)"""
    from ..snapshotter import load_snapshot
    for path in chain(directory, prefix):
        try:
            return path, load_snapshot(path)
        except SnapshotCorruptError as e:
            Logger().warning("snapshot %s unreadable (%s)", path, e)
            quarantine(path)
    return None


def restore_latest(workflow, directory: str,
                   prefix: str = "wf") -> Optional[str]:
    """Apply the newest valid snapshot in the chain to an initialized
    workflow; returns the path restored from, or None when the chain
    holds no valid snapshot."""
    found = load_latest(directory, prefix)
    if found is None:
        return None
    path, state = found
    from ..snapshotter import apply_state
    apply_state(workflow, state)
    workflow.restored_from_snapshot = True
    return path


#: cursor defaults for manifests written before the elastic plane
#: (docs/resilience.md "Elastic training"): epoch/step 0, one host
CURSOR_DEFAULT = {"epoch": 0, "step": 0, "world_size": 1}


def cursor_of(path: str) -> Dict[str, int]:
    """The snapshot's ``{epoch, step, world_size}`` training cursor
    from its sidecar manifest — where an elastic generation resumes.
    Legacy manifests (and missing/partial cursors) default the missing
    fields with a counted warning
    (``veles_manifest_cursor_defaults_total``), never a crash."""
    man = read_manifest(path) or {}
    raw = man.get("cursor")
    out = dict(CURSOR_DEFAULT)
    defaulted = []
    if not isinstance(raw, dict):
        raw = {}
    for key in out:
        try:
            out[key] = int(raw[key])
        except (KeyError, TypeError, ValueError):
            defaulted.append(key)
    if defaulted:
        inc("veles_manifest_cursor_defaults_total")
        Logger().warning(
            "snapshot %s manifest carries no %s cursor — defaulting "
            "to %s (pre-elastic manifest, or a torn sidecar)", path,
            "/".join(defaulted),
            {k: out[k] for k in defaulted})
    return out


def latest_cursor(directory: str, prefix: str = "wf"):
    """(path, cursor) of the newest chain entry, or None on an empty
    chain. Reads only the sidecar — no unpickle, so it is cheap enough
    for the elastic controller to log at every generation handoff."""
    for path in chain(directory, prefix):
        return path, cursor_of(path)
    return None


def prune(directory: str, prefix: str = "wf",
          keep_last: int = 0) -> List[str]:
    """Bounded retention: delete all but the newest ``keep_last``
    snapshots (and their sidecars). 0/None keeps everything. The
    ``_current`` symlink always points at the newest snapshot, so its
    target survives any ``keep_last >= 1``."""
    if not keep_last or keep_last <= 0:
        return []
    removed = []
    for path in chain(directory, prefix)[keep_last:]:
        for victim in (path, manifest_path(path)):
            try:
                os.unlink(victim)
                removed.append(victim)
            except OSError:
                pass
    return removed
