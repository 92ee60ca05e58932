"""compare_snapshots: structural diff of two training checkpoints
(counterpart of ``veles_tpu/scripts/compare_snapshots.py``).

A snapshot is the state tree of ``veles_tpu_torch/snapshotter.py``
(``__units__``/``__prng__``/``__meta__``, the reference's format), so
the walk is over that tree: every leaf is compared by shape, dtype and
value, and the differences are printed as a table with max|Δ| per
array. Either file may come from either package.

Usage: ``python -m veles_tpu_torch.scripts.compare_snapshots A B
[--rtol 1e-5] [--atol 1e-8] [--show-equal]``
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, List, Tuple

import numpy


def walk(prefix: str, node: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for key in sorted(node, key=str):
            yield from walk("%s/%s" % (prefix, key), node[key])
    elif isinstance(node, (list, tuple)) and not \
            isinstance(node, numpy.ndarray):
        for i, item in enumerate(node):
            yield from walk("%s[%d]" % (prefix, i), item)
    else:
        yield prefix, node


def compare(a: Dict[str, Any], b: Dict[str, Any], rtol: float = 1e-5,
            atol: float = 1e-8) -> List[Dict[str, Any]]:
    """Rows: {path, status, detail}; status ∈ equal/close/differs/
    only_a/only_b/shape/dtype."""
    fa, fb = dict(walk("", a)), dict(walk("", b))
    rows: List[Dict[str, Any]] = []
    for path in sorted(set(fa) | set(fb)):
        if path not in fb:
            rows.append({"path": path, "status": "only_a", "detail": ""})
            continue
        if path not in fa:
            rows.append({"path": path, "status": "only_b", "detail": ""})
            continue
        va, vb = fa[path], fb[path]
        if isinstance(va, numpy.ndarray) or isinstance(vb, numpy.ndarray):
            va, vb = numpy.asarray(va), numpy.asarray(vb)
            if va.shape != vb.shape:
                rows.append({"path": path, "status": "shape",
                             "detail": "%s vs %s" % (va.shape, vb.shape)})
            elif va.dtype != vb.dtype:
                rows.append({"path": path, "status": "dtype",
                             "detail": "%s vs %s" % (va.dtype, vb.dtype)})
            elif va.size and numpy.issubdtype(va.dtype, numpy.number):
                delta = float(numpy.abs(
                    va.astype(numpy.float64) -
                    vb.astype(numpy.float64)).max())
                if delta == 0.0:
                    rows.append({"path": path, "status": "equal",
                                 "detail": ""})
                elif numpy.allclose(va, vb, rtol=rtol, atol=atol):
                    rows.append({"path": path, "status": "close",
                                 "detail": "max|Δ|=%.3g" % delta})
                else:
                    rows.append({"path": path, "status": "differs",
                                 "detail": "max|Δ|=%.3g" % delta})
            else:
                same = (va.tolist() == vb.tolist())
                rows.append({"path": path,
                             "status": "equal" if same else "differs",
                             "detail": ""})
        else:
            same = (va == vb)
            rows.append({"path": path,
                         "status": "equal" if same else "differs",
                         "detail": "" if same else
                         "%r vs %r" % (va, vb)})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("snapshot_a")
    parser.add_argument("snapshot_b")
    parser.add_argument("--rtol", type=float, default=1e-5)
    parser.add_argument("--atol", type=float, default=1e-8)
    parser.add_argument("--show-equal", action="store_true")
    args = parser.parse_args(argv)
    from ..snapshotter import load_snapshot
    a = load_snapshot(args.snapshot_a)
    b = load_snapshot(args.snapshot_b)
    rows = compare(a, b, args.rtol, args.atol)
    shown = 0
    for row in rows:
        if row["status"] == "equal" and not args.show_equal:
            continue
        print("%-8s %-60s %s" % (row["status"], row["path"],
                                 row["detail"]))
        shown += 1
    counts: Dict[str, int] = {}
    for row in rows:
        counts[row["status"]] = counts.get(row["status"], 0) + 1
    print("—", ", ".join("%s: %d" % kv for kv in sorted(counts.items())))
    bad = sum(counts.get(k, 0) for k in
              ("differs", "shape", "dtype", "only_a", "only_b"))
    return 0 if bad == 0 else 1


if __name__ == "__main__":      # pragma: no cover
    import sys
    sys.exit(main())
