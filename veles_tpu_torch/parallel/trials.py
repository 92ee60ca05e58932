"""Parallel trial scheduler: the job farm under GA / ensemble search
(counterpart of ``veles_tpu/parallel/trials.py``).

A trial is one OS subprocess running the normal CLI; a fixed pool of
worker SLOTS runs up to ``n_workers`` trials at once; a *placement hook*
maps each slot to the environment that pins its device resources:

- :func:`cpu_placement` (default): the card hidden and the port on the
  CPU with one intra-op thread a slot — correctness fan-out on any host,
  CI included;
- :func:`mesh_slice_placement`: slot *i* sees cards ``[i·d, (i+1)·d)``
  through ``CUDA_VISIBLE_DEVICES``, so trials train on disjoint cards of
  one host at once.

Trials never share a process with the scheduler (device state stays
apart — the reference's reason for slave processes), and an overrunning
or crashing trial is killed by process group and reported, never
propagated.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import threading
import time
from queue import Queue
from typing import Callable, Dict, List, Optional, Sequence

from ..logger import Logger


def cpu_placement(slot: int) -> Dict[str, str]:
    """The slot's trial on the host: no card visible, the port's backend
    forced to the CPU, and one torch intra-op thread (``OMP_NUM_THREADS``
    1) so concurrent slots do not fight over the host's cores."""
    return {"CUDA_VISIBLE_DEVICES": "", "VELES_BACKEND": "cpu",
            "OMP_NUM_THREADS": "1"}


def mesh_slice_placement(devices_per_trial: int = 1,
                         total_devices: Optional[int] = None
                         ) -> Callable[[int], Dict[str, str]]:
    """Placement hook for a host with several cards: slot *i* sees cards
    ``[i*d, (i+1)*d)`` through ``CUDA_VISIBLE_DEVICES`` (the trial's
    ``cuda:0`` is the first of them), so trials train on disjoint slices
    of one host's cards at once. A slot past ``total_devices`` raises."""
    def place(slot: int) -> Dict[str, str]:
        d = int(devices_per_trial)
        cards = range(slot * d, (slot + 1) * d)
        if total_devices is not None and cards[-1] >= total_devices:
            raise ValueError(
                "slot %d needs cards %s but only %d exist"
                % (slot, list(cards), total_devices))
        return {"CUDA_VISIBLE_DEVICES": ",".join(map(str, cards))}
    return place


def run_json_trials(make_argv, n: int, n_workers: int,
                    placement: Optional[Callable[[int],
                                                 Dict[str, str]]] = None,
                    timeout: Optional[float] = None,
                    tags: Optional[Sequence[object]] = None):
    """Run ``n`` CLI trials that each write a JSON result file; returns
    ``[(TrialResult, parsed_json_or_None), ...]`` in submission order.

    ``make_argv(i, result_file) -> argv``. Owns the whole result-file
    lifecycle (mkstemp, guarded parse, unlink) so every caller — GA
    generations, ensemble members — shares one failure contract: a
    trial whose process failed OR whose result file is unreadable
    yields ``doc=None`` and never raises."""
    import json
    import tempfile
    result_files, trials = [], []
    for i in range(n):
        fd, rf = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        result_files.append(rf)
        trials.append(Trial(argv=make_argv(i, rf),
                            tag=tags[i] if tags else i, timeout=timeout))
    sched = TrialScheduler(n_workers=n_workers,
                           placement=placement or cpu_placement)
    try:
        out = []
        for res, rf in zip(sched.run(trials), result_files):
            doc = None
            if res.ok:
                try:
                    with open(rf) as fin:
                        doc = json.load(fin)
                except (ValueError, OSError):
                    doc = None      # rc=0 but no usable result: caller
                    # treats it exactly like a failed trial
            out.append((res, doc))
        return out
    finally:
        for rf in result_files:
            try:
                os.unlink(rf)
            except OSError:
                pass


@dataclasses.dataclass
class Trial:
    """One unit of farmed work: an argv command plus per-trial env."""
    argv: Sequence[str]
    tag: object = None
    env: Optional[Dict[str, str]] = None
    timeout: Optional[float] = None


@dataclasses.dataclass
class TrialResult:
    tag: object
    returncode: int
    stderr_tail: str
    elapsed: float
    slot: int
    timed_out: bool = False

    @property
    def ok(self) -> bool:
        return self.returncode == 0 and not self.timed_out


class TrialScheduler(Logger):
    """Run trials with bounded concurrency and per-slot placement.

    ``run`` preserves submission order in its result list; a failed or
    overrunning trial yields a TrialResult with ``ok == False`` (killed
    by process group) and never raises — one divergent candidate must
    not take down a whole generation (same contract the reference's
    job farm kept, veles/server.py:315-338 slave-death handling).
    """

    def __init__(self, n_workers: Optional[int] = None,
                 placement: Callable[[int], Dict[str, str]] = cpu_placement,
                 timeout: Optional[float] = None) -> None:
        super().__init__()
        if n_workers is None:
            n_workers = min(4, os.cpu_count() or 1)
        self.n_workers = int(n_workers)
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.placement = placement
        self.timeout = timeout

    def _run_one(self, trial: Trial, slot: int) -> TrialResult:
        env = dict(os.environ)
        env.update(self.placement(slot))
        if trial.env:
            env.update(trial.env)
        t0 = time.time()
        timeout = trial.timeout or self.timeout
        timed_out = False
        proc = subprocess.Popen(
            list(trial.argv), env=env, text=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            start_new_session=True)     # killable with its children
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()
            _, err = proc.communicate()
        return TrialResult(tag=trial.tag, returncode=proc.returncode,
                           stderr_tail=(err or "")[-2000:],
                           elapsed=time.time() - t0, slot=slot,
                           timed_out=timed_out)

    def run(self, trials: Sequence[Trial]) -> List[TrialResult]:
        trials = list(trials)
        # placement misconfiguration (e.g. a slice past the host's last
        # card) is a caller error and must raise BEFORE any trial runs,
        # not surface as N per-trial "failures"; only slots that can
        # ever be taken are validated (returned slots re-enter at the
        # queue tail, so indices ≥ the worker count never circulate)
        for s in range(min(self.n_workers, len(trials))):
            self.placement(s)
        results: List[Optional[TrialResult]] = [None] * len(trials)
        slots: Queue = Queue()
        for s in range(self.n_workers):
            slots.put(s)
        pending: Queue = Queue()
        for i, t in enumerate(trials):
            pending.put((i, t))

        def worker() -> None:
            while True:
                try:
                    i, trial = pending.get_nowait()
                except Exception:
                    return
                slot = slots.get()
                try:
                    res = self._run_one(trial, slot)
                except Exception as exc:   # spawn failure: report, go on
                    res = TrialResult(tag=trial.tag, returncode=-1,
                                      stderr_tail=str(exc), elapsed=0.0,
                                      slot=slot)
                finally:
                    slots.put(slot)
                if not res.ok:
                    self.warning(
                        "trial %r failed (rc=%s%s): %s", trial.tag,
                        res.returncode,
                        ", timed out" if res.timed_out else "",
                        res.stderr_tail[-500:])
                results[i] = res

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.n_workers, len(trials)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for i, r in enumerate(results):
            if r is None:      # worker thread died outside _run_one
                results[i] = TrialResult(
                    tag=trials[i].tag, returncode=-1,
                    stderr_tail="worker thread died", elapsed=0.0,
                    slot=-1)
        return results  # type: ignore[return-value]
