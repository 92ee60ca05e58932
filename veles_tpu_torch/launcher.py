"""Launcher: device, mesh, workflow lifecycle, resume and results
(counterpart of ``veles_tpu/launcher.py``).

:meth:`Launcher.initialize` resolves the device from the ``--backend``
name (:func:`backends.device_for_backend`: the card unless the CPU is
asked for, and an error when the card is asked for and absent), joins a
multi-process job (``coordinator``, ``num_processes``, ``process_id``:
``parallel.distributed.initialize_multihost``) and lays it out as the
``mesh`` (``backends.make_mesh``; ``root.common.mesh.axes`` when none is
given), initialises the workflow, checks that every rank runs the same
workflow from the same weights (``verify_checksums``) and arms the
failure hooks on its train step: the ``dispatch`` fault point, the
per-dispatch hang watchdog, the ``train_step`` heartbeat,
``--slave-death-probability`` and, under the elastic plane, the host
beat and one host-loss probe a dispatch. :meth:`resume` and
:meth:`try_restore_latest` restore snapshots through the checkpoint chain
(every rank reads the coordinator's file); :meth:`run` runs the workflow
and returns its gathered results, which only the coordinator writes;
:meth:`run_elastic` runs it in generations
(``resilience/elastic.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from . import prng
from .backends import device_for_backend, make_mesh
from .config import root
from .logger import Logger
from .parallel import distributed


class Launcher(Logger):
    """The reference's constructor less its plot and status-beacon
    options (ROADMAP Queue 1 item 11)."""

    def __init__(self, backend: Optional[str] = None,
                 mesh: Optional[Dict[str, int]] = None,
                 coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 random_seed: Optional[int] = None,
                 test_mode: bool = False,
                 profile_dir: Optional[str] = None) -> None:
        super().__init__()
        self.test_mode = test_mode
        self.workflow = None
        self.device = None
        #: the run's mesh (backends.Mesh), None at one process
        self.mesh = None
        self._mesh = mesh
        self._backend = backend
        #: torch.profiler capture of the run, exported as a Chrome trace
        self._profile_dir = profile_dir
        self._dist = (coordinator, num_processes, process_id)
        if random_seed is not None:
            prng.seed_all(random_seed)
        self._start_time = None
        self.stopped = False
        self.interrupted = False
        #: per-dispatch wall times of the armed train step (watchdog)
        self.step_history = distributed.StepTimes()
        #: the elastic plane's heartbeat name of this host (armed hooks)
        self._host_beat = None
        #: where the last restore found its chain: the elastic
        #: controller logs that chain's manifest cursor at a handoff
        self._last_restore_dir = None
        self._last_restore_prefix = "wf"

    # -- lifecycle -----------------------------------------------------------
    def make_device(self):
        """The run's ``torch.device``, after joining the job and laying it
        out as the mesh (a rank of an NCCL world takes its own card)."""
        self.device = device_for_backend(self._backend)
        distributed.initialize_multihost(*self._dist, device=self.device)
        if distributed.backend() == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self._mesh or distributed.active():
            axes = self._mesh or root.common.mesh.axes.as_dict()
            self.mesh = make_mesh(axes)
            self.info("mesh %s: rank %d at %s (backend %s)",
                      self.mesh.shape, self.mesh.rank, self.mesh.coords,
                      distributed.backend() or "none")
        return self.device

    def initialize(self, workflow) -> None:
        self.make_device()
        self.workflow = workflow
        if self.mesh is not None and not self.mesh.member:
            self.warning("rank %d is outside the mesh %s: idle",
                         self.mesh.rank, self.mesh.shape)
            return
        workflow.initialize(device=self.device)
        distributed.verify_checksums(workflow)
        self._arm_failure_hooks(workflow)
        if self.test_mode:
            self._enter_test_mode(workflow)
        self.info("initialized %s on %s", getattr(workflow, "name", "?"),
                  self.device)
        self.event("launcher.initialize", "single", device=str(self.device),
                   processes=distributed.process_count())

    def _enter_test_mode(self, workflow) -> None:
        """``--test``: one evaluation-only pass, no parameter updates."""
        step = getattr(workflow, "train_step", None)
        decision = getattr(workflow, "decision", None)
        if step is not None:
            step.evaluation_mode = True
        if decision is not None:
            decision.max_epochs = decision.epoch_number + 1

    def _arm_failure_hooks(self, workflow) -> None:
        """Every train-step dispatch passes the ``dispatch`` fault point,
        runs under the hang watchdog (``root.common.job_timeout`` is its
        floor) and beats the ``train_step`` heartbeat. Under the elastic
        plane it first beats this host's ``host:<rank>`` heartbeat and
        probes for host loss (``elastic.check_hosts``) BEFORE the step
        runs, so a loss never leaves half a step behind."""
        step = getattr(workflow, "train_step", None)
        if step is None or getattr(step, "_failure_hooks_armed", False):
            return
        from .resilience import elastic
        from .resilience.faults import fire as fire_fault
        from .resilience.health import heartbeats
        timeout = float(root.common.get("job_timeout", 0.0) or 0.0)
        death_p = float(
            root.common.get("slave_death_probability", 0.0) or 0.0)
        elastic_on = elastic.enabled()
        host_beat = (elastic.HOST_BEAT_PREFIX
                     + str(distributed.process_index())
                     if elastic_on else None)
        #: run()'s finally unregisters it: a finished run's host beat
        #: must not age into a false /healthz failure
        self._host_beat = host_beat
        inner_run = step.run

        def armed_run():
            fire_fault("dispatch")
            if elastic_on:
                heartbeats.beat(host_beat)
                elastic.check_hosts()
            with distributed.step_watchdog(
                    step.name, timeout=timeout, history=self.step_history):
                inner_run()
            heartbeats.beat("train_step")
            if death_p > 0:
                distributed.fault_injection(death_p)
        step.run = armed_run
        step._failure_hooks_armed = True

    def try_restore_latest(self) -> bool:
        """Resume from the newest valid snapshot in the snapshot
        directory (the linked Snapshotter's, else
        ``root.common.dirs.snapshots``), if there is one; warns when no
        Snapshotter is linked, since then nothing writes snapshots."""
        from .snapshotter import Snapshotter, SnapshotterToDB, resume
        wf = self.workflow
        directory, prefix = root.common.dirs.snapshots, "wf"
        snap_unit = next((u for u in getattr(wf, "units", ())
                          if isinstance(u, Snapshotter)), None)
        if snap_unit is None:
            self.warning(
                "workflow %r has no Snapshotter unit — snapshots will "
                "NOT be written this run; link Snapshotter(None, "
                "prefix=...) (directory defaults to the --snapshot-dir / "
                "root.common.dirs.snapshots setting) via "
                "StandardWorkflow(snapshotter_unit=...)",
                getattr(wf, "name", "?"))
        else:
            directory, prefix = snap_unit.directory, snap_unit.prefix
        if isinstance(snap_unit, SnapshotterToDB):
            dsn = snap_unit._resolve_dsn()
            if not os.path.exists(dsn):
                return False
            try:
                resume(wf, "sqlite://" + dsn)
            except FileNotFoundError:
                return False
        else:
            if not directory or not os.path.isdir(directory):
                return False
            if not distributed.restore_latest(wf, directory, prefix):
                return False
        decision = getattr(wf, "decision", None)
        if decision is not None:
            decision.complete <<= False
        self._last_restore_dir = directory
        self._last_restore_prefix = prefix
        self.info("auto-resumed from latest snapshot in %s", directory)
        return True

    def resume(self, snapshot_path: str) -> None:
        """Resume from ``snapshot_path``. A ``<prefix>_current`` link
        that dangles or names a corrupt file falls back to the newest
        valid snapshot of that chain."""
        from .resilience.checkpoint_chain import (SnapshotCorruptError,
                                                  restore_latest)
        from .snapshotter import resume
        t0 = time.time()
        try:
            resume(self.workflow, snapshot_path)
        except (FileNotFoundError, SnapshotCorruptError) as e:
            base = os.path.basename(snapshot_path)
            if "_current.pickle" not in base:
                raise
            prefix = base.split("_current.pickle")[0]
            directory = os.path.dirname(snapshot_path) or "."
            self.warning(
                "snapshot link %s is unusable (%s: %s) — falling back "
                "to the newest valid snapshot of chain %r in %s",
                snapshot_path, type(e).__name__, e, prefix, directory)
            restored = restore_latest(self.workflow, directory, prefix)
            if restored is None:
                raise
            self._last_restore_dir = directory
            self._last_restore_prefix = prefix
            snapshot_path = restored     # log the file really resumed
        decision = getattr(self.workflow, "decision", None)
        if decision is not None:
            decision.complete <<= False
        self.info("resumed from %s (%.3f s)", snapshot_path,
                  time.time() - t0)

    def run_elastic(self) -> Dict[str, Any]:
        """Run under the elastic generation controller
        (``resilience/elastic.py``): on a detected host loss the run
        resumes from the newest valid checkpoint in a new generation
        instead of dying — ``--elastic`` /
        ``root.common.resilience.elastic.enabled``."""
        from .resilience.elastic import ElasticController
        return ElasticController(self).run()

    def run(self, keep_services: bool = False) -> Dict[str, Any]:
        """Run the workflow; its ``gather_results()`` plus
        ``elapsed_sec`` and, after Ctrl-C, ``interrupted``.
        ``keep_services=True`` (elastic generations) leaves the once-a-job
        teardown to :meth:`finalize_services`."""
        from .resilience.health import heartbeats
        from .telemetry.recorder import flight
        if self.mesh is not None and not self.mesh.member:
            return {"idle": True}
        if flight.autodump_enabled():
            flight.install_sigterm()
        self._start_time = time.time()
        heartbeats.beat("launcher")
        self.event("launcher.work", "begin")
        prof = self._start_profiler()
        try:
            self.workflow.run()
        except KeyboardInterrupt:
            self.warning("interrupted — stopping workflow")
            self.workflow.stop()
            self.interrupted = True
        finally:
            if prof is not None:
                self._stop_profiler(prof)
            self.event("launcher.work", "end")
            self.stopped = True
            if not keep_services:
                self.finalize_services()
            # a finished run's beats are not hangs: left registered they
            # would age into a false /healthz failure
            heartbeats.unregister("launcher")
            heartbeats.unregister("train_step")
            if self._host_beat:
                heartbeats.unregister(self._host_beat)
        elapsed = time.time() - self._start_time
        self.info("elapsed: %.1fs", elapsed)
        results = self.workflow.gather_results()
        results["elapsed_sec"] = round(elapsed, 3)
        if self.interrupted:
            results["interrupted"] = True
        return results

    def _start_profiler(self):
        if not self._profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        self.info("profiler capture → %s", self._profile_dir)
        return prof

    def _stop_profiler(self, prof) -> None:
        prof.__exit__(None, None, None)
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir,
                            "trace_%d.json" % os.getpid())
        prof.export_chrome_trace(path)
        self.info("profiler trace → %s", path)

    def finalize_services(self) -> None:
        """The once-a-JOB half of :meth:`run`'s teardown, which the
        elastic controller calls after the last generation. The port has
        no plotter, graphics server or status beacon yet (ROADMAP Queue 1
        item 11), so there is nothing to tear down: a no-op, and so
        idempotent."""

    def stop(self) -> None:
        if self.workflow is not None:
            self.workflow.stop()
        self.stopped = True

    # -- reporting -----------------------------------------------------------
    def write_results(self, results: Dict[str, Any], path: str) -> None:
        """``--result-file``: the results as JSON, tensors as the numpy
        values of the same data."""
        if not distributed.is_coordinator():
            return
        from .json_encoders import NumpyJSONEncoder
        with open(path, "w") as fout:
            json.dump(results, fout, indent=2, cls=NumpyJSONEncoder)
        self.info("results → %s", path)

    def print_stats(self) -> None:
        self.workflow.print_stats()
