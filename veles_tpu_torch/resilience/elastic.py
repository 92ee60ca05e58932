"""Elastic, preemption-tolerant training (counterpart of
``veles_tpu/resilience/elastic.py``): generations, survivor barriers,
respawn supervision and a falsifiable scaling model.

A run is a sequence of **generations**, each under the world size of
its time. On a detected host loss (a lapsed ``host:*`` heartbeat, a
collective that fails because a peer died, or an injected
``distributed.host_loss`` fault) the survivors agree on the next
generation at a barrier and the state resumes from the newest valid
checkpoint of the chain (:func:`~veles_tpu_torch.resilience.
checkpoint_chain.restore_latest`). Resharding is free by construction:
a snapshot holds whole (gathered) tensors, and each unit puts them back
through its own placement on whatever mesh the new generation built,
so a snapshot taken at world 2 restores at world 1.

Data order stays deterministic per generation: the manifest carries an
``{epoch, step, world_size, generation}`` cursor, and the restore puts
back every random stream and the loader's epoch cursor, so a run
interrupted mid-epoch resumes at the last snapshot and ends in the same
state as an uninterrupted run.

Two halves:

- :class:`ElasticController` — the in-process generation loop the
  launcher runs under ``--elastic`` /
  ``root.common.resilience.elastic.enabled``. At one process a loss
  starts the next generation in the same process; in a multi-process
  job the survivor exits :data:`GENERATION_EXIT_CODE`, because a
  process cannot rebuild its ``torch.distributed`` world from inside a
  collective a dead peer wedged;
- :class:`Supervisor` — the respawn plane of a multi-process job: it
  spawns a generation's processes, watches them, reaps the survivors of
  a dead peer, shrinks (or regrows) the world and spawns the next
  generation.

:func:`predict_step_time` predicts the data-parallel step time at any
world size from two stated inputs: the gradient all-reduce bytes of a
step (ring all-reduce, ``2·(N-1)/N · grad_bytes`` a rank) and the
assumed per-card link rate (``telemetry.cost.LINK_BW_BYTES``, NVLink 4),
so one measurement confirms or refutes it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..config import root
from ..error import DistributedCommunicationError, VelesError
from ..logger import Logger
from ..telemetry.counters import inc
from .faults import FaultInjected, fire
from .health import heartbeats

#: exit code a survivor uses to hand control back to the respawn plane
#: (distinct from faults.CRASH_EXIT_CODE=42, the slave-death code: a 43
#: means "I am healthy but the generation is over — respawn me")
GENERATION_EXIT_CODE = 43

#: heartbeat-name prefix the elastic plane watches (one entry per host
#: process, beaten by the armed train step)
HOST_BEAT_PREFIX = "host:"

#: env var the respawn plane exports so a respawned worker numbers its
#: generations (gauges, manifest cursor, logs) from the job's true
#: generation instead of 1 — the Supervisor sets it before every spawn
GENERATION_ENV = "VELES_ELASTIC_GENERATION"


def base_generation() -> int:
    """The generation this process's controller starts counting from:
    :data:`GENERATION_ENV` when the respawn plane exported it, else 1."""
    try:
        return max(1, int(os.environ.get(GENERATION_ENV, "1")))
    except ValueError:
        return 1


#: every counter this module increments (telemetry/counters.py
#: DESCRIPTIONS)
ELASTIC_COUNTERS = (
    "veles_elastic_generations_total",
    "veles_elastic_preemptions_total",
    "veles_elastic_reshard_seconds_total",
    "veles_elastic_barrier_timeouts_total",
)


class HostLostError(VelesError):
    """A participating host was declared lost (heartbeat lapse,
    coordinator-join failure, or an injected ``distributed.host_loss``
    fault) — the current generation is over."""


# -- gauge state (the /metrics surfaces render it) -------------------------

_lock = threading.Lock()
_state: Dict[str, Any] = {
    "enabled": False, "generation": 0, "world_size": 0,
    "last_reshard_s": 0.0, "min_hosts": 1,
}


def _set_state(**kv: Any) -> None:
    with _lock:
        _state.update(kv)


def state() -> Dict[str, Any]:
    with _lock:
        return dict(_state)


def gauges() -> Dict[str, Any]:
    """Elastic gauges for the /metrics surfaces. No rows at all until
    the elastic plane was enabled — non-elastic processes keep a clean
    scrape page."""
    st = state()
    if not st["enabled"]:
        return {}
    return {
        "veles_elastic_generation":
            (st["generation"], "Current elastic training generation"),
        "veles_elastic_world_size":
            (st["world_size"],
             "Host processes participating in the current generation"),
        "veles_elastic_last_reshard_seconds":
            (round(st["last_reshard_s"], 6),
             "Restore+reshard time of the latest generation handoff"),
        "veles_elastic_min_hosts":
            (st["min_hosts"],
             "Floor below which the elastic run refuses to continue"),
    }


def config() -> Dict[str, Any]:
    """The elastic knob block ``root.common.resilience.elastic.*``
    (CLI: ``--elastic`` flips ``enabled``)."""
    node = root.common.resilience.elastic
    return {
        "enabled": bool(node.get("enabled", False)),
        "min_hosts": int(node.get("min_hosts", 1) or 1),
        "generation_timeout": float(
            node.get("generation_timeout", 60.0) or 60.0),
        "max_generations": int(node.get("max_generations", 8) or 8),
    }


def enabled() -> bool:
    return config()["enabled"]


# -- detection ---------------------------------------------------------------

def check_hosts(registry=heartbeats) -> None:
    """One host-loss probe: fires the ``distributed.host_loss`` point (an
    armed ``raise`` simulates a preempted peer, ``crash`` kills this
    process like a real preemption) and checks every ``host:*``
    heartbeat for lapse. Raises :class:`HostLostError` on either signal;
    the armed train step calls it once a dispatch, before the step runs.

    The lapse check covers the heartbeats registered in this process
    (its own, or peer liveness a sidecar feeds in with
    ``health.heartbeats.beat("host:<n>", timeout=...)``). A remote
    peer's death without such a feed surfaces through the other two
    signals: the collective that fails on the survivors, and the respawn
    plane's process watch (:class:`Supervisor`)."""
    try:
        fire("distributed.host_loss")
    except FaultInjected as e:
        raise HostLostError(
            "injected host loss (distributed.host_loss)") from e
    # a prefix-filtered age probe: this runs once a dispatch
    stale = registry.stale(HOST_BEAT_PREFIX)
    if stale:
        # the loss is hereby DECLARED: drop the lapsed entries so the
        # next generation starts clean instead of raising again on the
        # same beat — a host that comes back re-registers with its first
        # fresh beat
        for name in stale:
            registry.unregister(name)
        raise HostLostError(
            "host heartbeat(s) lapsed: %s" % ", ".join(sorted(stale)))


def generation_barrier(generation: int,
                       timeout: Optional[float] = None) -> int:
    """All survivors agree on the coordinator's generation index before
    any of them touches the checkpoint chain. Fires the
    ``distributed.generation_barrier`` point; a barrier that raises
    (injected, or a collective failure — a dead peer shows up here
    first) OR overruns ``timeout`` (a hung peer holds the collective for
    ``distributed.TIMEOUT_S``, so the wait runs on a watchdog thread that
    is abandoned on overrun — the process hands off to the respawn plane
    right after) is counted in ``veles_elastic_barrier_timeouts_total``
    and raised as :class:`HostLostError`. Returns the agreed index."""
    from ..parallel import distributed

    def _barrier() -> int:
        fire("distributed.generation_barrier")
        return distributed.survivor_barrier(generation)

    try:
        if not timeout or timeout <= 0:
            return _barrier()
        outcome: Dict[str, Any] = {}

        def _run() -> None:
            try:
                outcome["value"] = _barrier()
            except BaseException as e:   # noqa: BLE001 — re-raised below
                outcome["error"] = e

        worker = threading.Thread(target=_run, daemon=True,
                                  name="elastic-generation-barrier")
        worker.start()
        worker.join(timeout)
        if worker.is_alive():
            inc("veles_elastic_barrier_timeouts_total")
            raise HostLostError(
                "generation %d barrier timed out after %.0fs — a dead "
                "peer never arrives at the collective" % (generation,
                                                          timeout))
        if "error" in outcome:
            raise outcome["error"]
        return outcome["value"]
    except HostLostError:
        raise                           # timeout above: already counted
    except (FaultInjected, DistributedCommunicationError,
            RuntimeError) as e:
        inc("veles_elastic_barrier_timeouts_total")
        raise HostLostError(
            "generation %d barrier failed%s: %s"
            % (generation,
               "" if timeout is None else " (timeout %.0fs)" % timeout,
               e)) from e


# -- the in-process generation loop ------------------------------------------

class ElasticController(Logger):
    """Wraps a launcher's run in generations.

    Each generation: the survivors reach the barrier, the newest valid
    checkpoint is restored (onto the current mesh by the ordinary
    restore path), and training runs until it completes or a host is
    lost. A loss in a one-process job continues in the same process; in
    a multi-process job the controller exits with
    :data:`GENERATION_EXIT_CODE` so the respawn plane (:class:`Supervisor`,
    or a scheduler) rebuilds the job at the surviving world size.
    """

    def __init__(self, launcher) -> None:
        super().__init__()
        self._launcher = launcher
        cfg = config()
        self.min_hosts = cfg["min_hosts"]
        self.generation_timeout = cfg["generation_timeout"]
        self.max_generations = cfg["max_generations"]

    def run(self) -> Dict[str, Any]:
        from ..parallel import distributed
        world = distributed.process_count()
        _set_state(enabled=True, world_size=world,
                   min_hosts=self.min_hosts)
        if world < self.min_hosts:
            # refuse BEFORE training a generation the floor forbids
            raise HostLostError(
                "cannot start an elastic run at world size %d: "
                "min_hosts=%d" % (world, self.min_hosts))
        try:
            return self._generations(world)
        finally:
            # services are torn down once per JOB, not per generation:
            # see Launcher.run(keep_services=True)
            finalize = getattr(self._launcher, "finalize_services",
                               None)
            if callable(finalize):
                finalize()

    def _generations(self, world: int) -> Dict[str, Any]:
        from ..parallel import distributed
        self._last_loss: Optional[BaseException] = None
        # a respawned worker continues the job's generation numbering
        # (the respawn plane exports GENERATION_ENV)
        generation = base_generation()
        for _attempt in range(self.max_generations):
            distributed.set_generation(generation)
            _set_state(generation=generation, world_size=world)
            inc("veles_elastic_generations_total")
            try:
                # a failed barrier ends the generation like any other
                # host loss — never the whole run
                agreed = generation_barrier(
                    generation, timeout=self.generation_timeout)
                if agreed != generation:
                    # this worker missed generation declarations (a
                    # scheduler respawned it without GENERATION_ENV):
                    # adopt the coordinator's numbering everywhere
                    self.warning(
                        "adopting coordinator generation %d (local "
                        "view was %d)", agreed, generation)
                    generation = agreed
                    distributed.set_generation(agreed)
                    _set_state(generation=agreed)
            except HostLostError as e:
                generation = self._lost(generation, world, e)
                continue
            # EVERY generation restores from the chain, keyed on the
            # checkpoints that exist, not on the generation index. Sole
            # exception: a FRESH job (generation 1 by every signal) whose
            # workflow the caller already restored explicitly. The
            # restore runs OUTSIDE the preemption handlers: a restore
            # that fails for good is a real error, not a host loss to
            # respawn max_generations times.
            fresh_job = generation == 1 and base_generation() == 1
            already = bool(getattr(self._launcher.workflow,
                                   "restored_from_snapshot", False))
            if not (fresh_job and already):
                self._restore(generation,
                              initial=generation == base_generation())
            try:
                results = self._launcher.run(keep_services=True)
                results["elastic_generations"] = generation
                return results
            except HostLostError as e:
                # one process: the survivor IS the job — declare the
                # next generation and train on from the newest checkpoint
                generation = self._lost(generation, world, e)
            except (DistributedCommunicationError, RuntimeError) as e:
                # a collective failed mid-step: in a multi-process job
                # the likeliest cause is a dead peer (gloo raises a
                # RuntimeError on the survivors) — a preemption, handed
                # to the respawn plane. At one process a RuntimeError is
                # a real bug: re-raise.
                if world <= 1:
                    raise
                self._last_loss = e
                inc("veles_elastic_preemptions_total")
                self.warning(
                    "generation %d collective failure (%s: %s) — "
                    "treating as host loss, handing off to the "
                    "respawn plane (exit %d)", generation,
                    type(e).__name__, e, GENERATION_EXIT_CODE)
                raise SystemExit(GENERATION_EXIT_CODE)
        raise HostLostError(
            "elastic run did not complete within %d generation(s); "
            "last loss: %s" % (self.max_generations, self._last_loss))

    def _lost(self, generation: int, world: int,
              e: HostLostError) -> int:
        """Account one host loss; returns the next generation to declare
        (one process) or hands off to the respawn plane (several)."""
        self._last_loss = e
        inc("veles_elastic_preemptions_total")
        self.warning("generation %d lost a host: %s", generation, e)
        if world > 1:
            self.warning("handing off to the respawn plane (exit %d)",
                         GENERATION_EXIT_CODE)
            raise SystemExit(GENERATION_EXIT_CODE)
        return generation + 1

    def _restore(self, generation: int, initial: bool = False) -> None:
        """Generation handoff: newest valid checkpoint → current mesh,
        timed into ``veles_elastic_reshard_seconds_total``; the manifest
        cursor is logged so an operator sees where the generation
        resumes. ``initial`` marks the first generation this process
        declares — an empty chain is then a fresh start."""
        from .checkpoint_chain import latest_cursor
        t0 = time.time()
        restored = self._launcher.try_restore_latest()
        dt = time.time() - t0
        inc("veles_elastic_reshard_seconds_total", dt)
        _set_state(last_reshard_s=dt)
        if restored:
            directory = getattr(self._launcher, "_last_restore_dir",
                                None) or root.common.dirs.snapshots
            prefix = getattr(self._launcher, "_last_restore_prefix",
                             "wf")
            found = (latest_cursor(directory, prefix)
                     if directory else None)
            if found is not None:
                path, cur = found
                self.info(
                    "generation %d resumes from %s (epoch=%d step=%d, "
                    "snapshot world_size=%d) in %.2fs", generation,
                    path, cur["epoch"], cur["step"], cur["world_size"],
                    dt)
            else:
                self.info("generation %d resumed from newest valid "
                          "checkpoint in %.2fs", generation, dt)
        elif initial:
            self.debug("generation %d starts with an empty chain "
                       "(fresh job)", generation)
        else:
            self.warning(
                "generation %d found no valid checkpoint — continuing "
                "from live in-memory state (determinism vs an "
                "uninterrupted run is only guaranteed from a "
                "checkpoint)", generation)


# -- the respawn plane --------------------------------------------------------

class Supervisor(Logger):
    """The respawn plane of a multi-process job: spawn a generation's
    worker processes, watch them, and when one dies reap the survivors
    (wedged in collectives), shrink or regrow the world, and respawn
    from the newest valid checkpoint.

    ``spawn(generation, world_size) -> [subprocess.Popen]`` builds one
    generation (the caller owns argv and env: coordinator port, process
    ids, snapshot dir). Worker exits are classified:

    - all zero → the job completed: done;
    - :data:`GENERATION_EXIT_CODE` → a healthy survivor handing control
      back: respawned, world unchanged (unless peers died);
    - anything else (crash code, SIGKILL) → a lost host: the world
      shrinks by the number of losses, or regrows to ``target_world``
      when ``regrow`` is set.
    """

    def __init__(self, spawn: Callable[[int, int], List[Any]],
                 world_size: int, min_hosts: Optional[int] = None,
                 max_generations: Optional[int] = None,
                 regrow: bool = False, poll_interval: float = 0.2,
                 reap_timeout: float = 30.0,
                 generation_deadline: float = 0.0) -> None:
        super().__init__()
        cfg = config()
        self._spawn = spawn
        self.target_world = int(world_size)
        self.min_hosts = int(cfg["min_hosts"] if min_hosts is None
                             else min_hosts)
        self.max_generations = int(
            cfg["max_generations"] if max_generations is None
            else max_generations)
        self.regrow = bool(regrow)
        self.poll_interval = float(poll_interval)
        self.reap_timeout = float(reap_timeout)
        #: wall-clock bound on ONE generation (0 = unbounded): a
        #: partitioned host whose process stays alive exits nothing, so
        #: exit-code watching alone would block the respawn plane
        #: forever. Overrun reaps the wedged generation and respawns it
        #: (a counted preemption).
        self.generation_deadline = float(generation_deadline or 0.0)
        self.generation = 0
        self.world = int(world_size)

    def run(self) -> int:
        saved = os.environ.get(GENERATION_ENV)
        try:
            return self._run()
        finally:
            if saved is None:
                os.environ.pop(GENERATION_ENV, None)
            else:
                os.environ[GENERATION_ENV] = saved

    def _run(self) -> int:
        _set_state(enabled=True, min_hosts=self.min_hosts)
        for generation in range(1, self.max_generations + 1):
            self.generation = generation
            _set_state(generation=generation, world_size=self.world)
            inc("veles_elastic_generations_total")
            self.info("generation %d: spawning %d host process(es)",
                      generation, self.world)
            # exported BEFORE spawn so workers inherit it (directly, or
            # through the dict(os.environ) copy a spawn callback builds)
            os.environ[GENERATION_ENV] = str(generation)
            procs = list(self._spawn(generation, self.world))
            lost, restart = self._watch(procs)
            if lost == 0 and restart == 0:
                self.info("elastic job completed in generation %d "
                          "(world %d)", generation, self.world)
                return generation
            inc("veles_elastic_preemptions_total")
            survivors = self.world - lost
            self.warning(
                "generation %d over: %d host(s) lost, %d survivor "
                "restart(s); world %d -> %d", generation, lost,
                restart, self.world,
                self.target_world if self.regrow else survivors)
            self.world = self.target_world if self.regrow else survivors
            if self.world < self.min_hosts:
                raise HostLostError(
                    "world shrank to %d host(s), below min_hosts=%d"
                    % (self.world, self.min_hosts))
        raise HostLostError(
            "elastic job did not complete within %d generation(s)"
            % self.max_generations)

    def _watch(self, procs: List[Any]):
        """Block until the generation resolves. Returns ``(lost,
        restart)``: hosts that died vs healthy survivors. The first
        non-clean exit ends the generation and the rest are reaped (a
        survivor of a dead peer may wait in a collective). A process
        that died by itself with a code other than 0 or
        :data:`GENERATION_EXIT_CODE` is a lost host; one that exited with
        the generation code OR that the supervisor had to kill is a
        healthy survivor. With ``generation_deadline`` set, a generation
        with NO exit signal at all is reaped at the deadline."""
        deadline = (time.time() + self.generation_deadline
                    if self.generation_deadline > 0 else None)
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return 0, 0
            overdue = deadline is not None and time.time() >= deadline
            if overdue and not any(c is not None and c != 0
                                   for c in codes):
                self.warning(
                    "generation deadline %.0fs exceeded with %d "
                    "process(es) still running and no exit signal — "
                    "reaping the wedged generation",
                    self.generation_deadline,
                    sum(1 for c in codes if c is None))
            if overdue or any(c is not None and c != 0 for c in codes):
                reaped = self._reap(procs)
                codes = [p.poll() for p in procs]
                lost = sum(
                    1 for i, c in enumerate(codes)
                    if c not in (0, GENERATION_EXIT_CODE)
                    and i not in reaped)
                restart = sum(
                    1 for i, c in enumerate(codes)
                    if c == GENERATION_EXIT_CODE or i in reaped)
                return lost, restart
            time.sleep(self.poll_interval)

    def _reap(self, procs: List[Any]):
        """Give survivors a grace window to exit on their own
        (GENERATION_EXIT_CODE), then kill the rest. Returns the indices
        of the processes the supervisor killed — reaped survivors, not
        lost hosts."""
        deadline = time.time() + self.reap_timeout
        while time.time() < deadline:
            if all(p.poll() is not None for p in procs):
                return set()
            time.sleep(self.poll_interval)
        killed = set()
        for i, p in enumerate(procs):
            if p.poll() is None:
                try:
                    p.kill()
                    killed.add(i)
                except OSError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=self.reap_timeout)
            except Exception:       # noqa: BLE001 — already killed
                pass
        return killed


# -- the falsifiable scaling model --------------------------------------------

def psum_bytes_per_step(grad_bytes: float, n: int) -> float:
    """Per-rank wire bytes one data-parallel step moves through the
    gradient all-reduce at world size ``n``: the ring all-reduce cost
    ``2·(N-1)/N · grad_bytes`` (reduce-scatter + all-gather). 0 at N=1:
    no all-reduce is issued."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * float(grad_bytes)


def predict_step_time(t1_step_s: float, grad_bytes: float, n: int,
                      ici_bw: Optional[float] = None,
                      device_kind: Optional[str] = None
                      ) -> Dict[str, Any]:
    """Predicted data-parallel step time at world size ``n``:

        t_pred(N) = t1_compute / N  +  psum_bytes(N) / link_bw

    with every input STATED in the returned record, the link's source
    included (``ici_bw_source``: the ``telemetry.cost.LINK_BW_BYTES`` row
    of ``device_kind``, default the first card, or "caller"), so one
    measured run confirms the prediction or refutes an input."""
    from ..telemetry.cost import ici_bandwidth_entry
    if ici_bw is None:
        source, ici_bw = ici_bandwidth_entry(device_kind)
    else:
        source = "caller"
    psum = psum_bytes_per_step(grad_bytes, n)
    compute_s = float(t1_step_s) / max(1, int(n))
    comm_s = psum / float(ici_bw) if ici_bw else 0.0
    return {
        "n": int(n),
        "predicted_step_s": compute_s + comm_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "inputs": {
            "t1_step_s": float(t1_step_s),
            "grad_bytes": float(grad_bytes),
            "psum_bytes_per_step": psum,
            "ici_bw_bytes_per_s": float(ici_bw),
            "ici_bw_source": source,
        },
    }
