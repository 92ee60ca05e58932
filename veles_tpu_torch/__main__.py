"""CLI entry: ``python -m veles_tpu_torch MODEL.py [CONFIG] [root.x.y=v
...] [flags]`` (counterpart of ``veles_tpu/__main__.py``).

argv → config → model import → :class:`~veles_tpu_torch.launcher.
Launcher` → train, resume or serve → results. The model file defines
either ``build_workflow()`` or the reference's ``run(load, main)``
protocol, where the module calls ``load(WorkflowClass, **kw)`` to build
the workflow and ``main(**kw)`` to run it. Config layering: the CONFIG
file, then the ``root.x.y=v`` overrides, then both again after the
model's import (a model may set keys when it is imported). The run
happens on the CUDA card unless ``--backend cpu`` is given; without a
card ``--backend auto`` fails.

Subcommands: ``trace export|self-time``, ``blackbox dump|inspect``,
``faults list``, ``quantize SNAPSHOT [--out PATH] [--granularity G]``,
``export serve-artifact MODEL.py --out DIR`` and ``linalg bench|solve``;
the reference's others name the ROADMAP item that brings them.
``--elastic`` runs the training in generations
(``resilience/elastic.py``).
"""

from __future__ import annotations

import logging
import sys

from .cmdline import (apply_config_overrides, make_parser, parse_args,
                      parse_mesh, refuse_unported)
from .config import root
from .error import VelesError
from .import_file import import_file_as_module
from .launcher import Launcher
from .logger import setup_logging

#: the reference's subcommands that are not ported, with their items
REFUSED_SUBCOMMANDS = {
    "metrics": "11", "watch": "11", "alerts": "11", "route": "11",
    "loadgen": "11",
}


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in REFUSED_SUBCOMMANDS:
        raise VelesError(
            "the %r subcommand is not ported yet (ROADMAP Queue 1 item %s)"
            % (argv[0], REFUSED_SUBCOMMANDS[argv[0]]))
    if argv and argv[0] == "trace":
        return _trace_cli(argv[1:])
    if argv and argv[0] == "faults":
        return _faults_cli(argv[1:])
    if argv and argv[0] == "blackbox":
        return _blackbox_cli(argv[1:])
    if argv and argv[0] == "quantize":
        return _quantize_cli(argv[1:])
    if argv and argv[0] == "export":
        return _export_cli(argv[1:])
    if argv and argv[0] == "linalg":
        return _linalg_cli(argv[1:])
    parser = make_parser()
    args = parse_args(parser, argv)
    if args.serve_draft_snapshot and not args.serve_draft:
        parser.error("--serve-draft-snapshot needs --serve-draft")
    if args.serve_draft and args.serve_generate is None:
        parser.error("--serve-draft needs --serve-generate")
    refuse_unported(args)
    serving = root.common.serving
    for key, value in (("engine", args.serve_engine),
                       ("max_slots", args.serve_slots),
                       ("buckets", args.serve_buckets),
                       ("max_context", args.serve_max_context),
                       ("page_size", args.serve_page_size),
                       ("pages", args.serve_pages),
                       ("spec_gamma", args.serve_spec_gamma),
                       ("beam_width", args.serve_beam_width),
                       ("drain_grace", args.serve_drain_grace)):
        if value is not None:
            setattr(serving, key, value)
    for key, value in (("stream", args.serve_stream),
                       ("qos", args.serve_qos),
                       ("drain_handoff", args.serve_drain_handoff),
                       ("state_cache", args.serve_state_cache)):
        if value is not None:
            setattr(serving, key, value == "on")
    # int8 serving: the flags arm the config tree, which the engine that
    # --serve-generate builds reads
    if args.quant_weights:
        root.common.quant.weights = True
    if args.quant_kv:
        root.common.quant.kv = True
    if args.serve_artifact:
        serving.artifact = args.serve_artifact
    level = (logging.WARNING, logging.INFO,
             logging.DEBUG)[min(args.verbose, 2)]
    setup_logging(level=level, tracefile=args.trace_file)
    if args.trace_file:
        # telemetry spans stream into the same JSONL file as the
        # logger's events; `trace export` picks out the spans
        from .telemetry.spans import recorder
        recorder.set_sink(args.trace_file)
    if args.debug:
        from .logger import enable_debug
        enable_debug(args.debug)

    # a bare root.x=y in the config position is an override, not a file
    if args.config and "=" in args.config:
        args.config_list.insert(0, args.config)
        args.config = None
    if args.config:
        root.update_from_file(args.config)
    if args.config_list:
        apply_config_overrides(root, args.config_list)
    if args.force_numpy:
        root.common.engine.force_numpy = True
    if args.mixed_precision:
        root.common.engine.mixed_precision = True
    if args.job_timeout:
        root.common.job_timeout = args.job_timeout
    if args.snapshot_dir:
        root.common.dirs.snapshots = args.snapshot_dir
    if args.blackbox:
        root.common.telemetry.recorder.autodump = True
    if args.tensormon or args.nan_policy:
        # the model-health taps (telemetry/tensormon.py); --nan-policy
        # implies them
        root.common.telemetry.tensormon.enabled = True
        if args.nan_policy:
            root.common.telemetry.tensormon.nan_policy = args.nan_policy
    if args.dump_config:
        root.print_()
        return 0

    if args.slave_death_probability:
        root.common.slave_death_probability = args.slave_death_probability
    if args.elastic:
        # the elastic generation controller (resilience/elastic.py): a
        # host loss ends a generation, not the run
        root.common.resilience.elastic.enabled = True
    launcher = Launcher(
        backend=args.backend,
        mesh=parse_mesh(args.mesh) if args.mesh else None,
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, random_seed=args.random_seed,
        test_mode=args.test, profile_dir=args.profile_dir)
    module = import_file_as_module(args.model)
    # the user's file and overrides win over the model's import-time
    # defaults: apply both again, in layering order
    if args.config:
        root.update_from_file(args.config)
    if args.config_list:
        apply_config_overrides(root, args.config_list)
    _materialize()

    if hasattr(module, "run"):
        state = {}

        def load(workflow_cls, **kwargs):
            state["workflow"] = workflow_cls(**kwargs)
            return state["workflow"], bool(args.snapshot)

        def main_(**kwargs):
            return _drive(launcher, state["workflow"], args)
        module.run(load, main_)
        return 0
    if hasattr(module, "build_workflow"):
        _drive(launcher, module.build_workflow(), args)
        return 0
    raise VelesError("%s defines neither build_workflow() nor run(load, "
                     "main)" % args.model)


def _materialize() -> None:
    """Collapse Range/Tuneable markers to their defaults: a plain run
    works with an optimize-ready config."""
    from .genetics.config import materialize_defaults
    n = materialize_defaults(root)
    if n:
        logging.getLogger("veles_tpu_torch").info(
            "collapsed %d Range marker(s) to defaults (no --optimize)", n)


def _drive(launcher: Launcher, workflow, args):
    launcher.initialize(workflow)
    if args.snapshot:
        launcher.resume(args.snapshot)
    elif args.snapshot_dir:
        # rerunning the same command after a crash resumes from the
        # newest valid snapshot
        launcher.try_restore_latest()
    if args.workflow_graph:
        with open(args.workflow_graph, "w") as fout:
            fout.write(workflow.generate_graph())
        launcher.info("workflow graph → %s", args.workflow_graph)
        return None
    if args.dry_run:
        launcher.info("dry run: initialize OK (%d units)", len(workflow))
        return None
    if args.serve_generate is not None:
        return _serve(launcher, workflow, args)
    from .resilience import elastic
    results = (launcher.run_elastic() if elastic.enabled()
               else launcher.run())
    if args.timings:
        launcher.print_stats()
    if args.result_file:
        launcher.write_results(results, args.result_file)
    for key, value in sorted(results.items()):
        if not isinstance(value, dict):
            launcher.info("result %s = %s", key, value)
    try:
        import resource
        # ru_maxrss is KiB on Linux, bytes on Darwin
        div = 1024.0 * 1024.0 if sys.platform == "darwin" else 1024.0
        launcher.info("max RSS: %.1f MiB", resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / div)
    except ImportError:         # no resource module (Windows)
        pass
    if launcher.interrupted:
        sys.exit(130)   # Ctrl-C must not look like a completed run
    return results


def _serve(launcher: Launcher, workflow, args) -> None:
    """``--serve-generate PORT``: the workflow's generation stack behind
    ``GenerationAPI`` on the launcher's device until SIGINT (stop) or
    SIGTERM (drain, then stop; the drain hands in-flight requests back
    with their progress unless ``--serve-drain-handoff off``). The stack
    is validated first, so a model that cannot generate fails here and
    not at a request.
    ``--serve-draft MODEL_PY`` builds that file's workflow on the same
    device (resumed from ``--serve-draft-snapshot`` when given) as the
    draft of ``mode=speculative``."""
    import signal
    import threading
    from .nn.sampling import split_stack
    from .nn.standard_workflow import forwards_of
    from .restful_api import GenerationAPI
    from .telemetry.recorder import flight
    split_stack(list(workflow.forwards))
    draft = None
    if args.serve_draft:
        draft_wf = import_file_as_module(args.serve_draft,
                                         "veles_draft").build_workflow()
        draft_wf.initialize(device=launcher.device)
        if args.serve_draft_snapshot:
            from .snapshotter import resume
            resume(draft_wf, args.serve_draft_snapshot)
        split_stack(list(draft_wf.forwards))
        draft = forwards_of(draft_wf)
    api = GenerationAPI(forwards_of(workflow), port=args.serve_generate,
                        draft=draft, device=launcher.device,
                        name="serve_generate")
    api.initialize()
    launcher.info("generation serving on http://127.0.0.1:%d/generate — "
                  "Ctrl-C stops, SIGTERM drains", api.port)
    print("SERVING port=%d" % api.port, flush=True)  # scriptable
    term = threading.Event()
    prev_term = signal.signal(signal.SIGTERM, lambda _s, _f: term.set())
    try:
        while not term.wait(1.0):
            pass
        launcher.info("SIGTERM — draining the serving front")
        # --blackbox: the eviction notice writes the flight recorder's
        # ring next to the snapshots, as a training run's SIGTERM does
        flight.crash_dump("SIGTERM")
        api.drain(grace=args.serve_drain_grace)
    except KeyboardInterrupt:
        launcher.info("serving stopped")
    finally:
        api.stop()
        signal.signal(signal.SIGTERM, prev_term)


def _trace_cli(argv) -> int:
    """``trace export RUN.jsonl TRACE.json [--request ID]``: a span JSONL
    stream (``--trace-file``) as Chrome trace_event JSON for Perfetto.
    ``trace self-time TRACE.json[.gz] [--spans RUN.jsonl]``: device
    self-time per stream, and per span name, of a ``torch.profiler``
    Chrome trace. ``trace fleet`` is ROADMAP Queue 1 item 11."""
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch trace",
                                     description="telemetry trace tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    exp = sub.add_parser("export",
                         help="span JSONL -> Chrome trace_event JSON")
    exp.add_argument("jsonl", help="span JSONL (from --trace-file)")
    exp.add_argument("out", help="trace_event JSON to write")
    exp.add_argument("--request", default=None, metavar="ID",
                     help="only the spans of this request_id")
    sub.add_parser("fleet", help="not ported yet (ROADMAP item 11)")
    st = sub.add_parser("self-time",
                        help="device self-time of a profiler trace")
    st.add_argument("trace", help="Chrome trace-event JSON[.gz]")
    st.add_argument("--spans", default=None, metavar="RUN.jsonl",
                    help="span JSONL to attribute device time onto")
    st.add_argument("--top", type=int, default=12, metavar="N",
                    help="print at most N rows per table")
    args, rest = parser.parse_known_args(argv)
    if args.cmd == "fleet":
        raise VelesError("'trace fleet' is not ported yet (ROADMAP Queue 1 "
                         "item 11)")
    if rest:
        parser.error("unrecognized arguments: %s" % " ".join(rest))
    if args.cmd == "self-time":
        return _trace_self_time(args)
    from .telemetry import chrome_trace
    try:
        n = chrome_trace.export(args.jsonl, args.out,
                                request_id=args.request)
    except (OSError, ValueError) as e:
        print("trace export failed: %s" % e, file=sys.stderr)
        return 1
    print("exported %d spans%s -> %s (open in Perfetto)"
          % (n, " for request %s" % args.request if args.request else "",
             args.out))
    return 0


def _trace_self_time(args) -> int:
    from .telemetry import devtime
    try:
        events = devtime.load_trace_events(args.trace)
    except (OSError, ValueError) as e:
        print("trace self-time failed: %s" % e, file=sys.stderr)
        return 1
    st = devtime.device_self_time(events)
    print("device self-time: %.6f s over %d device-stream event(s)"
          % (st["device_time_s"], st["n_events"]))
    if not st["n_events"]:
        print("  (no device streams: a host-only capture)")
    rows = sorted(st["by_stream"].items(), key=lambda kv: -kv[1])
    for label, secs in rows[:max(0, args.top)]:
        print("  %-40s %.6f s" % (label, secs))
    if args.spans:
        from .telemetry.spans import read_jsonl
        try:
            span_records = read_jsonl(args.spans)
        except OSError as e:
            print("trace self-time failed: %s" % e, file=sys.stderr)
            return 1
        per = devtime.attribute_spans(events, span_records)
        print("per-span device self-time (%d span name(s)):" % len(per))
        rows = sorted(per.items(), key=lambda kv: -kv[1]["device_time_s"])
        for name, row in rows[:max(0, args.top)]:
            print("  %-40s %.6f s over %d span(s)"
                  % (name, row["device_time_s"], row["spans"]))
    return 0


def _faults_cli(argv) -> int:
    """``faults list``: the registered fault-injection points and the
    spec armed now."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch faults",
        description="deterministic fault-injection plane")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="print registered injection points")
    parser.parse_args(argv)
    from .resilience import faults
    print("registered injection points (arm via VELES_FAULTS or "
          "root.common.resilience.faults):")
    for name, desc in sorted(faults.list_points().items()):
        print("  %-17s %s" % (name, desc))
    print("clause grammar: point:action[:p=P,after=N,times=N,delay=S,"
          "window=T0:T1]")
    spec = faults.plane.current_spec()
    print("active spec: %s" % (spec or "(none)"))
    return 0


def _quantize_cli(argv) -> int:
    """``quantize SNAPSHOT [--out PATH] [--granularity G]``: offline int8
    quantization of a snapshot (``quant/``): eligible 2-D matmul weights
    become symmetric int8 with float32 scales, about a quarter of their
    bytes. The output is an ordinary snapshot with its manifest:
    ``load_snapshot`` of either package dequantizes it on read, so resume
    and serving work unchanged."""
    import argparse
    import os
    import pickle
    import time
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch quantize",
        description="int8 snapshot quantization")
    parser.add_argument("snapshot", help="snapshot file to quantize")
    parser.add_argument("--out", default=None,
                        help="output path (default: insert .int8 "
                             "before the .pickle extension)")
    parser.add_argument("--granularity", default=None,
                        choices=("per_channel", "per_tensor"),
                        help="scale granularity (default: "
                             "root.common.quant.granularity)")
    args = parser.parse_args(argv)
    from .quant import quantize_state
    from .resilience import checkpoint_chain as chain_mod
    from .snapshotter import CODECS, load_snapshot
    out = args.out
    if out is None:
        marker = ".pickle"
        if marker not in args.snapshot:
            parser.error("cannot derive --out from %r (no .pickle "
                         "extension); pass --out" % args.snapshot)
        idx = args.snapshot.rindex(marker)
        out = args.snapshot[:idx] + ".int8" + args.snapshot[idx:]
    try:
        state = load_snapshot(args.snapshot)
        qstate, report = quantize_state(state,
                                        granularity=args.granularity)
    except (OSError, VelesError) as e:
        print("quantize failed: %s" % e, file=sys.stderr)
        return 1
    opener = open
    for op, ext in CODECS.values():
        if ext and out.endswith(ext):
            opener = op
            break
    tmp = out + ".tmp"
    with opener(tmp, "wb") as fout:
        pickle.dump(qstate, fout, protocol=pickle.HIGHEST_PROTOCOL)
    digest = chain_mod.file_sha256(tmp)
    chain_mod.commit_file(tmp, out)
    chain_mod.write_manifest(
        out, sha256=digest, prefix="quantize", runs=0,
        created=time.time(),
        checksum=qstate.get("__meta__", {}).get("checksum", ""))
    out_size = os.path.getsize(out)
    granularity = qstate["__meta__"]["quant"]["granularity"]
    try:
        in_size = os.path.getsize(args.snapshot)
    except OSError:
        # a sqlite:// source has no file size to compare
        in_size = None
    if in_size is None:
        print("quantized %d tensor(s) (%s): %s -> %s (%.1f KiB)"
              % (report["params"], granularity, args.snapshot, out,
                 out_size / 1024))
    else:
        print("quantized %d tensor(s) (%s): %s (%.1f KiB) -> %s (%.1f "
              "KiB, %.2fx)"
              % (report["params"], granularity, args.snapshot,
                 in_size / 1024, out, out_size / 1024,
                 in_size / max(1, out_size)))
    return 0


def _linalg_cli(argv) -> int:
    """``linalg bench|solve`` — the blocked linear-algebra family
    (``linalg/``) from the command line, on the card unless
    ``VELES_BACKEND=cpu``.

    ``bench`` runs the blocked kernels (block-cyclic SUMMA matmul, the
    right-looking Cholesky solve) over the mesh, checks each against the
    dense float64 ``numpy.linalg`` reference within the stated dtype
    tolerance, and prints one JSON line with the relative errors, the
    MFU graded against the dtype's peak and the stated SUMMA step-time
    prediction. ``solve`` runs conjugate gradient on the 5-point Poisson
    model problem as a Workflow graph (``--precondition`` arms the
    2-level multigrid V-cycle) and prints the residual story.

    The mesh's points are processes: a grid larger than 1×1 is a job of
    ``--num-processes`` ranks joined at ``--coordinator``, each started
    with its ``--process-id``; only rank 0 prints the report."""
    import argparse
    import json as _json
    import time as _time
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch linalg",
        description="distributed linear-algebra workloads")
    sub = parser.add_subparsers(dest="cmd", required=True)
    bench = sub.add_parser(
        "bench", help="blocked kernels vs the dense reference + MFU")
    bench.add_argument("--m", type=int, default=512)
    bench.add_argument("--k", type=int, default=512)
    bench.add_argument("--n", type=int, default=512)
    bench.add_argument("--cholesky", type=int, default=256,
                       metavar="N",
                       help="SPD factor/solve size (0 skips it)")
    bench.add_argument("--block", type=int, default=None,
                       help="block size (default linalg.DEFAULT_BLOCK)")
    bench.add_argument("--grid", default=None, metavar="PRxPC",
                       help="process grid, e.g. 1x2 (default: squarest "
                            "factorization of the processes)")
    bench.add_argument("--dtype", default="float32",
                       choices=("float32", "float64"),
                       help="computation dtype (grades MFU against "
                            "the matching peak table)")
    bench.add_argument("--seed", type=int, default=0)
    solve = sub.add_parser(
        "solve", help="CG on the Poisson problem as a Workflow graph")
    solve.add_argument("--n", type=int, default=64, metavar="N",
                       help="interior grid side (N^2 unknowns)")
    solve.add_argument("--tol", type=float, default=1e-6)
    solve.add_argument("--max-iters", type=int, default=500)
    solve.add_argument("--precondition", action="store_true",
                       help="2-level multigrid V-cycle preconditioner "
                            "(needs even --n)")
    solve.add_argument("--grid", default=None, metavar="PRxPC")
    solve.add_argument("--block", type=int, default=None)
    solve.add_argument("--seed", type=int, default=0)
    solve.add_argument("--json", default=None, metavar="PATH",
                       help="write {iterations, residual, history} "
                            "as JSON")
    for p in (bench, solve):
        p.add_argument("--coordinator", default=None,
                       metavar="HOST:PORT",
                       help="multi-process job: rank 0 serves the TCP "
                            "store here")
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    import numpy
    import torch
    from .backends import device_for_backend
    from .linalg import (DEFAULT_BLOCK, LinalgError, TwoLevelPoisson,
                         blocked_matmul, build_cg_workflow,
                         cholesky_solve, default_tolerance,
                         linalg_mesh, poisson2d_matvec,
                         predict_summa_time)
    from .parallel import distributed
    grid = None
    if args.grid:
        try:
            pr, _, pc = args.grid.lower().partition("x")
            grid = (int(pr), int(pc))
        except ValueError:
            parser.error("--grid wants PRxPC, e.g. 1x2")
    block = args.block or DEFAULT_BLOCK
    # the device resolves through device_for, which turns TF32 off
    device = device_for_backend(None)
    distributed.initialize_multihost(args.coordinator, args.num_processes,
                                     args.process_id, device=device)
    if distributed.backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = linalg_mesh(grid)
        if not mesh.member:
            return 0            # a rank past a smaller grid idles
        report = distributed.is_coordinator()

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        rng = numpy.random.RandomState(args.seed)
        if args.cmd == "solve":
            rhs = rng.standard_normal(args.n * args.n).astype(
                numpy.float32)
            precond = None
            if args.precondition:
                precond = TwoLevelPoisson(args.n, block=block, mesh=mesh,
                                          device=device)
            wf = build_cg_workflow(poisson2d_matvec(args.n), rhs,
                                   tol=args.tol, max_iters=args.max_iters,
                                   preconditioner=precond, device=device)
            wf.initialize()
            t0 = _time.perf_counter()
            try:
                wf.run()
            except LinalgError as e:
                print("linalg solve FAILED verification: %s" % e,
                      file=sys.stderr)
                return 1
            sync()
            solve_s = _time.perf_counter() - t0
            res = wf.cg_decision.get_metric_values()
            res["solve_s"] = solve_s
            res["setup_s"] = precond.setup_s if precond else 0.0
            if not report:
                return 0 if res["converged"] else 1
            print("poisson %dx%d (%d unknowns)%s: %s in %d iteration(s), "
                  "recurrence residual %.3e, verified true residual %s"
                  % (args.n, args.n, args.n * args.n,
                     " + multigrid V-cycle" if precond else "",
                     "converged" if res["converged"] else
                     "DID NOT CONVERGE", res["iterations"],
                     res["residual"],
                     "%.3e" % res["true_residual"]
                     if res["true_residual"] is not None else "(skipped)"))
            print("  solve %.6f s, multigrid set-up %.6f s on %s"
                  % (solve_s, res["setup_s"], device))
            history = res["residual_history"]
            for i in range(0, len(history),
                           max(1, len(history) // 10) or 1):
                print("  iter %-4d residual %.3e" % (i, history[i]))
            if args.json:
                with open(args.json, "w") as fh:
                    _json.dump(res, fh, indent=2, sort_keys=True)
                print("report written: %s" % args.json)
            return 0 if res["converged"] else 1
        # bench
        from .telemetry.cost import peak_flops_entry
        dtype = numpy.dtype(args.dtype)
        tol = default_tolerance(dtype)
        a = rng.standard_normal((args.m, args.k)).astype(dtype)
        b = rng.standard_normal((args.k, args.n)).astype(dtype)
        a_t = torch.as_tensor(a, device=device)
        b_t = torch.as_tensor(b, device=device)
        c = blocked_matmul(a_t, b_t, block=block, mesh=mesh).cpu().numpy()
        ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
        mm_err = float(numpy.linalg.norm(c - ref) / numpy.linalg.norm(ref))
        del c, ref
        sync()
        t0 = _time.perf_counter()
        blocked_matmul(a_t, b_t, block=block, mesh=mesh)
        sync()
        step_s = max(_time.perf_counter() - t0, 1e-9)
        del a_t, b_t
        peak_source, peak = peak_flops_entry(dtype)
        pgrid = (mesh.axis_size("rows"), mesh.axis_size("cols"))
        out = {
            "grid": "%dx%d" % pgrid,
            "dtype": args.dtype,
            "block": block,
            "matmul": {"m": args.m, "k": args.k, "n": args.n,
                       "rel_err": mm_err, "tolerance": tol,
                       "step_s": step_s,
                       "mfu": (2.0 * args.m * args.n * args.k)
                       / (step_s * peak * mesh.size)},
            "peak_flops_used": peak,
            "peak_source": peak_source,
            "predicted": predict_summa_time(args.m, args.k, args.n, pgrid,
                                            t1_step_s=step_s, dtype=dtype),
        }
        failed = not mm_err < tol
        if args.cholesky:
            g = rng.standard_normal((args.cholesky,
                                     args.cholesky)).astype(dtype)
            spd = g @ g.T + args.cholesky * numpy.eye(args.cholesky,
                                                      dtype=dtype)
            rhs = rng.standard_normal((args.cholesky, 1)).astype(dtype)
            try:
                sync()
                t0 = _time.perf_counter()
                x = cholesky_solve(spd, rhs, block=block, mesh=mesh,
                                   check=True, device=device)
                sync()
                solve_s = _time.perf_counter() - t0
                x = x.cpu().numpy()
                xref = numpy.linalg.solve(spd.astype(numpy.float64),
                                          rhs.astype(numpy.float64))
                ch_err = float(numpy.linalg.norm(x - xref)
                               / numpy.linalg.norm(xref))
                out["cholesky"] = {"n": args.cholesky, "rel_err": ch_err,
                                   "tolerance": tol, "solve_s": solve_s}
                failed = failed or not ch_err < tol
            except LinalgError as e:
                out["cholesky"] = {"n": args.cholesky, "error": str(e)}
                failed = True
        if report:
            print(_json.dumps(out))
            if failed:
                print("linalg bench FAILED the dense-reference tolerance",
                      file=sys.stderr)
        return 1 if failed else 0
    finally:
        distributed.shutdown()


def _export_cli(argv) -> int:
    """``export serve-artifact MODEL.py --out DIR [--snapshot S] [-b
    cuda|cpu] [--serve-* knobs] [--quant-weights] [--quant-kv]``: build
    the model (resumed from a snapshot when given) on the backend's
    device and export the serving engine's programs there as
    ``torch.export`` programs (``export/serve_artifact.py``): the paged
    engine's prefill a bucket and decode step, or a recurrent stack's
    chunk scan and decode tile. Serve it with ``--serve-artifact DIR``
    and the same knobs."""
    import argparse
    import json
    import os
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch export",
        description="ahead-of-time export of the serving programs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    exp = sub.add_parser("serve-artifact",
                         help="export the serving engine's programs")
    exp.add_argument("model", help="workflow .py (build_workflow())")
    exp.add_argument("--out", required=True,
                     help="artifact package directory to write")
    exp.add_argument("--snapshot", default=None,
                     help="resume this snapshot before exporting")
    exp.add_argument("-b", "--backend", default=None,
                     help="auto | gpu | cuda[:N] (the card) or cpu: the "
                          "device the programs are traced for")
    exp.add_argument("--serve-slots", type=int, default=None)
    exp.add_argument("--serve-buckets", default=None, metavar="L1,L2,...")
    exp.add_argument("--serve-max-context", type=int, default=None)
    exp.add_argument("--serve-decode-block", type=int, default=None)
    exp.add_argument("--serve-page-size", type=int, default=None)
    exp.add_argument("--serve-pages", type=int, default=None)
    exp.add_argument("--quant-weights", action="store_true")
    exp.add_argument("--quant-kv", action="store_true")
    args = parser.parse_args(argv)
    if args.quant_weights:
        root.common.quant.weights = True
    if args.quant_kv:
        root.common.quant.kv = True
    from .backends import device_for
    from .export.serve_artifact import export_serve_artifact
    module = import_file_as_module(args.model)
    if not hasattr(module, "build_workflow"):
        raise VelesError("%s defines no build_workflow()" % args.model)
    workflow = module.build_workflow()
    device = device_for(args.backend)
    workflow.initialize(device=device)
    if args.snapshot:
        from .snapshotter import resume
        resume(workflow, args.snapshot)
    path = export_serve_artifact(
        workflow, args.out, max_slots=args.serve_slots,
        buckets=args.serve_buckets, max_context=args.serve_max_context,
        decode_block=args.serve_decode_block,
        page_size=args.serve_page_size, pages=args.serve_pages,
        device=device)
    with open(os.path.join(path, "contents.json")) as fin:
        serving = json.load(fin)["serving"]
    print("serve-artifact -> %s (%d programs: %s; serve with "
          "--serve-artifact %s)"
          % (path, len(serving["programs"]),
             ", ".join(sorted(serving["programs"])), path))
    print("export seconds: %s" % json.dumps(serving["export_seconds"],
                                             sort_keys=True), flush=True)
    return 0


def _blackbox_cli(argv) -> int:
    """``blackbox dump [--out PATH]``: this process's flight-recorder
    ring to a file; ``blackbox inspect PATH``: summarise a dump."""
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch blackbox",
                                     description="flight-recorder black box")
    sub = parser.add_subparsers(dest="cmd", required=True)
    dmp = sub.add_parser("dump", help="dump this process's ring")
    dmp.add_argument("--out", default=None,
                     help="output path (default: blackbox-<ts>.jsonl in "
                          "the snapshot directory)")
    dmp.add_argument("--reason", default="cli dump")
    ins = sub.add_parser("inspect", help="summarize a blackbox-*.jsonl dump")
    ins.add_argument("path")
    ins.add_argument("--tail", type=int, default=10, metavar="N",
                     help="also print the last N events")
    ins.add_argument("--request", default=None, metavar="ID",
                     help="only events tagged with this request_id or "
                          "trace_id")
    args = parser.parse_args(argv)
    from .telemetry.recorder import (flight, inspect, matches_request,
                                     read_blackbox)
    if args.cmd == "dump":
        try:
            path = flight.dump(args.reason, path=args.out)
        except OSError as e:
            print("blackbox dump failed: %s" % e, file=sys.stderr)
            return 1
        print("black box -> %s (%d events)"
              % (path, flight.stats()["buffered"]))
        return 0
    try:
        summary = inspect(args.path, request=args.request)
    except OSError as e:
        print("blackbox inspect failed: %s" % e, file=sys.stderr)
        return 1
    print("black box %s" % summary["path"])
    print("  reason:  %s" % summary["reason"])
    print("  pid:     %s" % summary["pid"])
    if args.request:
        print("  request: %s (%d of %d events)"
              % (args.request, summary["events"], summary["events_total"]))
    print("  events:  %d over %.3fs"
          % (summary["events"], summary["span_seconds"]))
    for kind, count in sorted(summary["by_kind"].items(),
                              key=lambda kv: -kv[1]):
        print("  %-12s %d" % (kind, count))
    if args.tail > 0:
        _, events = read_blackbox(args.path)
        if args.request:
            events = [e for e in events if matches_request(e, args.request)]
        for rec in events[-args.tail:]:
            label = rec.get("name") or rec.get("counter") or ""
            extra = ""
            if rec.get("request_id"):
                extra = " %s attempt=%s %s" % (
                    rec.get("request_id"), rec.get("attempt", "?"),
                    rec.get("phase") or rec.get("outcome") or "")
            print("  tail: %-10s %s%s" % (rec.get("kind", "?"), label,
                                          extra))
    return 0


if __name__ == "__main__":
    sys.exit(main())
