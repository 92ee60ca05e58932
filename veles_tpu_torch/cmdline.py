"""Command-line surface (counterpart of ``veles_tpu/cmdline.py``).

:func:`make_parser` accepts every flag of the reference with the same
``dest`` and default, so a reference command line parses unchanged.
A flag whose plane the port has not ported yet is refused after parsing
and before the model file is imported (:func:`refuse_unported`), with a
:class:`~veles_tpu_torch.error.VelesError` that names the ROADMAP item
that brings it.
"""

from __future__ import annotations

import argparse

from .error import VelesError

#: the planes not ported yet and the ROADMAP Queue 1 item of each
ITEMS = {
    "4.1": "prefix sharing and chunked prefill",
    "4.6": "tensor-parallel serving",
    "10": "distribution",
    "11": "the framework-agnostic planes",
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="PyTorch/CUDA port of veles_tpu: train, resume or "
                    "serve a workflow .py file on the CUDA card")
    p.add_argument("model", help="workflow .py file (defines "
                   "build_workflow() or run(load, main))")
    p.add_argument("config", nargs="?", default=None,
                   help="optional config .py/.json applied to root")
    p.add_argument("config_list", nargs="*", default=[],
                   help="inline overrides root.x.y=value")
    p.add_argument("-b", "--backend", default=None,
                   help="auto | gpu | cuda[:N] (the card) or cpu | numpy "
                        "(the host); default root.common.engine.backend")
    p.add_argument("--mesh", default=None,
                   help="mesh spec, e.g. data=2,sequence=2 (one process "
                        "a mesh point; default root.common.mesh.axes)")
    p.add_argument("-s", "--snapshot", default=None,
                   help="resume from snapshot file")
    p.add_argument("--snapshot-dir", default=None,
                   help="snapshot directory; resumes from its newest "
                        "valid snapshot when one exists")
    p.add_argument("--random-seed", type=int, default=None)
    p.add_argument("--test", action="store_true",
                   help="one evaluation-only pass, no parameter updates")
    p.add_argument("--result-file", default=None,
                   help="write gathered metrics JSON here")
    p.add_argument("--workflow-graph", default=None,
                   help="write the control graph DOT file and exit "
                        "after initialize")
    p.add_argument("--dump-config", action="store_true")
    p.add_argument("--dry-run", action="store_true",
                   help="build + initialize only")
    p.add_argument("--timings", action="store_true",
                   help="print the per-unit timing table at exit")
    p.add_argument("--trace-file", default=None,
                   help="append events and telemetry spans as JSON "
                        "lines here")
    p.add_argument("--tensormon", action="store_true",
                   help="model-health taps on the train step (gradient "
                        "norm, update ratios, NaN/Inf counts, activation "
                        "saturation): accumulated on the device, drained "
                        "with the epoch metrics, served as veles_model_* "
                        "gauges (root.common.telemetry.tensormon)")
    p.add_argument("--nan-policy", default=None,
                   choices=("warn", "halt", "snapshot_and_halt"),
                   help="NaN sentinel policy (implies --tensormon): warn "
                        "logs and counts; halt marks health unready and "
                        "raises ModelHealthError; snapshot_and_halt first "
                        "commits a snapshot through the checkpoint chain")
    p.add_argument("--blackbox", action="store_true",
                   help="arm flight-recorder autodump: unhandled "
                        "workflow crashes and SIGTERM write "
                        "blackbox-<ts>.jsonl next to the snapshots")
    p.add_argument("--force-numpy", action="store_true",
                   help="the reference's numpy device: the CPU here")
    p.add_argument("--mixed-precision", action="store_true",
                   help="bf16 forward/backward over float32 masters "
                        "(root.common.engine.mixed_precision)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--debug", default="", metavar="ClassA,ClassB",
                   help="enable DEBUG for specific unit/class loggers "
                        "('all' lowers the root logger)")
    p.add_argument("--graphics", action="store_true",
                   help="live plots (not ported: item 11)")
    p.add_argument("--plots-dir", default=None,
                   help="plot directory (not ported: item 11)")
    p.add_argument("--status-url", default=None,
                   help="web-status beacons (not ported: item 11)")
    p.add_argument("--status-interval", type=float, default=10.0,
                   help="beacon period in seconds")
    p.add_argument("--serve-generate", type=int, default=None,
                   metavar="PORT",
                   help="after initialize (and optional snapshot "
                        "resume), serve the workflow's generation stack "
                        "over HTTP instead of training; 0 picks a free "
                        "port; Ctrl-C stops, SIGTERM drains")
    p.add_argument("--serve-drain-grace", type=float, default=None,
                   metavar="SEC",
                   help="seconds a SIGTERM drain waits for in-flight "
                        "requests (root.common.serving.drain_grace, "
                        "default 30)")
    p.add_argument("--serve-drain-handoff", default=None,
                   choices=("on", "off"),
                   help="drain by handoff (default on): a SIGTERM drain "
                        "answers each in-flight request 503 + its emitted "
                        "tokens as resume at the next step boundary; "
                        "'off' waits out the grace "
                        "(root.common.serving.drain_handoff)")
    p.add_argument("--serve-engine", default=None,
                   choices=("continuous", "recurrent", "window"),
                   help="decode plane under --serve-generate "
                        "(root.common.serving.engine)")
    p.add_argument("--serve-slots", type=int, default=None, metavar="N",
                   help="slot rows of the continuous engine "
                        "(root.common.serving.max_slots)")
    p.add_argument("--serve-buckets", default=None, metavar="L1,L2,...",
                   help="prefill pad-to lengths "
                        "(root.common.serving.buckets)")
    p.add_argument("--serve-max-context", type=int, default=None,
                   metavar="T",
                   help="per-slot KV capacity "
                        "(root.common.serving.max_context)")
    p.add_argument("--serve-page-size", type=int, default=None,
                   metavar="P",
                   help="positions per KV-cache page "
                        "(root.common.serving.page_size)")
    p.add_argument("--serve-pages", type=int, default=None, metavar="N",
                   help="usable pages of the paged KV pool "
                        "(root.common.serving.pages)")
    p.add_argument("--serve-spec-gamma", type=int, default=None,
                   metavar="G",
                   help="draft tokens a speculation round proposes "
                        "(root.common.serving.spec_gamma)")
    p.add_argument("--serve-beam-width", type=int, default=None,
                   metavar="W", help="hypothesis slots of a pooled beam "
                                     "request (root.common.serving."
                                     "beam_width)")
    p.add_argument("--serve-prefix-cache", default=None,
                   choices=("on", "off"),
                   help="prefix-sharing KV cache (on: not ported, 4.1)")
    p.add_argument("--serve-prefill-chunk", type=int, default=None,
                   metavar="C",
                   help="chunked prefill (not ported: 4.1; 0 = "
                        "monolithic, the port's only mode)")
    p.add_argument("--serve-tp", type=int, default=None, metavar="N",
                   help="tensor-parallel serving (N > 1 not ported: "
                        "4.6)")
    p.add_argument("--serve-state-cache", default=None,
                   choices=("on", "off"),
                   help="the O(1)-state lane's state-checkpoint prefix "
                        "cache (root.common.serving.state_cache)")
    p.add_argument("--serve-stream", default=None,
                   choices=("on", "off"),
                   help="SSE token streaming of stream=true requests "
                        "(root.common.serving.stream; off answers them "
                        "buffered)")
    p.add_argument("--serve-qos", default=None,
                   choices=("on", "off"),
                   help="QoS classes (default off; "
                        "root.common.serving.qos): interactive requests "
                        "are admitted past queued batch ones, and batch "
                        "rows are preempted for them at a step boundary "
                        "and resumed without loss")
    p.add_argument("--router-qos", default=None,
                   choices=("on", "off"),
                   help="router admission control (not ported: 11)")
    p.add_argument("--router-slo-ttft-ms", type=float, default=None,
                   metavar="MS", help="router TTFT SLO (not ported: 11)")
    p.add_argument("--serve-artifact", default=None, metavar="DIR",
                   help="serve from this serve artifact's exported "
                        "programs (python -m veles_tpu_torch export "
                        "serve-artifact; root.common.serving.artifact); "
                        "a bad one falls back to live serving, counted")
    p.add_argument("--quant-weights", action="store_true",
                   help="serve with per-channel symmetric int8 decode "
                        "matmul weights, dequantized on read just before "
                        "each product (root.common.quant.weights)")
    p.add_argument("--quant-kv", action="store_true",
                   help="store the serving KV page pool int8 with one "
                        "float32 scale a position (root.common.quant.kv)")
    p.add_argument("--serve-draft", default=None, metavar="MODEL_PY",
                   help="draft model file (build_workflow()) for "
                        "mode=speculative under --serve-generate")
    p.add_argument("--serve-draft-snapshot", default=None,
                   help="snapshot the --serve-draft model resumes from")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process job: rank 0 serves the TCP store "
                        "here")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks of the multi-process job")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--slave-death-probability", type=float, default=0.0,
                   help="fault injection: each train dispatch kills this "
                        "process with this probability")
    p.add_argument("--elastic", action="store_true",
                   help="preemption-tolerant training: on detected "
                        "host loss (heartbeat lapse, join failure, or "
                        "an injected distributed.host_loss fault) the "
                        "run declares a new generation and resumes "
                        "from the newest valid checkpoint instead of "
                        "dying; multi-process survivors exit 43 for "
                        "the respawn plane "
                        "(root.common.resilience.elastic.{enabled,"
                        "min_hosts,generation_timeout,"
                        "max_generations})")
    p.add_argument("--overlap", action="store_true",
                   help="async side-plane (not ported: 11)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   metavar="N", help="loader prefetch (not ported: 11)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run and "
                        "export it as a Chrome trace into this "
                        "directory")
    p.add_argument("--job-timeout", type=float, default=0.0,
                   help="floor (seconds) of the per-dispatch hang "
                        "watchdog; 0 keeps only its mean+3σ threshold")
    p.add_argument("--optimize", default=None, metavar="SIZE[:GENS]",
                   help="GA search (not ported: 11)")
    p.add_argument("--optimize-subprocess", action="store_true")
    p.add_argument("--optimize-workers", type=int, default=1, metavar="W")
    p.add_argument("--trial-devices", type=int, default=0, metavar="D")
    p.add_argument("--optimize-crossover", default="uniform",
                   choices=("uniform", "arithmetic", "geometric",
                            "pointed"))
    p.add_argument("--optimize-selection", default="roulette",
                   choices=("roulette", "random", "tournament"))
    p.add_argument("--ensemble-train", default=None, metavar="N[:RATIO]",
                   help="ensembles (not ported: 11)")
    p.add_argument("--ensemble-test", default=None, metavar="MANIFEST")
    p.add_argument("--ensemble-file", default="ensemble.json")
    p.add_argument("--ensemble-workers", type=int, default=1, metavar="W")
    p.add_argument("--ensemble-member", type=int, default=None,
                   metavar="I")
    return p


def _refused(args):
    """``(flag, item)`` for every flag of ``args`` that asks for a plane
    not ported yet, in parser order."""
    on = ("on",)
    checks = [
        ("--optimize", args.optimize, "11"),
        ("--optimize-subprocess", args.optimize_subprocess, "11"),
        ("--optimize-workers", args.optimize_workers != 1, "11"),
        ("--trial-devices", args.trial_devices, "11"),
        ("--optimize-crossover", args.optimize_crossover != "uniform",
         "11"),
        ("--optimize-selection", args.optimize_selection != "roulette",
         "11"),
        ("--ensemble-train", args.ensemble_train, "11"),
        ("--ensemble-test", args.ensemble_test, "11"),
        ("--ensemble-file", args.ensemble_file != "ensemble.json", "11"),
        ("--ensemble-workers", args.ensemble_workers != 1, "11"),
        ("--ensemble-member", args.ensemble_member is not None, "11"),
        ("--graphics", args.graphics, "11"),
        ("--plots-dir", args.plots_dir, "11"),
        ("--status-url", args.status_url, "11"),
        ("--overlap", args.overlap, "11"),
        ("--prefetch-depth", args.prefetch_depth is not None, "11"),
        ("--router-qos", args.router_qos is not None, "11"),
        ("--router-slo-ttft-ms", args.router_slo_ttft_ms is not None,
         "11"),
        ("--serve-prefix-cache on", args.serve_prefix_cache in on, "4.1"),
        ("--serve-prefill-chunk", bool(args.serve_prefill_chunk), "4.1"),
        ("--serve-tp", (args.serve_tp or 1) > 1, "4.6"),
    ]
    return [(flag, item) for flag, asked, item in checks if asked]


def refuse_unported(args) -> None:
    """Raise a VelesError for the first flag of ``args`` whose plane is
    not ported yet, naming its ROADMAP item."""
    for flag, item in _refused(args):
        raise VelesError("%s is not ported yet (ROADMAP Queue 1 item %s: "
                         "%s)" % (flag, item, ITEMS[item]))


def parse_args(parser: argparse.ArgumentParser, argv):
    """Parse with ``root.x.y=value`` overrides allowed between and after
    the flags (``parse_intermixed_args``); parser shapes that intermixed
    parsing refuses keep the classic behaviour."""
    try:
        return parser.parse_intermixed_args(argv)
    except TypeError:
        return parser.parse_args(argv)


def split_child_argv(extra):
    """Partition forwarded argv into (positional config overrides, flag
    arguments): a child command must group every positional right after
    the model path. Every forwarded flag takes a value (``--backend X``),
    so a flag without ``=`` keeps its next item."""
    positionals, flags = [], []
    it = iter(extra)
    for item in it:
        if item.startswith("-"):
            flags.append(item)
            if "=" not in item:
                try:
                    flags.append(next(it))
                except StopIteration:
                    pass
        else:
            positionals.append(item)
    return positionals, flags


def parse_mesh(spec: str):
    """'data=4,sequence=2' → {'data': 4, 'sequence': 2}; the axes'
    validation is ``backends.make_mesh``'s."""
    out = {}
    for part in spec.split(","):
        name, eq, size = part.partition("=")
        try:
            out[name.strip()] = int(size)
        except ValueError:
            raise VelesError("--mesh %r: %r is not AXIS=SIZE"
                             % (spec, part)) from None
    return out


def apply_config_overrides(root, items):
    """Apply inline ``root.x.y=value`` overrides; a value parses as JSON
    where it can, else stays a string."""
    import json
    for item in items:
        path, eq, value = item.partition("=")
        if not eq:
            raise ValueError("override %r is not of form root.x.y=value"
                             % item)
        parts = path.split(".")
        if parts[0] == "root":
            parts = parts[1:]
        node = root
        for part in parts[:-1]:
            node = getattr(node, part)
        try:
            value = json.loads(value)
        except ValueError:
            pass
        setattr(node, parts[-1], value)
