"""The port's CLI (``python -m veles_tpu_torch``, veles_tpu_torch/
__main__.py, cmdline.py, launcher.py) against the reference's on the CPU.

- the cases of tests/test_cli.py on the port: dry run, a full run with
  its results file, ``--workflow-graph``, an override, ``--dump-config``,
  a bad model, ``--test`` (no updates), the two import-file cases,
  ``--debug`` and the RSS line, ``--serve-generate`` on an LM and its
  refusal of a non-LM, the draft-snapshot check and a config file that
  survives the model's import;
- parity on the same inputs: the parser's every ``dest`` and default,
  ``update_from_file`` / ``apply_config_overrides`` / ``update_from_env``
  / ``print_`` / ``materialize_defaults``, the default trees' shared
  keys, and ``generate_graph`` of one tiny workflow;
- resume through the CLI: the reference's 2-epoch snapshot of a tiny
  softmax chain, continued by the port's ``--snapshot F`` for 2 more
  epochs, follows the reference's own resume (errors atol 1e-5, weights
  rtol 2e-4 / atol 2e-5, tests/test_torch_snapshot.py's limits);
- serving through the CLI: the reference's tiny-LM snapshot served by
  ``--serve-generate 0 --snapshot F`` answers the greedy tokens the
  reference's ``nn.sampling.generate`` gives from it; SIGTERM drains
  and, under ``--blackbox``, dumps the flight recorder;
- ``--snapshot-dir`` auto-resume, ``run(load, main)``, the ``trace``,
  ``blackbox``, ``faults`` and ``quantize`` subcommands, ``--quant-weights``
  and ``--quant-kv`` arming ``root.common.quant``, and every refused flag
  and subcommand naming its ROADMAP item before the model is imported;
  ``--backend auto`` without a card fails with ``device_for``'s message.

Most cases call ``veles_tpu_torch.__main__.main`` in process (and put the
port's ``root`` back after each); four start ``python -m veles_tpu_torch``.
"""
import io
import json
import logging
import os
import select
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import cmdline as ref_cmdline
from veles_tpu import config as ref_config
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.genetics import config as ref_genetics
from veles_tpu.loader import TEST, TRAIN, VALID
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.nn import sampling as ref_sampling
from veles_tpu.nn.beam import beam_generate as ref_beam_generate
from veles_tpu_torch import cmdline, config, prng
from veles_tpu_torch.__main__ import REFUSED_SUBCOMMANDS, main
from veles_tpu_torch.config import root
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.genetics import config as genetics
from veles_tpu_torch.import_file import import_file_as_module
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.telemetry import chrome_trace
from veles_tpu_torch.telemetry.recorder import inspect as recorder_inspect
from veles_tpu_torch.telemetry.spans import recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5

#: the tiny softmax model of tests/test_cli.py, in the port; ``BUILT``
#: keeps every workflow it builds so a test can read its state
TINY_MODEL = textwrap.dedent("""
    import numpy
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
    from veles_tpu_torch.snapshotter import Snapshotter

    BUILT = []

    class L(FullBatchLoader):
        hide_from_registry = True
        def load_data(self):
            rng = numpy.random.RandomState(0)
            self.create_originals(
                rng.rand(120, 6).astype(numpy.float32),
                rng.randint(0, 3, 120).astype(numpy.int32))
            self.class_lengths = [0, 24, 96]

    def build_workflow():
        snap = (Snapshotter(None, prefix="tiny")
                if root.tiny.get("snapshots", False) else None)
        wf = StandardWorkflow(
            name="tiny",
            layers=[{"type": "softmax", "output_sample_shape": 3}],
            loader_unit=L(None, minibatch_size=24, name="l"),
            loss_function="softmax", snapshotter_unit=snap,
            decision_config=dict(max_epochs=root.tiny.get("epochs", 2)))
        BUILT.append(wf)
        return wf
""")

#: tests/test_cli.py's tiny LM (dim 16, one block) in either package
#: (``pkg``); ``build_workflow`` may link a Snapshotter
LM_MODEL = textwrap.dedent("""
    import numpy
    from %(pkg)s.loader import FullBatchLoaderMSE
    from %(pkg)s.nn.standard_workflow import StandardWorkflow

    class L(FullBatchLoaderMSE):
        hide_from_registry = True
        def load_data(self):
            rng = numpy.random.RandomState(0)
            stream = rng.randint(0, 8, 64 * 16 + 1).astype(numpy.int32)
            self.create_originals(
                stream[:-1].reshape(64, 16), None,
                targets=stream[1:].reshape(64, 16))
            self.class_lengths = [0, 16, 48]

    def build_workflow(snapshotter_unit=None):
        return StandardWorkflow(
            name="srv-lm",
            layers=[{"type": "embedding", "vocab_size": 8, "dim": 16},
                    {"type": "transformer_block", "n_heads": 2,
                     "ffn_hidden": 32, "causal": True, "rope": True},
                    {"type": "lm_head", "vocab_size": 8}],
            loader_unit=L(None, minibatch_size=16, name="l"),
            loss_function="softmax_seq", snapshotter_unit=snapshotter_unit,
            decision_config=dict(max_epochs=1))
""")


# -- helpers ---------------------------------------------------------------
def _snapshot_tree(node):
    """{key: (value, subtree or None)} of a Config node, recursively."""
    return {k: (v, _snapshot_tree(v) if isinstance(v, config.Config)
                else None) for k, v in node.items()}


def _restore_tree(node, snap):
    """Put ``node`` back to ``snap`` in place: nodes keep their identity
    (modules cache config nodes), keys added since go."""
    for k, _ in list(node.items()):
        if k not in snap:
            object.__delattr__(node, k)
    for k, (value, sub) in snap.items():
        object.__setattr__(node, k, value)
        if sub is not None:
            _restore_tree(value, sub)


@pytest.fixture(autouse=True)
def port_root():
    """Every in-process ``main`` call layers config into the process-wide
    ``root``; restore it, the span sink and the Launcher logger after."""
    snap = _snapshot_tree(root)
    try:
        yield root
    finally:
        _restore_tree(root, snap)
        recorder.set_sink(None)
        logging.getLogger("Launcher").setLevel(logging.NOTSET)


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "tiny_model.py"
    path.write_text(TINY_MODEL)
    return str(path)


def _built(path):
    return sys.modules["veles_model_" + os.path.splitext(
        os.path.basename(path))[0]].BUILT[-1]


def _cpu(*argv):
    return main([*argv, "--backend", "cpu"])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def run_cli(*argv, timeout=120):
    """``python -m veles_tpu_torch ARGV`` (no backend added)."""
    return subprocess.run([sys.executable, "-m", "veles_tpu_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=_env())


def fresh_prng():
    with prng._lock:
        prng._generators.clear()
    prng.seed_all(1234)


def fresh_ref_prng():
    with ref_prng._lock:
        ref_prng._generators.clear()
    ref_prng.seed_all(1234)


# -- tests/test_cli.py on the port -----------------------------------------
def test_cli_dry_run(tiny_model):
    r = run_cli(tiny_model, "--dry-run", "-v", "--backend", "cpu")
    assert r.returncode == 0, r.stderr
    assert "dry run: initialize OK" in r.stderr + r.stdout
    assert "initialized tiny on cpu" in r.stderr


def test_cli_full_run_with_results(tiny_model, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    res = tmp_path / "r.json"
    assert _cpu(tiny_model, "--result-file", str(res), "-v") == 0
    data = json.loads(res.read_text())
    assert data["epochs"] == 2
    assert "best_err" in data and isinstance(data["best_err"], float)
    assert len(data["err_history"]["validation"]) == 2
    assert "result epochs = 2" in caplog.text


def test_cli_workflow_graph(tiny_model, tmp_path):
    dot = tmp_path / "g.dot"
    assert _cpu(tiny_model, "--workflow-graph", str(dot)) == 0
    text = dot.read_text()
    assert "digraph" in text and '"Repeater" -> "l";' in text
    assert _built(tiny_model).decision.epoch_number == 0   # nothing ran


def test_cli_config_override(tiny_model):
    assert _cpu(tiny_model, "root.common.trace.run=true",
                "root.tiny.epochs=3", "--dry-run", "-v") == 0
    assert root.common.trace.run is True
    assert _built(tiny_model).decision.max_epochs == 3


def test_cli_dump_config(tiny_model, capsys):
    assert _cpu(tiny_model, "root.common.engine.backend=\"cpu\"",
                "--dump-config") == 0
    out = capsys.readouterr().out
    assert "engine:" in out and "    backend: 'cpu'" in out
    buf = io.StringIO()
    root.print_(file=buf)
    assert out == buf.getvalue()


def test_cli_bad_model(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(VelesError, match="build_workflow"):
        _cpu(str(bad), "--dry-run")


def test_cli_test_mode_no_updates(tiny_model, tmp_path):
    """--test runs one evaluation pass without changing the params."""
    res = tmp_path / "t.json"
    assert _cpu(tiny_model, "--test", "--result-file", str(res),
                "--random-seed", "7") == 0
    tested = _built(tiny_model)
    assert json.loads(res.read_text())["epochs"] == 1
    assert _cpu(tiny_model, "--dry-run", "--random-seed", "7") == 0
    fresh = _built(tiny_model)
    for name, tree in fresh.train_step.params.items():
        for key, value in tree.items():
            assert torch.equal(tested.train_step.params[name][key], value)


def test_import_file_does_not_clobber_stdlib(tmp_path):
    p = tmp_path / "json.py"
    p.write_text("VALUE = 42\n")
    m = import_file_as_module(str(p))
    assert m.VALUE == 42
    import json as real_json
    assert hasattr(real_json, "dumps")


def test_import_file_error_cleans_sys_modules(tmp_path):
    p = tmp_path / "broken_model.py"
    p.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(RuntimeError):
        import_file_as_module(str(p))
    assert "veles_model_broken_model" not in sys.modules


def test_debug_flag_and_rss(tiny_model, caplog):
    """--debug Class enables that logger; max RSS logged at exit."""
    from veles_tpu_torch.logger import enable_debug
    enable_debug("SomeUnitClass")
    assert logging.getLogger("SomeUnitClass").level == logging.DEBUG
    logging.getLogger("SomeUnitClass").setLevel(logging.NOTSET)
    caplog.set_level(logging.INFO)
    assert _cpu(tiny_model, "--debug", "Launcher") == 0
    assert logging.getLogger("Launcher").level == logging.DEBUG
    assert "max RSS" in caplog.text


def test_cli_serve_generate_rejects_non_lm(tiny_model):
    with pytest.raises(VelesError, match="cached sampling supports"):
        _cpu(tiny_model, "--serve-generate", "0")


def test_cli_serve_draft_snapshot_requires_draft(tiny_model, capsys):
    with pytest.raises(SystemExit) as err:
        _cpu(tiny_model, "--serve-generate", "0",
             "--serve-draft-snapshot", "x.pickle.gz")
    assert err.value.code != 0
    assert "--serve-draft" in capsys.readouterr().err


def test_cli_config_file_survives_model_import(tmp_path):
    """A config FILE wins over the model's import-time defaults, as
    inline overrides do."""
    model = tmp_path / "m.py"
    model.write_text(textwrap.dedent("""
        from veles_tpu_torch.config import root
        root.t.x = 1                     # import-time default

        class _WF:
            def initialize(self, device=None): pass
            def run(self): pass
            def gather_results(self):
                return {"x": int(root.t.x)}

        def build_workflow():
            return _WF()
    """))
    conf = tmp_path / "conf.py"
    conf.write_text("root.t.x = 2\n")
    rf = tmp_path / "res.json"
    assert _cpu(str(model), str(conf), "--result-file", str(rf)) == 0
    assert json.loads(rf.read_text())["x"] == 2


def test_cli_run_load_main_protocol(tmp_path):
    """The reference's ``run(load, main)`` model contract."""
    model = tmp_path / "proto.py"
    model.write_text(TINY_MODEL + textwrap.dedent("""
        CALLS = []

        def run(load, main):
            wf, restored = load(lambda: build_workflow())
            CALLS.append(restored)
            main()
    """))
    rf = tmp_path / "res.json"
    assert _cpu(str(model), "--result-file", str(rf)) == 0
    assert sys.modules["veles_model_proto"].CALLS == [False]
    assert json.loads(rf.read_text())["epochs"] == 2


def test_cli_range_markers_run_with_their_defaults(tmp_path, caplog):
    """A model file written for ``--optimize`` (Range markers set at
    import) runs with the markers' defaults, as the reference's
    ``_materialize`` does."""
    caplog.set_level(logging.INFO)
    model = tmp_path / "ranged.py"
    model.write_text(TINY_MODEL.replace(
        "BUILT = []",
        "from veles_tpu_torch.genetics import Range\n"
        "root.tiny.epochs = Range(3, 1, 5)\n"
        "BUILT = []"))
    rf = tmp_path / "res.json"
    assert _cpu(str(model), "--result-file", str(rf)) == 0
    assert json.loads(rf.read_text())["epochs"] == 3
    assert root.tiny.epochs == 3
    assert "collapsed 1 Range marker(s) to defaults" in caplog.text


def test_cli_timings_prints_the_unit_table(tiny_model, caplog):
    caplog.set_level(logging.INFO)
    assert _cpu(tiny_model, "--timings") == 0
    assert any("TrainStep" in r.getMessage() and "%" in r.getMessage()
               for r in caplog.records if r.name == "StandardWorkflow")


def test_cli_backend_auto_without_a_card(tiny_model):
    """No hidden CPU: --backend auto (the default) fails without a
    card, with device_for's message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: auto resolves to it")
    r = run_cli(tiny_model, "--dry-run")
    assert r.returncode != 0
    assert "needs a CUDA card and none is available" in r.stderr
    assert "dry run" not in r.stderr


# -- refusals ----------------------------------------------------------------
REFUSED_FLAGS = [
    (["--mesh", "data=2"], "10"), (["--coordinator", "h:1"], "10"),
    (["--num-processes", "2"], "10"), (["--process-id", "0"], "10"),
    (["--elastic"], "10"), (["--slave-death-probability", "0.1"], "10"),
    (["--optimize", "3:1"], "11"), (["--optimize-subprocess"], "11"),
    (["--optimize-workers", "2"], "11"), (["--trial-devices", "2"], "11"),
    (["--optimize-crossover", "pointed"], "11"),
    (["--optimize-selection", "random"], "11"),
    (["--ensemble-train", "2"], "11"), (["--ensemble-test", "m"], "11"),
    (["--ensemble-file", "e.json"], "11"),
    (["--ensemble-workers", "2"], "11"), (["--ensemble-member", "0"], "11"),
    (["--graphics"], "11"), (["--plots-dir", "p"], "11"),
    (["--status-url", "http://h"], "11"), (["--overlap"], "11"),
    (["--prefetch-depth", "2"], "11"), (["--router-qos", "on"], "11"),
    (["--router-slo-ttft-ms", "5"], "11"),
    (["--serve-artifact", "d"], "4.5"),
    (["--serve-prefix-cache", "on"], "4.1"),
    (["--serve-prefill-chunk", "8"], "4.1"), (["--serve-tp", "2"], "4.6"),
]


@pytest.mark.parametrize("flags,item", REFUSED_FLAGS,
                         ids=[" ".join(f) for f, _ in REFUSED_FLAGS])
def test_unported_flag_is_refused_before_the_model_import(tmp_path, flags,
                                                          item):
    model = tmp_path / "never.py"
    model.write_text("raise RuntimeError('imported')\n")
    with pytest.raises(VelesError,
                       match=r"not ported yet \(ROADMAP Queue 1 item %s:"
                       % item.replace(".", r"\.")):
        _cpu(str(model), *flags)


@pytest.mark.parametrize("argv", [[name] for name in REFUSED_SUBCOMMANDS]
                         + [["trace", "fleet", "http://h"]],
                         ids=lambda a: " ".join(a))
def test_unported_subcommand_names_its_item(argv):
    item = REFUSED_SUBCOMMANDS.get(argv[0], "11")
    with pytest.raises(VelesError, match=r"not ported yet \(ROADMAP Queue 1 "
                       r"item %s\)" % item.replace(".", r"\.")):
        main(argv)


def test_ported_off_values_are_accepted(tiny_model):
    """The off/neutral values of refused knobs parse and run."""
    assert _cpu(tiny_model, "--serve-qos", "off", "--serve-stream", "off",
                "--serve-prefix-cache", "off", "--serve-prefill-chunk", "0",
                "--serve-tp", "1", "--serve-drain-handoff", "off",
                "--dry-run") == 0


#: the serving flags of speculative and beam decoding, streaming, the QoS
#: plane, drain by handoff and the O(1)-state lane's cache, each with the ``root.common.serving`` key
#: and value it sets (None: the draft flags, which load a model under
#: --serve-generate)
SERVING_FLAGS = [
    (["--serve-spec-gamma", "3"], "spec_gamma", 3),
    (["--serve-beam-width", "2"], "beam_width", 2),
    (["--serve-stream", "on"], "stream", True),
    (["--serve-stream", "off"], "stream", False),
    (["--serve-qos", "on"], "qos", True),
    (["--serve-qos", "off"], "qos", False),
    (["--serve-drain-handoff", "on"], "drain_handoff", True),
    (["--serve-drain-handoff", "off"], "drain_handoff", False),
    (["--serve-state-cache", "on"], "state_cache", True),
    (["--serve-state-cache", "off"], "state_cache", False),
    (["--serve-generate", "0", "--serve-draft", "d.py",
      "--serve-draft-snapshot", "d.pickle.gz"], None, None),
]


@pytest.mark.parametrize("flags,key,value", SERVING_FLAGS,
                         ids=[" ".join(f) for f, _, _ in SERVING_FLAGS])
def test_serving_flag_is_accepted_and_reaches_root(tiny_model, flags, key,
                                                    value):
    """Each flag parses, is not refused, and sets its knob as the
    reference's ``__main__`` does."""
    assert _cpu(tiny_model, *flags, "--dry-run") == 0
    if key is not None:
        assert root.common.serving.get(key) == value


@pytest.mark.parametrize("flag,key", [("--quant-weights", "weights"),
                                      ("--quant-kv", "kv")])
def test_quant_flag_is_accepted_and_arms_root(tiny_model, flag, key):
    """The int8 serving flags (item 4.4, refused before it was ported)
    parse, are not refused, and arm ``root.common.quant`` as the
    reference's ``__main__`` does; the engine a ``--serve-generate``
    builds reads it."""
    assert not root.common.quant.get(key)
    assert _cpu(tiny_model, flag, "--dry-run") == 0
    assert root.common.quant.get(key) is True


def test_quantize_subcommand_writes_a_verified_int8_snapshot(tmp_path,
                                                             capsys):
    """``quantize SNAPSHOT`` (item 4.4's subcommand, refused before it was
    ported): the ``.int8`` file beside the input, its manifest's SHA-256
    verifying, the eligible weight read back as ``q · s`` and the rest
    as it was; an unreadable path fails with the reference's message
    and exit code 1."""
    import gzip
    import pickle
    from veles_tpu_torch.resilience.checkpoint_chain import verify
    from veles_tpu_torch.snapshotter import load_snapshot
    rng = numpy.random.RandomState(3)
    w = rng.randn(32, 16).astype(numpy.float32)
    b = rng.randn(16).astype(numpy.float32)
    path = str(tmp_path / "t_1.pickle.gz")
    with gzip.open(path, "wb") as fout:
        pickle.dump({"__units__": {"fc": {"weights": w, "bias": b}},
                     "__meta__": {"checksum": "c"}}, fout)
    assert main(["quantize", path]) == 0
    assert "quantized 1 tensor(s) (per_channel)" in capsys.readouterr().out
    out = str(tmp_path / "t_1.int8.pickle.gz")
    assert verify(out) is True
    state = load_snapshot(out)
    assert state["__meta__"]["quant"] == {"granularity": "per_channel",
                                          "params": 1}
    scale = numpy.abs(w).max(axis=0, keepdims=True) / numpy.float32(127)
    got = state["__units__"]["fc"]["weights"]
    assert got.dtype == numpy.float32
    assert numpy.abs(got - w).max() <= scale.max() / 2 + 1e-7
    assert numpy.array_equal(state["__units__"]["fc"]["bias"], b)
    assert main(["quantize", str(tmp_path / "nope.pickle.gz")]) == 1
    assert "quantize failed" in capsys.readouterr().err


def test_refused_serving_flags_still_name_their_items(tmp_path):
    """Prefix sharing and chunked prefill stay refused with item 4.1."""
    model = tmp_path / "never.py"
    model.write_text("raise RuntimeError('imported')\n")
    for flags in (["--serve-prefix-cache", "on"],
                  ["--serve-prefill-chunk", "8"]):
        with pytest.raises(VelesError, match=r"item 4\.1: prefix sharing "
                           r"and chunked prefill\)"):
            _cpu(str(model), *flags)


# -- parity with the reference ---------------------------------------------
def _actions(parser):
    return {a.dest: (a.default, tuple(a.option_strings), a.nargs,
                     a.choices, a.type, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_reference():
    """Every reference flag: same dest, default, spelling, arity, type."""
    assert _actions(cmdline.make_parser()) == \
        _actions(ref_cmdline.make_parser())
    argv = ["m.py", "c.py", "root.a=1", "--backend", "cpu", "root.b=2",
            "-s", "s.gz", "-vv", "--serve-generate", "0"]
    got = vars(cmdline.parse_args(cmdline.make_parser(), argv))
    want = vars(ref_cmdline.parse_args(ref_cmdline.make_parser(), argv))
    assert got == want
    assert cmdline.split_child_argv(["root.a=1", "--backend", "cpu"]) == \
        ref_cmdline.split_child_argv(["root.a=1", "--backend", "cpu"])
    assert cmdline.parse_mesh("data=4,tensor=2") == \
        ref_cmdline.parse_mesh("data=4,tensor=2")


def _printed(node):
    buf = io.StringIO()
    node.print_(file=buf)
    return buf.getvalue()


def test_config_layering_matches_reference(tmp_path, monkeypatch):
    py = tmp_path / "conf.py"
    py.write_text("root.model.lr = 0.1\nroot.model.layers = [4, 'x']\n"
                  "root.common.engine.flash_attention = False\n")
    js = tmp_path / "conf.json"
    js.write_text(json.dumps({"model": {"mb": 32, "tags": {"a": None}},
                              "common": {"dirs": {"cache": "/c"}}}))
    overrides = ["root.model.lr=0.25", "model.name=abc", "root.x.y=[1,2]",
                 "root.x.z={\"k\": true}"]
    monkeypatch.setenv("VELES_TPU_CFG_ENGINE__FORCE_NUMPY", "true")
    monkeypatch.setenv("VELES_TPU_CFG_TRACE__NAME", "run-1")
    trees = []
    for mod, cmd in ((config, cmdline), (ref_config, ref_cmdline)):
        node = mod.Config("root")
        node.update_from_file(str(py)).update_from_file(str(js))
        cmd.apply_config_overrides(node, overrides)
        node.common.update_from_env()
        node.protect("x")
        with pytest.raises(AttributeError, match="protected"):
            node.x = 1
        trees.append((node.as_dict(), _printed(node)))
    assert trees[0] == trees[1]
    assert trees[0][0]["common"]["engine"] == {"flash_attention": False,
                                               "force_numpy": True}
    with pytest.raises(ValueError):
        cmdline.apply_config_overrides(config.Config("root"), ["root.a"])


def test_materialize_defaults_matches_reference():
    counts, trees = [], []
    for cfg, gen in ((config, genetics), (ref_config, ref_genetics)):
        node = cfg.Config("root")
        node.mnist.lr = gen.Range(0.03, 0.001, 0.3)
        node.mnist.hidden = gen.Range(100, 25, 400)
        node.mnist.name = "m"
        node.deep.a.b = gen.Tuneable("t")
        found = gen.find_tuneables(node)
        assert [p for p, *_ in found] == ["root.mnist.lr",
                                          "root.mnist.hidden",
                                          "root.deep.a.b"]
        assert gen.resolve(found[1][3]) == 100 and gen.resolve(3) == 3
        counts.append(gen.materialize_defaults(node))
        trees.append(_printed(node))
    assert counts == [3, 3] and trees[0] == trees[1]
    with pytest.raises(ValueError):
        genetics.Range(5, 0, 1)


def _leaves(text):
    """{dotted path: printed value} of a ``print_`` dump."""
    out, stack = {}, []
    for line in text.splitlines():
        depth = (len(line) - len(line.lstrip(" "))) // 2
        key, _, value = line.strip().partition(": ")
        del stack[depth:]
        if line.rstrip().endswith(":") and not value:
            stack.append(key.rstrip(":"))
        else:
            out[".".join(stack + [key])] = value
    return out


def test_dump_config_matches_reference_on_shared_keys(tiny_model, capsys):
    """--dump-config prints the reference's value for every key both
    default trees have."""
    port = _leaves(_printed(config._default_root()))
    ref = _leaves(_printed(ref_config._default_root()))
    shared = sorted(set(port) & set(ref))
    assert len(shared) >= 25
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert _cpu(tiny_model, "--dump-config") == 0
    printed = _leaves(capsys.readouterr().out)
    assert printed == _leaves(_printed(root))


def _loader_data(self):
    rng = numpy.random.RandomState(0)
    self.create_originals(rng.rand(120, 6).astype(numpy.float32),
                          rng.randint(0, 3, 120).astype(numpy.int32))
    self.class_lengths = [0, 24, 96]


def test_generate_graph_matches_reference():
    """Same nodes and edges for the same tiny workflow, before and after
    initialize (the GD units join at initialize)."""
    graphs = []
    for sw, base in ((StandardWorkflow, FullBatchLoader),
                     (ref_nn.StandardWorkflow, RefFullBatchLoader)):
        loader = type("L", (base,), {"hide_from_registry": True,
                                     "load_data": _loader_data})
        wf = sw(name="tiny", layers=[
                    {"type": "all2all_tanh", "output_sample_shape": 4},
                    {"type": "softmax", "output_sample_shape": 3}],
                loader_unit=loader(None, minibatch_size=24, name="l"),
                loss_function="softmax", decision_config=dict(max_epochs=2))
        before = sorted(wf.generate_graph().splitlines())
        wf.initialize(device="cpu" if sw is StandardWorkflow
                      else vt.XLADevice(mesh_axes={"data": 1}))
        graphs.append((before, sorted(wf.generate_graph().splitlines())))
    assert graphs[0] == graphs[1]
    assert '  "TrainStep" -> "DecisionGD";' in graphs[0][1]


# -- resume through the CLI --------------------------------------------------
RESUME_MODEL = textwrap.dedent("""
    import numpy
    from %(pkg)s.loader import FullBatchLoader
    from %(pkg)s.nn.lr_adjust import exp_decay
    from %(pkg)s.nn.standard_workflow import StandardWorkflow

    BUILT = []

    class TinyLoader(FullBatchLoader):
        hide_from_registry = True
        def load_data(self):
            rng = numpy.random.RandomState(5)
            n = 240
            self.create_originals(rng.rand(n, 8).astype(numpy.float32),
                                  rng.randint(0, 3, n).astype(numpy.int32))
            self.class_lengths = [0, 40, 200]

    def build_workflow(max_epochs=4, snapshotter_unit=None):
        wf = StandardWorkflow(
            name="snap-wf",
            layers=[{"type": "all2all_tanh", "output_sample_shape": 8},
                    {"type": "softmax", "output_sample_shape": 3}],
            loader_unit=TinyLoader(None, minibatch_size=20, name="tiny"),
            loss_function="softmax",
            decision_config=dict(max_epochs=max_epochs,
                                 fail_iterations=99),
            snapshotter_unit=snapshotter_unit, steps_per_dispatch=4,
            lr_schedule=exp_decay(0.9))
        BUILT.append(wf)
        return wf
""")


def _write_model(directory, name, text, pkg):
    path = directory / name
    path.write_text(text % {"pkg": pkg})
    return str(path)


def test_cli_resume_follows_reference(tmp_path):
    """The reference snapshots after 2 epochs; the port's CLI continues
    the file for 2 more, as the reference's own resume does."""
    ref_mod = import_file_as_module(_write_model(
        tmp_path, "ref_resume.py", RESUME_MODEL, "veles_tpu"))
    fresh_ref_prng()
    first = ref_mod.build_workflow(2, vt.Snapshotter(
        None, prefix="tiny", directory=str(tmp_path / "s"),
        compression="gz"))
    first.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    first.run()
    snap = str(tmp_path / "s" / "tiny_current.pickle.gz")
    fresh_ref_prng()
    again = ref_mod.build_workflow(4)
    again.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    vt.resume(again, snap)
    again.decision.complete <<= False
    again.run()

    port_model = _write_model(tmp_path, "port_resume.py", RESUME_MODEL,
                              "veles_tpu_torch")
    fresh_prng()
    rf = tmp_path / "r.json"
    assert _cpu(port_model, "--snapshot", snap, "--result-file",
                str(rf)) == 0
    wf = _built(port_model)
    assert json.loads(rf.read_text())["epochs"] == 4
    for cls in (TRAIN, VALID, TEST):
        numpy.testing.assert_allclose(
            wf.decision.epoch_metrics[cls], again.decision.epoch_metrics[cls],
            atol=METRIC_ATOL, err_msg="set %d" % cls)
    for name, tree in wf.train_step.params.items():
        for key, value in tree.items():
            numpy.testing.assert_allclose(
                value.numpy(), numpy.asarray(again.train_step.params[name][
                    key]), rtol=RTOL, atol=ATOL, err_msg=name + key)


def test_cli_snapshot_dir_auto_resumes(tiny_model, tmp_path, caplog):
    """Rerunning with --snapshot-dir resumes from the newest snapshot
    there; without a Snapshotter linked the launcher warns."""
    caplog.set_level(logging.INFO)
    d = str(tmp_path / "snaps")
    assert _cpu(tiny_model, "--snapshot-dir", d, "root.tiny.snapshots=true",
                "--dry-run") == 0
    assert "auto-resumed" not in caplog.text
    assert _cpu(tiny_model, "--snapshot-dir", d, "root.tiny.snapshots=true",
                "root.tiny.epochs=2") == 0
    assert os.path.islink(os.path.join(d, "tiny_current.pickle.gz"))
    caplog.clear()
    rf = tmp_path / "r.json"
    assert _cpu(tiny_model, "--snapshot-dir", d, "root.tiny.snapshots=true",
                "root.tiny.epochs=3", "--result-file", str(rf)) == 0
    assert "auto-resumed from latest snapshot in %s" % d in caplog.text
    data = json.loads(rf.read_text())
    assert data["epochs"] == 3
    assert len(data["err_history"]["validation"]) == 3
    caplog.clear()
    assert _cpu(tiny_model, "--snapshot-dir", d, "root.tiny.snapshots=false",
                "--dry-run") == 0
    assert "has no Snapshotter unit" in caplog.text


# -- serving through the CLI -------------------------------------------------
def _serve(argv, timeout=120):
    """Start ``python -m veles_tpu_torch ARGV --serve-generate 0``; the
    process, its port (read from the SERVING line) and what it printed
    up to that line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", *argv, "--serve-generate",
         "0", "--backend", "cpu", "-v"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env())
    deadline, buf, head = time.time() + timeout, "", []
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        chunk = os.read(proc.stdout.fileno(), 4096).decode(errors="replace")
        if not chunk:
            break
        buf += chunk
        *lines, buf = buf.split("\n")
        for line in lines:
            if line.startswith("SERVING port="):
                return proc, int(line.split("=", 1)[1]), "\n".join(head)
            head.append(line)
    proc.kill()
    raise AssertionError("no SERVING line:\n" + buf
                         + proc.communicate()[0][-3000:])


def _get(port, path, payload=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_cli_serve_generate(tmp_path):
    """The CLI face of GenerationAPI: serve an untrained LM, answer a
    greedy request over HTTP, stop on SIGINT with exit 0."""
    model = _write_model(tmp_path, "lm_model.py", LM_MODEL,
                         "veles_tpu_torch")
    proc, port, _ = _serve([model])
    try:
        code, out = _get(port, "/generate", {"prompt": [1, 2, 3],
                                             "n_new": 5})
        assert code == 200 and len(out["tokens"]) == 5, out
        assert out["engine"] == "continuous"
        proc.send_signal(signal.SIGINT)
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout[-2000:]
    assert "serving stopped" in stdout


def test_cli_serves_reference_snapshot(tmp_path):
    """The reference trains the tiny LM one epoch and snapshots it; the
    port's CLI serves that file, answering the greedy tokens the
    reference's sampler gives from it; /healthz and /readyz answer 200;
    SIGTERM drains to exit 0."""
    ref_mod = import_file_as_module(_write_model(
        tmp_path, "ref_lm.py", LM_MODEL, "veles_tpu"))
    fresh_ref_prng()
    wf = ref_mod.build_workflow(vt.Snapshotter(
        None, prefix="lm", directory=str(tmp_path / "s"),
        compression="gz"))
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    wf.run()
    prompts = ([1, 2, 3], [5, 0, 7, 7, 1, 2, 6, 3, 4])
    want = [ref_sampling.generate(wf, p, 6, temperature=0) for p in prompts]
    model = _write_model(tmp_path, "lm_model.py", LM_MODEL,
                         "veles_tpu_torch")
    box = tmp_path / "box"
    proc, port, head = _serve([model, "--snapshot", str(
        tmp_path / "s" / "lm_current.pickle.gz"), "--snapshot-dir",
        str(box), "--blackbox"])
    try:
        got = [_get(port, "/generate", {"prompt": p, "n_new": 6})[1]
               for p in prompts]
        health = [_get(port, path) for path in ("/healthz", "/readyz")]
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert [g["tokens"] for g in got] == want
    assert health[0][0] == 200 and health[0][1]["status"] == "ok"
    assert health[1] == (200, {"status": "ok", "components": {
        "serve.serve_generate": True}})
    assert proc.returncode == 0, stdout[-2000:]
    assert "resumed from" in head and "drain complete" in stdout
    dumps = sorted(box.glob("blackbox-*.jsonl"))     # --blackbox, SIGTERM
    assert len(dumps) == 1
    summary = recorder_inspect(str(dumps[0]))
    assert summary["reason"] == "SIGTERM" and summary["by_kind"]["request"]


def _sse(port, payload):
    """POST a streamed request; its SSE events."""
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert "text/event-stream" in r.headers["Content-Type"]
        return [json.loads(line[6:]) for line in r.read().splitlines()
                if line.startswith(b"data: ")]


def test_cli_serves_speculative_beam_and_streams(tmp_path):
    """``--serve-draft`` with ``--serve-draft-snapshot``: the reference's
    tiny-LM snapshot is both the target and the draft, so every draft
    token verifies (acceptance 1.0) and the speculative tokens are the
    reference's greedy ones; a beam request of the pool's width 2 gives
    the reference's ``beam_generate`` tokens; a streamed request's
    events carry the buffered answer; ``/stats`` shows the knobs."""
    ref_mod = import_file_as_module(_write_model(
        tmp_path, "ref_lm.py", LM_MODEL, "veles_tpu"))
    fresh_ref_prng()
    wf = ref_mod.build_workflow(vt.Snapshotter(
        None, prefix="lm", directory=str(tmp_path / "s"),
        compression="gz"))
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    wf.run()
    p = [5, 0, 7, 7, 1, 2]
    want = ref_sampling.generate(wf, p, 7, temperature=0)
    want_beam, _ = ref_beam_generate(wf, p, 5, beam=2)
    snap = str(tmp_path / "s" / "lm_current.pickle.gz")
    model = _write_model(tmp_path, "lm_model.py", LM_MODEL,
                         "veles_tpu_torch")
    proc, port, _ = _serve([model, "--snapshot", snap, "--serve-draft",
                            model, "--serve-draft-snapshot", snap,
                            "--serve-spec-gamma", "3",
                            "--serve-beam-width", "2",
                            "--serve-stream", "on"])
    try:
        _, spec = _get(port, "/generate", {"prompt": p, "n_new": 7,
                                           "mode": "speculative"})
        _, beam = _get(port, "/generate", {"prompt": p, "n_new": 5,
                                           "mode": "beam"})
        events = _sse(port, {"prompt": p, "n_new": 7})
        _, stats = _get(port, "/stats")
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert spec["engine"] == "continuous" and spec["tokens"] == want
    assert (spec["acceptance"], spec["rounds"]) == (1.0, 2)
    assert beam["engine"] == "continuous"
    assert beam["tokens"] == [int(t) for t in want_beam]
    assert events[-1]["done"] and events[-1]["tokens"] == want
    assert [t for ev in events[:-1] for t in ev["tokens"]] == want
    assert stats["speculative_enabled"] is True
    assert (stats["continuous"]["spec_gamma"],
            stats["continuous"]["beam_width"]) == (3, 2)
    assert proc.returncode == 0, stdout[-2000:]


# -- subcommands --------------------------------------------------------------
def test_trace_blackbox_and_faults_subcommands(tiny_model, tmp_path,
                                               capsys):
    jsonl = str(tmp_path / "run.jsonl")
    assert _cpu(tiny_model, "--trace-file", jsonl) == 0
    recorder.set_sink(None)
    out = str(tmp_path / "trace.json")
    assert main(["trace", "export", jsonl, out]) == 0
    with open(out) as fin:
        doc = json.load(fin)
    assert chrome_trace.validate(doc) == []
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"workflow.run", "unit.run"} <= names
    with open(jsonl) as fin:   # the logger's events share the file
        assert any('"launcher.work"' in line for line in fin)
    assert main(["trace", "export", str(tmp_path / "none.jsonl"),
                 out]) == 1
    box = str(tmp_path / "box.jsonl")
    assert main(["blackbox", "dump", "--out", box]) == 0
    capsys.readouterr()
    assert main(["blackbox", "inspect", box, "--tail", "2"]) == 0
    text = capsys.readouterr().out
    assert "reason:  cli dump" in text and "events:" in text
    assert main(["faults", "list"]) == 0
    text = capsys.readouterr().out
    assert "dispatch" in text and "active spec: (none)" in text
