"""The port's package plane (veles_tpu_torch/export/package.py) on the
CPU, against the reference's (veles_tpu/export/package.py): a reference
StandardWorkflow of each case is initialised from a seed, its parameter
tree is carried into the port's twin with ``convert.params_from_jax``,
and each package exports its own (the port's int8 package without its
program, which the plain one already covers).

- every ``.npy`` of the two packages is byte-identical, plain and int8
  (``quant=True``: the same int8 payloads and float32 scale sidecars);
- ``contents.json`` is equal but for two named differences: the
  ``checksum`` (a hash of each workflow class's source) and the forward
  program's key (the port's ``"torch_export"``, the reference's
  ``"stablehlo"``, written here by neither side's test settings);
- each package's executor reads the other's: the reference's
  ``package_import`` + ``run_package`` on the port's package and the
  port's on the reference's agree with the reference's own within
  1e-4 · max(1, max|ref|) (float32 sums in another order);
- the fan-in DAG (``InputJoiner``), the forward-reference refusal, a
  newer format refused, the three archive suffixes, the reference's
  ``forward.stablehlo`` ignored, LoRA merged into the dense weights, and
  ``forward.pt2`` loaded back equal to ``run_package``."""
import json
import os

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.export import package_export as ref_export
from veles_tpu.export import package_import as ref_import
from veles_tpu.export import run_package as ref_run
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader

from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.export import package_export, package_import, run_package
from veles_tpu_torch.export.package import (FORMAT_VERSION, load_program,
                                            program_params)
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.all2all import All2AllSoftmax, All2AllTanh
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.telemetry.counters import counters
from veles_tpu_torch.workflow import Workflow

#: case → (sample shape, float or token ids, layers)
CASES = {
    "fc": ((32,), "f", [
        {"type": "all2all_tanh", "output_sample_shape": 16},
        {"type": "softmax", "output_sample_shape": 3}]),
    "conv": ((8, 8, 3), "f", [
        {"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3,
         "padding": (1, 1, 1, 1)},
        {"type": "max_pooling", "kx": 2, "ky": 2}, {"type": "norm"},
        {"type": "all2all_tanh", "output_sample_shape": 10},
        {"type": "softmax", "output_sample_shape": 3}]),
    "seq": ((6, 8), "f", [
        {"type": "multi_head_attention", "n_heads": 2, "causal": True},
        {"type": "moe_ffn", "n_experts": 4, "hidden": 16, "top_k": 2,
         "capacity_factor": 1.0},
        {"type": "lstm", "hidden_size": 8},
        {"type": "softmax", "output_sample_shape": 3}]),
    "transformer": ((6, 8), "f", [
        {"type": "pos_embedding"},
        {"type": "transformer_block", "n_heads": 4, "n_kv_heads": 2,
         "ffn_hidden": 16, "causal": True, "rope": True, "window": 3},
        {"type": "transformer_block", "n_heads": 2, "ffn_hidden": 16,
         "causal": True, "norm": "rms", "ffn": "swiglu"},
        {"type": "mean_pool"},
        {"type": "softmax", "output_sample_shape": 3}]),
    "tokens": ((6,), "i", [
        {"type": "embedding", "vocab_size": 11, "dim": 8},
        {"type": "transformer_block", "n_heads": 2, "ffn_hidden": 16,
         "rope": True},
        {"type": "mean_pool"},
        {"type": "softmax", "output_sample_shape": 3}]),
}

#: the contents keys that differ between the packages, and why
NAMED_DIFFERENCES = ("checksum",)


def _data(shape, kind):
    rng = numpy.random.RandomState(9)
    if kind == "i":
        x = rng.randint(0, 11, (48,) + shape).astype(numpy.int32)
    else:
        x = rng.rand(48, *shape).astype(numpy.float32)
    return x, rng.randint(0, 3, 48).astype(numpy.int32)


def _loader(base, data):
    def load_data(self):
        x, y = data
        self.create_originals(x, y)
        self.class_lengths = [0, 12, 36]
    return type("Rows", (base,), {"hide_from_registry": True,
                                  "load_data": load_data})


def _twins(case):
    """(reference workflow, the port's with its weights, a batch of 5
    rows)."""
    shape, kind, layers = CASES[case]
    data = _data(shape, kind)
    ref_prng.seed_all(3)
    ref = ref_nn.StandardWorkflow(
        name="pkg-" + case, layers=layers,
        loader_unit=_loader(RefFullBatchLoader, data)(
            None, minibatch_size=12, name="rows"),
        loss_function="softmax", decision_config=dict(max_epochs=1))
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    prng.seed_all(3)
    port = StandardWorkflow(
        name="pkg-" + case, layers=layers,
        loader_unit=_loader(FullBatchLoader, data)(
            None, minibatch_size=12, name="rows"),
        loss_function="softmax", decision_config=dict(max_epochs=1))
    port.initialize(device="cpu")
    tree = {n: {k: numpy.asarray(jax.device_get(v)) for k, v in p.items()}
            for n, p in ref.train_step.params.items()}
    params_from_jax(port, tree)
    return ref, port, data[0][:5].astype(numpy.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def packages(request, tmp_path_factory):
    """case → both packages, plain and int8, and the batch."""
    ref, port, batch = _twins(request.param)
    root = tmp_path_factory.mktemp("pkg_" + request.param)
    out = {"case": request.param, "batch": batch}
    for quant in (False, True):
        tag = "int8" if quant else "plain"
        out[("ref", tag)] = ref_export(ref, str(root / ("ref_" + tag)),
                                       with_stablehlo=False, quant=quant)
        out[("port", tag)] = package_export(port, str(root / ("port_" + tag)),
                                            with_program=not quant,
                                            quant=quant)
    return out


def _tol(want):
    return 1e-4 * max(1.0, float(numpy.abs(want).max()))


@pytest.mark.parametrize("tag", ["plain", "int8"])
def test_package_arrays_and_contents_equal_the_reference(packages, tag):
    ref_dir, port_dir = packages[("ref", tag)], packages[("port", tag)]
    files = sorted(f for f in os.listdir(ref_dir) if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(port_dir)
                           if f.endswith(".npy"))
    assert files
    for fname in files:
        with open(os.path.join(ref_dir, fname), "rb") as a, \
                open(os.path.join(port_dir, fname), "rb") as b:
            assert a.read() == b.read(), fname
    with open(os.path.join(ref_dir, "contents.json")) as fin:
        want = json.load(fin)
    with open(os.path.join(port_dir, "contents.json")) as fin:
        got = json.load(fin)
    if tag == "plain":
        assert got.pop("torch_export") == "forward.pt2"
    assert "stablehlo" not in want
    for key in NAMED_DIFFERENCES:
        assert got.pop(key) != want.pop(key)
    assert got == want
    assert got["format_version"] == (3 if "quant" in got else 2)
    if tag == "int8" and packages["case"] == "fc":
        # the 32 x 16 weight is eligible, the 16 x 3 head too small
        assert got["quant"]["params"] == 1


@pytest.mark.parametrize("tag", ["plain", "int8"])
def test_each_executor_reads_the_other_package(packages, tag):
    batch = packages["batch"]
    ref_dir, port_dir = packages[("ref", tag)], packages[("port", tag)]
    want = numpy.asarray(ref_run(ref_dir, batch))
    for got in (numpy.asarray(ref_run(port_dir, batch)),
                run_package(ref_dir, batch, device="cpu"),
                run_package(port_dir, batch, device="cpu")):
        assert got.shape == want.shape
        assert float(numpy.abs(got - want).max()) <= _tol(want)
    # the int8 plane dequantizes on read in both readers
    a, b = ref_import(port_dir), package_import(ref_dir)
    for unit, params in a["params"].items():
        for k, v in params.items():
            numpy.testing.assert_array_equal(numpy.asarray(v),
                                             b["params"][unit][k])


def test_forward_program_round_trips(packages):
    """``forward.pt2`` loaded back runs the package's own arrays to the
    executor's answer."""
    port_dir = packages[("port", "plain")]
    pkg = package_import(port_dir)
    n = pkg["contents"]["input_shape"][0]
    batch = packages["batch"]
    full = numpy.concatenate([batch] * (n // len(batch) + 1))[:n]
    got = load_program(port_dir)(program_params(pkg, "cpu"),
                                 torch.from_numpy(full)).numpy()
    want = run_package(pkg, full, device="cpu")
    assert numpy.array_equal(got, want)


def _fanin(tmp_path, graph=None):
    """input → (tanh fa | tanh fb) → InputJoiner → softmax head in both
    packages (the reference's own fan-in, with the port's FC family)."""
    from veles_tpu_torch.input_joiner import InputJoiner
    rng = numpy.random.RandomState(11)
    x = rng.rand(6, 10).astype(numpy.float32)
    out = {}
    for side, (mod, wf_cls, tanh, soft, joiner, arr, kw) in {
            "ref": (ref_prng, vt.Workflow, ref_nn.All2AllTanh,
                    ref_nn.All2AllSoftmax, vt.InputJoiner, vt.Array,
                    dict(device=vt.XLADevice(mesh_axes={"data": 1}))),
            "port": (prng, Workflow, All2AllTanh, All2AllSoftmax,
                     InputJoiner, Array, dict(device="cpu"))}.items():
        mod.seed_all(5)
        wf = wf_cls(name="fanin")
        fa = tanh(wf, output_sample_shape=7, name="fa")
        fb = tanh(wf, output_sample_shape=5, name="fb")
        for f in (fa, fb):
            f.input = arr(x)
            f.initialize(**kw)
        join = joiner(wf, inputs=[arr(numpy.zeros((6, 7), numpy.float32)),
                                  arr(numpy.zeros((6, 5), numpy.float32))],
                      name="join")
        head = soft(wf, output_sample_shape=3, name="head")
        head.input = arr(numpy.zeros((6, 12), numpy.float32))
        head.initialize(**kw)
        wf.forwards = [fa, fb, join, head]
        exporter = ref_export if side == "ref" else package_export
        extra = {"with_stablehlo": False} if side == "ref" else {}
        out[side] = exporter(
            wf, str(tmp_path / side), input_shape=list(x.shape),
            graph=graph or [["@input"], ["@input"], ["fa", "fb"], ["join"]],
            **extra)
    return out, x


def test_fanin_dag_runs_in_both_executors(tmp_path):
    pkgs, x = _fanin(tmp_path)
    want = numpy.asarray(ref_run(pkgs["ref"], x))
    for got in (run_package(pkgs["port"], x, device="cpu"),
                run_package(pkgs["ref"], x, device="cpu"),
                numpy.asarray(ref_run(pkgs["port"], x))):
        assert float(numpy.abs(got - want).max()) <= _tol(want)
    with open(os.path.join(pkgs["port"], "contents.json")) as fin:
        units = json.load(fin)["units"]
    assert [u["inputs"] for u in units] == [["@input"], ["@input"],
                                           ["fa", "fb"], ["join"]]


def test_forward_reference_graph_is_refused(tmp_path):
    prng.seed_all(1)
    wf = Workflow(name="badg")
    x = numpy.random.RandomState(1).rand(4, 6).astype(numpy.float32)
    units = []
    for name in ("a", "b"):
        f = All2AllTanh(wf, output_sample_shape=4, name=name)
        f.input = Array(x)
        f.initialize(device="cpu")
        units.append(f)
    wf.forwards = units
    with pytest.raises(VelesError, match="preceding"):
        package_export(wf, str(tmp_path / "bad"), input_shape=[4, 6],
                       graph=[["b"], ["a"]])


def test_newer_format_is_refused_by_both_readers(packages, tmp_path):
    import shutil
    future = str(tmp_path / "future")
    shutil.copytree(packages[("port", "plain")], future)
    path = os.path.join(future, "contents.json")
    with open(path) as fin:
        contents = json.load(fin)
    contents["format_version"] = FORMAT_VERSION + 1
    with open(path, "w") as fout:
        json.dump(contents, fout)
    with pytest.raises(VelesError, match="newer"):
        package_import(future)
    with pytest.raises(Exception, match="newer"):
        ref_import(future)


@pytest.mark.parametrize("suffix", [".zip", ".tgz", ".tar.gz"])
def test_archives_round_trip(tmp_path, suffix):
    prng.seed_all(2)
    wf = Workflow(name="arch")
    x = numpy.random.RandomState(0).rand(5, 9).astype(numpy.float32)
    fc = All2AllTanh(wf, output_sample_shape=6, name="fc")
    fc.input = Array(x)
    fc.initialize(device="cpu")
    wf.forwards = [fc]
    path = package_export(wf, str(tmp_path / ("net" + suffix)),
                          input_shape=[5, 9])
    assert path.endswith(suffix) and os.path.exists(path)
    assert not (tmp_path / "net").exists()      # the staging directory
    want = fc.apply({k: v.device_view("cpu")
                     for k, v in fc.param_arrays().items()},
                    torch.from_numpy(x)).numpy()
    for got in (run_package(path, x, device="cpu"),
                numpy.asarray(ref_run(path, x))):
        assert float(numpy.abs(got - want).max()) <= 1e-6
    assert package_import(path)["dir"] is None


def test_reference_program_is_ignored(tmp_path):
    """A reference package with its ``forward.stablehlo`` reads in the
    port: the arrays as they are, the program left alone."""
    ref, port, batch = _twins("fc")
    path = ref_export(ref, str(tmp_path / "ref"), with_stablehlo=True)
    assert os.path.exists(os.path.join(path, "forward.stablehlo"))
    pkg = package_import(path)
    assert pkg["contents"]["stablehlo"] == "forward.stablehlo"
    want = numpy.asarray(ref_run(path, batch))
    got = run_package(pkg, batch, device="cpu")
    assert float(numpy.abs(got - want).max()) <= _tol(want)


def test_lora_is_merged_and_int8_is_counted(tmp_path):
    """A LoRA'd layer exports its merged dense weight (no adapter files);
    ``quant=True`` counts one calibration and each quantized tensor."""
    prng.seed_all(4)
    wf = Workflow(name="lora")
    x = numpy.random.RandomState(2).rand(5, 32).astype(numpy.float32)
    fc = All2AllTanh(wf, output_sample_shape=16, name="fc", lora_rank=2)
    fc.input = Array(x)
    fc.initialize(device="cpu")
    fc.weights_lora_b.reset(numpy.random.RandomState(3).randn(
        2, 16).astype(numpy.float32))
    wf.forwards = [fc]
    before = counters.snapshot()
    path = package_export(wf, str(tmp_path / "lora"), input_shape=[5, 32],
                          quant=True)
    delta = counters.delta(before)
    assert delta["veles_quant_calibrations_total"] == 1
    assert delta["veles_quant_params_total"] == 1
    assert not [f for f in os.listdir(path) if "lora" in f]
    merged = fc.export_param_arrays()["weights"].map_read()
    assert not numpy.array_equal(merged, fc.weights.map_read())
    got = package_import(path)["params"]["fc"]["weights"]
    scale = numpy.abs(merged).max(axis=0, keepdims=True) / 127
    assert float(numpy.abs(got - merged).max()) <= float(scale.max()) / 2 \
        + 1e-7
