"""The serve artifact (veles_tpu_torch/export/serve_artifact.py) on the
CPU: the paged engine's prefill and decode programs and the O(1)-state
lane's chunk scan and decode tile, exported with ``torch.export`` and
served, against the live engines and the reference's
``ContinuousEngine``. The reference's char LM (2 RoPE blocks, dim 32)
is initialised from a seed and carried into the port with
``convert.params_from_jax``; the engines run 3 slots, one bucket of 16,
max_context 48 and pages of 8 positions, so the longest request decodes
across 6 pages.

- the artifact engine's greedy tokens equal the live port engine's and
  the reference ``ContinuousEngine``'s, and its sampled tokens the live
  port engine's, float and int8 (int8 weights and the int8 KV pool);
  every prefill and decode dispatch went through a loaded program;
- an unusable artifact (a corrupt program, another knob, another device
  type, a newer version, the reference's artifact, no artifact, the
  ``artifact.load`` fault point) falls back to live serving: one
  ``veles_artifact_load_failures_total``, the same answers;
- no exported program mutates an input or holds a weight;
- ``GenerationAPI(artifact=)`` answers over HTTP as the live engine
  does, with ``veles_serving_artifact_mode`` 1.

The lane's artifact and the CLI: ``tests/test_torch_serve_artifact_cli.py``."""
import json
import os
import shutil
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.nn import sampling as ref_sampling
from veles_tpu.serving import ContinuousEngine as RefContinuousEngine
from veles_tpu.serving.engine import make_request as ref_make_request

from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.export.serve_artifact import (ARTIFACT_VERSION,
                                                   export_serve_artifact)
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.resilience import faults
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import ContinuousEngine, make_request
from veles_tpu_torch.telemetry.counters import counters

from conftest import import_model

ENGINE = dict(max_slots=3, buckets=(16,), max_context=48, page_size=8)
MODES = {"float": {}, "int8": dict(quant_weights=True, quant_kv=True)}
FAILURES = "veles_artifact_load_failures_total"
LOADS = "veles_artifact_loads_total"


@pytest.fixture(scope="module")
def lm():
    """(reference workflow, the port's stack with its weights, requests:
    4 greedy and 2 sampled, prompts 5–16 tokens, up to 30 new)."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        mod = import_model("char_lm")
        ref_prng.seed_all(971)
        wf = mod.build_workflow(epochs=1, minibatch_size=64, n_blocks=2,
                                dim=32, n_train=128, n_valid=64)
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        params = {unit: {k: numpy.asarray(v) for k, v in tree.items()}
                  for unit, tree in ref_sampling.params_of(wf).items()}
        port = params_from_jax(build_forwards(wf.layers_config,
                                              device="cpu"), params)
        rng = numpy.random.RandomState(5)
        specs = [(16, 30, 0.0), (5, 20, 0.0), (9, 12, 0.0), (12, 25, 0.0),
                 (7, 18, 0.8), (14, 22, 0.7)]
        reqs = [(rng.randint(0, mod.VOCAB, t).tolist(), n, tau, i)
                for i, (t, n, tau) in enumerate(specs)]
        yield wf, port, reqs
    finally:
        vt.root.common.engine.compute_dtype = prev


@pytest.fixture(scope="module")
def artifacts(lm, tmp_path_factory):
    """mode → an artifact exported on the CPU."""
    _, port, _ = lm
    root = tmp_path_factory.mktemp("artifacts")
    return {mode: export_serve_artifact(port, str(root / mode),
                                        device="cpu", **ENGINE, **kw)
            for mode, kw in MODES.items()}


def _serve(stack, reqs, **kw):
    """(tokens, stats) of ``reqs`` on a port engine."""
    engine = ContinuousEngine(stack, name="art_t", **dict(ENGINE, **kw))
    engine.start()
    try:
        return engine.serve([make_request(p, n, temperature=tau, seed=s)
                             for p, n, tau, s in reqs]), engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_artifact_equals_live_and_reference(lm, artifacts, mode):
    wf, port, reqs = lm
    kw = MODES[mode]
    before = counters.snapshot()
    live, live_st = _serve(port, reqs, **kw)
    got, st = _serve(port, reqs, artifact=artifacts[mode], **kw)
    delta = counters.delta(before)
    assert delta[LOADS] == 1 and delta.get(FAILURES, 0) == 0
    assert live_st["artifact_mode"] == 0 and st["artifact_mode"] == 1
    assert got == live
    # every prefill and decode step through the loaded programs
    assert st["program_calls"] == live_st["program_calls"]
    assert sum(v for k, v in st["program_calls"].items()
               if k.startswith("prefill_")) == len(reqs)
    assert st["program_calls"]["decode"] >= 29
    assert st["admitted"] == st["retired"] == len(reqs)
    assert st["pages_in_use"] == 0
    greedy = [i for i, r in enumerate(reqs) if r[2] == 0]
    ref = RefContinuousEngine(wf, name="art_ref", **ENGINE, **kw).start()
    try:
        want = ref.serve([ref_make_request(reqs[i][0], reqs[i][1])
                          for i in greedy])
    finally:
        ref.stop()
    assert [got[i] for i in greedy] == want


def _edit(path, fn):
    cpath = os.path.join(path, "contents.json")
    with open(cpath) as fin:
        contents = json.load(fin)
    fn(contents)
    with open(cpath, "w") as fout:
        json.dump(contents, fout)


def _corrupt(path):
    with open(os.path.join(path, "serve_decode.pt2"), "r+b") as f:
        f.truncate(100)


BAD = {
    "corrupt_program": (_corrupt, {}),
    "another_knob": (None, dict(max_slots=2)),
    "another_device": (lambda p: _edit(p, lambda c: c["serving"][
        "signature"].update(device="cuda")), {}),
    "newer_version": (lambda p: _edit(p, lambda c: c["serving"].update(
        artifact_version=ARTIFACT_VERSION + 1)), {}),
    "reference_artifact": (lambda p: _edit(p, lambda c: c["serving"].update(
        jax_version=c["serving"].pop("torch_version"))), {}),
    "no_artifact": (lambda p: shutil.rmtree(p), {}),
    "fault_point": (None, {}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_artifact_falls_back_counted(lm, artifacts, case, tmp_path,
                                         monkeypatch):
    _, port, reqs = lm
    spoil, knobs = BAD[case]
    path = str(tmp_path / "art")
    shutil.copytree(artifacts["float"], path)
    if spoil is not None:
        spoil(path)
    reqs = reqs[:1] + reqs[4:5]
    want, _ = _serve(port, reqs, **knobs)
    before = counters.snapshot()
    if case == "fault_point":
        monkeypatch.setenv("VELES_FAULTS", "artifact.load:raise:times=1")
        faults.plane.configure()
    try:
        got, st = _serve(port, reqs, artifact=path, **knobs)
    finally:
        monkeypatch.setenv("VELES_FAULTS", "")
        faults.plane.configure()
    delta = counters.delta(before)
    assert delta[FAILURES] == 1 and delta.get(LOADS, 0) == 0
    assert st["artifact_mode"] == 0
    assert got == want


def test_exported_programs_mutate_no_input_and_hold_no_weight(lm,
                                                             artifacts):
    weights = {tuple(t.shape) for layer in lm[1]
               for t in layer.params().values() if t.dim() == 2}
    for mode, path in artifacts.items():
        names = sorted(f for f in os.listdir(path) if f.endswith(".pt2"))
        assert names == ["serve_decode.pt2", "serve_prefill_16.pt2"]
        # the int8 prefill differs from the float one by its quantizer
        for name in names if mode == "float" else names[:1]:
            program = torch.export.load(os.path.join(path, name))
            # the tree and pool it was traced with are not saved with it
            assert program.example_inputs is None, (mode, name)
            sig = program.graph_signature
            assert sig.user_inputs_to_mutate == {}, (mode, name)
            assert not sig.buffers_to_mutate, (mode, name)
            assert not program.state_dict, (mode, name)
            # constants: the RoPE angles of the bucket's positions and
            # frequencies, never a weight
            for t in program.constants.values():
                if isinstance(t, torch.Tensor):
                    assert tuple(t.shape) not in weights, (mode, name)


def _post(port, payload):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_generation_api_serves_the_artifact(lm, artifacts):
    """``GenerationAPI(artifact=)`` hands the artifact to its engine:
    the answers over HTTP are the live engine's."""
    _, port, reqs = lm
    reqs = reqs[:1] + reqs[4:5]
    want, _ = _serve(port, reqs)
    api = GenerationAPI(port, port=0, device="cpu", artifact=artifacts[
        "float"], name="art_api", **ENGINE).initialize()
    try:
        assert api._engine.artifact_mode
        got = []
        for prompt, n, tau, seed in reqs:
            got.append(_post(api.port, {
                "prompt": prompt, "n_new": n, "temperature": tau,
                "seed": seed, "mode": "sample" if tau else "greedy"})[
                    "tokens"])
        assert got == want
        assert api._metrics_gauges()["veles_serving_artifact_mode"] == 1
    finally:
        api.stop()
