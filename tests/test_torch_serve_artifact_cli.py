"""The serve artifact through the command line and on the O(1)-state
lane, on the CPU (the paged engine's artifact against the reference:
``tests/test_torch_serve_artifact.py``).

- the lane's artifact (an LSTM LM, random weights from a numpy seed):
  its ``rscan`` and ``rstep`` programs serve the live lane's tokens,
  greedy and sampled, with the same program calls;
- ``python -m veles_tpu_torch export serve-artifact`` exports a model
  file's programs in a subprocess, and a server built with
  ``root.common.serving.artifact`` (the key ``--serve-artifact`` sets,
  ``tests/test_torch_cli.py``) on the same model file serves them over
  HTTP: ``veles_serving_artifact_mode 1`` and one load on ``/metrics``,
  the live engine's tokens, greedy and sampled."""
import json
import os
import subprocess
import sys
import urllib.request

import numpy

from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.export.serve_artifact import export_serve_artifact
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import ContinuousEngine, make_request
from veles_tpu_torch.serving.recurrent import RecurrentEngine
from veles_tpu_torch.telemetry.counters import counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADS = "veles_artifact_loads_total"


def test_lane_artifact_equals_the_live_lane(tmp_path):
    stack = build_forwards(
        [{"type": "embedding", "vocab_size": 32, "dim": 32, "name": "emb"},
         {"type": "lstm", "hidden_size": 32, "return_sequences": True,
          "name": "lstm0"},
         {"type": "lm_head", "vocab_size": 32, "name": "head"}],
        device="cpu")
    params_from_jax(stack, random_params(stack, seed=7))
    lane = dict(max_slots=3, max_context=64, page_size=8)
    path = export_serve_artifact(stack, str(tmp_path / "lane"),
                                 device="cpu", **lane)
    with open(os.path.join(path, "contents.json")) as fin:
        programs = json.load(fin)["serving"]["programs"]
    assert programs == {"rscan": "serve_rscan.pt2",
                        "rstep": "serve_rstep.pt2"}
    rng = numpy.random.RandomState(2)
    reqs = [make_request(rng.randint(0, 32, t).tolist(), n, temperature=tau,
                         seed=i)
            for i, (t, n, tau) in enumerate(((20, 12, 0.0), (3, 9, 0.0),
                                             (11, 14, 0.9), (8, 6, 0.6)))]
    out = {}
    for name, art in (("live", None), ("artifact", path)):
        eng = RecurrentEngine(stack, name="lane_t", artifact=art,
                              **lane).start()
        try:
            out[name] = eng.serve(reqs)
            out[name + "_st"] = eng.stats()
        finally:
            eng.stop()
    assert out["artifact_st"]["artifact_mode"] == 1
    assert out["artifact"] == out["live"]
    assert out["artifact_st"]["program_calls"] == \
        out["live_st"]["program_calls"]


MODEL = '''
from veles_tpu_torch.models import char_lm


def build_workflow():
    return char_lm.build_workflow(epochs=1, minibatch_size=32, n_blocks=1,
                                  dim=16, n_train=64, n_valid=32)
'''
KNOBS = ["--serve-slots", "2", "--serve-buckets", "16",
         "--serve-max-context", "32", "--serve-page-size", "8"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _post(port, payload):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_cli_exports_and_the_serving_key_serves(tmp_path):
    """``python -m veles_tpu_torch export serve-artifact`` in a
    subprocess writes the model's programs; ``root.common.serving.
    artifact``, the key ``--serve-artifact`` sets
    (``test_torch_cli.py``), makes a server built on the same model file
    serve from them: ``veles_serving_artifact_mode 1`` and one load on
    ``/metrics``, the live engine's tokens."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.import_file import import_file_as_module
    from veles_tpu_torch.nn.standard_workflow import forwards_of
    model = tmp_path / "lm_model.py"
    model.write_text(MODEL)
    out = str(tmp_path / "art")
    r = subprocess.run([sys.executable, "-m", "veles_tpu_torch", "export",
                        "serve-artifact", str(model), "--out", out, "-b",
                        "cpu", *KNOBS], cwd=REPO, capture_output=True,
                       text=True, timeout=180, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "serve-artifact -> %s (2 programs: decode, prefill_16" % out \
        in r.stdout
    wf = import_file_as_module(str(model), "art_model").build_workflow()
    wf.initialize(device="cpu")
    stack = forwards_of(wf)
    knobs = dict(max_slots=2, buckets=(16,), max_context=32, page_size=8)
    prev = root.common.serving.get("artifact", None)
    before = counters.snapshot()
    root.common.serving.artifact = out
    try:
        api = GenerationAPI(stack, port=0, device="cpu", name="art_cli",
                            **knobs).initialize()
    finally:
        root.common.serving.artifact = prev
    try:
        answers = [_post(api.port, {"prompt": [1, 2, 3, 4, 5], "n_new": 12,
                                    "temperature": tau, "seed": 3,
                                    "mode": "sample" if tau else "greedy"})
                   for tau in (0.0, 0.9)]
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % api.port, timeout=30) as resp:
            metrics = resp.read().decode()
    finally:
        api.stop()
    assert "veles_serving_artifact_mode 1" in metrics
    assert counters.delta(before)[LOADS] == 1
    live = ContinuousEngine(stack, name="art_cli_live", **knobs).start()
    try:
        assert [a["tokens"] for a in answers] == live.serve(
            [make_request([1, 2, 3, 4, 5], 12, temperature=tau, seed=3)
             for tau in (0.0, 0.9)])
    finally:
        live.stop()
