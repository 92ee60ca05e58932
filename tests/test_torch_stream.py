"""SSE token streaming and the speculative and beam modes over real HTTP
on the port's GenerationAPI (veles_tpu_torch/restful_api.py), on the
CPU, with the tiny LM and draft of tests/test_torch_speculative.py.

- ``"stream": true`` is answered with HTTP/1.1 chunked
  ``text/event-stream``: the token events, concatenated, equal the
  buffered answer to the same request and the terminal event's tokens
  (greedy, sampled, speculative and beam on the pool; a window-plane
  request bursts its tokens in one event before the terminal one); the
  first event arrives before the terminal one;
  ``root.common.serving.stream = False`` answers buffered (the
  reference's tests/test_prefix_stream.py cases); a client that leaves
  mid-stream does not stop the engine;
- ``mode=speculative`` and ``mode=beam`` are answered 200 on the pool
  and on the window plane, equal to the solo calls; the 400s: a beam
  wider than the vocabulary, ``gamma`` < 1, speculation on a server
  with no draft, a non-boolean ``stream``; ``/stats`` says
  ``speculative_enabled``."""
import json
import socket
import time
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import pytest

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.beam import beam_generate
from veles_tpu_torch.nn.speculative import generate_speculative
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI

from test_torch_speculative import VOCAB, lm_layers, prompt

ENGINE = dict(max_slots=5, buckets=(8, 16), max_context=48, page_size=8,
              spec_gamma=3, beam_width=2)


def _stack(n_blocks, seed):
    m = build_forwards(lm_layers(n_blocks), device="cpu")
    return params_from_jax(m, random_params(m, seed=seed))


@pytest.fixture(scope="module")
def models():
    return _stack(2, 11), _stack(1, 12)


@pytest.fixture(scope="module")
def api(models):
    target, draft = models
    api = GenerationAPI(target, port=0, device="cpu", draft=draft,
                        batch_window=0.05, name="stream_t",
                        **ENGINE).initialize()
    yield api, "http://127.0.0.1:%d" % api.port
    api.stop()


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_stream(url, payload):
    """(headers, events, seconds to the first event, to the last)."""
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    events, first = [], None
    with urllib.request.urlopen(req, timeout=60) as r:
        headers = dict(r.headers)
        while True:
            line = r.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                first = first or time.perf_counter() - t0
                events.append(json.loads(line[6:]))
    return headers, events, first, time.perf_counter() - t0


def _streamed(events):
    return [t for ev in events if not ev.get("done") for t in ev["tokens"]]


@pytest.mark.parametrize("payload", [
    {"n_new": 12},
    {"n_new": 9, "mode": "sample", "temperature": 0.7, "seed": 9},
    {"n_new": 11, "mode": "speculative"},
    {"n_new": 7, "mode": "beam"}], ids=["greedy", "sample",
                                        "speculative", "beam"])
def test_sse_events_equal_the_buffered_answer(api, payload):
    _, url = api
    body = dict(payload, prompt=prompt(30, 6))
    code, buffered = _post(url + "/generate", body)
    assert code == 200 and buffered["engine"] == "continuous"
    headers, events, first, last = _post_stream(url + "/generate", body)
    assert "text/event-stream" in headers["Content-Type"]
    assert headers["Transfer-Encoding"] == "chunked"
    final = events[-1]
    assert final["done"] and final["engine"] == "continuous"
    assert _streamed(events) == final["tokens"] == buffered["tokens"]
    assert all("request_id" in ev for ev in events)
    assert first < last and len(events) >= 2
    if payload.get("mode") == "beam":
        # a beam's tokens exist only at its end: one burst
        assert len(events) == 2 and final["scores"]
    else:
        # the engine pushes at every step boundary
        assert len(events) > 2


def test_window_plane_stream_bursts_once(api, models):
    """A prompt past the largest bucket rides the window plane, whose
    tokens arrive in one event before the terminal one."""
    target, _ = models
    _, url = api
    p = (prompt(31, 10) * 2)[:20]
    _, events, _, _ = _post_stream(url + "/generate",
                                   {"prompt": p, "n_new": 6})
    assert len(events) == 2 and events[0]["i"] == 0
    assert "engine" not in events[1]
    assert events[0]["tokens"] == events[1]["tokens"] == \
        sampling.generate(target, p, 6, temperature=0)


def test_stream_knob_off_answers_buffered(api, models):
    target, _ = models
    _, url = api
    p = prompt(32, 5)
    prev = root.common.serving.get("stream", True)
    root.common.serving.stream = False
    try:
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"prompt": p, "n_new": 4, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert "application/json" in r.headers["Content-Type"]
            body = json.loads(r.read())
    finally:
        root.common.serving.stream = prev
    assert body["tokens"] == sampling.generate(target, p, 4,
                                               temperature=0)


def test_client_leaving_mid_stream_keeps_the_engine(api, models):
    target, _ = models
    gen_api, url = api
    port = gen_api.port
    data = json.dumps({"prompt": prompt(33, 6), "n_new": 30,
                       "stream": True}).encode()
    for _ in range(3):
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(data), data))
        assert sock.recv(4096).startswith(b"HTTP/1.1 200")
        sock.close()                    # gone before the decode ends
    p = prompt(34, 6)
    code, body = _post(url + "/generate", {"prompt": p, "n_new": 5})
    assert code == 200
    assert body["tokens"] == sampling.generate(target, p, 5,
                                               temperature=0)
    assert gen_api._engine._thread.is_alive()
    deadline = time.time() + 30
    while gen_api._engine.scheduler.busy_count() and time.time() < deadline:
        time.sleep(0.05)
    assert gen_api._engine.page_pool.ledger() == {}


@pytest.mark.parametrize("plane", ["pool", "window"])
def test_speculative_and_beam_answer_200_on_both_planes(api, models,
                                                        plane):
    """The pool takes prompts up to its largest bucket; a longer one
    rides the window plane. Both answer as the solo calls do."""
    target, draft = models
    _, url = api
    p = prompt(35, 9) if plane == "pool" else (prompt(35, 9) * 2)[:18]
    code, spec = _post(url + "/generate", {"prompt": p, "n_new": 8,
                                           "mode": "speculative"})
    assert code == 200
    solo, st = generate_speculative(target, draft, p, 8, gamma=3)
    assert spec["tokens"] == solo
    assert (spec["rounds"], spec["acceptance"]) == (st["rounds"],
                                                    st["acceptance"])
    code, beam = _post(url + "/generate", {"prompt": p, "n_new": 6,
                                           "mode": "beam"})
    assert code == 200
    want, bst = beam_generate(target, p, 6, beam=2)
    assert beam["tokens"] == want
    assert ("engine" in spec) == ("engine" in beam) == (plane == "pool")


@pytest.mark.parametrize("payload,why", [
    ({"mode": "beam", "beam": VOCAB + 1}, "exceeds the head's vocab"),
    ({"mode": "speculative", "gamma": 0}, "'gamma' must be >= 1"),
    ({"mode": "beam", "beam": 0}, "'beam' must be >= 1"),
    ({"stream": "yes"}, "'stream' must be a boolean")],
    ids=["beam_over_vocab", "gamma_0", "beam_0", "stream_not_bool"])
def test_bad_requests_answer_400(api, payload, why):
    _, url = api
    code, body = _post(url + "/generate",
                       dict(payload, prompt=prompt(36, 4), n_new=3))
    assert code == 400 and why in body["error"]


def test_speculative_without_a_draft_answers_400(models):
    target, _ = models
    api = GenerationAPI(target, port=0, device="cpu", engine="window",
                        name="stream_nodraft").initialize()
    try:
        url = "http://127.0.0.1:%d" % api.port
        code, body = _post(url + "/generate", {
            "prompt": [1, 2], "n_new": 2, "mode": "speculative"})
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        api.stop()
    assert code == 400 and "needs a draft model" in body["error"]
    assert stats["speculative_enabled"] is False


def test_stats_say_speculation_is_enabled(api):
    _, url = api
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["speculative_enabled"] is True
    assert stats["modes"] == ["greedy", "sample", "speculative", "beam"]
    assert stats["continuous"]["spec_gamma"] == 3
    assert stats["continuous"]["beam_width"] == 2
