"""Classic REST serving (``restful_api.RESTfulAPI`` with
``loader/stream.py``) in both packages on the CPU: the serving workflow
of ``tests/test_services.py`` (``Repeater → RestfulLoader → forwards →
RESTfulAPI``) built in each, the port's forward given the reference's
weights through ``convert.params_from_jax``, the same POSTs sent to
both. Each case compares the status codes and the payload keys, and
every answered row within 1e-5 (float32 products in another order) of
the reference's and of the forward of that row alone:

- the round trip, a bad body, a bad shape, a non-object body, an unknown
  path (``tests/test_services.py:51-200``);
- the image round trip through ``RestfulImageLoader`` (a base64 PNG
  resized 8 → 4, junk → 400);
- dynamic batching: six clients queued before the workflow runs, each
  answered its own row in fewer dispatches than requests
  (``tests/test_services.py:201-260``);
- the ``max_pending`` bound sheds 503 + Retry-After
  (``tests/test_resilience.py:624``), as an injected ``serve.request``
  fault does; a closed loader answers 503; the
  stop sweep settles an outstanding ticket once
  (``tests/test_lossless.py:630``);
- the interactive and ZeroMQ loaders' feed, close and batching
  (``tests/test_loaders.py:243, 262, 530``);
- the GET plane: ``/healthz``, ``/readyz``, ``/metrics``,
  ``/trace/spans``; ``/metrics/history`` and ``/alerts`` (planes of
  ROADMAP item 11) answer 404 on the port.
"""
import base64
import io
import json
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import stream as ref_stream
from veles_tpu.plumbing import Repeater as RefRepeater
from veles_tpu.serving.scheduler import Ticket as RefTicket
from veles_tpu.telemetry.counters import counters as ref_counters
from veles_tpu.telemetry.counters import histograms as ref_histograms
import veles_tpu_torch as pt
from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader import TEST, stream
from veles_tpu_torch.nn.all2all import All2AllSoftmax
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.serving.scheduler import Ticket
from veles_tpu_torch.telemetry.counters import counters, histograms
from veles_tpu_torch.workflow import Workflow

#: an answered row against the reference's and the forward alone
ROW_ATOL = 1e-5


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            body = json.loads(body)
        except ValueError:
            body = body.decode(errors="replace")
        return e.code, dict(e.headers), body


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


class Served:
    """One package's serving workflow: the loader, the forward, the API
    and the workflow's run thread."""

    def __init__(self, port, loader_cls="RestfulLoader", sample_shape=(4,),
                 n_out=3, mb=1, seed=3, **loader_kw):
        (prng if port else ref_prng).seed_all(seed)
        mod = stream if port else ref_stream
        self.port = port
        self.wf = (Workflow if port else vt.Workflow)(name="serve")
        rep = (Repeater if port else RefRepeater)(self.wf)
        self.loader = getattr(mod, loader_cls)(
            self.wf, sample_shape=sample_shape, timeout=30.0,
            minibatch_size=mb, name="rest_loader", **loader_kw)
        self.fwd = (All2AllSoftmax if port else ref_nn.All2AllSoftmax)(
            self.wf, output_sample_shape=n_out, name="fwd")
        self.api = (pt if port else vt).RESTfulAPI(
            self.wf, loader=self.loader, port=0, request_timeout=30.0)
        rep.link_from(self.wf.start_point)
        self.loader.link_from(rep)
        self.fwd.link_from(self.loader)
        self.fwd.link_attrs(self.loader, ("input", "minibatch_data"))
        self.api.link_from(self.fwd)
        self.api.link_attrs(self.fwd, ("input", "output"))
        rep.link_from(self.api)
        if port:
            self.wf.initialize(device="cpu")
        else:
            self.wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        self.url = "http://127.0.0.1:%d" % self.api.port
        self.thread = None

    def start(self):
        self.thread = threading.Thread(target=self.wf.run, daemon=True)
        self.thread.start()
        return self

    def close(self):
        self.loader.close()
        if self.thread is not None:
            self.thread.join(timeout=10)
            assert not self.thread.is_alive()
        self.api.stop()

    def alone(self, x):
        """The forward of one row alone (the row-count-1 product)."""
        x = numpy.asarray(x, dtype=numpy.float32)[None]
        if not self.port:
            return self.fwd.numpy_apply(self.fwd.params_np(), x)[0]
        params = {k: v.device_view("cpu")
                  for k, v in self.fwd.param_arrays().items()}
        with torch.no_grad():
            return self.fwd.apply(params, torch.from_numpy(x))[0].numpy()


def _pair(**kw):
    """The reference's and the port's serving workflows, the port's
    forward carrying the reference's weights."""
    ref = Served(False, **kw)
    port = Served(True, **kw)
    params_from_jax(port.wf, {"fwd": {k: numpy.asarray(v) for k, v in
                                      ref.fwd.params_np().items()}})
    return ref, port


def _same_answers(answers, rows=None):
    """Both packages' (status, headers, body) lists: equal codes and
    payload keys, rows within ROW_ATOL of each other (and of the rows
    ``rows`` gives)."""
    (ref, port) = answers
    assert [a[0] for a in port] == [a[0] for a in ref]
    for i, (r, p) in enumerate(zip(ref, port)):
        if isinstance(r[2], dict):
            assert sorted(p[2]) == sorted(r[2]), (i, r[2], p[2])
        else:
            assert not isinstance(p[2], dict), (i, p[2])
        if r[0] == 200:
            got = numpy.asarray(p[2]["result"])
            numpy.testing.assert_allclose(got, r[2]["result"], rtol=0,
                                          atol=ROW_ATOL)
            if rows is not None and rows[i] is not None:
                numpy.testing.assert_allclose(got, rows[i], rtol=0,
                                              atol=ROW_ATOL)
        if r[0] == 503:
            assert ("Retry-After" in p[1]) == ("Retry-After" in r[1])


def test_roundtrip_bad_requests_and_close():
    """``tests/test_services.py:51-83, 150-200``: a round trip, a body
    without ``input``, a wrong shape, a non-object body, then a good
    request again; the loader's close ends the workflow thread."""
    x = [0.1, -0.2, 0.3, 0.4]
    posts = [{"input": x}, {"wrong": 1}, {"input": [1.0, 2.0]},
             "just a string", {"input": x}, {"input": [0.5, 0.5, 0.5, 0]}]
    answers = []
    for srv in _pair():
        srv.start()
        answers.append([_post(srv.url + "/api", p) for p in posts])
        assert srv.api.requests_served == 3
        srv.close()
    port = srv
    _same_answers(answers, [port.alone(p["input"]) if isinstance(p, dict)
                            and "input" in p and len(p["input"]) == 4
                            else None for p in posts])
    assert [a[0] for a in answers[1]] == [200, 400, 400, 400, 200, 200]
    assert abs(sum(answers[1][0][2]["result"]) - 1.0) < 1e-5


def test_unknown_path_and_get_plane():
    """An unknown POST or GET path is 404; the health probes, the
    metrics page and the span pull answer as the reference's."""
    gets = ["/healthz", "/readyz", "/metrics", "/trace/spans", "/nope"]
    answers, texts = [], []
    for srv in _pair():
        code, _, _ = _post(srv.url + "/nope", {"input": []}, timeout=5)
        got = [(code,)]
        for path in gets:
            c, text = _get(srv.url + path)
            got.append((c,))
            texts.append(text)
        answers.append(got)
        if srv.port:
            assert _get(srv.url + "/metrics/history")[0] == 404
            assert _get(srv.url + "/alerts")[0] == 404
            metrics = texts[-3]
        srv.close()
    assert answers[1] == answers[0]
    assert answers[1][0] == (404,)
    assert "veles_rest_requests_served 0" in metrics
    assert "veles_rest_pending 0" in metrics


def test_image_roundtrip():
    """``tests/test_services.py:119-148``: a base64 PNG decoded with the
    training loader's size policy (8x8 resized to 4x4), junk → 400, and
    the service still answers; the numeric ``input`` path works too."""
    from PIL import Image
    rng = numpy.random.RandomState(0)
    img = (rng.rand(8, 8, 3) * 255).astype(numpy.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    payload = base64.b64encode(buf.getvalue()).decode()
    x = rng.rand(4, 4, 3).tolist()
    posts = [{"image": payload},
             {"image": base64.b64encode(b"junk").decode()},
             {"image": payload}, {"input": x}]
    answers = []
    for srv in _pair(loader_cls="RestfulImageLoader", sample_shape=(4, 4, 3),
                     n_out=2, size=(4, 4), color="RGB"):
        srv.start()
        answers.append([_post(srv.url + "/api", p) for p in posts])
        decoded = srv.loader.parse_request(posts[0])
        srv.close()
    rows = [srv.alone(decoded), None, srv.alone(decoded), srv.alone(x)]
    _same_answers(answers, rows)
    assert [a[0] for a in answers[1]] == [200, 400, 200, 200]


def test_dynamic_batching_serves_concurrent_requests():
    """``tests/test_services.py:201-260``: six clients queued before the
    workflow runs share dispatches, each answered its own row."""
    xs = numpy.random.RandomState(0).rand(6, 4).astype(numpy.float32)
    answers = []
    for srv in _pair(mb=8):
        results = [None] * 6

        def client(i, url=srv.url):
            results[i] = _post(url + "/api", {"input": xs[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        deadline = time.time() + 20
        while srv.loader._queue.qsize() < 4 and time.time() < deadline:
            time.sleep(0.02)
        assert srv.loader._queue.qsize() >= 4
        srv.start()
        for th in threads:
            th.join(timeout=30)
        assert srv.api.requests_served == 6
        assert srv.loader.samples_served == 6
        assert srv.loader.run_count < 6, srv.loader.run_count
        answers.append(results)
        srv.close()
    _same_answers(answers, [srv.alone(x) for x in xs])


def test_pending_bound_sheds():
    """``tests/test_resilience.py:624``: ``max_pending=0`` sheds every
    request 503 + Retry-After, counted once."""
    answers = []
    for pkg, mod, wf_cls, reg in (
            (vt, ref_stream, vt.Workflow, ref_counters),
            (pt, stream, Workflow, counters)):
        wf = wf_cls(None, name="w")
        loader = mod.RestfulLoader(wf, sample_shape=(4,), name="rl")
        api = pkg.RESTfulAPI(wf, loader=loader, port=0, max_pending=0,
                             name="shed_r")
        api.initialize()
        try:
            before = reg.get("veles_shed_requests_total")
            answers.append([_post("http://127.0.0.1:%d/api" % api.port,
                                  {"input": [1, 2, 3, 4]})])
            assert reg.get("veles_shed_requests_total") - before == 1
        finally:
            api.stop()
    _same_answers(answers)
    assert answers[1][0][0] == 503


def test_request_fault_is_shed_503(monkeypatch):
    """An injected ``serve.request`` fault sheds that request 503 +
    Retry-After (counted) and the next is served."""
    monkeypatch.setenv("VELES_FAULTS", "serve.request:raise:times=1")
    answers = []
    for srv, reg in zip(_pair(), (ref_counters, counters)):
        srv.start()
        before = reg.get("veles_shed_requests_total")
        answers.append([_post(srv.url + "/api", {"input": [0, 1, 0, 1]})
                        for _ in range(2)])
        assert reg.get("veles_shed_requests_total") - before == 1
        srv.close()
    _same_answers(answers, [None, srv.alone([0, 1, 0, 1])])
    assert [a[0] for a in answers[1]] == [503, 200]


def test_closed_loader_answers_503():
    """A feed after ``close()`` is the server shutting down: 503."""
    answers = []
    for srv in _pair():
        srv.loader.close()
        answers.append([_post(srv.url + "/api", {"input": [0, 0, 0, 0]})])
        srv.api.stop()
    _same_answers(answers)
    assert answers[1][0][0] == 503
    with pytest.raises(stream.LoaderClosed):
        srv.loader.feed(numpy.zeros(4))


def test_stop_sweep_settles_outstanding_once():
    """``tests/test_lossless.py:630``: ``stop()`` answers an outstanding
    ticket 503 with Retry-After 5 through the first-terminal ``fail``;
    a second sweep changes nothing."""
    for pkg, wf_cls, ticket_cls, hist in (
            (vt, vt.Workflow, RefTicket, ref_histograms),
            (pt, Workflow, Ticket, histograms)):
        wf = wf_cls(name="sweep_wf")
        api = pkg.RESTfulAPI(wf, loader=None, port=0)
        ticket = ticket_cls(mode="greedy")
        api._outstanding.add(ticket)
        qw = hist.count("veles_serving_queue_wait_seconds")
        api.stop()
        assert ticket.event.is_set() and ticket.code == 503
        assert ticket.retry_after == 5.0
        assert ticket.error_payload()["request_id"] == ticket.request_id
        api.stop()
        assert hist.count("veles_serving_queue_wait_seconds") - qw == 1
        assert ticket.fail("third sweep", code=503) is False


def test_interactive_loader_feed_and_close():
    """``tests/test_loaders.py:243``: one fed sample is served as a TEST
    minibatch with its label and ticket; an unlabeled row after it is
    labelled 0; close stops the workflow; a feed after it raises."""
    for mod, wf_cls in ((ref_stream, vt.Workflow), (stream, Workflow)):
        wf = wf_cls(name="stream-wf")
        ld = mod.InteractiveLoader(wf, sample_shape=(4,), timeout=5.0,
                                   minibatch_size=2, name="inter")
        ld.initialize(device=None)
        ld.feed(numpy.ones(4), label=2, ticket="t1")
        ld.run()
        assert ld.minibatch_size == 1 and ld.minibatch_class == TEST
        assert ld.current_tickets == ["t1"]
        assert (ld.minibatch_data.mem[0] == 1).all()
        assert ld.minibatch_labels.mem[0] == 2
        ld.feed(numpy.full(4, 2.0), ticket="t2")
        ld.feed(numpy.full(4, 3.0), label=1, ticket="t3")
        ld.run()
        assert ld.current_tickets == ["t2", "t3"]
        assert ld.minibatch_labels.mem.tolist() == [0, 1]
        with pytest.raises(Exception, match=r"sample shape \(3,\)"):
            ld.feed(numpy.zeros(3))
        ld.close()
        ld.run()
        assert bool(wf.stopped)
        with pytest.raises(Exception, match="is closed"):
            ld.feed(numpy.zeros(4))


def _zmq_roundtrip(mod, wf_cls, mb):
    import zmq
    wf = wf_cls(name="zmq-wf")
    ld = mod.ZeroMQLoader(wf, sample_shape=(3,), timeout=10.0,
                          minibatch_size=mb, name="zl")
    ld.initialize(device=None)
    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.RCVTIMEO = 10000
    sock.connect(ld.bound_endpoint)
    try:
        acks = []
        for i in range(mb):
            sock.send(pickle.dumps((numpy.full(3, float(i)), i)))
            acks.append(sock.recv())
        ld.run()
        got = (ld.minibatch_size, ld.minibatch_data.mem[:mb].copy(),
               ld.minibatch_labels.mem[:mb].copy(), ld.samples_served)
        sock.send(b"")
        acks.append(sock.recv())
        ld.run()
        assert bool(wf.stopped)
    finally:
        sock.close(0)
    return acks, got


@pytest.mark.parametrize("mb", [1, 3])
def test_zeromq_loader_roundtrip_and_batching(mb):
    """``tests/test_loaders.py:262, 530``: items acknowledged ``b"ok"``,
    the items queued before a run served in one minibatch in arrival
    order, an empty payload acknowledged ``b"bye"`` and closing."""
    ref = _zmq_roundtrip(ref_stream, vt.Workflow, mb)
    port = _zmq_roundtrip(stream, Workflow, mb)
    assert port[0] == ref[0] == [b"ok"] * mb + [b"bye"]
    assert port[1][0] == ref[1][0] == mb
    numpy.testing.assert_array_equal(port[1][1], ref[1][1])
    numpy.testing.assert_array_equal(port[1][2], ref[1][2])
    assert port[1][3] == ref[1][3] == mb


def test_many_concurrent_clients_each_get_their_own_row():
    """A stress of the port's ticket plane: 48 clients (more than the
    cores) at a 10 µs thread switch interval, 2 requests each; every
    client gets the forward of its own row, every ticket is answered
    once, and the pending count and the outstanding set return to
    empty."""
    import sys
    srv = Served(True, mb=8)
    xs = numpy.random.RandomState(5).rand(96, 4).astype(numpy.float32)
    results = [None] * len(xs)

    def client(c):
        for i in (c, c + 48):
            results[i] = _post(srv.url + "/api", {"input": xs[i].tolist()})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv.start()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(48)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        for x, (code, _, body) in zip(xs, results):
            assert code == 200, body
            numpy.testing.assert_allclose(body["result"], srv.alone(x),
                                          rtol=0, atol=ROW_ATOL)
        assert len({body["request_id"] for _, _, body in results}) == 96
        assert srv.api.requests_served == srv.loader.samples_served == 96
        assert srv.api._pending == 0 and not srv.api._outstanding
    finally:
        srv.close()
