"""The port's QoS plane (veles_tpu_torch/serving/overload.py, the
scheduler's priority admission and the engines' lossless batch
preemption) on the CPU, against the reference's (veles_tpu/serving/
overload.py, tests/test_overload.py) on the same inputs.

- the overload module's pure functions and controllers give the
  reference's values on the same inputs and injected clocks;
- with QoS on, interactive requests pass queued batch work in the
  reference's order, counting the same deferrals; with it off the queue
  is FIFO and a mixed-priority load moves no QoS counter;
- a batch row preempted mid-decode for an interactive arrival finishes
  with the tokens of its uninterrupted decode, on the paged pool and on
  the O(1)-state lane, greedy (equal to the reference's greedy tokens
  from the same weights) and sampled (equal to the port's own solo
  decode: the port draws from ``torch.Generator``s), with one admission,
  one end-to-end and one queue-wait sample a request: deltas (2, 2, 2);
- per-ticket deadlines: the sweep expires each ticket at its own
  deadline, and ``deadline_ms`` tightens the ticket's deadline below
  ``request_timeout``; ``priority`` and ``deadline_ms`` answer the
  reference's 400s.

The engines run the reference's fixture sizes (1 block, dim 32, buckets
(8, 24), max_context 48) and are driven tick by tick, never started, so
every preemption point is deterministic."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.nn import sampling as ref_sampling
from veles_tpu.serving import overload as ref_overload
from veles_tpu.serving.recurrent import \
    generate_recurrent as ref_generate_recurrent
from veles_tpu.serving.scheduler import SlotScheduler as RefSlotScheduler
from veles_tpu.serving.scheduler import Ticket as RefTicket

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import (QOS_COUNTERS, ContinuousEngine,
                                     RecurrentEngine, generate_recurrent,
                                     make_request)
from veles_tpu_torch.serving import overload
from veles_tpu_torch.serving.scheduler import (SlotScheduler, Ticket,
                                               shed_expired, split_expired)
from veles_tpu_torch.telemetry.counters import (DESCRIPTIONS, counters,
                                                histograms)

from conftest import import_model


# -- the overload module against the reference's ---------------------------

def test_request_priority_matches_reference():
    for req in ({}, {"priority": "batch"}, {"priority": "interactive"},
                {"priority": 7}, {"priority": None}):
        assert overload.request_priority(req) \
            == ref_overload.request_priority(req)
    assert overload.QOS_PRIORITIES == ref_overload.QOS_PRIORITIES
    assert overload.RETRY_AFTER_MAX == ref_overload.RETRY_AFTER_MAX


@pytest.mark.parametrize("depth,capacity,lo,hi", [
    (0, 16, 1.0, 30.0), (4, 16, 1.0, 30.0), (64, 16, 1.0, 30.0),
    (10 ** 6, 16, 1.0, 30.0), (3, 0, 2.5, 10.0), (-5, 8, 1.0, 30.0)])
def test_retry_after_hint_matches_reference(depth, capacity, lo, hi):
    assert overload.retry_after_hint(depth, capacity, lo, hi) \
        == ref_overload.retry_after_hint(depth, capacity, lo, hi)


def test_dynamic_retry_after_provider_lifecycle():
    assert overload.dynamic_retry_after(None) is None
    assert overload.dynamic_retry_after(5.0) == 5.0
    provider = lambda: (32, 16)  # noqa: E731
    overload.set_pressure_provider(provider)
    ref_overload.set_pressure_provider(provider)
    try:
        for base in (1.0, 5.0, 29.0, 40.0):
            assert overload.dynamic_retry_after(base) \
                == ref_overload.dynamic_retry_after(base)
        assert overload.dynamic_retry_after(1.0) > 1.0
        ticket = Ticket()
        ticket.retry_after = 1.0
        assert ticket.retry_after_hint() == overload.RETRY_AFTER_MAX
    finally:
        overload.clear_pressure_provider(provider)
        ref_overload.clear_pressure_provider(provider)
    # another provider's clear leaves the current one alone
    broken = lambda: 1 / 0  # noqa: E731
    overload.set_pressure_provider(broken)
    try:
        overload.clear_pressure_provider(provider)
        assert overload.dynamic_retry_after(2.0) == 2.0   # never raises
    finally:
        overload.clear_pressure_provider(broken)
    ticket = Ticket()
    ticket.retry_after = 5.0
    assert ticket.retry_after_hint() == 5.0


def test_aimd_controller_matches_reference():
    # the final observe(None) polls each package's live histogram: start
    # both from an empty registry, whatever an earlier test in this
    # process served
    from veles_tpu.telemetry.counters import histograms as ref_histograms
    from veles_tpu_torch.telemetry.counters import histograms
    histograms.reset()
    ref_histograms.reset()
    kw = dict(slo_ms=100.0, floor=0.05, additive=0.1,
              multiplicative=0.5, interval=0.0)
    ours, ref = overload.AIMDController(**kw), \
        ref_overload.AIMDController(**kw)
    values = [250.0, 250.0, 50.0] + [500.0] * 50 + [10.0] * 7 + [None]
    for v in values:
        assert ours.observe(value_ms=v) == ref.observe(value_ms=v)
    assert ours.rate == ref.rate
    ours.rate = ref.rate = 0.5
    ours._credit = ref._credit = 0.0
    grants = [ours.grant() for _ in range(8)]
    assert grants == [ref.grant() for _ in range(8)] == [False, True] * 4
    # the interval throttles polls of the histogram signal
    slow = overload.AIMDController(interval=10.0)
    assert slow.observe(now=100.0) == 1.0
    assert slow.observe(now=101.0) == 1.0


def test_brownout_ladder_matches_reference():
    kw = dict(slo_ms=100.0, enter=1.5, exit=0.8, patience=2, cap_n_new=4)
    ours, ref = overload.BrownoutLadder(**kw), \
        ref_overload.BrownoutLadder(**kw)
    trace = [200.0, 200.0, 90.0, 90.0, 200.0, 200.0, 50.0, 50.0, 50.0,
             50.0, None, 300.0, 300.0, 300.0, 300.0, 300.0, 300.0, 300.0]
    levels = [ours.observe(v) for v in trace]
    assert levels == [ref.observe(v) for v in trace]
    assert levels[:10] == [0, 1, 1, 1, 1, 2, 2, 1, 1, 0]
    assert ours.transitions == ref.transitions
    for level in range(4):
        ours.level = ref.level = level
        for body in ({"n_new": 64, "mode": "speculative",
                      "temperature": 0.7},
                     {"n_new": 2, "mode": "speculative"},
                     {"n_new": "x", "mode": "greedy"}):
            a, b = dict(body), dict(body)
            assert ours.degrade(a) == ref.degrade(b)
            assert a == b
    with pytest.raises(ValueError, match="hysteresis"):
        overload.BrownoutLadder(enter=1.0, exit=1.0)


def test_retry_token_bucket_matches_reference():
    clock = {"t": 0.0}
    ours = overload.RetryTokenBucket(rate=2.0, burst=3,
                                     clock=lambda: clock["t"])
    ref = ref_overload.RetryTokenBucket(rate=2.0, burst=3,
                                        clock=lambda: clock["t"])
    for t, n in ((0.0, 4), (1.0, 3), (100.0, 4), (100.25, 2)):
        clock["t"] = t
        assert [ours.take() for _ in range(n)] \
            == [ref.take() for _ in range(n)]
        assert ours.available() == ref.available()


def test_governor_off_by_default_and_interactive_never_shed():
    assert overload.governor_from_config() is None
    root.common.router.qos = True
    ref_root.common.router.qos = True
    try:
        gov = overload.governor_from_config()
        ref_gov = ref_overload.governor_from_config()
        assert isinstance(gov, overload.OverloadGovernor)
        for g in (gov, ref_gov):
            g.aimd.rate = 0.0
            g.ladder.level = 3
        assert gov.admit({"priority": "interactive"}) is None
        assert gov.admit({}) is None
        before = counters.get("veles_qos_throttled_total")
        assert gov.admit({"priority": "batch"}) \
            == ref_gov.admit({"priority": "batch"})
        assert counters.get("veles_qos_throttled_total") - before == 1
        assert gov.retry_after(2.0) == ref_gov.retry_after(2.0)
        assert gov.snapshot() == ref_gov.snapshot()
        before = counters.get("veles_qos_retry_denied_total")
        allowed = [gov.allow_retry() for _ in range(25)]
        assert allowed.count(False) >= 4
        assert counters.get("veles_qos_retry_denied_total") - before \
            == allowed.count(False)
    finally:
        root.common.router.qos = False
        ref_root.common.router.qos = False


def test_qos_counters_registered_with_reference_help():
    from veles_tpu.serving import QOS_COUNTERS as REF_QOS_COUNTERS
    from veles_tpu.telemetry.counters import DESCRIPTIONS as REF_DESC
    assert QOS_COUNTERS == REF_QOS_COUNTERS
    for name in QOS_COUNTERS + ("veles_resume_tokens_total",
                                "veles_handoff_requests_total"):
        assert DESCRIPTIONS[name] == REF_DESC[name]


# -- the scheduler: promotion and per-ticket deadlines ---------------------

REQS = [{"prompt": [1, 2], "n_new": 1, "priority": "batch", "tag": 0},
        {"prompt": [1, 2], "n_new": 1, "priority": "interactive",
         "tag": 1},
        {"prompt": [1, 2], "n_new": 1, "priority": "batch", "tag": 2},
        {"prompt": [1, 2], "n_new": 1, "tag": 3}]


@pytest.mark.parametrize("qos", [False, True])
def test_admission_order_matches_reference(qos):
    orders = []
    for sched_cls, ticket_cls in ((SlotScheduler, Ticket),
                                  (RefSlotScheduler, RefTicket)):
        sched = sched_cls(max_slots=4, buckets=(8,), max_context=16)
        sched.qos = qos
        for req in REQS:
            sched.push(dict(req), ticket_cls())
        before = counters.get("veles_qos_batch_deferrals_total")
        slots, expired = sched.take_admissions()
        assert not expired
        orders.append([s.req["tag"] for s in slots])
        if sched_cls is SlotScheduler:
            deferred = counters.get("veles_qos_batch_deferrals_total") \
                - before
    assert orders[0] == orders[1] == ([1, 3, 0, 2] if qos
                                      else [0, 1, 2, 3])
    assert deferred == (2 if qos else 0)


def test_deadline_sweep_honors_per_ticket_deadline():
    sched = SlotScheduler(max_slots=1, buckets=(8,), max_context=8)
    now = time.time()
    short, long_ = Ticket(deadline=now - 0.1), Ticket(deadline=now + 60.0)
    sched.push({"tag": "short"}, short)
    sched.push({"tag": "long"}, long_)
    with sched.cv:
        live, expired = split_expired(list(sched._queue))
        sched._queue.clear()
        sched._queue.extend(live)
    shed_expired(expired)
    assert [req["tag"] for req, _t in sched._queue] == ["long"]
    assert short.code == 503 and short.outcome == "expired"
    assert long_.error is None and not long_.event.is_set()


# -- the engines: preempt and resume ----------------------------------------

@pytest.fixture(scope="module")
def stacks():
    """family → (reference workflow, the port's stack with its weights):
    the reference's tests/test_overload.py fixtures, a 1-block dim-32
    char LM trained one epoch and its LSTM twin initialised."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    out = {}
    try:
        for arch, seed, train in (("transformer", 1717, True),
                                  ("lstm", 1718, False)):
            ref_prng.seed_all(seed)
            wf = lm.build_workflow(
                epochs=1, minibatch_size=32, n_blocks=1, dim=32,
                n_train=64, n_valid=32,
                **({} if arch == "transformer" else {"arch": arch}))
            wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
            if train:
                wf.run()
            params = {u: {k: numpy.asarray(v) for k, v in t.items()}
                      for u, t in ref_sampling.params_of(wf).items()}
            out[arch] = (lm, wf, params_from_jax(
                build_forwards(wf.layers_config, device="cpu"), params))
        yield out
    finally:
        vt.root.common.engine.compute_dtype = prev


def _drive(engine, done, limit=3000):
    """Tick the never-started engine until ``done()``: manual step
    boundaries make the preemption point deterministic."""
    for _ in range(limit):
        if done():
            return True
        engine._tick()
    return done()


def _preempt_drill(engine, prompt_b, prompt_i, mode, temp):
    """A batch request preempted mid-decode by an interactive arrival on
    a 1-slot pool → (its tokens, the interactive ticket, accounting
    deltas (e2e samples, queue-wait samples, admissions))."""
    req = make_request(prompt_b, 12, temperature=temp, seed=99, mode=mode)
    req["priority"] = "batch"
    e2e0 = histograms.count("veles_serving_e2e_seconds")
    qw0 = histograms.count("veles_serving_queue_wait_seconds")
    adm0 = counters.get("veles_serving_admitted_total")
    pre0 = counters.get("veles_qos_preemptions_total")
    tok0 = counters.get("veles_qos_preempted_tokens_total")
    t_b, t_i = Ticket(mode=mode), Ticket()
    assert engine.submit(dict(req), t_b)

    def mid_decode():
        active = engine.scheduler.active()
        return bool(active and active[0].tokens
                    and len(active[0].tokens) < 8)
    assert _drive(engine, mid_decode, limit=200)
    emitted = len(engine.scheduler.active()[0].tokens)
    req_i = make_request(prompt_i, 3)
    req_i["priority"] = "interactive"
    assert engine.submit(req_i, t_i)
    assert _drive(engine, lambda: t_b.event.is_set()
                  and t_i.event.is_set())
    assert t_i.error is None and t_b.error is None
    assert counters.get("veles_qos_preemptions_total") - pre0 == 1
    assert counters.get("veles_qos_preempted_tokens_total") - tok0 \
        == emitted == engine.preempted_tokens
    assert engine.preemptions == 1
    deltas = (histograms.count("veles_serving_e2e_seconds") - e2e0,
              histograms.count("veles_serving_queue_wait_seconds") - qw0,
              int(counters.get("veles_serving_admitted_total") - adm0))
    return t_b.result["tokens"], t_i, deltas


def _prompts(lm, seed):
    rng = numpy.random.RandomState(seed)
    return ([int(t) for t in rng.randint(0, lm.VOCAB, 6)],
            [int(t) for t in rng.randint(0, lm.VOCAB, 5)])


@pytest.fixture
def qos_on():
    root.common.serving.qos = True
    try:
        yield
    finally:
        root.common.serving.qos = False


@pytest.mark.parametrize("mode,temp", [("greedy", 0.0), ("sample", 0.9)])
def test_continuous_preempt_resume_bit_identical(stacks, qos_on, mode,
                                                 temp):
    lm, wf, port = stacks["transformer"]
    prompt_b, prompt_i = _prompts(lm, 5)
    eng = ContinuousEngine(port, max_slots=1, buckets=(8, 24),
                           max_context=48, name="qos_cont_" + mode)
    assert eng.qos and eng.scheduler.qos
    got, t_i, deltas = _preempt_drill(eng, prompt_b, prompt_i, mode, temp)
    solo = sampling.generate(port, prompt_b, 12, temperature=temp, seed=99)
    assert got == solo
    if mode == "greedy":
        assert got == [int(t) for t in ref_sampling.generate(
            wf, prompt_b, 12, temperature=0)]
    assert t_i.result["tokens"] == sampling.generate(
        port, prompt_i, 3, temperature=0)
    assert deltas == (2, 2, 2)
    assert eng.page_pool.in_use() == 0 and not eng.page_pool.ledger()
    st = eng.stats()
    assert (st["qos"], st["preemptions"]) == (1, 1)


@pytest.mark.parametrize("mode,temp", [("greedy", 0.0), ("sample", 0.9)])
def test_recurrent_preempt_resume_bit_identical(stacks, qos_on, mode,
                                                temp):
    lm, wf, port = stacks["lstm"]
    prompt_b, prompt_i = _prompts(lm, 6)
    eng = RecurrentEngine(port, max_slots=1, max_context=48, page_size=8,
                          name="qos_rec_" + mode)
    got, t_i, deltas = _preempt_drill(eng, prompt_b, prompt_i, mode, temp)
    assert got == generate_recurrent(port, prompt_b, 12, temperature=temp,
                                     seed=99, mode=mode)
    if mode == "greedy":
        assert got == [int(t) for t in ref_generate_recurrent(
            wf, prompt_b, 12)]
    assert len(t_i.result["tokens"]) == 3
    assert deltas == (2, 2, 2)
    assert eng.stats()["preempted_tokens"] == eng.preempted_tokens > 0


def test_twice_preempted_row_accumulates_its_resume(stacks, qos_on):
    """Two interactive arrivals, one after the other, preempt the same
    sampled batch row twice: its generator advances by every token it
    ever emitted, and the answer is still its solo decode."""
    lm, _wf, port = stacks["transformer"]
    prompt_b, prompt_i = _prompts(lm, 7)
    eng = ContinuousEngine(port, max_slots=1, buckets=(8, 24),
                           max_context=48, name="qos_twice")
    req = make_request(prompt_b, 14, temperature=0.8, seed=5,
                       mode="sample")
    req["priority"] = "batch"
    t_b = Ticket(mode="sample")
    assert eng.submit(req, t_b)
    for _ in range(2):
        assert _drive(eng, lambda: eng.scheduler.active()
                      and eng.scheduler.active()[0].tokens, limit=50)
        eng._tick()
        t_i = Ticket()
        assert eng.submit(make_request(prompt_i, 2), t_i)
        assert _drive(eng, t_i.event.is_set)
    assert _drive(eng, t_b.event.is_set)
    assert eng.preemptions == 2
    assert t_b.result["tokens"] == sampling.generate(
        port, prompt_b, 14, temperature=0.8, seed=5)


def test_preempt_knob_off_only_reorders(stacks, qos_on):
    """``qos_preempt = False`` keeps priority admission and preempts
    nothing: the interactive request waits for the batch row."""
    lm, _wf, port = stacks["transformer"]
    prompt_b, prompt_i = _prompts(lm, 8)
    root.common.serving.qos_preempt = False
    try:
        eng = ContinuousEngine(port, max_slots=1, buckets=(8, 24),
                               max_context=48, name="qos_nopreempt")
        req = make_request(prompt_b, 6)
        req["priority"] = "batch"
        t_b, t_i = Ticket(), Ticket()
        assert eng.submit(req, t_b)
        eng._tick()
        assert eng.submit(make_request(prompt_i, 2), t_i)
        assert _drive(eng, lambda: t_b.event.is_set()
                      and t_i.event.is_set())
        assert t_b.error is None and t_i.error is None
        # one slot: the interactive request waited for the batch row
        assert t_i.admitted >= t_b.admitted
        assert len(t_b.result["tokens"]) == 6
        assert eng.preemptions == 0
    finally:
        root.common.serving.qos_preempt = True


def test_feature_off_lock_no_qos_counters(stacks):
    """With every knob off (the default), a mixed-priority load moves no
    QoS counter and admits strictly FIFO."""
    lm, _wf, port = stacks["transformer"]
    rng = numpy.random.RandomState(7)
    before = {name: counters.get(name) for name in QOS_COUNTERS}
    assert root.common.serving.qos is False
    assert root.common.serving.qos_preempt is True
    eng = ContinuousEngine(port, max_slots=2, buckets=(8,),
                           max_context=24, name="qos_off")
    assert eng.qos is False and eng.scheduler.qos is False
    tickets = []
    for i in range(4):
        req = make_request([int(t) for t in rng.randint(0, lm.VOCAB, 5)],
                           3)
        req["priority"] = "batch" if i % 2 else "interactive"
        ticket = Ticket()
        assert eng.submit(req, ticket)
        tickets.append(ticket)
    assert _drive(eng, lambda: all(t.event.is_set() for t in tickets))
    assert all(t.error is None for t in tickets)
    admitted = [t.admitted for t in tickets]
    assert admitted == sorted(admitted)
    assert eng.preemptions == 0
    for name in QOS_COUNTERS:
        assert counters.get(name) == before[name], name


# -- the request's QoS fields over the API ----------------------------------

@pytest.fixture(scope="module")
def api_parse(stacks):
    return GenerationAPI(stacks["transformer"][2], port=0, device="cpu",
                         engine="window", request_timeout=30.0,
                         name="qos_parse")


@pytest.mark.parametrize("extra,message", [
    ({"priority": "urgent"}, "'priority' must be one of"),
    ({"priority": 1}, "'priority' must be one of"),
    ({"deadline_ms": 0}, "'deadline_ms' must be a positive number"),
    ({"deadline_ms": -5}, "'deadline_ms' must be a positive number"),
    ({"deadline_ms": True}, "'deadline_ms' must be a positive number"),
    ({"deadline_ms": "10"}, "'deadline_ms' must be a positive number")])
def test_parse_refuses_bad_qos_fields_as_reference(api_parse, extra,
                                                   message):
    body = dict({"prompt": [1, 2, 3], "n_new": 2}, **extra)
    with pytest.raises(ValueError, match=message):
        api_parse._parse(body)


def test_parse_qos_fields_default_and_pass_through(api_parse):
    req = api_parse._parse({"prompt": [1, 2], "n_new": 2})
    assert (req["priority"], req["deadline_ms"], req["resume_k"]) \
        == ("interactive", None, 0)
    req = api_parse._parse({"prompt": [1, 2], "n_new": 2,
                            "priority": "batch", "deadline_ms": 250})
    assert (req["priority"], req["deadline_ms"]) == ("batch", 250.0)


def test_deadline_ms_tightens_the_ticket_deadline(stacks):
    """A request whose ``deadline_ms`` passes while the tick thread is
    held is answered 503 expired at the next step boundary, long before
    ``request_timeout``."""
    lm, _wf, port = stacks["transformer"]
    api = GenerationAPI(port, port=0, device="cpu", max_slots=1,
                        buckets=(8, 24), max_context=48,
                        request_timeout=60.0, name="qos_deadline")
    engine = None
    try:
        api.initialize()
        engine = api._engine
        hold = threading.Event()
        real_tick = engine._tick

        def held_tick():
            hold.wait(10.0)
            real_tick()
        engine._tick = held_tick
        url = "http://127.0.0.1:%d/generate" % api.port
        out = {}

        def post(key, body):
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    out[key] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                out[key] = (e.code, json.loads(e.read()))
        t0 = time.time()
        th = threading.Thread(target=post, args=(
            "short", {"prompt": [1, 2, 3], "n_new": 2,
                      "deadline_ms": 200}))
        th.start()
        time.sleep(0.6)
        hold.set()
        th.join(timeout=30)
        assert out["short"][0] == 503, out
        assert "expired" in out["short"][1]["error"]
        assert time.time() - t0 < 30.0
    finally:
        api.stop()
