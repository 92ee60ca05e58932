"""The port's continuous-batching engine (veles_tpu_torch/serving/) on
the CPU, against the reference's (veles_tpu/serving/) on the same
weights: a reference char-LM (2 RoPE blocks, dim 32) is trained one
epoch from a seed and its parameter tree carried into the port with
``convert.params_from_jax``; both engines run 3 slots, buckets (8, 16)
and max_context 48, the reference's own fixture.

The reference's engine tests are ported on the same inputs (scheduler
geometry, slot lifecycle, eos retirement, deadlines, the window
fallback, HTTP routing, /stats and /metrics, the paged pool), and three
parity checks hold the port to the reference: greedy tokens equal the
reference ``ContinuousEngine``'s exactly (decode_block 1 and 4); the
same scheduler calls give the same slots, buckets, pages and rejection
texts; and sampled rows equal the port's own solo ``generate`` with the
same seed (the port draws with ``torch.Generator``, not threefry). The
page ledger is empty after every test."""
import json
import time
import urllib.error
import urllib.request

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest

import veles_tpu as vt
from veles_tpu import prng
from veles_tpu.nn import sampling as jsampling
from veles_tpu.serving import ContinuousEngine as JContinuousEngine
from veles_tpu.serving.engine import make_request as jmake_request
from veles_tpu.serving.pages import PagePool as JPagePool
from veles_tpu.serving.scheduler import SlotScheduler as JSlotScheduler
from veles_tpu.serving.scheduler import Ticket as JTicket

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.restful_api import GenerationAPI
from veles_tpu_torch.serving import (ContinuousEngine, make_request,
                                     parse_buckets)
from veles_tpu_torch.serving.pages import PagePool
from veles_tpu_torch.serving.scheduler import SlotScheduler, Ticket
from veles_tpu_torch.telemetry.counters import counters

from conftest import import_model

ENGINE = dict(max_slots=3, buckets=(8, 16), max_context=48)


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _drained(engine):
    """Every slot retired, every page back on the free list."""
    assert engine.scheduler.busy_count() == 0
    assert engine.page_pool.ledger() == {}
    assert engine.page_pool.in_use() == 0
    assert engine.page_pool.free_count() == engine.pages


@pytest.fixture(scope="module")
def stacks():
    """(char_lm module, reference workflow, the port's stack with its
    weights)."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        lm = import_model("char_lm")
        prng.seed_all(971)
        wf = lm.build_workflow(epochs=1, minibatch_size=64, n_blocks=2,
                               dim=32, n_train=256, n_valid=64)
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
        wf.run()
        params = {unit: {k: numpy.asarray(v) for k, v in tree.items()}
                  for unit, tree in jsampling.params_of(wf).items()}
        port = params_from_jax(build_forwards(wf.layers_config,
                                              device="cpu"), params)
        yield lm, wf, port
    finally:
        vt.root.common.engine.compute_dtype = prev


@pytest.fixture(scope="module")
def served(stacks):
    lm, wf, port = stacks
    engine = ContinuousEngine(port, name="eng_t", **ENGINE).start()
    yield lm, port, engine
    engine.stop()


def _prompt(lm, seed, length=12):
    return [int(t) for t in
            lm.make_corpus(numpy.random.RandomState(seed), length)]


# -- scheduler geometry --------------------------------------------------------

def test_bucket_selection_and_rejection():
    sched = SlotScheduler(2, (8, 16), 32)
    assert sched.bucket_for(3) == 8
    assert sched.bucket_for(8) == 8
    assert sched.bucket_for(9) == 16
    assert sched.bucket_for(17) is None
    assert sched.reject_reason(5, 10) is None
    assert "bucket" in sched.reject_reason(20, 4)
    assert "max_context" in sched.reject_reason(16, 30)
    with pytest.raises(ValueError):
        SlotScheduler(2, (8, 64), 32)     # bucket beyond max_context


def test_parse_buckets_forms():
    assert parse_buckets("16, 8,8") == (8, 16)
    assert parse_buckets([32, 16]) == (16, 32)
    with pytest.raises(VelesError):
        parse_buckets("")


def test_expired_ticket_purged_even_when_pool_full():
    sched = SlotScheduler(1, (8,), 16)
    t_busy, t_old = Ticket(), Ticket(deadline=time.time() - 1)
    sched.push(make_request([1, 2], 4), t_busy)
    admitted, expired = sched.take_admissions()
    assert len(admitted) == 1 and not expired
    sched.push(make_request([1, 2], 4), t_old)
    # pool is full — the expired HEAD must still be answered
    admitted, expired = sched.take_admissions()
    assert not admitted and expired == [t_old]
    # ... and so must an expired ticket BEHIND a live head
    t_live = Ticket(deadline=time.time() + 60)
    t_mid = Ticket(deadline=time.time() - 1)
    sched.push(make_request([1, 2], 4), t_live)
    sched.push(make_request([1, 2], 4), t_mid)
    admitted, expired = sched.take_admissions()
    assert not admitted and expired == [t_mid]
    assert sched.queue_depth() == 1               # t_live kept, FIFO


def test_poisoned_head_answered_400_not_crash_loop():
    """A queued request that fits no bucket (a raw push bypassing
    accepts()) is popped and answered 400, not crash-looped while the
    pool starves behind it."""
    sched = SlotScheduler(2, (8,), 16)
    bad, good = Ticket(), Ticket()
    sched.push(make_request([1] * 20, 2), bad)
    sched.push(make_request([1, 2], 2), good)
    admitted, expired = sched.take_admissions()
    assert bad.event.is_set() and bad.code == 400
    assert "bucket" in bad.error
    assert len(admitted) == 1          # the pool kept serving
    assert not expired


def test_retire_is_idempotent():
    # a shutdown abort racing a late _finish retires the same slot
    # twice — the free list must not hold an index twice
    sched = SlotScheduler(2, (8,), 16)
    sched.push(make_request([1, 2], 4), Ticket())
    (slot,), _ = sched.take_admissions()
    sched.retire(slot)
    sched.retire(slot)
    assert sorted(sched._free) == [0, 1]


def test_paged_admission_beats_dense_at_same_hbm():
    """16 pages x 8 positions is the memory a dense pool spends on 4
    slots of max_context 32; the paged scheduler admits on each
    request's own footprint, so the same memory holds 8 short
    requests."""
    pool = PagePool(16, 8)
    sched = SlotScheduler(8, (8,), 32, page_pool=pool)
    for s in range(8):
        sched.push(make_request([1, 2, 3, 4], 4, seed=s), Ticket())
    admitted, expired = sched.take_admissions()
    assert not expired
    assert len(admitted) == 8          # dense tops out at 4
    assert pool.in_use() == 8          # one page each (8 positions)
    for slot in admitted:
        sched.retire(slot)
    assert pool.in_use() == 0
    assert pool.free_count() == 16
    assert pool.ledger() == {}


def test_admission_waits_for_pages_then_proceeds():
    """Real exhaustion at admission keeps FIFO order and waits for
    retirements (no shed)."""
    pool = PagePool(2, 8)
    sched = SlotScheduler(4, (8,), 16, page_pool=pool)
    t1, t2 = Ticket(), Ticket()
    sched.push(make_request([1] * 6, 8), t1)     # worst 14 -> 2 pages
    sched.push(make_request([1] * 6, 8), t2)
    admitted, _ = sched.take_admissions()
    assert len(admitted) == 1                    # pool can hold one
    again, _ = sched.take_admissions()
    assert not again                             # starved, not shed
    assert not t2.event.is_set()
    sched.retire(admitted[0])
    admitted, _ = sched.take_admissions()
    assert len(admitted) == 1                    # head admitted now
    assert pool.in_use() == 2
    sched.retire(admitted[0])
    assert pool.ledger() == {}


def test_page_pool_refcounts():
    """share() adds a holder, free() drops one; a page returns to the
    free list with its last holder, and sharing a free page raises."""
    pool = PagePool(3, 4)
    (page,) = pool.alloc(1)
    assert pool.share(page) == 2
    pool.free([page])
    assert pool.ledger() == {page: 1} and pool.in_use() == 1
    pool.free([page])
    pool.free([page])                            # double free tolerated
    assert pool.ledger() == {} and pool.free_count() == 3
    with pytest.raises(ValueError):
        pool.share(page)
    assert pool.alloc(4) is None                 # exhaustion
    assert pool.device_rows == 4                 # + the sink page 0


def _scheduler_story(sched_cls, pool_cls, make_req, ticket_cls):
    """One fixed sequence of scheduler calls → everything observable."""
    pool = pool_cls(6, 8)
    sched = sched_cls(3, (8, 16), 32, page_pool=pool)
    log = [sched.reject_reason(t, n) for t, n in
           ((3, 4), (20, 4), (16, 30), (8, 25), (16, 16), (1, 31))]
    for t, n in ((3, 4), (9, 6), (12, 14), (5, 3), (16, 10), (2, 2)):
        sched.push(make_req([1] * t, n), ticket_cls())

    def take():
        admitted, expired = sched.take_admissions()
        log.append([(s.idx, s.bucket, list(s.pages)) for s in admitted])
        log.append((len(expired), sched.queue_depth(),
                    sorted(pool.ledger().items()), pool.in_use()))
        return admitted

    first = take()
    log.append((sched.grow(first[0], 15), list(first[0].pages)))
    log.append((sched.grow(first[1], 40), list(first[1].pages)))
    sched.retire(first[1])
    second = take()
    for slot in first[:1] + first[2:] + second:
        sched.retire(slot)
    third = take()
    for slot in third:
        sched.retire(slot)
    log.append((sorted(pool.ledger().items()), pool.in_use(),
                sched.busy_count(), sched.queue_depth()))
    return log


def test_scheduler_matches_reference():
    """The same push / take_admissions / grow / retire sequence gives
    the same slot indices, buckets, page ids, ledgers and rejection
    texts as the reference's SlotScheduler."""
    got = _scheduler_story(SlotScheduler, PagePool, make_request, Ticket)
    ref = _scheduler_story(JSlotScheduler, JPagePool, jmake_request,
                           JTicket)
    assert got == ref
    assert got[-1] == ([], 0, 0, 0)


# -- the engine ------------------------------------------------------------------

def test_slot_lifecycle_admit_bucket_retire_reuse(served):
    """admit → prefill-bucket selection → retirement → slot reuse by a
    later request: 6 mixed-length requests through a 3-slot pool."""
    lm, port, engine = served
    before = counters.snapshot()
    admitted0, retired0 = engine.admitted, engine.retired
    buckets0 = dict(engine.prefills_by_bucket)
    reqs = [make_request(_prompt(lm, s, length=ln), n, seed=s)
            for s, ln, n in ((1, 6, 8), (2, 12, 5), (3, 9, 10),
                             (4, 16, 6), (5, 5, 7), (6, 11, 9))]
    out = engine.serve(list(reqs))
    for req, toks in zip(reqs, out):
        assert len(toks) == req["n_new"]
        assert all(0 <= t < lm.VOCAB for t in toks)
    # 6 admissions through 3 slots: slots were reused
    assert engine.admitted - admitted0 == 6
    assert engine.retired - retired0 == 6
    assert engine.peak_slots == 3
    delta = counters.delta(before)
    assert delta["veles_serving_admitted_total"] == 6
    assert delta["veles_serving_retired_total"] == 6
    assert delta["veles_serving_tokens_total"] == \
        sum(r["n_new"] for r in reqs)
    assert delta["veles_serving_prefill_dispatches_total"] == 6
    assert delta["veles_serving_decode_dispatches_total"] >= 1
    assert delta["veles_serving_pages_alloc_total"] == \
        delta["veles_serving_pages_free_total"]
    # prompts of 5, 6 → bucket 8; 9, 11, 12, 16 → bucket 16
    grown = {b: engine.prefills_by_bucket[b] - buckets0.get(b, 0)
             for b in engine.prefills_by_bucket}
    assert grown == {8: 2, 16: 4}
    _drained(engine)


def test_early_eos_retirement_frees_slot_for_queue(served):
    """A row emitting eos_id retires immediately: its tokens stop at
    the stop token (inclusive) and its slot is reused while longer
    co-tenants keep decoding."""
    lm, port, engine = served
    p = _prompt(lm, 40, length=10)
    full = engine.serve([make_request(p, 12)])[0]
    eos = full[4]
    first = full.index(eos)
    admitted0 = engine.admitted
    reqs = [make_request(p, 12, eos_id=eos),
            make_request(_prompt(lm, 41, 9), 12),
            make_request(_prompt(lm, 42, 13), 12),
            make_request(_prompt(lm, 43, 7), 12)]
    out = engine.serve(reqs)
    assert out[0] == full[:first + 1]
    assert out[0][-1] == eos
    assert len(out[0]) < 12                # retired before its n_new
    for toks in out[1:]:
        assert len(toks) == 12
    assert engine.admitted - admitted0 == 4
    _drained(engine)


def test_queued_past_deadline_answered_503(served):
    lm, port, engine = served
    before = counters.get("veles_serving_expired_total")
    ticket = Ticket(deadline=time.time() - 0.5)
    assert engine.submit(make_request(_prompt(lm, 50, 6), 4), ticket)
    assert ticket.event.wait(30)
    assert ticket.error is not None and ticket.code == 503
    assert ticket.retry_after
    assert counters.get("veles_serving_expired_total") == before + 1
    _drained(engine)


def test_failing_tick_answers_500_then_recovers(served, monkeypatch):
    """A tick that raises answers its in-flight tickets with 500 (never
    hangs them), drops the pool, and the next request is served from a
    rebuilt pool with its solo tokens."""
    lm, port, engine = served
    req = make_request(_prompt(lm, 60, 6), 6)
    real = engine._decode
    calls = []

    def broken():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("decode step failed")
        return real()

    monkeypatch.setattr(engine, "_decode", broken)
    ticket = Ticket()
    assert engine.submit(req, ticket)
    assert ticket.event.wait(30)
    assert ticket.code == 500 and "internal serving error" in ticket.error
    _drained(engine)
    assert engine.serve([req])[0] == sampling.generate(
        port, req["prompt"], req["n_new"], temperature=0)
    _drained(engine)


def test_unknown_mode_rejected_400_not_leaked(served):
    """accepts() fails CLOSED on a mode string no tick advances."""
    lm, port, engine = served
    ticket = Ticket()
    assert engine.submit(
        make_request(_prompt(lm, 140, 5), 4, mode="gredy"), ticket)
    assert ticket.event.wait(30)
    assert ticket.code == 400
    assert "mode" in ticket.error
    _drained(engine)


def test_accepts_sends_the_rest_to_the_window_plane(served):
    """What the pool does not take, with the reference's reasons: modes
    not ported to the pool, a window past max_context, a temperature
    below the clamp; the port's choose_flash has no crossover, so no
    prompt straddles one."""
    lm, port, engine = served
    p = _prompt(lm, 60, 6)
    assert engine.accepts(make_request(p, 4)) is None
    assert engine.accepts(make_request(p, 4, temperature=0.5)) is None
    for mode in ("speculative", "beam"):
        assert "window plane" in engine.accepts(
            make_request(p, 4, mode=mode))
    assert "max_context" in engine.accepts(make_request(p, 43))
    assert "bucket" in engine.accepts(make_request([1] * 17, 4))
    assert "resolution" in engine.accepts(
        make_request(p, 4, temperature=1e-4))
    assert not any(engine._kernel_straddle(t, engine.scheduler.bucket_for(t))
                   for t in range(1, 17))


def test_unported_knobs_raise(stacks):
    """A knob of the reference's engine that is not ported raises; it
    is never silently ignored."""
    _, _, port = stacks
    for knob in (dict(draft=port), dict(quant_kv=True),
                 dict(prefix_cache=True), dict(prefill_chunk=8),
                 dict(artifact="x"), dict(tp=2)):
        with pytest.raises(ValueError, match="not ported yet"):
            ContinuousEngine(port, **dict(ENGINE, **knob))
    with pytest.raises(ValueError, match="multiple of decode_block"):
        ContinuousEngine(port, page_size=6, decode_block=4, **ENGINE)


def test_page_reuse_after_retire_not_poisoned(stacks):
    """Pages freed by retired rows are handed out again at once; a
    page-constrained pool forces heavy reuse across waves, and every
    wave stays id-exact — a stale row bleeding through a reused page
    would show up here."""
    lm, _, port = stacks
    engine = ContinuousEngine(port, max_slots=3, buckets=(8,),
                              max_context=32, page_size=8, pages=6,
                              name="eng_tight").start()
    try:
        reqs_a = [make_request(_prompt(lm, 90 + i, 5), 6,
                               temperature=0.6 if i == 1 else 0.0,
                               seed=90 + i) for i in range(3)]
        reqs_b = [make_request(_prompt(lm, 95 + i, 6), 7, seed=95 + i)
                  for i in range(3)]
        ref_a = [engine.serve([r])[0] for r in reqs_a]
        for _wave in range(3):
            engine.serve(list(reqs_b))           # dirty every page
            assert engine.serve(list(reqs_a)) == ref_a
        _drained(engine)
    finally:
        engine.stop()


def test_masked_and_retired_rows_write_only_the_sink(stacks):
    """Every lane of the fixed-shape step writes somewhere: a masked or
    retired lane writes to the sink page 0, never to pages another
    slot now holds. The corpus prompts above all start with token 0,
    whose K/V at position 0 equals what a retired lane (token 0,
    position 0) would write; these prompts never hold token 0, so a
    stray write would change their answers."""
    lm, _, port = stacks
    engine = ContinuousEngine(port, max_slots=3, buckets=(8,),
                              max_context=32, page_size=8, pages=6,
                              name="eng_sink").start()
    rng = numpy.random.RandomState(7)
    try:
        reqs = [make_request(rng.randint(1, lm.VOCAB, 4 + i % 4).tolist(),
                             3 + (5 * i) % 9, seed=i) for i in range(9)]
        solo = [engine.serve([r])[0] for r in reqs]
        for _wave in range(2):
            assert engine.serve(list(reqs)) == solo
            assert engine.serve(list(reversed(reqs))) == solo[::-1]
        _drained(engine)
        # a retired row's page-table row is zeroed ...
        assert not engine._page_table.any()
        # ... and a masked lane targets the sink whatever its table holds
        engine._page_table[:] = numpy.arange(1, 13).reshape(3, 4)
        pos = numpy.array([3, 9, 40])
        page, off = engine._row_targets(pos, numpy.array([False, True,
                                                          True]))
        assert page.tolist() == [0, 6, 0] and off.tolist() == [3, 1, 0]
        engine._page_table[:] = 0
    finally:
        engine.stop()


def _greedy_requests(lm):
    return [make_request(_prompt(lm, s, length=ln), n, seed=s)
            for s, ln, n in ((11, 6, 8), (12, 12, 5), (13, 9, 10),
                             (14, 16, 6), (15, 1, 7), (16, 11, 9),
                             (17, 8, 12))]


@pytest.mark.parametrize("decode_block", [1, 4])
def test_greedy_tokens_match_reference_engine(stacks, decode_block):
    """The port's engine gives the reference ContinuousEngine's greedy
    tokens exactly, on the same weights and request list."""
    lm, wf, port = stacks
    reqs = _greedy_requests(lm)
    ref = JContinuousEngine(wf, decode_block=decode_block,
                            name="ref_%d" % decode_block, **ENGINE).start()
    try:
        want = ref.serve([jmake_request(r["prompt"], r["n_new"],
                                        seed=r["seed"]) for r in reqs])
    finally:
        ref.stop()
    engine = ContinuousEngine(port, decode_block=decode_block,
                              name="port_%d" % decode_block,
                              **ENGINE).start()
    try:
        assert engine.serve(reqs) == want
        _drained(engine)
    finally:
        engine.stop()


def test_sampled_rows_equal_solo_generate(served):
    """Sampled and greedy rows co-tenant in the pool, and each sampled
    row equals the port's own solo generate with the same seed: each
    slot draws from its own generator, one draw a token."""
    lm, port, engine = served
    reqs = [make_request(_prompt(lm, 10 + i, length=5 + i), 6 + i % 3,
                         temperature=0.8 if i % 2 else 0.0,
                         seed=50 + i) for i in range(6)]
    conc = engine.serve(list(reqs))
    for r, toks in zip(reqs, conc):
        assert toks == sampling.generate(port, r["prompt"], r["n_new"],
                                         temperature=r["temperature"],
                                         seed=r["seed"])
    assert conc == [engine.serve([r])[0] for r in reqs]
    _drained(engine)


# -- GenerationAPI over HTTP ---------------------------------------------------

def test_non_lm_workflow_degrades_to_window_worker():
    stack = build_forwards([{"type": "embedding", "vocab_size": 8,
                             "dim": 8},
                            {"type": "lm_head", "vocab_size": 8}],
                           device="cpu")
    api = GenerationAPI(stack, port=0, engine="continuous", device="cpu",
                        name="deg_g")
    api.initialize()
    try:
        assert api._engine is None         # graceful fallback, no raise
    finally:
        api.stop()


def test_bad_knob_geometry_raises_not_degrades(stacks):
    # an operator who ASKED for continuous batching must not silently
    # get the window worker because of a knob mistake
    _, _, port = stacks
    api = GenerationAPI(port, port=0, engine="continuous",
                        buckets=(8, 128), max_context=48, device="cpu",
                        name="bad_g")
    with pytest.raises(ValueError):
        api.initialize()
    assert api._service is None


@pytest.fixture(scope="module")
def api_served(stacks):
    lm, _, port = stacks
    api = GenerationAPI(port, port=0, engine="continuous", device="cpu",
                        name="capi", **ENGINE)
    api.initialize()
    url = "http://127.0.0.1:%d/generate" % api.port
    yield lm, port, api, url
    api.stop()


def test_http_greedy_and_sample_ride_the_engine(api_served):
    lm, port, api, url = api_served
    p = _prompt(lm, 70, 9)
    code, out, _ = _post(url, {"prompt": p, "n_new": 8})
    assert code == 200, out
    assert out["engine"] == "continuous"
    assert out["tokens"] == sampling.generate(port, p, 8, temperature=0)
    code, out, _ = _post(url, {"prompt": p, "n_new": 6,
                               "mode": "sample", "temperature": 0.7,
                               "seed": 11})
    assert code == 200 and out["engine"] == "continuous"
    assert out["tokens"] == sampling.generate(port, p, 6,
                                              temperature=0.7, seed=11)
    _drained(api._engine)


def test_http_oversized_request_falls_back_to_window(api_served):
    """A prompt longer than the largest bucket still gets served —
    through the window plane."""
    lm, port, api, url = api_served
    long_p = (_prompt(lm, 71, 12) * 2)[:20]     # > largest bucket 16
    code, out, _ = _post(url, {"prompt": long_p, "n_new": 5})
    assert code == 200, out
    assert "engine" not in out                  # window worker answered
    assert out["tokens"] == sampling.generate(port, long_p, 5,
                                              temperature=0)
    code, out, _ = _post(url, {"prompt": [1, 2], "n_new": 2,
                               "mode": "beam"})
    assert code == 400 and "not ported yet" in out["error"]


def test_http_metrics_and_stats_expose_occupancy(api_served):
    lm, port, api, url = api_served
    code, _, _ = _post(url, {"prompt": _prompt(lm, 73, 6), "n_new": 4})
    assert code == 200
    with urllib.request.urlopen("http://127.0.0.1:%d/stats" % api.port,
                                timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["engine"] == "continuous"
    assert stats["continuous"]["slots"] == 3
    assert stats["continuous"]["retired"] >= 1
    assert stats["continuous"]["pages_in_use"] == 0
    with urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % api.port, timeout=30) as r:
        text = r.read().decode()
    assert "veles_serving_slots 3" in text
    assert "veles_serving_queue_depth" in text
    assert "veles_serving_admitted_total" in text
    assert "veles_serving_pages_total 9" in text
    assert "veles_serving_pages_in_use 0" in text


def test_continuous_is_the_default_engine(stacks):
    """GenerationAPI with no engine argument serves through the
    ContinuousEngine, as the reference does."""
    lm, _, port = stacks
    assert root.common.serving.engine == "continuous"
    api = GenerationAPI(port, port=0, device="cpu", name="dflt",
                        **ENGINE).initialize()
    try:
        assert isinstance(api._engine, ContinuousEngine)
        base = "http://127.0.0.1:%d" % api.port
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            assert json.loads(r.read())["engine"] == "continuous"
        code, out, _ = _post(base + "/generate",
                             {"prompt": _prompt(lm, 74, 5), "n_new": 3})
        assert code == 200 and out["engine"] == "continuous"
        _drained(api._engine)
    finally:
        api.stop()


def test_many_concurrent_requests_all_answered_by_the_engine(api_served):
    """More client threads than cores, with a short switch interval,
    against the engine's queue and tick thread: every request is
    answered exactly once by the engine with its solo decode, admitted
    and retired counts agree, and no page is left held."""
    import sys
    import threading
    lm, port, api, url = api_served
    engine = api._engine
    rng = numpy.random.RandomState(21)
    payloads = [{"prompt": rng.randint(0, lm.VOCAB, 1 + i % 16).tolist(),
                 "n_new": 1 + (7 * i) % 12, "seed": i,
                 **({"mode": "sample", "temperature": 0.9} if i % 3 else {})}
                for i in range(24)]
    out = [None] * len(payloads)

    def fire(i):
        out[i] = _post(url, payloads[i])

    admitted0, retired0 = engine.admitted, engine.retired
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [code for code, _, _ in out] == [200] * len(payloads)
    assert len({body["request_id"] for _, body, _ in out}) == len(payloads)
    for p, (_, body, _) in zip(payloads, out):
        assert body["engine"] == "continuous"
        assert body["tokens"] == sampling.generate(
            port, p["prompt"], p["n_new"],
            temperature=p.get("temperature", 0.0), seed=p["seed"])
    assert engine.admitted - admitted0 == len(payloads)
    assert engine.retired - retired0 == len(payloads)
    _drained(engine)
