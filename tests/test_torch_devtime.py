"""The port's device-time plane (veles_tpu_torch/telemetry/devtime.py)
against the reference's on the CPU: the interval union, the device-lane
filter, per-stream self-time, span attribution and the gate arithmetic
give equal results on tests/test_devtime.py's synthetic XLA-shaped
events; a ``torch.profiler`` capture in kineto's format (a trimmed real
capture of an H100, tests/fixtures/kineto_h100_trace.json) is filtered
to its kernel, memcpy and memset events, one lane per stream; torn
traces salvage alike; ``measure`` on the CPU is the counted host-sync
source, and on a CUDA device without a card it raises."""
import copy
import gzip
import importlib
import json
import os

import pytest

from veles_tpu.telemetry import devtime as ref
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.telemetry import devtime as port

counters = importlib.import_module("veles_tpu_torch.telemetry.counters")

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "kineto_h100_trace.json")


def _fake_trace(extra=()):
    """tests/test_devtime.py's XLA-shaped trace: one TPU device process
    with an "XLA Ops" stream (two overlapping events covering 150 us) and
    an enveloping "XLA Modules" lane, plus a busy host process."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 11,
         "args": {"name": "XLA Modules"}},
        {"ph": "X", "pid": 1, "tid": 10, "ts": 0.0, "dur": 100.0,
         "name": "fusion.1"},
        {"ph": "X", "pid": 1, "tid": 10, "ts": 50.0, "dur": 100.0,
         "name": "fusion.2"},
        {"ph": "X", "pid": 1, "tid": 11, "ts": 0.0, "dur": 1000.0,
         "name": "jit_epoch_block"},
        {"ph": "X", "pid": 2, "tid": 1, "ts": 0.0, "dur": 99999.0,
         "name": "python"},
    ] + list(extra)


def _no_ops_lane():
    return [e for e in _fake_trace()
            if not (e.get("ph") == "M" and e.get("name") == "thread_name")]


SPANS = [{"name": "train_step.epoch_block", "ts": 0.0, "dur": 75e-6},
         {"name": "train_step.epoch_block", "ts": 100e-6, "dur": 50e-6},
         {"name": "unit.loader", "ts": 200e-6, "dur": 50e-6}]


@pytest.mark.parametrize("ivals", [
    [], [(0, 10)], [(0, 10), (5, 15)], [(0, 10), (2, 5)],
    [(0, 10), (20, 30)], [(20, 30), (0, 10), (5, 12)]])
def test_interval_union_equal(ivals):
    assert port._interval_union_us(ivals) == ref._interval_union_us(ivals)


@pytest.mark.parametrize("events", [_fake_trace, _no_ops_lane])
def test_xla_traces_read_as_the_reference_reads_them(events):
    assert port.device_events(events()) == ref.device_events(events())
    assert port.device_self_time(events()) == \
        ref.device_self_time(events())
    for offset in (0.0, None):
        assert port.attribute_spans(events(), SPANS, offset) == \
            ref.attribute_spans(events(), SPANS, offset)
    shifted = [dict(s, ts=s["ts"] + 1000.0) for s in SPANS]
    assert port.attribute_spans(events(), shifted) == \
        ref.attribute_spans(events(), shifted)


def _capture():
    with open(FIXTURE) as f:
        return json.load(f)["traceEvents"]


def test_kineto_capture_filtered_to_device_lanes():
    events = _capture()
    dev = port.device_events(events)
    assert len(dev) == 12
    assert {e["cat"] for e in dev} == {"kernel", "gpu_memcpy",
                                       "gpu_memset"}
    assert all(e["pid"] == 0 for e in dev)          # the "GPU 0" process
    st = port.device_self_time(events)
    assert set(st["by_stream"]) == {"GPU 0/stream 7", "GPU 0/stream 13"}
    assert st["n_events"] == 12
    per_stream = {}
    for e in dev:
        per_stream.setdefault(e["tid"], []).append(
            (e["ts"], e["ts"] + e["dur"]))
    assert st["device_time_s"] == pytest.approx(sum(
        port._interval_union_us(v) for v in per_stream.values()) / 1e6)
    flash = [e for e in dev if "flash_fwd_kernel" in e["name"]]
    assert len(flash) == 3
    # a GPU-lane annotation envelope and host events never count
    envelope = {"ph": "X", "cat": "gpu_user_annotation", "pid": 0,
                "tid": 7, "name": "serving.prefill",
                "ts": dev[0]["ts"] - 10, "dur": 1e6}
    assert port.device_self_time(events + [envelope]) == st
    # the anchor the capture recorded on the host clock puts spans on
    # the trace clock
    anchor = [e for e in events if e.get("name") == "veles.anchor"][0]
    h = (anchor["ts"] + anchor["dur"] / 2) / 1e6
    assert port._anchor_offset_us(
        [dict(anchor, name=port.ANCHOR)], h, h) == pytest.approx(0.0)
    t0 = flash[0]["ts"]
    window = {"name": "serving.prefill", "ts": 0.0,
              "dur": (flash[-1]["ts"] + flash[-1]["dur"] - t0) / 1e6}
    per = port.attribute_spans(events, [window], offset_us=t0)
    assert per["serving.prefill"]["events"] == 3
    # the trace's µs since its base time (~1.4e12) hold ~1e-4 µs
    assert per["serving.prefill"]["device_time_s"] == pytest.approx(
        sum(e["dur"] for e in flash) / 1e6, rel=1e-5)
    kernels = port._by_kernel(events)
    assert sum(r["events"] for r in kernels.values()) == 12


def test_trace_loading_and_salvage_equal(tmp_path):
    doc = {"displayTimeUnit": "ns", "traceEvents": _fake_trace()}
    plain = str(tmp_path / "t.json")
    json.dump(doc, open(plain, "w"))
    gz = str(tmp_path / "t.json.gz")
    with gzip.open(gz, "wt") as f:
        json.dump(doc, f)
    bare = str(tmp_path / "bare.json")
    json.dump(_fake_trace(), open(bare, "w"))
    torn = str(tmp_path / "torn.json")
    text = json.dumps(doc)
    open(torn, "w").write(text[:text.index('"jit_epoch_block"') + 5])
    for path in (plain, gz, bare, torn, FIXTURE):
        assert port.load_trace_events(path) == ref.load_trace_events(path)
    assert len(port.load_trace_events(torn)) == 6


def _sec(per_epoch=0.5, source="profiler", **over):
    out = {"device_time_s": per_epoch * 4, "wall_time_s": per_epoch * 5,
           "device_time_per_epoch": per_epoch, "source": source}
    out.update(over)
    return out


def test_gate_arithmetic_equal():
    wall = _sec()
    wall["wall_time_s"] = wall["device_time_s"] / 2
    missing = _sec()
    del missing["device_time_per_epoch"]
    cases = [(_sec(0.5), _sec(0.6), {}), (_sec(0.5), _sec(0.7), {}),
             (_sec(0.5), _sec(0.7), {"timing": False}),
             (_sec(0.5), _sec(0.7), {"tolerance": ref.LEGACY_TOLERANCE}),
             (_sec(), _sec(0.0), {}), (_sec(), wall, {}),
             (_sec(), _sec(source="guesswork"), {}), (_sec(), missing, {}),
             (None, _sec(), {"base_rate": 100.0, "cur_rate": 50.0}),
             (None, _sec(), {"base_rate": 100.0, "cur_rate": 1.0}),
             (_sec(), None, {"base_rate": 1.0, "cur_rate": 1.0})]
    for base, cur, kw in cases:
        assert port.compare_sections("s", copy.deepcopy(base),
                                     copy.deepcopy(cur), **kw) == \
            ref.compare_sections("s", base, cur, **kw)
    assert port.section_invariants("s", _sec()) == []
    assert (port.DEVTIME_TOLERANCE, port.LEGACY_TOLERANCE) == \
        (ref.DEVTIME_TOLERANCE, ref.LEGACY_TOLERANCE)


def test_measure_on_the_cpu_is_the_counted_host_sync():
    calls = {"fn": 0, "sync": 0}

    def fn():
        calls["fn"] += 1

    def sync():
        calls["sync"] += 1

    before = counters.counters.snapshot()
    rec = port.measure(fn, sync, calls=3, device="cpu")
    delta = counters.counters.delta(before)
    assert rec["source"] == "host_sync"
    assert rec["calls"] == 3 and calls == {"fn": 3, "sync": 2}
    assert rec["wall_time_s"] >= rec["device_time_s"] > 0
    assert rec["device_time_per_call"] == pytest.approx(
        rec["device_time_s"] / 3)
    assert rec["idle_share"] == 0.0
    assert delta.get("veles_devtime_fallbacks_total") == 1
    assert not delta.get("veles_devtime_captures_total")
    assert port.section_invariants("s", dict(
        rec, device_time_per_epoch=rec["device_time_per_call"])) == []


def test_measure_on_a_cuda_device_never_falls_back(monkeypatch):
    """Without a card, asking for the card raises — no host-time record
    stands in for device time."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = counters.counters.snapshot()
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(VelesError, match="CUDA"):
            port.measure(lambda: None, device=device)
    assert counters.counters.delta(before) == {}


def test_span_time_of_an_inner_event_is_its_dur_at_a_large_clock():
    """A kernel wholly inside its span counts its ``dur``: at a trace
    clock of ~1.76e15 µs a float64 ``ts + dur`` keeps ~0.1 µs, which
    once put the span's time below the kernel's on the card."""
    ts = 1760000000000000.3
    events = [{"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "GPU 0"}},
              {"ph": "X", "cat": "kernel", "name": "k", "pid": 1,
               "tid": 7, "ts": ts, "dur": 52.286}]
    span = [{"name": "s", "ts": 100.0, "dur": 1e-3}]
    got = port.attribute_spans(events, span, offset_us=ts - 100e6 - 10.0)
    assert got["s"]["device_time_s"] >= port._by_kernel(
        events)["k"]["device_time_s"]
    assert got["s"]["device_time_s"] == pytest.approx(52.286e-6, abs=1e-15)


def test_anchor_with_the_tightest_bracket_puts_the_clocks_together():
    """Of several anchors, the one whose host bracket has the least slack
    over its trace event sets the offset: a host stall between an
    anchor and its clock read (the first anchor here, 2 ms) moves only
    that anchor's bracket midpoint."""
    offset = 1.0e9               # trace µs − host µs
    anchors, brackets = [], []
    for i, (h0, stall) in enumerate(((10.0, 2e-3), (10.01, 0.0),
                                     (10.02, 1e-4))):
        ts = h0 * 1e6 + offset + 20.0
        anchors.append({"ph": "X", "name": port.ANCHOR, "ts": ts,
                        "dur": 40.0})
        brackets.append((h0, h0 + 80e-6 + stall))
    got = port._anchor_offset_us(list(reversed(anchors)), brackets)
    assert got == pytest.approx(offset, abs=1e-3)
    # the stalled anchor alone is off by half its stall
    assert port._anchor_offset_us(anchors[:1], *brackets[0]) == \
        pytest.approx(offset - 1000.0, abs=1e-3)
    assert port._anchor_offset_us([], brackets) is None
