"""The port's graph engine (mutable.py, units.py, workflow.py,
plumbing.py) against the reference's: the same Bool expressions give the
same values, attribute links alias both ways, gates block and skip the
same units, and a Repeater loop runs its units in the reference's order.
Both packages build the same graph and record what runs."""
import pytest

import veles_tpu.mutable as ref_mutable
import veles_tpu.plumbing as ref_plumbing
import veles_tpu.units as ref_units
import veles_tpu.workflow as ref_workflow
from veles_tpu_torch import mutable, plumbing, units, workflow
from veles_tpu_torch.error import Bug

PACKAGES = {
    "ref": (ref_mutable, ref_units, ref_workflow, ref_plumbing),
    "port": (mutable, units, workflow, plumbing),
}

EXPRESSIONS = [
    lambda a, b, c: ~a,
    lambda a, b, c: a & b,
    lambda a, b, c: a | b,
    lambda a, b, c: a ^ b,
    lambda a, b, c: ~a & (b | c),
    lambda a, b, c: (a ^ c) | ~b,
    lambda a, b, c: a & True,
    lambda a, b, c: False | ~c,
]


@pytest.mark.parametrize("expr", range(len(EXPRESSIONS)))
def test_bool_algebra_matches(expr):
    for values in [(x, y, z) for x in (0, 1) for y in (0, 1)
                   for z in (0, 1)]:
        got = {}
        for pkg, (mut, _, _, _) in PACKAGES.items():
            flags = [mut.Bool(False) for _ in range(3)]
            derived = EXPRESSIONS[expr](*flags)
            for f, v in zip(flags, values):
                f <<= v                       # operands re-read lazily
            got[pkg] = bool(derived)
        assert got["port"] == got["ref"], values


def test_bool_assignment_and_callback():
    fired = []
    flag = mutable.Bool()
    flag.on_true = lambda: fired.append(1)
    same = flag
    flag <<= True
    assert same is flag and bool(same) and fired == [1]
    with pytest.raises(ValueError):
        derived = ~flag
        derived <<= False


class _Holder:
    def __init__(self, value):
        self.value = value


def test_linkable_attribute_aliases():
    src, dst, sibling = _Holder(1), _Holder(2), _Holder(3)
    mutable.link(dst, "value", src)
    assert dst.value == 1
    src.value = 5
    assert dst.value == 5
    dst.value = 7                              # writes reach the source
    assert src.value == 7 and sibling.value == 3
    mutable.LinkableAttribute.unlink(dst, "value")
    src.value = 9
    assert dst.value == 7


def _loop_graph(pkg, n_laps, gate):
    """StartPoint → Repeater → a → b → (c | d) → decide ┐ back to the
    Repeater until ``n_laps`` laps; c is gate-skipped on odd laps, d is
    gate-blocked on lap 2 (which starves the join). Returns the run
    order and whether the workflow stopped."""
    mut, uni, wfm, plb = PACKAGES[pkg]
    order = []

    class Rec(uni.Unit):
        hide_from_registry = True

        def run(self):
            order.append(self.name)

    class Decide(uni.Unit):
        hide_from_registry = True

        def __init__(self, wf, **kw):
            super().__init__(wf, **kw)
            self.laps = 0
            self.complete = mut.Bool(False)
            self.odd = mut.Bool(False)
            self.second = mut.Bool(False)

        def run(self):
            order.append(self.name)
            self.laps += 1
            self.odd <<= self.laps % 2 == 1
            self.second <<= self.laps == 2
            self.complete <<= self.laps >= n_laps

    wf = wfm.Workflow(name="loop")
    rep = plb.Repeater(wf)
    a, b, c, d = (Rec(wf, name=n) for n in "abcd")
    dec = Decide(wf, name="decide")
    rep.link_from(wf.start_point)
    a.link_from(rep)
    b.link_from(a)
    c.link_from(b)
    d.link_from(b)
    dec.link_from(c, d)
    rep.link_from(dec)
    if gate:
        c.gate_skip = dec.odd
        d.gate_block = dec.second & ~dec.complete
    rep.gate_block = dec.complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~dec.complete
    wf.initialize()
    wf.run()
    return order, bool(wf.stopped)


@pytest.mark.parametrize("laps,gate", [(1, False), (3, False), (4, True)])
def test_repeater_loop_runs_in_reference_order(laps, gate):
    ref_order, ref_stopped = _loop_graph("ref", laps, gate)
    port_order, port_stopped = _loop_graph("port", laps, gate)
    assert port_order == ref_order
    # a blocked join (d on lap 2) starves the loop in both packages
    assert port_stopped == ref_stopped == (not gate)


def test_link_attrs_and_demand():
    wf = workflow.Workflow(name="w")
    src = units.Unit(wf, name="src")
    src.payload = 1
    dst = units.Unit(wf, name="dst")
    dst.demand("payload")
    assert dst.initialize() is True              # not there yet: re-queue
    dst.link_attrs(src, "payload")
    assert dst.initialize() is None and dst.payload == 1
    orphan = units.Unit(wf, name="orphan")
    orphan.demand("never")
    with pytest.raises(Bug, match="deadlock"):
        wf.initialize()


def test_unit_registry_maps_layer_types():
    from veles_tpu_torch.nn import standard_workflow  # noqa: F401
    for name in ("all2all", "all2all_tanh", "softmax", "train_step",
                 "decision_gd", "evaluator_softmax", "lr_adjust"):
        assert name in units.UnitRegistry.mapping, name
    with pytest.raises(Bug, match="duplicate"):
        type("Other", (units.Unit,), {"MAPPING": "softmax"})
