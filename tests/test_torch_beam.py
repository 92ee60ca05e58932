"""The port's beam search (veles_tpu_torch/nn/beam.py and the continuous
engine's beam groups) against the reference's ``veles_tpu.nn.beam`` on
the same weights: the tiny LM of tests/test_torch_speculative.py (2 RoPE
blocks, dim 32, vocab 32, initialised by the reference from a seed and
carried over with ``convert.params_from_jax``).

- ``beam_generate``: best tokens and every hypothesis equal the
  reference's, scores within 1e-5; with an eos the frozen lanes and the
  length-penalised ranking match; beam 1 is greedy; beam > vocab,
  beam < 1 and n_new < 1 are refused as the reference refuses them;
  ties keep ``lax.top_k``'s order (the lower index first);
- the pool: a beam group of width 2 on the continuous engine equals the
  solo search (tokens exact, scores within 1e-5), for groups whose
  parents cross and form cycles; greedy, sampled, speculative and beam
  rows sharing one step boundary each equal their solo decodes (the
  reference's co-tenancy bar); n_new 1 answers at admission; the page
  ledger is empty afterwards."""
import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu.nn.beam import beam_generate as jbeam_generate

from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.beam import _beam_topk, _top, beam_generate
from veles_tpu_torch.nn.speculative import generate_speculative
from veles_tpu_torch.serving import ContinuousEngine, make_request
from veles_tpu_torch.serving.scheduler import Ticket

from conftest import import_model
from test_torch_speculative import VOCAB, lm_layers, prompt, reference_pair

TOL_SCORE = 1e-5


@pytest.fixture(scope="module")
def lms():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    try:
        yield (reference_pair(lm, lm_layers(2), 4321, "target"),
               reference_pair(lm, lm_layers(1), 99, "draft"))
    finally:
        vt.root.common.engine.compute_dtype = prev


@pytest.mark.parametrize("beam,eos", [(4, None), (3, 5)],
                         ids=["beam4", "beam3_eos"])
def test_beam_matches_reference(lms, beam, eos):
    (jt, tt), _ = lms
    p = prompt(20, 9)
    want, jst = jbeam_generate(jt, p, 8, beam=beam, eos_id=eos,
                               length_penalty=0.6 if eos else 0.0)
    got, st = beam_generate(tt, p, 8, beam=beam, eos_id=eos,
                            length_penalty=0.6 if eos else 0.0)
    assert got == want
    assert st["beams"] == jst["beams"]
    assert st["finished"] == jst["finished"]
    numpy.testing.assert_allclose(st["scores"], jst["scores"], rtol=0,
                                  atol=TOL_SCORE)


def test_beam_one_is_greedy(lms):
    (_, tt), _ = lms
    p = prompt(21)
    assert beam_generate(tt, p, 7, beam=1)[0] == sampling.generate(
        tt, p, 7, temperature=0)


def test_beam_refusals_match_reference(lms):
    (jt, tt), _ = lms
    for gen, wf in ((jbeam_generate, jt), (beam_generate, tt)):
        with pytest.raises(ValueError, match="exceeds the head's vocab"):
            gen(wf, [1, 2], 4, beam=VOCAB + 1)
        with pytest.raises(ValueError, match="beam must be >= 1"):
            gen(wf, [1, 2], 4, beam=0)
        with pytest.raises(ValueError, match="n_new must be >= 1"):
            gen(wf, [1, 2], 0)
    with pytest.raises(VelesError, match="single prompt"):
        beam_generate(tt, [[1, 2]], 4)


def test_top_keeps_the_lower_index_first_among_ties():
    vals, idx = _top(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 4)
    assert idx.tolist() == [1, 2, 4, 3]
    assert vals.tolist() == [3.0, 3.0, 3.0, 2.0]
    # equal joint scores across parents: the lower flat index survives
    logits = torch.zeros((1, 2, 3))
    tok, parent, scores, fin = _beam_topk(
        logits, torch.zeros((1, 2)), torch.zeros((1, 2), dtype=torch.bool),
        torch.tensor([-1]))
    assert parent.tolist() == [[0, 0]] and tok.tolist() == [[0, 1]]
    assert not fin.any()


def test_frozen_lane_keeps_its_score():
    """A finished hypothesis continues only with eos, at zero cost."""
    logits = torch.randn((1, 2, 6), generator=torch.Generator().manual_seed(1))
    scores = torch.tensor([[-0.5, -9.0]])
    fin = torch.tensor([[True, False]])
    tok, parent, new, nfin = _beam_topk(logits, scores, fin,
                                        torch.tensor([4]))
    assert (tok[0, 0], parent[0, 0]) == (4, 0)
    assert float(new[0, 0]) == -0.5 and bool(nfin[0, 0])


# -- beam groups on the continuous engine ------------------------------------
@pytest.fixture(scope="module")
def pool(lms):
    (_, tt), (_, td) = lms
    engine = ContinuousEngine(tt, max_slots=5, buckets=(8, 16),
                              max_context=48, page_size=8, spec_gamma=3,
                              beam_width=2, draft=td,
                              name="beam_pool").start()
    yield engine
    engine.stop()


@pytest.mark.parametrize("seed", [110, 111, 112])
def test_pooled_beam_matches_solo(lms, pool, seed):
    """Hypothesis rows on the page tables, the group top-k step and the
    page reorder by parent give ``beam_generate``'s best tokens and
    scores; 12 steps over pages of 8 cross page boundaries."""
    (_, tt), _ = lms
    p = prompt(seed, 6)
    res = pool.serve_results([make_request(p, 12, mode="beam",
                                           beam=2)])[0]
    solo, st = beam_generate(tt, p, 12, beam=2)
    assert res["engine"] == "continuous"
    assert res["tokens"] == solo
    numpy.testing.assert_allclose(res["scores"], st["scores"], rtol=0,
                                  atol=TOL_SCORE)
    assert pool.page_pool.ledger() == {}


def test_pooled_beam_of_one_token_answers_at_admission(lms, pool):
    (_, tt), _ = lms
    p = prompt(113, 5)
    res = pool.serve_results([make_request(p, 1, mode="beam", beam=2)])[0]
    assert res["tokens"] == beam_generate(tt, p, 1, beam=2)[0]
    assert pool.scheduler.busy_count() == 0
    assert pool.page_pool.ledger() == {}


def test_reorder_survives_parent_cycles(lms, pool):
    """Parents that swap rows (a cycle) must read every source page
    before any is written: the reordered caches equal the solo search's
    gathered ones, so the next step's scores agree."""
    (_, tt), _ = lms
    engine = pool
    seen_cycle = []
    reorder = engine._reorder_pages

    def spy(groups, parent):
        for row in parent:
            if list(row) == sorted(row, reverse=True) and \
                    len(set(row)) == len(row) > 1:
                seen_cycle.append(list(row))
        return reorder(groups, parent)

    engine._reorder_pages = spy
    try:
        for seed in range(120, 132):
            p = prompt(seed, 5)
            res = engine.serve_results([make_request(p, 10, mode="beam",
                                                     beam=2)])[0]
            assert res["tokens"] == beam_generate(tt, p, 10, beam=2)[0]
    finally:
        del engine._reorder_pages
    assert seen_cycle, "no step swapped its parents"


def test_mixed_mode_cotenancy_all_match_solo(lms, pool):
    """Greedy, sampled, speculative and beam rows sharing one step
    boundary each equal their solo decode: no mode perturbs another's
    tokens (the reference's co-tenancy bar)."""
    (_, tt), (_, td) = lms
    pg, ps, pv, pb = (prompt(s, n) for s, n in
                      ((140, 6), (141, 9), (142, 7), (143, 5)))
    reqs = [make_request(pg, 8),
            make_request(ps, 7, temperature=0.8, seed=7, mode="sample"),
            make_request(pv, 8, mode="speculative", gamma=3),
            make_request(pb, 6, mode="beam", beam=2)]
    tickets = [Ticket() for _ in reqs]
    with pool.scheduler.cv:      # one step boundary admits all four
        for r, t in zip(reqs, tickets):
            assert pool.submit(r, t)
    for t in tickets:
        assert t.event.wait(120)
        assert t.error is None, t.error
    assert pool.peak_slots == 5
    assert tickets[0].result["tokens"] == sampling.generate(
        tt, pg, 8, temperature=0)
    assert tickets[1].result["tokens"] == sampling.generate(
        tt, ps, 7, temperature=0.8, seed=7)
    assert tickets[2].result["tokens"] == generate_speculative(
        tt, td, pv, 8, gamma=3)[0]
    assert tickets[2].result["rounds"] >= 1
    assert tickets[3].result["tokens"] == beam_generate(tt, pb, 6,
                                                        beam=2)[0]
    assert pool.page_pool.ledger() == {}
