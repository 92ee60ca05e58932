"""The port's speculative decoding (veles_tpu_torch/nn/speculative.py and
the continuous engine's speculative round) against the reference's
``veles_tpu.nn.speculative`` on the same weights.

A tiny LM (2 RoPE blocks, dim 32, vocab 32) and a 1-block draft are
built and initialised by the reference from seeds, untrained, and their
parameter trees carried into the port with ``convert.params_from_jax``.

- greedy: the port's tokens, ``rounds`` and ``acceptance`` equal the
  reference's ``generate_speculative`` at gamma 1, 3 and 4, and the
  tokens are the target's own greedy decode; the target as its own draft
  accepts everything; batched rows equal their solo decodes; ragged
  batches and gamma < 1 are refused with the reference's errors;
- sampled: the port draws with ``torch.Generator``, not threefry, so it
  is held by the accept rule's distribution (20k trials, 5 sigma, the
  reference's oracle) and by seed determinism: a batched row, and a
  pooled row, equal the solo decode under the same seed;
- the pool: a speculative row of the continuous engine (3 slots' worth
  of pages, gamma 3, pages of 8) equals the solo call, greedy and
  sampled; greedy also equals plain greedy; the page ledger is empty
  afterwards.

Row ``j`` of ``_rope_span`` is ``_rope_at(pos0 + j)`` bit for bit."""
import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as jnn
from veles_tpu import prng
from veles_tpu.error import VelesError as JVelesError
from veles_tpu.nn import sampling as jsampling
from veles_tpu.nn.speculative import \
    generate_speculative as jgenerate_speculative

from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.sampling import _rope_at
from veles_tpu_torch.nn.speculative import (_rope_span, _stochastic_accept,
                                            generate_speculative)
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.serving import ContinuousEngine, make_request

from conftest import import_model

VOCAB = 32


def lm_layers(n_blocks, dim=32):
    return ([{"type": "embedding", "vocab_size": VOCAB, "dim": dim}]
            + [{"type": "transformer_block", "n_heads": 4,
                "ffn_hidden": 2 * dim, "causal": True, "rope": True,
                "name": "blk%d" % i} for i in range(n_blocks)]
            + [{"type": "lm_head", "vocab_size": VOCAB}])


def reference_pair(lm, layers, seed, name):
    """(reference workflow initialised from ``seed``, the port's stack
    with its weights)."""
    prng.seed_all(seed)
    wf = jnn.StandardWorkflow(
        name=name, layers=layers,
        loader_unit=lm.CharLMLoader(None, n_train=64, n_valid=64,
                                    minibatch_size=64, name="chars"),
        loss_function="softmax_seq")
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    params = {unit: {k: numpy.asarray(v) for k, v in tree.items()}
              for unit, tree in jsampling.params_of(wf).items()}
    return wf, params_from_jax(build_forwards(layers, device="cpu"),
                               params)


@pytest.fixture(scope="module")
def lms():
    """Target (2 blocks) and draft (1 block) in both packages."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    try:
        yield (reference_pair(lm, lm_layers(2), 4321, "target"),
               reference_pair(lm, lm_layers(1), 99, "draft"))
    finally:
        vt.root.common.engine.compute_dtype = prev


def prompt(seed, length=10):
    return [int(t) for t in
            numpy.random.RandomState(seed).randint(0, VOCAB, length)]


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_matches_reference(lms, gamma):
    (jt, tt), (jd, td) = lms
    p = prompt(5)
    want, jstats = jgenerate_speculative(jt, jd, p, 12, gamma=gamma)
    got, stats = generate_speculative(tt, td, p, 12, gamma=gamma)
    assert got == want
    assert stats == jstats
    assert got == sampling.generate(tt, p, 12, temperature=0)


def test_self_draft_accepts_everything(lms):
    """Draft == target: every draft token verifies, rounds =
    ceil((n_new - 1) / gamma) and acceptance 1.0, as the reference's."""
    (jt, tt), _ = lms
    p = prompt(6)
    want, jstats = jgenerate_speculative(jt, jt, p, 12, gamma=4)
    got, stats = generate_speculative(tt, tt, p, 12, gamma=4)
    assert got == want == sampling.generate(tt, p, 12, temperature=0)
    assert stats == jstats == {"rounds": 3, "acceptance": 1.0}


def test_batched_rows_match_solo(lms):
    """Rows of one batch advance by their own accepted lengths and each
    equals its solo decode, greedy and sampled (a seed per row)."""
    _, (_, td) = lms
    (_, tt), _ = lms
    prompts = [prompt(s) for s in (7, 8, 9)]
    rows, stats = generate_speculative(tt, td, prompts, 10, gamma=3)
    for i, p in enumerate(prompts):
        solo, st = generate_speculative(tt, td, p, 10, gamma=3)
        assert rows[i] == solo
        assert stats["rounds"][i] == st["rounds"]
        assert stats["acceptance"][i] == st["acceptance"]
    assert stats["mean_rounds"] == numpy.mean(stats["rounds"])
    rows, _ = generate_speculative(tt, td, prompts, 10, gamma=3,
                                   temperature=0.9, seed=[3, 4, 5])
    for i, (p, s) in enumerate(zip(prompts, (3, 4, 5))):
        assert rows[i] == generate_speculative(
            tt, td, p, 10, gamma=3, temperature=0.9, seed=s)[0]


def test_sampled_is_seeded_and_in_vocab(lms):
    (_, tt), (_, td) = lms
    p = prompt(10)
    a, st = generate_speculative(tt, td, p, 16, gamma=3, temperature=0.9,
                                 seed=1)
    b, _ = generate_speculative(tt, td, p, 16, gamma=3, temperature=0.9,
                                seed=1)
    c, _ = generate_speculative(tt, td, p, 16, gamma=3, temperature=0.9,
                                seed=2)
    assert a == b != c
    assert len(a) == 16 and all(0 <= t < VOCAB for t in a + c)
    assert 0.0 <= st["acceptance"] <= 1.0 and st["rounds"] >= 1


def test_rejects_ragged_batch_and_bad_gamma(lms):
    """The reference's refusals, with its messages."""
    (jt, tt), (jd, td) = lms
    for gen, err, (t, d) in ((jgenerate_speculative, JVelesError,
                              (jt, jd)),
                             (generate_speculative, VelesError, (tt, td))):
        with pytest.raises(err, match="EQUAL-length"):
            gen(t, d, [[1, 2], [3, 4, 5]], 8)
        with pytest.raises(err, match="flat id list"):
            gen(t, d, [[[1, 2]], [[3, 4]]], 8)
        with pytest.raises(ValueError, match="gamma"):
            gen(t, d, [1, 2, 3], 8, gamma=0)


def test_stochastic_accept_preserves_target_distribution():
    """The Leviathan accept/resample rule, Monte-Carlo: with proposals
    drawn from p_d, the next emitted token's marginal is p_t, for an
    adversarially different draft. 20k trials, 5-sigma gate (the
    reference's oracle)."""
    rng = numpy.random.RandomState(0)
    v = 8
    pt = torch.from_numpy(rng.dirichlet(numpy.ones(v)).astype("float32"))
    pd = torch.from_numpy(
        rng.dirichlet(numpy.ones(v) * 0.3).astype("float32"))
    gen = torch.Generator().manual_seed(7)
    n = 20000
    drafts = torch.multinomial(pd, n, replacement=True, generator=gen)
    counts = numpy.zeros(v)
    for d in drafts:
        a, fix = _stochastic_accept(gen, pt[None], pd[None], d[None])
        counts[int(d) if a >= 1 else fix] += 1
    emp = counts / n
    p = pt.numpy()
    sigma = numpy.sqrt(p * (1 - p) / n)
    assert (numpy.abs(emp - p) < 5 * sigma + 1e-3).all(), (emp, p)


def test_rope_span_rows_equal_rope_at_bits():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 4, 8), generator=g)
    pos0 = [7, 1234]
    out = _rope_span(x, pos0)
    for b, p0 in enumerate(pos0):
        for j in range(5):
            assert torch.equal(out[b, j],
                               _rope_at(x[b:b + 1, j:j + 1], p0 + j)[0, 0])
    assert torch.equal(_rope_span(x, 40), _rope_span(x, [40, 40]))


# -- the continuous engine's speculative round ------------------------------
@pytest.fixture(scope="module")
def pool(lms):
    (_, tt), (_, td) = lms
    engine = ContinuousEngine(tt, max_slots=5, buckets=(8, 16),
                              max_context=48, page_size=8, spec_gamma=3,
                              beam_width=2, draft=td,
                              name="spec_pool").start()
    yield engine
    engine.stop()


def test_pooled_speculative_matches_solo(lms, pool):
    """A pooled speculative row equals ``generate_speculative`` greedy and
    sampled (its generator seeded from the request's seed), and greedy
    equals plain greedy; rounds and acceptance ride the answer."""
    (_, tt), (_, td) = lms
    for temp, seed in ((0.0, 0), (0.7, 21)):
        p = prompt(100 + seed, 7)
        res = pool.serve_results([make_request(
            p, 9, temperature=temp, seed=seed, mode="speculative",
            gamma=3)])[0]
        solo, st = generate_speculative(tt, td, p, 9, gamma=3,
                                        temperature=temp, seed=seed)
        assert res["tokens"] == solo
        assert (res["rounds"], res["acceptance"]) == \
            (st["rounds"], st["acceptance"])
        if temp == 0.0:
            assert res["tokens"] == sampling.generate(tt, p, 9,
                                                      temperature=0)
    assert pool.page_pool.ledger() == {}


def test_pooled_self_draft_accepts_everything(lms):
    (_, tt), _ = lms
    engine = ContinuousEngine(tt, max_slots=2, buckets=(8, 16),
                              max_context=48, page_size=8, spec_gamma=4,
                              draft=tt, name="spec_self").start()
    try:
        p = prompt(12, 9)
        res = engine.serve_results([make_request(p, 13,
                                                 mode="speculative")])[0]
    finally:
        engine.stop()
    assert res["tokens"] == sampling.generate(tt, p, 13, temperature=0)
    assert res["acceptance"] == 1.0 and res["rounds"] == 3
    assert engine.page_pool.ledger() == {}
