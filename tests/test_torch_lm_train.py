"""The port's LM training path (nn/transformer.py units, nn/nn_units.py
adam/adamw, nn/evaluator.py EvaluatorSoftmaxSeq, loader/fullbatch.py
FullBatchLoaderMSE, nn/train_step.py targets, convert.py,
models/char_lm.py) against the reference's on the same data and seed, on
the CPU:

- the units' initial parameters are bitwise equal under
  ``prng.seed_all``;
- adam/adamw updates equal the reference's GD updates (rtol 1e-6 /
  atol 1e-9: the same f32 ops in the same order; the bias corrections'
  f32 powers may differ in the last bit), the step count exactly;
- EvaluatorSoftmaxSeq's loss and metrics equal the reference's within
  float32 rounding, the token counts exactly;
- FullBatchLoaderMSE serves bitwise-equal plans, and its targets follow
  the rows through ``resize_validation``;
- the char-LM StandardWorkflow (2 blocks, dim 32, 4 heads, T 32, mb 8,
  adam) trains 2 epochs on the reference's trajectory: per-epoch error
  rates within atol 1e-5, weights and adam m/v within rtol 2e-4 /
  atol 2e-5 (float32, the products run in another order), t exactly;
- the bench LM cut to width 32 at T 128 takes 2 steps against the
  reference with its Pallas flash forward and backward in interpret
  mode, within the same tolerances;
- ``params_from_jax`` loads a trained reference's params and adam state.
"""
import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.loader import TRAIN, VALID
from veles_tpu.nn import evaluator as ref_evaluator
from veles_tpu.nn import transformer as ref_transformer
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn import evaluator, transformer
from veles_tpu_torch.workflow import Workflow

from conftest import import_model

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
SEED = 2024


@pytest.fixture(scope="module")
def ref_lm():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    try:
        yield import_model("char_lm")
    finally:
        vt.root.common.engine.compute_dtype = prev


def _tree(tree):
    """A (nested) device tree as numpy."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return numpy.asarray(jax.device_get(tree))


def _assert_tree_close(got, want, what, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], "%s/%s" % (what, k), rtol,
                               atol)
    elif numpy.issubdtype(want.dtype, numpy.integer):
        numpy.testing.assert_array_equal(got, want, err_msg=what)
    else:
        numpy.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                      err_msg=what)


def _char_lm(port, ref_lm, **kw):
    args = dict(epochs=2, minibatch_size=8, n_blocks=2, dim=32, n_train=96,
                n_valid=32, lr=0.003)
    args.update(kw)
    if port:
        prng.seed_all(SEED)
        return char_lm.build_workflow(**args)
    ref_prng.seed_all(SEED)
    return ref_lm.build_workflow(**args)


def _bench_lm(port, ref_lm):
    args = dict(seq_len=128, dim=32, n_blocks=2, ffn_hidden=64, n_heads=4,
                vocab=16, minibatch_size=4, n_train=8, n_valid=4)
    if port:
        prng.seed_all(SEED)
        wf = char_lm.build_bench_workflow(**args)
    else:
        ref_prng.seed_all(SEED)
        wf = ref_lm.build_bench_workflow(**args)
    wf.decision.max_epochs = 1
    return wf


def _init(wf, port):
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def test_initial_params_bitwise_equal(ref_lm):
    ref = _init(_char_lm(False, ref_lm), False)
    port = _init(_char_lm(True, ref_lm), True)
    assert [f.name for f in port.forwards] == [f.name for f in ref.forwards]
    assert [type(f).MAPPING for f in port.forwards] == \
        [type(f).MAPPING for f in ref.forwards]
    want = _tree(ref.train_step.params)
    got = _tree(port.train_step.params)
    assert sorted(got) == sorted(want)
    for name, params in want.items():
        assert sorted(got[name]) == sorted(params)
        for k, v in params.items():
            assert got[name][k].dtype == v.dtype
            numpy.testing.assert_array_equal(got[name][k], v,
                                             err_msg=name + "." + k)


def test_units_register_the_reference_names():
    from veles_tpu_torch.units import UnitRegistry
    for mapping, cls in (("transformer_block",
                          transformer.TransformerBlockUnit),
                         ("embedding", transformer.EmbeddingUnit),
                         ("lm_head", transformer.LMHeadUnit),
                         ("pos_embedding",
                          transformer.PositionalEmbeddingUnit),
                         ("gd_transformer_block",
                          transformer.GDTransformerBlock)):
        assert UnitRegistry.mapping[mapping] is cls


@pytest.mark.parametrize("solver,kw", [
    ("adam", {}),
    ("adam", dict(weights_decay=0.01, weights_decay_bias=0.001,
                  learning_rate_bias=0.02)),
    ("adamw", dict(weights_decay=0.05, beta1=0.8, beta2=0.99,
                   epsilon=1e-6)),
])
def test_adam_update_matches_reference(solver, kw):
    rng = numpy.random.RandomState(3)
    params = {"weights": rng.randn(6, 5).astype(numpy.float32),
              "bias": rng.randn(5).astype(numpy.float32)}
    ref = ref_transformer.GDLMHead(vt.Workflow(name="r"), solver=solver,
                                   learning_rate=0.01, **kw)
    port = transformer.GDLMHead(Workflow(name="p"), solver=solver,
                                learning_rate=0.01, **kw)
    rp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rs, ps = ref.init_state(rp), port.init_state(pp)
    assert ps["t"].dtype == torch.int32
    for step in range(4):
        grads = {k: rng.randn(*v.shape).astype(numpy.float32)
                 for k, v in params.items()}
        scale = numpy.float32(0.5 + step / 4)
        rp, rs = ref.update(rp, {k: jax.numpy.asarray(g)
                                 for k, g in grads.items()}, rs, scale)
        pp, ps = port.update(pp, {k: torch.from_numpy(g)
                                  for k, g in grads.items()}, ps,
                             float(scale))
        _assert_tree_close(_tree(pp), _tree(rp), "params", 1e-6, 1e-9)
        _assert_tree_close(_tree(ps), _tree(rs), "state", 1e-6, 1e-9)
    assert int(ps["t"]) == 4


def test_unported_solvers_still_raise():
    gd = transformer.GDLMHead(Workflow(name="p"), solver="rmsprop")
    with pytest.raises(VelesError, match="not ported yet"):
        gd.init_state({"bias": torch.zeros(3)})


def test_evaluator_softmax_seq_matches_reference():
    rng = numpy.random.RandomState(4)
    logits = rng.randn(5, 7, 11).astype(numpy.float32)
    targets = rng.randint(0, 11, (5, 7)).astype(numpy.int32)
    mask = numpy.array([1, 1, 0, 1, 1], numpy.float32)
    ref = ref_evaluator.EvaluatorSoftmaxSeq(vt.Workflow(name="r"))
    port = evaluator.EvaluatorSoftmaxSeq(Workflow(name="p"))
    jl, jt, jm = map(jax.numpy.asarray, (logits, targets, mask))
    tl, tt, tm = map(torch.from_numpy, (logits, targets, mask))
    numpy.testing.assert_allclose(float(port.loss(tl, tt, tm)),
                                  float(ref.loss(jl, jt, jm)), rtol=1e-6)
    want = ref.metrics_fn(jl, jt, jm)
    got = port.metrics_fn(tl, tt, tm)
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert float(port.sum_loss_weight(tl, tm)) == \
        float(ref.sum_loss_weight(jl, jm)) == 4 * 7


def _loaders(ref_lm, mb=16):
    ref_prng.seed_all(SEED)
    ref = ref_lm.SyntheticTokenLoader(None, seq_len=24, vocab=32,
                                      n_train=40, n_valid=10,
                                      minibatch_size=mb, name="tok")
    prng.seed_all(SEED)
    port = char_lm.SyntheticTokenLoader(None, seq_len=24, vocab=32,
                                        n_train=40, n_valid=10,
                                        minibatch_size=mb, name="tok")
    return ref, port


def test_fullbatch_mse_plans_and_targets_bitwise(ref_lm):
    ref, port = _loaders(ref_lm)
    for loader in (ref, port):
        loader.fused = True
        loader.plan_steps = 4
        loader.initialize()
    for arr in ("original_data", "original_targets"):
        want = getattr(ref, arr).mem
        got = getattr(port, arr).mem
        assert got.dtype == want.dtype == numpy.int32
        numpy.testing.assert_array_equal(got, want)
    assert not port.original_labels
    assert port.minibatch_targets.shape == ref.minibatch_targets.shape
    for _ in range(7):                       # > 2 epochs of plans
        ref.run()
        port.run()
        numpy.testing.assert_array_equal(port.minibatch_indices.mem,
                                         ref.minibatch_indices.mem)
        numpy.testing.assert_array_equal(port.minibatch_mask.mem,
                                         ref.minibatch_mask.mem)
        assert port.minibatch_class == ref.minibatch_class


def test_fullbatch_mse_fills_targets_and_resizes_validation(ref_lm):
    ref, port = _loaders(ref_lm, mb=8)
    for loader in (ref, port):
        loader.load_data()
        loader.resize_validation(0.25)
    assert port.class_lengths == ref.class_lengths == [0, 20, 30]
    for arr in ("original_data", "original_targets"):
        numpy.testing.assert_array_equal(getattr(port, arr).mem,
                                         getattr(ref, arr).mem)
    # the targets still belong to their rows: each row's next tokens
    numpy.testing.assert_array_equal(port.original_data.mem[:, 1:],
                                     port.original_targets.mem[:, :-1])
    port.initialize()
    port.run()
    idx = port.minibatch_indices.mem
    numpy.testing.assert_array_equal(port.minibatch_targets.mem,
                                     port.original_targets.mem[idx])
    numpy.testing.assert_array_equal(port.minibatch_data.mem,
                                     port.original_data.mem[idx])


def _check_trajectory(ref, port, epochs):
    assert port.decision.epoch_number == ref.decision.epoch_number == epochs
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(
            port.decision.epoch_metrics[cls],
            ref.decision.epoch_metrics[cls], atol=METRIC_ATOL,
            err_msg="set %d" % cls)
    _assert_tree_close(_tree(port.train_step.params),
                       _tree(ref.train_step.params), "params")
    _assert_tree_close(_tree(port.train_step.opt_state),
                       _tree(ref.train_step.opt_state), "opt_state")


def test_char_lm_trains_on_the_reference_trajectory(ref_lm):
    ref = _init(_char_lm(False, ref_lm), False)
    ref.run()
    port = _init(_char_lm(True, ref_lm), True)
    assert port.train_step.target_mode == "targets"
    assert port.train_step._fused_fc is None
    port.run()
    _check_trajectory(ref, port, 2)
    # 2 epochs x 12 steps of mb 8
    for name, state in port.train_step.opt_state.items():
        assert int(state["t"]) == 24, name
    # the per-token mean NLL of every epoch, as the drained sums give it
    assert len(port.decision.epoch_losses[VALID]) == 2
    assert all(numpy.isfinite(port.decision.epoch_losses[TRAIN]))
    # the trained params reach the units' host arrays at stop
    blk = port.forwards[1]
    numpy.testing.assert_array_equal(
        blk.wq.map_read(), port.train_step.params[blk.name]["wq"].numpy())


def test_all_padded_plan_rows_do_not_run(ref_lm, monkeypatch):
    """A class shorter than the plan (4 validation rows in a 12-row plan)
    runs only its served rows; the trajectory test above shows the
    result is the reference's, which computes the padded rows and
    discards them."""
    port = _init(_char_lm(True, ref_lm, epochs=1), True)
    calls = []
    step = port.train_step
    real = step._eval_step

    def counted(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(step, "_eval_step", counted)
    port.run()
    assert port.loader.plan_steps == 12 and len(calls) == 32 // 8


def test_bench_lm_matches_the_reference_pallas_path(ref_lm):
    """The reference with ``engine.flash_attention = "force"``: its
    forward AND backward attention run the Pallas kernels (interpret
    mode); the port's CPU path runs the plain attention under autograd."""
    prev = vt.root.common.engine.flash_attention
    vt.root.common.engine.flash_attention = "force"
    try:
        ref = _init(_bench_lm(False, ref_lm), False)
        ref.run()
    finally:
        vt.root.common.engine.flash_attention = prev
    port = _init(_bench_lm(True, ref_lm), True)
    port.run()
    _check_trajectory(ref, port, 1)
    for state in port.train_step.opt_state.values():
        assert int(state["t"]) == 2


def test_lm_rejects_the_fused_fc_path(caplog):
    import logging
    root.common.engine.fused_fc_scan = True
    try:
        wf = char_lm.build_workflow(epochs=1, n_train=16, n_valid=8,
                                    minibatch_size=8)
        with caplog.at_level(logging.INFO):
            wf.initialize(device="cpu")
    finally:
        root.common.engine.fused_fc_scan = False
    assert wf.train_step._fused_fc is None
    assert any("ineligible" in r.getMessage() and "chain" in r.getMessage()
               for r in caplog.records)


def test_params_from_jax_loads_adam_state(ref_lm):
    ref = _init(_char_lm(False, ref_lm, epochs=1), False)
    ref.run()
    params = _tree(ref.train_step.params)
    opt = _tree(ref.train_step.opt_state)
    port = _init(_char_lm(True, ref_lm, epochs=1), True)
    assert params_from_jax(port, params, opt) is port
    _assert_tree_close(_tree(port.train_step.params), params, "params", 0, 0)
    _assert_tree_close(_tree(port.train_step.opt_state), opt, "opt", 0, 0)
    assert port.train_step.opt_state["blk0"]["t"].dtype == torch.int32
    bad = dict(opt, blk0=dict(opt["blk0"], m=dict(opt["blk0"]["m"])))
    bad["blk0"]["m"]["wq"] = bad["blk0"]["m"]["wq"][:, :-1]
    with pytest.raises(VelesError, match="shape"):
        params_from_jax(port, params, bad)
    bad = dict(opt, blk0={"m": opt["blk0"]["m"], "v": opt["blk0"]["v"]})
    with pytest.raises(VelesError, match="entries"):
        params_from_jax(port, params, bad)


def test_generate_serves_the_trained_weights(ref_lm):
    """``generate(wf, ...)`` runs the sampler over the workflow's current
    parameters: greedy tokens equal the reference's on the same trained
    weights."""
    ref = _init(_char_lm(False, ref_lm, epochs=1), False)
    ref.run()
    port = _init(_char_lm(True, ref_lm, epochs=1), True)
    params_from_jax(port, _tree(ref.train_step.params))
    want = ref_lm.generate(ref, [0, 1, 2], 10, temperature=0)
    assert char_lm.generate(port, [0, 1, 2], 10, temperature=0) == want


def test_main_runs_and_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(VelesError, match="not ported"):
        char_lm.main(["--text", "corpus.txt", "--device", "cpu"])
    with pytest.raises(VelesError, match="not ported"):
        char_lm.build_workflow(arch="lstm", text_file="corpus.txt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        char_lm.main(["--epochs", "1"])
