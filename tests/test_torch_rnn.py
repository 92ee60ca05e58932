"""The port's recurrent family (veles_tpu_torch/nn/rnn.py, nn/ssm.py) and
what trains through it, against the reference (veles_tpu/nn/rnn.py,
nn/ssm.py) on the same inputs, on the CPU:

- LSTM, RNN and SSMBlock forwards, ``return_sequences`` both ways,
  within 1e-5 of max|reference| from the same parameters, and the
  gradients of ``sum(y · E)`` (the parameters' and the input's) within
  1e-4 of max|reference gradient| against ``jax.grad`` (float32 in
  another order of sums);
- the training unit and the serving module of each unit give the same
  bits;
- scan ↔ step: the scan's outputs and final state equal a loop of the
  step body bit for bit (``torch.equal``), and a padded, length-masked
  scan carries exactly the unpadded scan's state, garbage in the tail;
- ``convert.random_params`` gives ``a_log`` the reference's
  deterministic init;
- initial parameters bitwise equal under ``prng.seed_all``, then
  training trajectories: BASELINE #5 (models/genre_recognition.py at its
  width: LSTM 64 over T 64 × 24, mb 60, lr 0.05, its 1,800 / 360 rows,
  one epoch) and the char LM's ``arch="lstm"`` and ``"ssm"`` at the
  widths of the reference's ``build_workflow`` (dim 32, 2 blocks, adam)
  on 128 / 64 rows, two epochs: per-epoch error rates within atol 1e-5,
  weights and optimiser state within rtol 2e-4 / atol 2e-5 (as the MNIST
  and LM parity);
- under ``engine.mixed_precision`` (bf16 parameters and input) each
  unit's output and carry are bf16 as the reference's, its forward
  within 2^-7 and its gradients within 2^-5 of max(1, max|reference|),
  the scan still equals its step loop bit for bit, and each family (an
  LSTM, an RNN, an SSM block with a mean-pool head) trains 3 epochs
  with float32 masters, its per-epoch error rates within 0.02 of the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import TRAIN, VALID
from veles_tpu.memory import Array as RefArray
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models import char_lm, genre_recognition
from veles_tpu_torch.nn import rnn, ssm
from veles_tpu_torch.nn.standard_workflow import Forwards, build_forwards

from conftest import import_model

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
SEED = 4242

#: (name, reference class, port unit class, port module class, config,
#:  input width)
UNITS = {
    "lstm": (ref_nn.LSTM, rnn.LSTM, rnn.LSTMLayer,
             {"hidden_size": 6}, 5),
    "rnn": (ref_nn.RNN, rnn.RNN, rnn.RNNLayer, {"hidden_size": 6}, 5),
    "ssm": (ref_nn.SSMBlock, ssm.SSMBlock, ssm.SSMBlockLayer,
            {"n_heads": 2}, 8),
}
CASES = [("lstm", False), ("lstm", True), ("rnn", False), ("rnn", True),
         ("ssm", True)]


@pytest.fixture(autouse=True)
def f32_compute():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    yield
    vt.root.common.engine.compute_dtype = prev


def _config(kind, return_sequences):
    cfg = dict(UNITS[kind][3])
    if kind != "ssm":
        cfg["return_sequences"] = return_sequences
    return cfg


def _reference(kind, return_sequences, x):
    """The reference unit initialised on ``x``, and its parameters."""
    cls = UNITS[kind][0]
    wf = vt.Workflow(name="t")
    u = cls(wf, name=kind + "0", **_config(kind, return_sequences))
    u.input = RefArray(x, name="x")
    u.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    params = {k: numpy.asarray(v.map_read(), numpy.float32)
              for k, v in u.param_arrays().items()}
    return u, params


def _port_unit(kind, return_sequences, x):
    u = UNITS[kind][1](None, name=kind + "0",
                       **_config(kind, return_sequences))
    u.input = Array(x, name="x")
    return u


def _inputs(kind, b=3, t=9, seed=5):
    d = UNITS[kind][4]
    return numpy.random.RandomState(seed).randn(b, t, d).astype("float32")


def _close(got, want, rtol, what):
    scale = max(1.0, float(numpy.abs(want).max()))
    err = float(numpy.abs(numpy.asarray(got) - want).max())
    assert err <= rtol * scale, "%s: %g > %g" % (what, err, rtol * scale)


@pytest.mark.parametrize("kind,return_sequences", CASES)
def test_unit_matches_reference(kind, return_sequences):
    x = _inputs(kind)
    ref, params = _reference(kind, return_sequences, x)
    y_ref = numpy.asarray(ref.apply({k: jnp.asarray(v)
                                     for k, v in params.items()},
                                    jnp.asarray(x)))
    e = numpy.random.RandomState(6).randn(*y_ref.shape).astype("float32")

    def loss(p, xx):
        return jnp.sum(ref.apply(p, xx) * e)
    g_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    port = _port_unit(kind, return_sequences, x)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    y = port.apply(tp, tx)
    assert tuple(y.shape) == y_ref.shape == port.output_shape_for(x.shape)
    _close(y.detach().numpy(), y_ref, FWD_RTOL, "forward")
    (y * torch.from_numpy(e)).sum().backward()
    _close(tx.grad.numpy(), numpy.asarray(gx_ref), GRAD_RTOL, "d input")
    for k, t in tp.items():
        _close(t.grad.numpy(), numpy.asarray(g_ref[k]), GRAD_RTOL, "d " + k)


@pytest.mark.parametrize("kind", sorted(UNITS))
def test_unit_and_module_forms_agree_bitwise(kind):
    """The training unit and the serving module run one copy of the
    math: the module loaded with the unit's parameters (through
    ``params_from_jax``) gives the same bits."""
    x = _inputs(kind)
    _, params = _reference(kind, True, x)
    unit = _port_unit(kind, True, x)
    module = UNITS[kind][2](x.shape[-1], name=kind + "0", device="cpu",
                            **_config(kind, True))
    stack = params_from_jax(Forwards({kind + "0": module}),
                            {kind + "0": params})
    tx = torch.from_numpy(x)
    with torch.no_grad():
        want = unit.apply({k: torch.from_numpy(v) for k, v in
                           params.items()}, tx)
        assert torch.equal(stack.layers[kind + "0"](tx), want)


def _port_state_and_params(kind, x):
    _, params = _reference(kind, True, x)
    unit = _port_unit(kind, True, x)
    return unit, {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.mark.parametrize("kind", sorted(UNITS))
def test_scan_equals_step_bitwise(kind):
    x = _inputs(kind)
    unit, params = _port_state_and_params(kind, x)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        st0 = unit.init_state(x.shape[0])
        ys, st_scan = unit.scan_state(params, tx, st0)
        st, ys_loop = st0, []
        for t in range(x.shape[1]):
            y, st = unit.step_state(params, tx[:, t].contiguous(), st)
            ys_loop.append(y)
    assert torch.equal(ys, torch.stack(ys_loop, dim=1))
    assert sorted(st) == sorted(st_scan) == sorted(unit.state_shapes(1))
    for k in st:
        assert torch.equal(st_scan[k], st[k]), k
        assert tuple(st[k].shape) == unit.state_shapes(x.shape[0])[k]


@pytest.mark.parametrize("kind", sorted(UNITS))
def test_padded_masked_scan_keeps_the_unpadded_state(kind):
    """Each row scanned to its own length inside a padded batch (a
    garbage tail of 1e6) ends in the state of the unpadded scan of that
    many steps, bit for bit; a length of 0 keeps the initial state."""
    x = _inputs(kind, b=4, t=8)
    unit, params = _port_state_and_params(kind, x)
    lengths = [5, 8, 1, 0]
    pad = x.copy()
    for r, n in enumerate(lengths):
        pad[r, n:] = 1e6
    with torch.no_grad():
        st0 = unit.init_state(4)
        _, st_pad = unit.scan_state(params, torch.from_numpy(pad), st0,
                                    length=torch.tensor(lengths))
        for r, n in enumerate(lengths):
            if n:
                _, st = unit.scan_state(params, torch.from_numpy(x[:, :n]),
                                        st0)
            else:
                st = st0
            for k in st:
                assert torch.equal(st_pad[k][r], st[k][r]), (r, k)


@pytest.mark.parametrize("n_heads,decay", [(4, (0.6, 0.95)),
                                           (2, (0.3, 0.99))])
def test_random_params_a_log_is_the_reference_init(n_heads, decay):
    x = _inputs("ssm")
    wf = vt.Workflow(name="t")
    ref = ref_nn.SSMBlock(wf, name="s", n_heads=n_heads,
                          decay_min=decay[0], decay_max=decay[1])
    ref.input = RefArray(x, name="x")
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    want = numpy.asarray(ref.param_arrays()["a_log"].map_read())
    stack = build_forwards(
        [{"type": "embedding", "vocab_size": 4, "dim": 8},
         {"type": "ssm_block", "n_heads": n_heads, "decay_min": decay[0],
          "decay_max": decay[1], "name": "s"},
         {"type": "lm_head", "vocab_size": 4}], device="cpu")
    tree = random_params(stack, seed=3)
    assert tree["s"]["a_log"].dtype == want.dtype
    numpy.testing.assert_array_equal(tree["s"]["a_log"], want)
    # the draws of the other parameters are the documented ones
    assert tree["s"]["wq"].std() == pytest.approx(1 / numpy.sqrt(8),
                                                  rel=0.3)


# -- training -----------------------------------------------------------------

def _tree(tree):
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


def _workflow(kind, port):
    (prng if port else ref_prng).seed_all(SEED)
    if kind == "genre":
        mod = genre_recognition if port else import_model(
            "genre_recognition")
        return mod.build_workflow(epochs=1)
    mod = char_lm if port else import_model("char_lm")
    return mod.build_workflow(epochs=2, minibatch_size=32, n_blocks=2,
                              dim=32, n_train=128, n_valid=64, arch=kind)


def _init(wf, port):
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


@pytest.mark.parametrize("kind", ["genre", "lstm", "ssm"])
def test_initial_params_bitwise_equal(kind):
    ref = _init(_workflow(kind, False), False)
    port = _init(_workflow(kind, True), True)
    assert [(f.name, type(f).MAPPING) for f in port.forwards] == \
        [(f.name, type(f).MAPPING) for f in ref.forwards]
    want = _tree(ref.train_step.params)
    got = _tree(port.train_step.params)
    assert sorted(got) == sorted(want)
    for name, params in want.items():
        assert sorted(got[name]) == sorted(params)
        for k, v in params.items():
            assert got[name][k].dtype == v.dtype
            numpy.testing.assert_array_equal(got[name][k], v,
                                             err_msg=name + "." + k)


@pytest.mark.parametrize("kind", ["genre", "lstm", "ssm"])
def test_training_matches_reference(kind):
    ref = _init(_workflow(kind, False), False)
    ref.run()
    port = _init(_workflow(kind, True), True)
    port.run()
    assert port.decision.epoch_number == ref.decision.epoch_number
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=METRIC_ATOL, err_msg=str(cls))
    _assert_tree_close(_tree(port.train_step.params),
                       _tree(ref.train_step.params), "params")
    _assert_tree_close(_tree(port.train_step.opt_state),
                       _tree(ref.train_step.opt_state), "opt_state")
    if kind == "genre":
        valid = port.decision.epoch_metrics[VALID]
        assert 0 <= valid[-1] <= 1


def test_genre_loader_serves_the_reference_rows():
    ref = import_model("genre_recognition").GenreLoader(
        None, minibatch_size=60, name="g")
    port = genre_recognition.GenreLoader(None, minibatch_size=60, name="g")
    ref.load_data()
    port.load_data()
    assert port.class_lengths == ref.class_lengths == [0, 360, 1800]
    numpy.testing.assert_array_equal(port.original_data.mem,
                                     numpy.asarray(ref.original_data.mem))
    numpy.testing.assert_array_equal(
        port.original_labels.mem, numpy.asarray(ref.original_labels.mem))
    assert port.original_data.mem.shape == (2160, 64, 24)


def test_units_register_the_reference_names():
    from veles_tpu_torch.nn.nn_units import MATCHING
    from veles_tpu_torch.units import UnitRegistry
    for mapping, cls in (("lstm", rnn.LSTM), ("rnn", rnn.RNN),
                         ("ssm_block", ssm.SSMBlock),
                         ("gd_lstm", rnn.GDLSTM), ("gd_rnn", rnn.GDRNN),
                         ("gd_ssm_block", ssm.GDSSMBlock)):
        assert UnitRegistry.mapping[mapping] is cls
    for fwd, gd in ((rnn.LSTM, rnn.GDLSTM), (rnn.RNN, rnn.GDRNN),
                    (ssm.SSMBlock, ssm.GDSSMBlock)):
        assert MATCHING[fwd] is gd


#: mixed precision: a bf16 output within the AMP limit of PERF.md §2;
#: a bf16 gradient of a T-step recurrence rounds every step's sum in
#: each framework's order (observed 1.6e-2 at T 9)
AMP_FWD_RTOL = 2.0 ** -7
AMP_GRAD_RTOL = 2.0 ** -5
#: per-epoch error rates of an AMP run against the reference's
#: (tests/test_torch_amp.py's limit)
AMP_METRIC_ATOL = 0.02


@pytest.mark.parametrize("kind", sorted(UNITS))
def test_mixed_precision_unit_matches_reference(kind):
    """bf16 parameters and input, as the train step hands them over under
    ``engine.mixed_precision``: the output (and the carry) bf16 as the
    reference's, the forward and the gradients within the AMP limits."""
    x = _inputs(kind)
    ref, params = _reference(kind, True, x)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    y_ref = ref.apply(jp, jx)
    e = numpy.random.RandomState(6).randn(*y_ref.shape).astype("float32")
    g_ref = jax.grad(lambda p: jnp.sum(
        ref.apply(p, jx).astype(jnp.float32) * e))(jp)
    port = _port_unit(kind, True, x)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16).requires_grad_(True)
          for k, v in params.items()}
    y = port.apply(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    _close(y.detach().float().numpy(), numpy.asarray(
        y_ref.astype(jnp.float32)), AMP_FWD_RTOL, "bf16 forward")
    (y.float() * torch.from_numpy(e)).sum().backward()
    for k, t in tp.items():
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad.float().numpy(), numpy.asarray(
            g_ref[k].astype(jnp.float32)), AMP_GRAD_RTOL, "bf16 d " + k)


@pytest.mark.parametrize("kind", sorted(UNITS))
def test_mixed_precision_scan_equals_step_bitwise(kind):
    x = _inputs(kind)
    unit, params = _port_state_and_params(kind, x)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        st0 = unit.init_state(x.shape[0], tx.dtype)
        ys, st_scan = unit.scan_state(params, tx, st0)
        st, ys_loop = st0, []
        for t in range(x.shape[1]):
            y, st = unit.step_state(params, tx[:, t].contiguous(), st)
            ys_loop.append(y)
    assert ys.dtype == torch.bfloat16
    assert torch.equal(ys, torch.stack(ys_loop, dim=1))
    for k in st:
        assert st_scan[k].dtype == torch.bfloat16, k
        assert torch.equal(st_scan[k], st[k]), k


AMP_CHAINS = {
    "lstm": [{"type": "lstm", "hidden_size": 16}],
    "rnn": [{"type": "rnn", "hidden_size": 16}],
    "ssm": [{"type": "ssm_block", "n_heads": 2}, {"type": "mean_pool"}],
}


def _amp_workflow(kind, port):
    """A sequence classifier of ``kind`` under ``engine.mixed_precision``
    on toy (256, 6, 8) sequences: the label says whether x[0, 0] >
    x[5, 1]."""
    from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

    class Toy(FullBatchLoader if port else RefFullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(0)
            x = rng.rand(256, 6, 8).astype(numpy.float32)
            y = (x[:, 0, 0] > x[:, 5, 1]).astype(numpy.int32)
            self.create_originals(x, y)
            self.class_lengths = [0, 64, 192]

    (prng if port else ref_prng).seed_all(SEED)
    (root if port else vt.root).common.engine.mixed_precision = True
    cls = StandardWorkflow if port else ref_nn.StandardWorkflow
    wf = cls(name="amp_" + kind, layers=AMP_CHAINS[kind] + [
        {"type": "softmax", "output_sample_shape": 2}],
        loader_unit=Toy(None, minibatch_size=32, name="toy"),
        loss_function="softmax", decision_config=dict(max_epochs=3))
    return _init(wf, port)


@pytest.mark.parametrize("kind", sorted(AMP_CHAINS))
def test_mixed_precision_training_follows_reference(kind):
    """Each recurrent family trains under ``engine.mixed_precision`` with
    float32 masters, its per-epoch error rates following the
    reference's within the AMP limit."""
    try:
        ref = _amp_workflow(kind, False)
        ref.run()
        port = _amp_workflow(kind, True)
        port.run()
    finally:
        root.common.engine.mixed_precision = False
        vt.root.common.engine.mixed_precision = False
    assert port.decision.epoch_number == ref.decision.epoch_number == 3
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=AMP_METRIC_ATOL, err_msg=str(cls))
    for tree in port.train_step.params.values():
        assert all(t.dtype == torch.float32 for t in tree.values())


def test_params_from_jax_carries_a_trained_recurrent_tree():
    ref = _init(_workflow("lstm", False), False)
    ref.run()
    params = _tree(ref.train_step.params)
    opt = _tree(ref.train_step.opt_state)
    assert params["lstm0"]["weights"].shape == (64, 128)
    port = _init(_workflow("lstm", True), True)
    assert params_from_jax(port, params, opt) is port
    _assert_tree_close(_tree(port.train_step.params), params, "params",
                       0, 0)
    _assert_tree_close(_tree(port.train_step.opt_state), opt, "opt", 0, 0)
    with pytest.raises(VelesError, match="shape"):
        bad = dict(params, lstm0={"weights": params["lstm0"]["weights"].T,
                                  "bias": params["lstm0"]["bias"]})
        params_from_jax(port, bad)


def test_genre_entry_point_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        genre_recognition.main(["--epochs", "1"])
