"""Training through the rest of the port's LM family (veles_tpu_torch/
models/tiny_transformer.py and chains of the ``mean_pool``,
``multi_head_attention``, ``moe_ffn`` and ``rprop_all2all`` units)
against the reference's workflows from the same seeds, on the CPU:

- trajectories (per-epoch error rates within atol 1e-5, weights and
  optimiser state within rtol 2e-4 / atol 2e-5, as the MNIST and LM
  parity): ``tiny_transformer`` at 2 blocks (its loader's rows and its
  initial weights bit for bit, then one adam epoch), the reference's
  RProp workflow (tests/test_variants.py:42-64) for 3 epochs, and one
  chain of every new unit (GQA causal MHA → top-2 MoE → mean_pool →
  rprop → softmax) for 2 epochs, whose parameters and GDRProp
  ``{"step", "prev_grad"}`` state ``params_from_jax`` carries into a
  port workflow;
- under ``engine.mixed_precision`` each new unit's output is bf16 as
  the reference's, the masters stay float32, and each trains with its
  per-epoch validation error within 0.02 of the reference's
  (``tests/test_torch_amp.py``'s AMP limit: two frameworks round bf16
  chains differently);
- the fused-FC kernel refuses ``rprop_all2all`` and ``moe_ffn`` chains;
- ``tiny_transformer`` runs through ``python -m veles_tpu_torch``'s
  ``main`` and its own entry point, which defaults to the card.
"""
import logging

import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as ref_nn
from veles_tpu import prng as ref_prng
from veles_tpu.loader import FullBatchLoader as RefFullBatchLoader
from veles_tpu.loader import TRAIN, VALID
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import FullBatchLoader
from veles_tpu_torch.models import alexnet, tiny_transformer
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow
from veles_tpu_torch.ops.precision import amp_cast
from veles_tpu_torch.telemetry.spans import recorder

from conftest import import_model
from test_torch_cli import _restore_tree, _snapshot_tree

METRIC_ATOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
AMP_METRIC_ATOL = 0.02
SEED = 5150


@pytest.fixture(autouse=True)
def f32_compute():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    yield
    vt.root.common.engine.compute_dtype = prev
    vt.root.common.engine.mixed_precision = False
    root.common.engine.mixed_precision = False


# -- trajectories -------------------------------------------------------------

def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
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


def _blobs(base, seq):
    """The reference's toy two-class rows: (256, 8) flat, or as (256, 4,
    8) sequences whose label is x[0, 0] > x[3, 1]."""
    class Toy(base):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(0)
            if seq:
                x = rng.rand(256, 4, 8).astype(numpy.float32)
                y = (x[:, 0, 0] > x[:, 3, 1]).astype(numpy.int32)
            else:
                x = rng.rand(256, 8).astype(numpy.float32)
                y = (x[:, 0] > x[:, 1]).astype(numpy.int32)
            self.create_originals(x, y)
            self.class_lengths = [0, 64, 192]
    return Toy(None, minibatch_size=32, name="toy")


CHAINS = {
    # the reference's RProp workflow (tests/test_variants.py:42-64)
    "rprop": (False, [{"type": "rprop_all2all", "output_sample_shape": 16},
                      {"type": "softmax", "output_sample_shape": 2}]),
    # every new unit in one chain
    "lm_family": (True, [
        {"type": "multi_head_attention", "n_heads": 4, "n_kv_heads": 2,
         "causal": True, "learning_rate": 0.1},
        {"type": "moe_ffn", "n_experts": 4, "hidden": 16, "top_k": 2,
         "learning_rate": 0.1},
        {"type": "mean_pool"},
        {"type": "rprop_all2all", "output_sample_shape": 8},
        {"type": "softmax", "output_sample_shape": 2}]),
    "mha": (True, [{"type": "multi_head_attention", "n_heads": 4,
                    "n_kv_heads": 2, "learning_rate": 0.1},
                   {"type": "mean_pool"},
                   {"type": "softmax", "output_sample_shape": 2}]),
    "moe_dense": (False, [{"type": "moe_ffn", "n_experts": 4, "hidden": 16,
                           "learning_rate": 0.1},
                          {"type": "softmax", "output_sample_shape": 2,
                           "learning_rate": 0.1}]),
    "moe_top2": (False, [{"type": "moe_ffn", "n_experts": 4, "hidden": 16,
                          "top_k": 2, "learning_rate": 0.05},
                         {"type": "softmax", "output_sample_shape": 2}]),
}


def _chain(name, port, epochs, amp=False):
    seq, layers = CHAINS[name]
    (prng if port else ref_prng).seed_all(SEED)
    (root if port else vt.root).common.engine.mixed_precision = amp
    mod_nn = StandardWorkflow if port else ref_nn.StandardWorkflow
    wf = mod_nn(name=name, layers=layers,
                loader_unit=_blobs(FullBatchLoader if port
                                   else RefFullBatchLoader, seq),
                loss_function="softmax",
                decision_config=dict(max_epochs=epochs))
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _follows(port, ref, atol=METRIC_ATOL, trees=True):
    assert port.decision.epoch_number == ref.decision.epoch_number
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=atol, err_msg=str(cls))
    if trees:
        _assert_tree_close(_tree(port.train_step.params),
                           _tree(ref.train_step.params), "params")
        _assert_tree_close(_tree(port.train_step.opt_state),
                           _tree(ref.train_step.opt_state), "opt_state")


def test_tiny_transformer_follows_reference():
    ref_tt = import_model("tiny_transformer")
    kw = dict(epochs=1, n_blocks=2, n_train=128, n_valid=64)
    ref_prng.seed_all(1234)
    ref = ref_tt.build_workflow(**kw)
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    prng.seed_all(1234)
    port = tiny_transformer.build_workflow(**kw)
    port.initialize(device="cpu")
    numpy.testing.assert_array_equal(port.loader.original_data.mem,
                                     ref.loader.original_data.mem)
    assert [(f.name, type(f).MAPPING) for f in port.forwards] == \
        [(f.name, type(f).MAPPING) for f in ref.forwards]
    _assert_tree_close(_tree(port.train_step.params),
                       _tree(ref.train_step.params), "initial", 0, 0)
    ref.run()
    port.run()
    _follows(port, ref)


@pytest.mark.parametrize("name,epochs", [("rprop", 3), ("lm_family", 2)])
def test_chain_follows_reference(name, epochs):
    ref = _chain(name, False, epochs)
    port = _chain(name, True, epochs)
    gds = {type(port.train_step._gd_for[f.name]).__name__
           for f in port.forwards if f.PARAMETERIZED}
    assert "GDRProp" in gds
    ref.run()
    port.run()
    _follows(port, ref)
    if name == "lm_family":
        # the trained tree, GDRProp's state with it, into a fresh port
        fresh = _chain(name, True, epochs)
        params = _tree(ref.train_step.params)
        opt = _tree(ref.train_step.opt_state)
        assert params["multi_head_attention0"]["wk"].shape == (8, 4)
        assert params["moe_ffn1"]["w1"].shape == (4, 8, 16)
        assert sorted(opt["rprop_all2all3"]) == ["prev_grad", "step"]
        params_from_jax(fresh, params, opt)
        _assert_tree_close(_tree(fresh.train_step.params), params, "p", 0,
                           0)
        _assert_tree_close(_tree(fresh.train_step.opt_state), opt, "o", 0,
                           0)


@pytest.mark.parametrize("name", ["mha", "moe_dense", "moe_top2", "rprop"])
def test_mixed_precision_follows_reference(name):
    """Each new unit under ``engine.mixed_precision``: bf16 outputs as
    the reference's, float32 masters, validation error per epoch within
    the AMP limit (the chain with MHA holds mean_pool too)."""
    ref = _chain(name, False, 3, amp=True)
    port = _chain(name, True, 3, amp=True)
    x = port.loader.original_data.mem[:4]
    params = amp_cast(port.train_step.params)
    h = amp_cast(torch.from_numpy(x))
    for f in port.forwards[:-1]:
        h = f.apply(params.get(f.name, {}), h)
        assert h.dtype == torch.bfloat16, f.name
    ref.run()
    port.run()
    for tree in port.train_step.params.values():
        assert all(t.dtype == torch.float32 for t in tree.values())
    _follows(port, ref, atol=AMP_METRIC_ATOL, trees=False)


def test_fused_fc_refuses_rprop_and_moe_chains(caplog):
    root.common.engine.fused_fc_scan = True
    try:
        for name in ("rprop", "moe_dense"):
            with caplog.at_level(logging.INFO):
                wf = _chain(name, True, 1)
            assert wf.train_step._fused_fc is None
            assert "needs an [all2all_tanh" in caplog.text
            caplog.clear()
    finally:
        root.common.engine.fused_fc_scan = False


# -- the zoo member -----------------------------------------------------------

def test_tiny_transformer_runs_through_the_cli(tmp_path, capsys):
    """The zoo file itself (and AlexNet's) through ``python -m
    veles_tpu_torch``'s main (``--dry-run``: its full-size
    ``build_workflow()`` initialises), a
    model file that trains a cut-down one through it, and the module's
    own entry point."""
    from veles_tpu_torch.__main__ import main
    cut = tmp_path / "tt_cut.py"
    cut.write_text(
        "from veles_tpu_torch.models import tiny_transformer\n"
        "def build_workflow():\n"
        "    return tiny_transformer.build_workflow(\n"
        "        epochs=1, n_blocks=1, n_train=128, n_valid=64)\n")
    result = tmp_path / "result.json"
    snap = _snapshot_tree(root)
    try:
        main([tiny_transformer.__file__, "--dry-run", "--backend", "cpu"])
        # the other zoo file the README runs this way
        main([alexnet.__file__, "--dry-run", "--backend", "cpu"])
        main([str(cut), "--backend", "cpu", "--result-file", str(result)])
    finally:
        # main layers config into the process-wide root: put it back
        _restore_tree(root, snap)
        recorder.set_sink(None)
        logging.getLogger("Launcher").setLevel(logging.NOTSET)
    assert result.exists()
    res = tiny_transformer.main(["--epochs", "1", "--blocks", "1",
                                 "--device", "cpu"])
    assert 0 <= res["best_err"] <= 1
    assert "best validation error" in capsys.readouterr().out


def test_tiny_transformer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        tiny_transformer.main(["--epochs", "1"])
