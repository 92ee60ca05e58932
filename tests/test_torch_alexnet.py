"""AlexNet through ``mcdnnic_topology`` and the STL-10 conv workflow in
the port (veles_tpu_torch/models/alexnet.py, models/cifar.py's
``build_stl10_workflow``, nn/standard_workflow.py's ``parse_mcdnnic``)
against the reference's, on the CPU:

- ``parse_mcdnnic`` gives the reference's ``layers`` for both AlexNet
  topologies (and its parameters merged into every layer), and refuses
  the same bad strings, and ``layers`` with a topology, with a
  VelesError;
- at 224 px the five-conv stack's shapes, by shape inference alone,
  equal the reference's layer by layer (no 224 px training on the CPU);
- the CI AlexNet (32 px, 128 train / 64 validation rows, mb 64, adam,
  2 epochs) and the STL-10 workflow (16 px, 60 / 30 rows, mb 30, SGD lr
  0.05, 2 epochs) trained by both packages from one seed (the
  reference's compile of its steps is the cost, so the rows are few):
  initial
  weights and the surrogate rows bitwise equal; per-epoch error rates
  within 1e-5 and the last step's loss within 1e-5 relative (the
  reference's decision keeps no per-epoch loss); the optimiser state
  within rtol 2e-4 / atol 2e-5 and the final weights so at all but 1 in
  10^4 elements and within 2 lr everywhere (tests/test_torch_zoo.py's
  limits: adam's normalised step turns a rounding-noise gradient into a
  step of up to ±lr);
- the entry points run on the card unless asked for the CPU.
"""
import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.error import VelesError as RefVelesError
from veles_tpu.loader import TRAIN, VALID
from veles_tpu.nn.standard_workflow import parse_mcdnnic as ref_parse
from veles_tpu_torch import prng
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.models import alexnet, cifar
from veles_tpu_torch.nn.standard_workflow import (StandardWorkflow,
                                                  parse_mcdnnic)

from conftest import import_model

RTOL, ATOL = 2e-4, 2e-5
ERR_ATOL = 1e-5
LOSS_RTOL = 1e-5
REF_ALEXNET = import_model("alexnet")
REF_CIFAR = import_model("cifar")
PARAMS = {"learning_rate": 0.001, "solver": "adam"}


@pytest.mark.parametrize("size", [32, 224])
def test_parse_mcdnnic_matches_reference(size):
    topo = alexnet.topology(size)
    assert topo == REF_ALEXNET.topology(size)
    got = parse_mcdnnic(topo, PARAMS)
    assert got == ref_parse(topo, PARAMS)
    assert [c["type"] for c in got].count("conv_tanh") == (
        5 if size >= 96 else 2)
    assert got[-1]["type"] == "softmax" and all(
        c["solver"] == "adam" for c in got)


@pytest.mark.parametrize("bad", [
    "3x32x32", "3x32x32-16X5", "3x32x32-MP", "3x32x32--10N",
    "3x32x32-16C5-mp2-10N", "3x32x32-10N-1.5N"])
def test_parse_mcdnnic_refuses_what_the_reference_refuses(bad):
    with pytest.raises(RefVelesError):
        ref_parse(bad)
    with pytest.raises(VelesError):
        parse_mcdnnic(bad)


def test_layers_and_topology_together_are_refused():
    with pytest.raises(VelesError, match="not both"):
        StandardWorkflow(layers=[{"type": "softmax",
                                  "output_sample_shape": 2}],
                         mcdnnic_topology="3x8x8-2N",
                         loader_unit=alexnet.SyntheticImagenet(None))


def test_alexnet_224_shapes_match_reference():
    """The five-conv stack at 224 px by shape inference alone: 218² → 109²
    → 105² → 53² (ceil mode) → 51² → 49² → 47² → 24², then 512, 512,
    10."""
    port = alexnet.build_workflow(image_size=224)
    ref = REF_ALEXNET.build_workflow(image_size=224)
    assert port.layers_config == ref.layers_config
    shape = want = (64, 224, 224, 3)
    shapes = []
    for f, g in zip(port.forwards, ref.forwards, strict=True):
        assert type(f).__name__ == type(g).__name__ and f.name == g.name
        if hasattr(f, "n_kernels"):
            # the kernels run over the full input: no padding
            assert tuple(f.padding) == tuple(g.padding) == (0, 0, 0, 0)
        shape = f.output_shape_for(shape)
        want = g.output_shape_for(want)
        assert shape == want, f.name
        shapes.append(shape[1:])
    assert shapes == [(218, 218, 48), (109, 109, 48), (105, 105, 128),
                      (53, 53, 128), (51, 51, 192), (49, 49, 192),
                      (47, 47, 128), (24, 24, 128), (512,), (512,), (10,)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, "%s/%s" % (prefix, k)))
        return out
    return {prefix: tree}


def _train_pair(build_port, build_ref, seed):
    ref_prng.seed_all(seed)
    ref = build_ref()
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    prng.seed_all(seed)
    port = build_port()
    port.initialize(device="cpu")
    numpy.testing.assert_array_equal(port.loader.original_data.mem,
                                     ref.loader.original_data.mem)
    for f, g in zip(port.forwards, ref.forwards):
        for k, v in g.param_arrays().items():
            numpy.testing.assert_array_equal(f.param_arrays()[k].map_read(),
                                             v.map_read())
    ref.run()
    port.run()
    assert port.decision.epoch_number == ref.decision.epoch_number == 2
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      atol=ERR_ATOL)
    assert float(port.train_step.last_loss) == pytest.approx(
        float(ref.train_step.last_loss), rel=LOSS_RTOL)
    lr = port.forwards[0].gd_config["learning_rate"]
    for attr in ("params", "opt_state"):
        want = _flat(jax.tree_util.tree_map(
            lambda v: numpy.asarray(jax.device_get(v)),
            getattr(ref.train_step, attr)))
        got = _flat(getattr(port.train_step, attr))
        assert sorted(got) == sorted(want)
        for path, v in want.items():
            g = got[path].numpy()
            assert g.dtype == v.dtype, path
            if attr == "opt_state":
                numpy.testing.assert_allclose(g, v, rtol=RTOL, atol=ATOL,
                                              err_msg=path)
                continue
            diff = numpy.abs(g - v)
            outside = int((diff > ATOL + RTOL * numpy.abs(v)).sum())
            assert outside <= v.size // 10 ** 4, (path, outside)
            assert diff.max() <= 2 * lr, (path, diff.max())
    return ref, port


def test_ci_alexnet_follows_reference():
    rows = dict(epochs=2, minibatch_size=64, n_train=128, n_valid=64)
    ref, port = _train_pair(lambda: alexnet.build_workflow(**rows),
                            lambda: REF_ALEXNET.build_workflow(**rows), 21)
    assert port.train_step._gd_for["conv_tanh0"].solver == "adam"
    assert int(port.train_step.opt_state["softmax5"]["t"]) == 4
    losses = port.decision.epoch_losses[TRAIN]
    assert all(numpy.isfinite(losses))


def test_stl10_follows_reference():
    kw = dict(epochs=2, minibatch_size=30, lr=0.05, image_size=16,
              n_train=60, n_valid=30)
    _train_pair(lambda: cifar.build_stl10_workflow(**kw),
                lambda: REF_CIFAR.build_stl10_workflow(**kw), 22)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        alexnet.main(["--epochs", "1"])
    wf = cifar.build_stl10_workflow(image_size=8, n_train=4, n_valid=2)
    with pytest.raises(VelesError, match="CUDA"):
        wf.initialize()
