"""BASELINE config #2's units in the port (veles_tpu_torch/
mean_disp_normalizer.py, input_joiner.py, normalization.py) against the
reference's, on the CPU:

- ``MeanDispNormalizer``: the same ``compute_mean_rdisp`` bits, and the
  port's unit on seeded data against the reference's ``xla_run`` within
  rtol 1e-6 / atol 1e-7 and against its own ``numpy_run`` within rtol
  1e-5 / atol 1e-6 (tests/test_aux_units.py), with |y| <= 1 + 1e-5;
- ``InputJoiner`` is exact, against the reference's and its numpy run;
- every normalizer of the registry normalizes and denormalizes as the
  reference's, a reference ``state_dict`` loads into the port's
  normalizer, and an unknown name raises.
"""
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import normalization as ref_normalization
from veles_tpu.memory import Array as RefArray
from veles_tpu_torch import InputJoiner, MeanDispNormalizer, normalization
from veles_tpu_torch.memory import Array
from veles_tpu_torch.workflow import Workflow


def _ref_dev():
    return vt.XLADevice(mesh_axes={"data": 1})


def _images():
    rng = numpy.random.RandomState(0)
    return (rng.rand(50, 7, 3) * 255).astype(numpy.uint8).astype(
        numpy.float32)


def test_mean_disp_normalizer_matches_reference():
    data = _images()
    mean, rdisp = MeanDispNormalizer.compute_mean_rdisp(data)
    ref_mean, ref_rdisp = vt.MeanDispNormalizer.compute_mean_rdisp(data)
    numpy.testing.assert_array_equal(mean, ref_mean)
    numpy.testing.assert_array_equal(rdisp, ref_rdisp)

    ref = vt.MeanDispNormalizer(vt.Workflow(name="t"))
    ref.input = RefArray(data)
    ref.mean, ref.rdisp = RefArray(mean), RefArray(rdisp)
    ref.initialize(device=_ref_dev())
    ref.xla_run()
    want = numpy.asarray(ref.output.map_read())

    u = MeanDispNormalizer(Workflow(name="t"))
    u.input = Array(data)
    u.mean, u.rdisp = Array(mean), Array(rdisp)
    u.initialize(device="cpu")
    u.run()
    got = u.output.map_read()
    assert got.dtype == numpy.float32 and got.shape == data.shape
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    u.numpy_run()
    oracle = u.output.map_read()
    numpy.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    assert abs(oracle).max() <= 1.0 + 1e-5


def test_mean_disp_normalizer_on_the_workflow_device():
    u = MeanDispNormalizer(Workflow(name="t"))
    u.input = Array(_images())
    u.mean, u.rdisp = (Array(a) for a in MeanDispNormalizer
                       .compute_mean_rdisp(_images()))
    u.initialize(device="cpu")
    u.run()
    assert isinstance(u.output.devmem, torch.Tensor)
    assert u.output.devmem.device == torch.device("cpu")


def test_input_joiner_is_exact():
    a = numpy.arange(12, dtype=numpy.float32).reshape(4, 3)
    b = numpy.random.RandomState(1).rand(4, 2, 2).astype(numpy.float32)
    ref = vt.InputJoiner(vt.Workflow(name="t"),
                         inputs=[RefArray(a), RefArray(b)])
    ref.initialize(device=_ref_dev())
    ref.xla_run()
    u = InputJoiner(Workflow(name="t"), inputs=[Array(a), Array(b)])
    u.initialize(device="cpu")
    u.run()
    y = u.output.map_read()
    assert y.shape == (4, 7)
    numpy.testing.assert_array_equal(y, numpy.asarray(ref.output.map_read()))
    u.numpy_run()
    numpy.testing.assert_array_equal(u.output.map_read(), y)


@pytest.mark.parametrize("name", sorted(ref_normalization.NORMALIZERS))
def test_normalizer_matches_reference(name):
    assert sorted(normalization.NORMALIZERS) == sorted(
        ref_normalization.NORMALIZERS)
    rng = numpy.random.RandomState(3)
    data = (rng.rand(20, 5) * 10 - 3).astype(numpy.float32)
    kwargs = ({"mean_source": data.mean(axis=0)}
              if name == "external_mean" else {})
    ref = ref_normalization.get_normalizer(name, **kwargs)
    ref.analyze(data)
    out_ref = ref.normalize(data.copy())
    port = normalization.get_normalizer(name, **kwargs)
    port.analyze(data)
    out = port.normalize(data.copy())
    numpy.testing.assert_array_equal(out, out_ref)
    # the reference's state, loaded into a fresh port normalizer
    loaded = normalization.get_normalizer(name, **kwargs)
    loaded.load_state_dict(ref.state_dict())
    numpy.testing.assert_array_equal(loaded.normalize(data.copy()), out_ref)
    if name != "linear":           # per-sample linear is not invertible
        numpy.testing.assert_array_equal(port.denormalize(out),
                                         ref.denormalize(out_ref))
        numpy.testing.assert_allclose(port.denormalize(out), data,
                                      rtol=1e-4, atol=1e-4)


def test_unknown_normalizer():
    with pytest.raises(KeyError):
        normalization.get_normalizer("nope")
