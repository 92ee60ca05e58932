"""The small zoo models of BASELINE #2's slice trained in the port
(veles_tpu_torch/models/kanji.py, video_ae.py) against the reference's
(models/kanji.py, models/video_ae.py) on the CPU: their own widths,
rows cut to 240 train / 48 validation, 2 epochs from one seed (the
initial weights bitwise equal). The loaders' data are the reference's
bits; per-epoch train and validation rmse agree within 1e-5 relative,
adam's ``opt_state`` (m, v and t) within rtol 2e-4 / atol 2e-5 at every
element (float32 in another summation order, the limits of
tests/test_torch_conv_train.py for MSE chains), and so do the final
weights at all but 1 in 10^4 elements of a tensor; no weight is further
than 2 lr from the reference's. Why: adam's normalised step lr·m̂/(√v̂ +
ε) turns a gradient that is rounding noise (|g| near ε, its sign
changing between steps) into a step of up to ±lr, so two summation
orders can part at such an element while the moments behind it agree
to 1e-8 (observed: one of kanji's 147,456 first-layer weights at
2.37e-5, the moments within 6.1e-9; the chip's bench-LM phase limits
adam's weights the same way).
"""
import jax
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import prng as ref_prng
from veles_tpu.loader import TRAIN, VALID
from veles_tpu_torch import prng
from veles_tpu_torch.models import kanji, video_ae

from conftest import import_model

RTOL, ATOL = 2e-4, 2e-5
RMSE_RTOL = 1e-5
ROWS = dict(n_train=240, n_valid=48)
MODELS = {"kanji": (kanji, ((576, 256), (256, 576)), "targets"),
          "video_ae": (video_ae, ((256, 96), (96, 24), (24, 96), (96, 256)),
                       "input")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, "%s/%s" % (prefix, k)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_reference(name):
    port_mod, shapes, target_mode = MODELS[name]
    ref_prng.seed_all(31)
    ref = import_model(name).build_workflow(epochs=2, **ROWS)
    ref.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    prng.seed_all(31)
    port = port_mod.build_workflow(epochs=2, **ROWS)
    port.initialize(device="cpu")
    numpy.testing.assert_array_equal(port.loader.original_data.mem,
                                     ref.loader.original_data.mem)
    assert [tuple(f.weights.shape) for f in port.forwards] == list(shapes)
    for f, g in zip(port.forwards, ref.forwards):
        numpy.testing.assert_array_equal(f.weights.map_read(),
                                         g.weights.map_read())
    ref.run()
    port.run()
    assert port.train_step.target_mode == target_mode
    assert port.decision.epoch_number == ref.decision.epoch_number == 2
    for cls in (TRAIN, VALID):
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      ref.decision.epoch_metrics[cls],
                                      rtol=RMSE_RTOL)
    lr = port.forwards[0].gd_config["learning_rate"]
    for attr in ("params", "opt_state"):
        want = _flat(jax.tree_util.tree_map(
            lambda v: numpy.asarray(jax.device_get(v)),
            getattr(ref.train_step, attr)))
        got = _flat(getattr(port.train_step, attr))
        assert sorted(got) == sorted(want)
        for path, v in want.items():
            g = got[path]
            assert isinstance(g, torch.Tensor) and g.numpy().dtype == v.dtype
            g = g.numpy()
            if attr == "opt_state":
                numpy.testing.assert_allclose(g, v, rtol=RTOL, atol=ATOL,
                                              err_msg=path)
                continue
            diff = numpy.abs(g - v)
            outside = int((diff > ATOL + RTOL * numpy.abs(v)).sum())
            assert outside <= v.size // 10 ** 4, (path, outside)
            assert diff.max() <= 2 * lr, (path, diff.max())
