"""The C++ inference runtime (``native/``) built by the port
(veles_tpu_torch/export/native.py) and run on the port's packages, on
the CPU, against the reference's package executor: the port's packages
of an MNIST-like FC chain, a conv stack, a transformer chain (GQA, a
sliding window, RoPE, RMS norm with SwiGLU), a token transformer and an
LSTM (behind multi-head attention and a sparse MoE), each with the
reference's weights carried by ``convert.params_from_jax``, through
``NativeModel`` (``vi_run``) equal the reference's ``run_package`` of
the same package within ``rtol 2e-3, atol 2e-4`` — the reference's own
native tolerances (``tests/test_export_native.py``). The cached greedy
generation (``vi_generate``) of a char LM's package equals the port's
greedy ``generate`` token for token. The build goes into the git-ignored
``build/veles_tpu_torch/native/``, once a source hash, under a file
lock; a bad package and a newer format are refused."""
import json
import os
import shutil

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest

from veles_tpu.export import run_package as ref_run

from veles_tpu_torch import prng
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.export import package_export
from veles_tpu_torch.export import native
from veles_tpu_torch.export.native import NativeModel
from veles_tpu_torch.models import char_lm
from veles_tpu_torch.nn import sampling
from veles_tpu_torch.nn.standard_workflow import forwards_of

from test_torch_export_package import CASES, _twins

RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def library():
    """The runtime, built from the checkout (an error, never a skip, if
    it does not build)."""
    path = native.build_library()
    assert path.startswith(native.NATIVE_BUILD_DIR)
    assert native.find_library() == path
    return path


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_runs_the_port_packages(library, case, tmp_path):
    _, port, batch = _twins(case)
    path = package_export(port, str(tmp_path / case), with_program=False)
    want = numpy.asarray(ref_run(path, batch))
    model = NativeModel(path)
    try:
        assert model.unit_count == len(port.forwards)
        got = model(batch).reshape(want.shape)
    finally:
        model.close()
    numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_native_cached_generation_equals_the_port(library, tmp_path):
    """``vi_generate`` over the port's char-LM package (the reference's
    char-LM workflow: embedding → 2 RoPE blocks → lm_head, one epoch)
    gives the port's greedy ``generate`` tokens, for a prompt shorter
    and one longer than the training window."""
    prng.seed_all(21)
    wf = char_lm.build_workflow(epochs=1, minibatch_size=32, n_blocks=2,
                                dim=16, n_train=128, n_valid=32)
    wf.initialize(device="cpu")
    wf.run()
    path = package_export(wf, str(tmp_path / "lm"), with_program=False)
    stack = forwards_of(wf)
    rng = numpy.random.RandomState(3)
    model = NativeModel(path)
    try:
        for n in (11, char_lm.SEQ_LEN + 5):
            prompt = [int(t) for t in char_lm.make_corpus(rng, n)]
            want = sampling.generate(stack, prompt, 10, temperature=0)
            assert model.generate(prompt, 10) == want
    finally:
        model.close()


def test_bad_and_newer_packages_are_refused(library, tmp_path):
    with pytest.raises(VelesError, match="native load failed"):
        NativeModel(str(tmp_path))
    _, port, _ = _twins("fc")
    path = package_export(port, str(tmp_path / "fc"), with_program=False)
    future = str(tmp_path / "future")
    shutil.copytree(path, future)
    cpath = os.path.join(future, "contents.json")
    with open(cpath) as fin:
        contents = json.load(fin)
    contents["format_version"] = 99
    with open(cpath, "w") as fout:
        json.dump(contents, fout)
    with pytest.raises(VelesError, match="newer"):
        NativeModel(future)
    model = NativeModel(path)
    try:
        with pytest.raises(VelesError):
            model(numpy.empty((0, 32), dtype=numpy.float32))
    finally:
        model.close()
