"""Package-level contracts of the PyTorch port (veles_tpu_torch/):
it imports neither JAX nor the JAX package, its entry points default to
the card and raise without one, the kernel wrapper on a CPU tensor
takes the plain path without building anything, and parameter trees
are checked name by name and shape by shape."""
import ast
import os

import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

from veles_tpu_torch import backends
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, random_params
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn.standard_workflow import build_forwards
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import flash_attention as fa
from veles_tpu_torch.telemetry import counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "veles_tpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]

LAYERS = [{"type": "embedding", "vocab_size": 8, "dim": 16},
          {"type": "transformer_block", "n_heads": 2, "ffn_hidden": 32,
           "rope": True, "name": "b0"},
          {"type": "lm_head", "vocab_size": 8}]


def _imported_modules(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "veles_tpu"), (path, mod)


def test_import_scan_covers_every_subpackage():
    """The scan walks the whole package: the snapshot plane's
    subpackages too."""
    for sub in ("resilience", "scripts", "nn", "ops", "serving", "loader",
                "models", "telemetry"):
        assert any(p.startswith(os.path.join("veles_tpu_torch", sub, ""))
                   for p in PORT_FILES), sub
    assert os.path.join("veles_tpu_torch", "snapshotter.py") in PORT_FILES


@pytest.mark.parametrize("name", [None, "auto", "cuda", "cuda:0"])
def test_device_for_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        backends.device_for(name)


def test_device_for_cpu_and_policy():
    assert backends.device_for("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(VelesError, match="unsupported"):
        backends.device_for("meta")


def test_device_for_turns_reduced_precision_reductions_off():
    """A bf16 (or float16) product on the card accumulates in float32:
    cuBLAS may not reduce its split-K partial sums in the narrow type,
    whatever other code in the process set before."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    matmul.allow_fp16_reduced_precision_reduction = True
    assert backends.device_for("cpu") == torch.device("cpu")
    assert matmul.allow_bf16_reduced_precision_reduction is False
    assert matmul.allow_fp16_reduced_precision_reduction is False


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VelesError, match="CUDA"):
        build_forwards(LAYERS)


def test_cpu_tensor_takes_the_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("built %s for a CPU tensor" % name)

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    rng = numpy.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 20, 2, 8).astype("float32"))
               for _ in range(3))
    before = counters.get("veles_flash_attention_launches_total")
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert counters.get("veles_flash_attention_launches_total") == before


def test_build_paths_are_keyed_by_source(tmp_path, monkeypatch):
    path = _build.library_path("flash_attention_fwd")
    assert path.startswith(os.path.join(REPO, "build", "veles_tpu_torch"))
    assert path == _build.library_path("flash_attention_fwd")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first


def test_build_paths_are_keyed_by_headers(tmp_path, monkeypatch):
    """A source's library is keyed by every csrc/*.cuh as well: an edited
    header rebuilds the sources that may include it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    header.write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.library_path("k") not in (first, second)
    assert _build.sources() == ["k"]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(VelesError, match="nvcc"):
        _build.nvcc()


@pytest.fixture
def stack():
    return build_forwards(LAYERS, device="cpu")


def _breakers():
    def missing_unit(t):
        del t["b0"]

    def extra_unit(t):
        t["b9"] = {}

    def missing_param(t):
        del t["b0"]["b1"]

    def extra_param(t):
        t["b0"]["w3"] = numpy.zeros((16, 32), "float32")

    def wrong_shape(t):
        t["lm_head2"]["weights"] = numpy.zeros((16, 9), "float32")

    return [missing_unit, extra_unit, missing_param, extra_param,
            wrong_shape]


@pytest.mark.parametrize("breaker", _breakers(),
                         ids=lambda f: f.__name__)
def test_params_from_jax_rejects(stack, breaker):
    tree = random_params(stack, seed=1)
    breaker(tree)
    before = stack.layers["b0"].wq.clone()
    with pytest.raises(VelesError):
        params_from_jax(stack, tree)
    assert torch.equal(stack.layers["b0"].wq, before)  # nothing written


def test_params_from_jax_loads_every_tensor(stack):
    tree = random_params(stack, seed=2)
    params_from_jax(stack, tree)
    for name, params in tree.items():
        for pname, arr in params.items():
            assert numpy.array_equal(
                getattr(stack.layers[name], pname).numpy(), arr)


def test_counters_are_registered_names_only():
    with pytest.raises(KeyError):
        counters.inc("veles_no_such_counter_total")
    before = counters.get("veles_decode_tokens_total")
    counters.inc("veles_decode_tokens_total", 3)
    assert counters.get("veles_decode_tokens_total") == before + 3


def test_config_defaults():
    assert root.common.engine.flash_attention is True
    assert root.common.engine.precision_type == "float32"
    # the reference's serving defaults (veles_tpu/config.py)
    assert root.common.serving.engine == "continuous"
    assert (root.common.serving.max_slots, root.common.serving.buckets,
            root.common.serving.max_context,
            root.common.serving.decode_block,
            root.common.serving.page_size) == (8, [16, 32, 64, 128], 640,
                                               1, 16)
    assert root.common.serving.get("pages", 7) is None
    assert root.common.serving.get("no_such_key", 7) == 7
