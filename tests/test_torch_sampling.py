"""The port's KV-cached sampler (veles_tpu_torch/nn/sampling.py) against
``veles_tpu.nn.sampling`` on the same weights: reference workflows are
built and initialised on the CPU, their parameter trees carried into the
port with ``convert.params_from_jax``. Prompt logits agree within atol
1e-4 (float32, six matmul layers deep, summation order differs) and
greedy tokens are identical. Sampled tokens cannot match JAX's threefry
bits, so the port's own sampling contract is tested instead: a row's
tokens depend only on its seed and prompt."""
import jax  # noqa: F401 — both frameworks in one process, JAX on CPU
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import nn as jnn
from veles_tpu import prng
from veles_tpu.nn import sampling as jsampling

from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.nn import sampling as tsampling
from veles_tpu_torch.nn.standard_workflow import build_forwards

from conftest import import_model

SEQ_LEN = 32     # char_lm's loader sequence length (pos-table rows)

MODERN = [
    {"type": "embedding", "vocab_size": 16, "dim": 32, "solver": "adam"},
    {"type": "transformer_block", "n_heads": 4, "n_kv_heads": 2,
     "ffn_hidden": 48, "causal": True, "rope": True, "norm": "rms",
     "ffn": "swiglu", "window": 6, "name": "L0", "solver": "adam"},
    {"type": "transformer_block", "n_heads": 2, "ffn_hidden": 64,
     "causal": True, "rope": True, "rope_base": 500000.0, "name": "L1"},
    {"type": "lm_head", "vocab_size": 16, "learning_rate": 0.01}]

POSEMB = [
    {"type": "embedding", "vocab_size": 16, "dim": 32},
    {"type": "pos_embedding"},
    {"type": "transformer_block", "n_heads": 4, "ffn_hidden": 64,
     "causal": True, "name": "P0"},
    {"type": "lm_head", "vocab_size": 16}]


def _reference(lm, name, layers):
    prng.seed_all(5)
    if layers is None:
        wf = lm.build_workflow(n_blocks=2, dim=32, n_train=128,
                               n_valid=64)
        layers = wf.layers_config
    else:
        wf = jnn.StandardWorkflow(
            name=name, layers=layers,
            loader_unit=lm.CharLMLoader(None, n_train=128, n_valid=64,
                                        minibatch_size=64, name="chars"),
            loss_function="softmax_seq")
    wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    params = {unit: {k: numpy.asarray(v) for k, v in tree.items()}
              for unit, tree in jsampling.params_of(wf).items()}
    port = params_from_jax(build_forwards(layers, seq_len=SEQ_LEN,
                                          device="cpu"), params)
    return wf, port


@pytest.fixture(scope="module")
def stacks():
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    lm = import_model("char_lm")
    try:
        yield {"char_lm": _reference(lm, "char_lm", None),
               "gqa_window_rms_swiglu": _reference(lm, "modern", MODERN),
               "pos_embedding": _reference(lm, "posemb", POSEMB)}
    finally:
        vt.root.common.engine.compute_dtype = prev


NAMES = ["char_lm", "gqa_window_rms_swiglu", "pos_embedding"]


def _prompts(seed, n, length):
    rng = numpy.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 16, length)] for _ in range(n)]


@pytest.mark.parametrize("name", NAMES)
def test_prompt_logits_match(stacks, name):
    wf, port = stacks[name]
    for prompt in _prompts(1, 2, 11):
        numpy.testing.assert_allclose(
            tsampling.prompt_logits(port, prompt),
            jsampling.prompt_logits(wf, prompt), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_full_forward_matches_prefill(stacks, name):
    """The port's full-window forward and its cached prefill agree."""
    _, port = stacks[name]
    prompt = _prompts(2, 1, 9)[0]
    full = port(torch.tensor([prompt]))[0, -1].numpy()
    numpy.testing.assert_allclose(full,
                                  tsampling.prompt_logits(port, prompt),
                                  rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_identical(stacks, name):
    wf, port = stacks[name]
    prompt = _prompts(3, 1, 7)[0]
    ref = jsampling.generate(wf, prompt, 12, temperature=0)
    assert tsampling.generate(port, prompt, 12, temperature=0) == ref


@pytest.mark.parametrize("name", NAMES)
def test_greedy_batched_tokens_identical(stacks, name):
    wf, port = stacks[name]
    prompts = _prompts(4, 3, 6)
    ref = jsampling.generate(wf, prompts, 10, temperature=0)
    got = tsampling.generate(port, prompts, 10, temperature=0)
    assert got == ref
    # each batched row is its solo decode
    assert got[1] == tsampling.generate(port, prompts[1], 10,
                                        temperature=0)


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batched"])
def test_zero_new_tokens_match_reference(stacks, batched):
    """``n_new=0`` yields no token, as the reference's scan over
    ``arange(0)`` does: ``[]``, or one empty row per prompt."""
    wf, port = stacks["char_lm"]
    prompt = [[1, 2, 3], [4, 5, 6]] if batched else [1, 2, 3]
    ref = jsampling.generate(wf, prompt, 0, temperature=0)
    assert ref == ([[], []] if batched else [])
    assert tsampling.generate(port, prompt, 0, temperature=0) == ref


def test_sampled_rows_invariant_to_batch_composition(stacks):
    _, port = stacks["char_lm"]
    prompts = _prompts(5, 3, 8)
    solo = tsampling.generate(port, prompts[0], 16, temperature=0.9,
                              seed=11)
    batch = tsampling.generate(port, prompts, 16, temperature=0.9,
                               seed=11)
    assert batch[0] == solo
    strangers = tsampling.generate(port, [prompts[0], prompts[2]], 16,
                                   temperature=0.9, seed=[11, 3])
    assert strangers[0] == solo


def test_sampled_seed_determinism(stacks):
    _, port = stacks["gqa_window_rms_swiglu"]
    prompt = _prompts(6, 1, 8)[0]
    a = tsampling.generate(port, prompt, 20, temperature=1.0, seed=4)
    assert a == tsampling.generate(port, prompt, 20, temperature=1.0,
                                   seed=4)
    assert a != tsampling.generate(port, prompt, 20, temperature=1.0,
                                   seed=5)
    assert all(0 <= t < 16 for t in a)


def test_generation_errors(stacks):
    _, port = stacks["pos_embedding"]
    with pytest.raises(VelesError, match="EQUAL-length"):
        tsampling.generate(port, [[1, 2], [3]], 4, temperature=0)
    with pytest.raises(VelesError, match="PositionalEmbedding"):
        tsampling.generate(port, [1] * 30, 4, temperature=0)
    with pytest.raises(VelesError, match="seed"):
        tsampling.generate(port, [[1, 2], [3, 4]], 4, temperature=1.0,
                           seed=[1, 2, 3])


def test_build_forwards_names_and_layout(stacks):
    wf, port = stacks["char_lm"]
    assert [f.name for f in wf.forwards] == [f.name for f in port]
    ref = jsampling.params_of(wf)
    for layer in port:
        for pname, shape in layer.param_shapes().items():
            assert tuple(ref[layer.name][pname].shape) == shape
    with pytest.raises(VelesError, match="not ported"):
        build_forwards([{"type": "embedding", "vocab_size": 4, "dim": 8},
                        {"type": "moe_ffn", "n_experts": 2}], device="cpu")
    with pytest.raises(VelesError, match="seq_len"):
        build_forwards(POSEMB, device="cpu")
