"""The port's transformer layers (veles_tpu_torch/nn/transformer.py)
against the JAX package's functions and units on the same inputs and
parameters, made from a seed with numpy. atol 1e-5: both sides run
float32 and differ only in summation order."""
import types

import jax.numpy as jnp
import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu.nn import sampling as jsampling
from veles_tpu.nn import transformer as jtr

from veles_tpu_torch.nn import sampling as tsampling
from veles_tpu_torch.nn import transformer as ttr

ATOL = 1e-5


@pytest.fixture(autouse=True)
def f32_reference():
    """Full float32 dots on the JAX side, like the port."""
    prev = vt.root.common.engine.compute_dtype
    vt.root.common.engine.compute_dtype = "float32"
    yield
    vt.root.common.engine.compute_dtype = prev


def close(a, b, atol=ATOL):
    numpy.testing.assert_allclose(numpy.asarray(a), numpy.asarray(b),
                                  rtol=1e-5, atol=atol)


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(numpy.float32)


def block_params(rng, layer, d, f, kv_d):
    """A parameter dict of the reference layout for a block config."""
    p = {"wq": rand(rng, d, d, scale=d ** -0.5),
         "wk": rand(rng, d, kv_d, scale=d ** -0.5),
         "wv": rand(rng, d, kv_d, scale=d ** -0.5),
         "wo": rand(rng, d, d, scale=d ** -0.5),
         "w1": rand(rng, d, f, scale=d ** -0.5),
         "w2": rand(rng, f, d, scale=f ** -0.5),
         "ln1_g": 1 + rand(rng, d, scale=0.1),
         "ln2_g": 1 + rand(rng, d, scale=0.1)}
    if layer.get("ffn") == "swiglu":
        p["w3"] = rand(rng, d, f, scale=d ** -0.5)
    else:
        p["b1"] = rand(rng, f, scale=0.1)
        p["b2"] = rand(rng, d, scale=0.1)
    if layer.get("norm", "layer") == "layer":
        p["ln1_b"] = rand(rng, d, scale=0.1)
        p["ln2_b"] = rand(rng, d, scale=0.1)
    return p


def port_block(d, cfg, params):
    blk = ttr.TransformerBlock(d, device="cpu", **cfg)
    with torch.no_grad():
        for k, v in params.items():
            getattr(blk, k).copy_(torch.from_numpy(v))
    return blk


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_block_norm(norm):
    rng = numpy.random.RandomState(1)
    x = rand(rng, 2, 5, 16, scale=3.0) + 1.0
    p = {"ln1_g": rand(rng, 16), "ln1_b": rand(rng, 16)}
    ref = jtr.block_norm(jnp, types.SimpleNamespace(norm=norm), p,
                         jnp.asarray(x), "ln1")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    close(ttr.block_norm(types.SimpleNamespace(norm=norm), tp,
                         torch.from_numpy(x), "ln1"), ref)


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
def test_block_ffn(ffn):
    rng = numpy.random.RandomState(2)
    x = rand(rng, 2, 5, 16)
    p = {"w1": rand(rng, 16, 24, scale=0.25),
         "w3": rand(rng, 16, 24, scale=0.25),
         "w2": rand(rng, 24, 16, scale=0.2),
         "b1": rand(rng, 24, scale=0.1), "b2": rand(rng, 16, scale=0.1)}
    ref = jtr.block_ffn(jnp, types.SimpleNamespace(ffn=ffn), p,
                        jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    close(ttr.block_ffn(types.SimpleNamespace(ffn=ffn), tp,
                        torch.from_numpy(x)), ref)


@pytest.mark.parametrize("hd,base", [(8, 10000.0), (8, 500000.0),
                                     (7, 10000.0)])
def test_rope(hd, base):
    rng = numpy.random.RandomState(3)
    x = rand(rng, 2, 40, 3, hd)
    close(ttr._rope(torch.from_numpy(x), base),
          jtr._rope(jnp, jnp.asarray(x), base))


@pytest.mark.parametrize("pos", [0, 5, 37])
def test_rope_at(pos):
    """Single position vs the JAX step rotation, and bit-identical to
    row ``pos`` of the port's full-window rotation (the prefill and the
    decode step must agree exactly)."""
    rng = numpy.random.RandomState(4)
    x = rand(rng, 2, 1, 3, 8)
    got = tsampling._rope_at(torch.from_numpy(x), pos)
    close(got, jsampling._rope_at(jnp, jnp.asarray(x), jnp.int32(pos)))
    full = numpy.repeat(x, 40, axis=1)
    assert torch.equal(got[:, 0],
                       ttr._rope(torch.from_numpy(full))[:, pos])


def test_embedding_clips_out_of_range_ids():
    rng = numpy.random.RandomState(5)
    table = rand(rng, 10, 6)
    ids = numpy.array([[-3, 0, 4], [9, 10, 57]], numpy.int32)
    wf = vt.Workflow(name="emb")
    ref = jtr.Embedding(wf, vocab_size=10, dim=6).apply(
        {"table": jnp.asarray(table)}, jnp.asarray(ids))
    emb = ttr.Embedding(10, 6, device="cpu")
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    close(emb(torch.from_numpy(ids)), ref, atol=0)


def test_positional_embedding():
    rng = numpy.random.RandomState(6)
    table, x = rand(rng, 12, 6), rand(rng, 2, 7, 6)
    wf = vt.Workflow(name="pos")
    ref = jtr.PositionalEmbedding(wf).apply({"table": jnp.asarray(table)},
                                            jnp.asarray(x))
    pe = ttr.PositionalEmbedding(12, 6, device="cpu")
    with torch.no_grad():
        pe.table.copy_(torch.from_numpy(table))
    close(pe(torch.from_numpy(x)), ref)


def test_lm_head():
    rng = numpy.random.RandomState(7)
    w, bias, x = rand(rng, 16, 11), rand(rng, 11), rand(rng, 2, 3, 16)
    wf = vt.Workflow(name="head")
    ref = jtr.LMHead(wf, vocab_size=11).apply(
        {"weights": jnp.asarray(w), "bias": jnp.asarray(bias)},
        jnp.asarray(x))
    head = ttr.LMHead(16, 11, device="cpu")
    with torch.no_grad():
        head.weights.copy_(torch.from_numpy(w))
        head.bias.copy_(torch.from_numpy(bias))
    close(head(torch.from_numpy(x)), ref)


BLOCKS = {
    "layer_gelu_mha_rope": dict(n_heads=4, ffn_hidden=48, rope=True),
    "rms_swiglu_gqa_window": dict(n_heads=4, n_kv_heads=2, window=5,
                                  norm="rms", ffn="swiglu", rope=True,
                                  ffn_hidden=40),
    "layer_gelu_noncausal": dict(n_heads=2, ffn_hidden=32, causal=False),
    "rms_gelu_mqa_rope_base": dict(n_heads=4, n_kv_heads=1, norm="rms",
                                   rope=True, rope_base=500000.0),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_transformer_block_forward(name):
    cfg = BLOCKS[name]
    d = 16
    rng = numpy.random.RandomState(len(name))
    kv = cfg.get("n_kv_heads", cfg["n_heads"])
    f = cfg.get("ffn_hidden") or 4 * d
    params = block_params(rng, cfg, d, f, d // cfg["n_heads"] * kv)
    x = rand(rng, 2, 13, d)
    wf = vt.Workflow(name="blk")
    ref = jtr.TransformerBlock(wf, **cfg).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = port_block(d, cfg, params)(torch.from_numpy(x))
    close(got, ref)


def test_block_validates_options():
    with pytest.raises(ValueError, match="norm"):
        ttr.TransformerBlock(16, norm="batch", device="cpu")
    with pytest.raises(ValueError, match="ffn"):
        ttr.TransformerBlock(16, ffn="relu", device="cpu")
    with pytest.raises(ValueError, match="window"):
        ttr.TransformerBlock(16, window=4, causal=False, device="cpu")
    with pytest.raises(ValueError, match="window"):
        ttr.TransformerBlock(16, window=0, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ttr.TransformerBlock(16, n_heads=4, n_kv_heads=3, device="cpu")
