"""KV-cached autoregressive sampling — the LM serving path (counterpart
of ``veles_tpu/nn/sampling.py``).

Prefill runs the whole prompt through every block once, writing each
block's K/V into a cache of ``prompt + n_new`` rows (the attention goes
through ``attention_core``, so on the card it is the flash kernel);
then each new token runs only its single-position projections and one
attention row over the cache. The reference runs the decode as one
``lax.scan``; here it is a Python loop over steps (a CUDA graph of the
step is later work). Caches are updated in place.

Operates on the ``Embedding`` → [``PositionalEmbedding``] →
``TransformerBlock``×N → ``LMHead`` stack and reuses transformer.py's
norm/FFN/RoPE so the cached and the full forward cannot drift. The
continuous-batching engine (``serving/engine.py``) advances rows that
sit at different positions with :func:`_block_step_rows`, the same
arithmetic as :func:`_block_step` over each row's paged view, and draws
each sampled row's token with :func:`_draw`, as :func:`_pick` does.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy
import torch

from ..error import VelesError
from ..telemetry.counters import inc
from ..telemetry.spans import span
from .transformer import (Embedding, EmbeddingUnit, LMHead, LMHeadUnit,
                          PositionalEmbedding, PositionalEmbeddingUnit,
                          TransformerBlock, TransformerBlockUnit, _rotate,
                          add_positions, block_apply, block_ffn, block_norm,
                          block_qkv, embed, lm_logits, rope_angles,
                          rope_angles_rows)


def _rope_at(x, pos: int, base=10000.0):
    """RoPE for a SINGLE position: x (B, 1, H, Dh). The angles are
    those of row ``pos`` of :func:`transformer._rope`, bit for bit."""
    return _rotate(x, rope_angles([pos], x.shape[-1], base))


def _positions(positions, device):
    """Per-row positions as an int64 tensor on ``device``: host ints or
    numpy as they come, a tensor as it is (a traced program's input)."""
    if isinstance(positions, torch.Tensor):
        return positions
    return torch.as_tensor(numpy.asarray(positions, numpy.int64),
                           device=device)


def _rope_rows(x, ang):
    """RoPE of x (S, 1, H, Dh), row ``s`` by ``ang[s]``, the angles of its
    own position (``transformer.rope_angles_rows``): those of
    :func:`_rope_at` at that position, bit for bit."""
    return _rotate(x.transpose(0, 1), ang).transpose(0, 1)


def split_stack(forwards) -> Dict[str, object]:
    """Stem / block-list / head decomposition of a generation-capable
    stack — its layers, or the training units of a workflow's
    ``forwards`` (as the reference's, whose layers are the units: the
    CLI validates a workflow before it builds the serving stack);
    raises for anything else."""
    stem = pos_emb = head = None
    blocks: List[TransformerBlock] = []
    for f in forwards:
        if isinstance(f, (Embedding, EmbeddingUnit)):
            stem = f
        elif isinstance(f, (PositionalEmbedding, PositionalEmbeddingUnit)):
            pos_emb = f
        elif isinstance(f, (TransformerBlock, TransformerBlockUnit)):
            blocks.append(f)
        elif isinstance(f, (LMHead, LMHeadUnit)):
            head = f
        else:
            raise VelesError(
                "cached sampling supports Embedding → [PositionalEmbedding]"
                " → TransformerBlock* → LMHead chains; found %s"
                % type(f).__name__)
    if stem is None or head is None or not blocks:
        raise VelesError("not a generation stack: stem=%r head=%r "
                         "blocks=%d" % (stem, head, len(blocks)))
    return {"stem": stem, "pos_emb": pos_emb, "blocks": blocks,
            "head": head}


def _visible(rows, pos, window):
    """Causal (and sliding-window) visibility of cache ``rows`` from a
    query at ``pos``: rows <= pos (and > pos - window)."""
    valid = rows <= pos
    if window:
        valid = valid & (rows > pos - window)
    return valid


def _attend(block, p, x_t, q, cache_k, cache_v, valid):
    """The attention of Q new positions over a cache and the rest of the
    block: x_t (B, Q, D), q (B, Q, H, Dh) already rotated, caches
    (B, T, KV, Dh), ``valid`` broadcastable to the (B, KV, G, Q, T)
    scores. Scores and softmax in f32; GQA reads the unrepeated cache
    through a (kv, group) view of the query heads."""
    b, nq = x_t.shape[:2]
    h, kv = block.n_heads, block.n_kv_heads
    g, hd = h // kv, block.head_dim
    q5 = q.reshape(b, nq, kv, g, hd).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", q5,
                     cache_k.float()) / math.sqrt(hd)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", w,
                     cache_v.float()).to(x_t.dtype).reshape(b, nq, h * hd)
    x_t = x_t + o @ p["wo"]
    return x_t + block_ffn(block, p, block_norm(block, p, x_t, "ln2"))


def _block_step(block, x_t, cache_k, cache_v, pos: int):
    """One-token pass: x_t (B, 1, D), caches (B, T_max, KV, Dh) updated
    in place at row ``pos``; attention reads the cache rows <= pos (and
    > pos - window)."""
    p = block.params()
    q, k, v = block_qkv(block, p, block_norm(block, p, x_t, "ln1"))
    if block.rope:
        q = _rope_at(q, pos, block.rope_base)
        k = _rope_at(k, pos, block.rope_base)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    rows = torch.arange(cache_k.shape[1], device=x_t.device)
    return _attend(block, p, x_t, q, cache_k, cache_v,
                   _visible(rows, pos, block.window))


class _RowIndex:
    """The index tensors of one decode step over S rows at their own
    ``positions`` (an (S,) tensor), each made once and shared by every
    block that asks for it: the RoPE angles by head dim and base, and by
    view length the rows' write positions (clamped into the view) and
    their causal (and window) masks."""

    def __init__(self, positions) -> None:
        self.positions = positions
        self._memo: Dict = {}

    def _get(self, key, make):
        val = self._memo.get(key)
        if val is None:
            val = self._memo[key] = make()
        return val

    def angles(self, hd: int, base: float):
        return self._get(("rope", hd, base), lambda: rope_angles_rows(
            self.positions, hd, base))

    def write_at(self, n_rows: int):
        """(row ids, positions clamped to the view): a masked row may sit
        past its view, and its write then lands on the last row, as the
        reference's dynamic_update_slice clamps it (its output is never
        read)."""
        pos = self.positions
        return self._get(("at", n_rows), lambda: (
            torch.arange(pos.shape[0], device=pos.device),
            pos.clamp(max=n_rows - 1)))

    def visible(self, n_rows: int, window):
        """Each row's mask over its ``n_rows``-position view,
        broadcastable to :func:`_attend`'s scores."""
        pos = self.positions
        return self._get(("visible", n_rows, window), lambda: _visible(
            torch.arange(n_rows, device=pos.device)[None, :], pos[:, None],
            window)[:, None, None, None, :])


def _step_qkv_rows(block, p, x_t, index):
    """q, k, v of S single-position rows at their own positions
    (a :class:`_RowIndex`), rotated."""
    q, k, v = block_qkv(block, p, block_norm(block, p, x_t, "ln1"))
    if block.rope:
        ang = index.angles(q.shape[-1], block.rope_base)
        q, k = _rope_rows(q, ang), _rope_rows(k, ang)
    return q, k, v


def _attend_own_rows(block, p, x_t, q, cache_k, cache_v, k, v, index):
    """Write each row's new K and V rows into its own gathered views (S,
    n_rows, KV, Dh) at its position, in place, then attend over them
    under each row's own mask."""
    n_rows = cache_k.shape[1]
    rows, at = index.write_at(n_rows)
    cache_k[rows, at] = k
    cache_v[rows, at] = v
    return _attend(block, p, x_t, q, cache_k, cache_v,
                   index.visible(n_rows, block.window))


def _block_step_rows(block, x_t, pool_k, pool_v, tables, index, p=None):
    """One-token pass of S rows that sit at different positions, over a
    paged cache: x_t (S, 1, D); pools (pages + 1, page_size, KV, Dh);
    ``tables`` (S, P) page ids and the rows' positions (``index``, a
    :class:`_RowIndex`), tensors on the pools' device. Each row reads its
    view through its page-table row (a gathered copy), with its own new
    K/V row written into that copy at its position, under its own causal
    and window mask: :func:`_block_step`'s arithmetic row by row. The
    pools are only read: returns ``(x, (k, v))`` with the new rows (S,
    KV, Dh), which the caller writes into the pools (one ``index_put_``
    each), so a traced step mutates none of its inputs. ``p`` overrides
    the block's parameters (the int8 engine's dequantizing view)."""
    p = block.params() if p is None else p
    q, k, v = _step_qkv_rows(block, p, x_t, index)
    cache_k = pool_k[tables].flatten(1, 2)        # (S, P*page_size, ...)
    cache_v = pool_v[tables].flatten(1, 2)
    return (_attend_own_rows(block, p, x_t, q, cache_k, cache_v, k[:, 0],
                             v[:, 0], index),
            (k[:, 0], v[:, 0]))


def _block_step_rows_int8(block, x_t, pool, tables, index, p=None):
    """:func:`_block_step_rows` over an int8 pool ``(kq, vq, k_scale,
    v_scale)`` (``quant/kv.py``): each row's view is dequantized in the
    activations' dtype, its own new K/V row goes into that view
    unquantized, and the attention reads it; only the new rows are
    quantized, each with its own scale, and returned in the pool's order
    ``(kq, vq, k_scale, v_scale)`` for the caller to write. Written rows
    are never re-scaled (the reference's ``rowq``)."""
    from ..ops.precision import dequantize_rows_int8, quantize_rows_int8
    p = block.params() if p is None else p
    kq, vq, ks, vs = pool
    q, k, v = _step_qkv_rows(block, p, x_t, index)
    cache_k = dequantize_rows_int8(kq[tables].flatten(1, 2),
                                   ks[tables].flatten(1, 2), x_t.dtype)
    cache_v = dequantize_rows_int8(vq[tables].flatten(1, 2),
                                   vs[tables].flatten(1, 2), x_t.dtype)
    x = _attend_own_rows(block, p, x_t, q, cache_k, cache_v, k[:, 0],
                         v[:, 0], index)
    qk, sk = quantize_rows_int8(k[:, 0])
    qv, sv = quantize_rows_int8(v[:, 0])
    return x, (qk, qv, sk, sv)


def prefill_rows(stack, params, ids, last, quant_kv: bool = False):
    """The continuous engine's bucketed prefill as a tensor function:
    ``ids`` (1, bucket) through every block (the attention through
    ``attention_core``, on the card the flash kernel) → ``(logits (1, V)
    at position ``last`` (a (1,) tensor), [rows of each block])``. A
    block's rows are its K and V (bucket, KV, Dh) or, for the int8 pool
    (``quant_kv``), their int8 payloads and one float32 scale a position,
    in the pool's order ``(kq, vq, k_scale, v_scale)``. ``params`` is
    the ``{layer name: params}`` tree; nothing is written, so the same
    function runs live and as an exported program."""
    x = _embed_prompt(stack["stem"], stack["pos_emb"], ids, params=params)
    x, caches = _prefill_blocks(stack["blocks"], x, ids.shape[-1], params)
    rows = []
    for ck, cv in caches:
        if quant_kv:
            from ..ops.precision import quantize_rows_int8
            qk, sk = quantize_rows_int8(ck[0])
            qv, sv = quantize_rows_int8(cv[0])
            rows.append((qk, qv, sk, sv))
        else:
            rows.append((ck[0], cv[0]))
    logits = _head_logits(stack["head"], x[0].index_select(0, last),
                          params)
    return logits, rows


def step_rows(stack, params, tok, positions, tables, pools):
    """One decode position of every row as a tensor function: ``tok``,
    ``positions`` (S,) and the page ``tables`` (S, P) over the paged
    ``pools`` (per block float ``(k, v)`` or int8 ``(kq, vq, k_scale,
    v_scale)``) → ``(logits (S, V), [new rows of each block])``
    (:func:`_block_step_rows`, :func:`_block_step_rows_int8`). The pools
    are only read; the caller writes the new rows. ``params`` (``{layer
    name: params}``) overrides the layers' own (None: their own)."""
    x = _embed_rows(stack["stem"], stack["pos_emb"], tok, positions, params)
    index = _RowIndex(positions)
    new = []
    for blk, pool in zip(stack["blocks"], pools):
        p = None if params is None else params[blk.name]
        if len(pool) == 4:
            x, rows = _block_step_rows_int8(blk, x, pool, tables, index, p)
        else:
            x, rows = _block_step_rows(blk, x, pool[0], pool[1], tables,
                                       index, p)
        new.append(rows)
    return _head_logits(stack["head"], x[:, 0], params), new


def params_of(layers) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer name: {param: tensor}}`` of ``layers``: the tree the
    recurrent lane's step bodies index by the reference's names."""
    return {layer.name: layer.params() for layer in layers}


def _embed_ids(stem, ids):
    """Embedding-table gather for int token ids of any shape; ids clamp
    to the table (the reference's ``mode="clip"``)."""
    return stem(ids)


def _embed_prompt(stem, pos_emb, ids, pos0: int = 0, params=None):
    """(B, T) token ids → (B, T, D): the embedding gather plus the
    positional rows ``pos0..pos0+T`` — the stack entry every prompt
    consumer shares. ``params`` (``{layer name: params}``) overrides the
    layers' own tables."""
    if params is None:
        x = _embed_ids(stem, ids)
    else:
        x = embed(params[stem.name]["table"], ids)
    if pos_emb is not None:
        table = (pos_emb.table if params is None
                 else params[pos_emb.name]["table"])
        idx = (pos0 + torch.arange(ids.shape[-1], device=ids.device)
               ).clamp(0, pos_emb.max_len - 1)
        x = x + table[idx][None]
    return x


def _embed_rows(stem, pos_emb, tok, positions, params=None):
    """(S,) token ids at per-row ``positions`` (host ints or a tensor)
    → (S, 1, D): the row-wise counterpart of :func:`_embed_prompt`
    (positions clamp to the table). ``params`` (``{layer name:
    params}``) overrides the layers' own tables."""
    if params is None:
        x = _embed_ids(stem, tok[:, None])
    else:
        x = embed(params[stem.name]["table"], tok[:, None])
    if pos_emb is not None:
        table = (pos_emb.table if params is None
                 else params[pos_emb.name]["table"])
        idx = _positions(positions, tok.device).clamp(
            0, pos_emb.max_len - 1)
        x = x + table[idx][:, None]
    return x


def _prefill_blocks(blocks, x, cache_len: int, params=None):
    """Every block's full-window pass over fresh zero K/V caches of
    ``cache_len`` rows, writing each block's K/V into its cache's first
    T rows → (x, [(ck, cv), ...]). The pass is the block's own
    composition (``transformer.block_apply``), causal, so prefill logits
    cannot drift from the full forward. Each block shapes its own cache
    (heads may differ per block; GQA caches hold n_kv_heads).
    ``params`` (``{layer name: params}``) overrides the blocks' own."""
    b = x.shape[0]
    caches = []
    for blk in blocks:
        shape = (b, cache_len, blk.n_kv_heads, blk.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        p = blk.params() if params is None else params[blk.name]
        x = block_apply(blk, p, x, cache=(ck, cv), causal=True)
        caches.append((ck, cv))
    return x, caches


def _head_logits(head, x_last, params=None):
    """Vocabulary head projection of the last positions (…, D) →
    (…, V); ``params`` (``{layer name: params}``) overrides the head's
    own."""
    if params is None:
        return head(x_last)
    return lm_logits(params[head.name], x_last)


def prompt_logits(forwards, prompt, params=None) -> numpy.ndarray:
    """Last-position logits (V,) for ``prompt`` through the cached-decode
    prefill path — the float reference a decode is checked against.
    ``params`` (``{layer name: {param: tensor}}``) overrides the
    stack's own tree: a ``dequantize(quantize(...))`` twin measures the
    quantization error alone."""
    stack = split_stack(forwards)
    device = forwards.device
    stem, pos_emb = stack["stem"], stack["pos_emb"]
    with torch.inference_mode():
        ids = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                              device=device)[None]
        if params is None:
            x = _embed_prompt(stem, pos_emb, ids)
        else:
            x = embed(params[stem.name]["table"], ids)
            if pos_emb is not None:
                x = add_positions(params[pos_emb.name]["table"], x)
        x, _ = _prefill_blocks(stack["blocks"], x, ids.shape[-1], params)
        return _head_logits(stack["head"], x[0, -1],
                            params).cpu().numpy()


def _row_generators(seed, batch: int, device) -> List[torch.Generator]:
    """One ``torch.Generator`` per row: an int seeds every row
    identically (same request → same tokens whatever the batch), a
    sequence of B ints gives each row its own stream."""
    seeds = numpy.asarray(seed)
    if seeds.ndim == 0:
        seeds = numpy.broadcast_to(seeds, (batch,))
    elif seeds.shape != (batch,):
        raise VelesError("seed must be an int or a sequence of %d ints,"
                         " got shape %s" % (batch, seeds.shape))
    gens = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens.append(g)
    return gens


def _draw(logits_row, temperature: float, gen):
    """One row's sampled token, (V,) logits → (1,): a draw from the
    row's OWN generator at ``temperature`` — the one draw of every
    sampled row, solo, batched or in the engine's pool."""
    probs = torch.softmax(logits_row.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


#: per (device, vocabulary size): the Philox offset one :func:`_draw`
#: moves a CUDA generator by (measured once by a probe draw)
_DRAW_OFFSETS: Dict = {}


def _draw_offset(vocab: int, device) -> int:
    """The CUDA generator offset one :func:`_draw` over ``vocab`` logits
    consumes: ``torch.multinomial`` draws ``vocab`` exponentials, and
    the Philox offset moves by an amount that depends on that count and
    on the card alone, never on the probabilities."""
    key = (str(device), int(vocab))
    step = _DRAW_OFFSETS.get(key)
    if step is None:
        probe = torch.Generator(device=device)
        probe.manual_seed(0)
        start = probe.get_offset()
        _draw(torch.zeros(int(vocab), device=device), 1.0, probe)
        step = _DRAW_OFFSETS[key] = probe.get_offset() - start
    return step


def replay_draws(gen, steps: int, vocab: int) -> None:
    """Advance ``gen`` by ``steps`` draws of :func:`_draw` over
    ``vocab`` logits, one by one: the plain version of
    :func:`advanced_generator`."""
    zeros = torch.zeros(int(vocab), device=gen.device)
    for _ in range(int(steps)):
        _draw(zeros, 1.0, gen)


def advanced_generator(seed: int, steps: int, vocab: int,
                       device) -> torch.Generator:
    """A sampled row's generator after ``steps`` emitted tokens (the
    counterpart of the reference's ``advanced_prng_key``): seeded as
    :func:`_row_generators` seeds a row, then advanced by ``steps``
    draws of :func:`_draw` over ``vocab`` logits. A draw consumes the
    same part of the stream whatever the probabilities, so the state is
    a function of ``(seed, steps, vocab, device)``, and a resumed prefill
    that draws its first token from it continues the uninterrupted
    row's stream exactly. On the card the advance is offset arithmetic
    on the Philox counter, no launch however deep the resume; a CPU
    generator has no offset and replays the draws
    (:func:`replay_draws`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    steps = int(steps)
    if steps <= 0:
        return gen
    if device.type == "cuda":
        gen.set_offset(gen.get_offset()
                       + steps * _draw_offset(vocab, device))
    else:
        replay_draws(gen, steps, vocab)
    return gen


def _pick(logits, temperature: float, gens):
    """(B, V) logits → (B,) tokens: argmax (lowest index on ties) when
    greedy, else each row draws from its OWN generator, so a row's
    token depends only on its seed and its prompt, never on its
    batch-mates."""
    if gens is None:
        return torch.argmax(logits, dim=-1)
    return torch.cat([_draw(logits[r], temperature, g)
                      for r, g in enumerate(gens)])


def generate(forwards, prompt, n_new: int, temperature: float = 1.0,
             seed=0):
    """Sample ``n_new`` tokens continuing ``prompt`` from the stack.
    ``prompt`` is a list of ids (→ a flat token list) or a batch of B
    equal-length prompts (→ B lists, decoded together).
    ``temperature <= 0`` is greedy. ``seed`` is an int or a sequence of
    B ints (see :func:`_row_generators`)."""
    try:
        prompt = numpy.asarray(prompt, dtype=numpy.int64)
    except ValueError as e:
        raise VelesError(
            "batched generation needs EQUAL-length prompts (pad or "
            "group by length): %s" % e) from e
    batched = prompt.ndim == 2
    if not batched:
        prompt = prompt[None, :]
    n_new = int(n_new)
    bsz, t_p = prompt.shape
    stack = split_stack(forwards)
    stem, pos_emb = stack["stem"], stack["pos_emb"]
    blocks, head = stack["blocks"], stack["head"]
    t_max = t_p + n_new
    if pos_emb is not None and t_max > pos_emb.max_len:
        raise VelesError(
            "generation to %d positions exceeds the PositionalEmbedding "
            "table (%d rows); use RoPE blocks for open-ended generation"
            % (t_max, pos_emb.max_len))
    if n_new <= 0:
        # the reference's scan over arange(n_new) yields no token
        return [[] for _ in range(bsz)] if batched else []
    device = forwards.device
    gens = _row_generators(seed, bsz, device) if temperature > 0 else None
    with torch.inference_mode(), span("decode.cached", batch=bsz,
                                      n_new=n_new):
        ids = torch.as_tensor(prompt, device=device)
        x, caches = _prefill_blocks(blocks, _embed_prompt(
            stem, pos_emb, ids), t_max)
        inc("veles_decode_dispatches_total")
        tok = _pick(_head_logits(head, x[:, -1]), temperature, gens)
        out = [tok]
        for i in range(n_new - 1):
            pos = t_p + i
            x_t = _embed_prompt(stem, pos_emb, tok[:, None], pos)
            for blk, (ck, cv) in zip(blocks, caches):
                x_t = _block_step(blk, x_t, ck, cv, pos)
            tok = _pick(_head_logits(head, x_t[:, 0]), temperature, gens)
            out.append(tok)
            inc("veles_decode_dispatches_total")
        toks = torch.stack(out, dim=1).cpu().numpy()        # (B, n_new)
    inc("veles_decode_tokens_total", n_new * bsz)
    rows = [[int(t) for t in row] for row in toks]
    return rows if batched else rows[0]
