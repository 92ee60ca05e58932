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
from .transformer import (Embedding, LMHead, PositionalEmbedding,
                          TransformerBlock, _rotate, block_apply, block_ffn,
                          block_norm, block_qkv, rope_angles)


def _rope_at(x, pos: int, base=10000.0):
    """RoPE for a SINGLE position: x (B, 1, H, Dh). The angles are
    those of row ``pos`` of :func:`transformer._rope`, bit for bit."""
    return _rotate(x, rope_angles([pos], x.shape[-1], base))


def _rope_rows(x, positions, base=10000.0):
    """RoPE of x (S, 1, H, Dh), row ``s`` at its own position
    ``positions[s]``: the angles of :func:`_rope_at` at that position,
    bit for bit."""
    ang = rope_angles(positions, x.shape[-1], base)
    return _rotate(x.transpose(0, 1), ang).transpose(0, 1)


def split_stack(forwards) -> Dict[str, object]:
    """Stem / block-list / head decomposition of a generation-capable
    stack; raises for anything else."""
    stem = pos_emb = head = None
    blocks: List[TransformerBlock] = []
    for f in forwards:
        if isinstance(f, Embedding):
            stem = f
        elif isinstance(f, PositionalEmbedding):
            pos_emb = f
        elif isinstance(f, TransformerBlock):
            blocks.append(f)
        elif isinstance(f, LMHead):
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
    """The one-token attention over a cache and the rest of the block:
    q (B, 1, H, Dh) already rotated, caches (B, T, KV, Dh), ``valid``
    broadcastable to the (B, KV, G, 1, T) scores. Scores and softmax in
    f32; GQA reads the unrepeated cache through a (kv, group) view of
    the query heads."""
    b = x_t.shape[0]
    h, kv = block.n_heads, block.n_kv_heads
    g, hd = h // kv, block.head_dim
    q5 = q.reshape(b, 1, kv, g, hd).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", q5,
                     cache_k.float()) / math.sqrt(hd)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", w,
                     cache_v.float()).to(x_t.dtype).reshape(b, 1, h * hd)
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


def _block_step_rows(block, x_t, pool_k, pool_v, tables, positions,
                     targets):
    """One-token pass of S rows that sit at different positions, over a
    paged cache: x_t (S, 1, D); pools (pages + 1, page_size, KV, Dh);
    ``tables`` (S, P) page ids on the pools' device; ``positions`` the
    S host-side positions; ``targets`` = (page ids, in-page offsets),
    (S,) each, where each row's new K/V row is written (in place; a
    masked row's target is the sink page 0). Each row then reads its
    view through its page-table row, with its own causal and window
    mask: :func:`_block_step`'s arithmetic row by row."""
    p = block.params()
    q, k, v = block_qkv(block, p, block_norm(block, p, x_t, "ln1"))
    if block.rope:
        q = _rope_rows(q, positions, block.rope_base)
        k = _rope_rows(k, positions, block.rope_base)
    page, off = targets
    pool_k[page, off] = k[:, 0]
    pool_v[page, off] = v[:, 0]
    cache_k = pool_k[tables].flatten(1, 2)        # (S, P*page_size, ...)
    cache_v = pool_v[tables].flatten(1, 2)
    rows = torch.arange(cache_k.shape[1], device=x_t.device)
    pos = torch.as_tensor(numpy.asarray(positions, numpy.int64),
                          device=x_t.device)[:, None]
    valid = _visible(rows[None, :], pos, block.window)
    return _attend(block, p, x_t, q, cache_k, cache_v,
                   valid[:, None, None, None, :])


def params_of(layers) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer name: {param: tensor}}`` of ``layers``: the tree the
    recurrent lane's step bodies index by the reference's names."""
    return {layer.name: layer.params() for layer in layers}


def _embed_ids(stem, ids):
    """Embedding-table gather for int token ids of any shape; ids clamp
    to the table (the reference's ``mode="clip"``)."""
    return stem(ids)


def _embed_prompt(stem, pos_emb, ids, pos0: int = 0):
    """(B, T) token ids → (B, T, D): the embedding gather plus the
    positional rows ``pos0..pos0+T`` — the stack entry every prompt
    consumer shares."""
    x = _embed_ids(stem, ids)
    if pos_emb is not None:
        idx = (pos0 + torch.arange(ids.shape[-1], device=ids.device)
               ).clamp(0, pos_emb.max_len - 1)
        x = x + pos_emb.table[idx][None]
    return x


def _embed_rows(stem, pos_emb, tok, positions):
    """(S,) token ids at per-row ``positions`` → (S, 1, D): the row-wise
    counterpart of :func:`_embed_prompt` (positions clamp to the
    table)."""
    x = _embed_ids(stem, tok[:, None])
    if pos_emb is not None:
        idx = torch.as_tensor(numpy.asarray(positions, numpy.int64),
                              device=tok.device).clamp(
                                  0, pos_emb.max_len - 1)
        x = x + pos_emb.table[idx][:, None]
    return x


def _prefill_blocks(blocks, x, cache_len: int):
    """Every block's full-window pass over fresh zero K/V caches of
    ``cache_len`` rows, writing each block's K/V into its cache's first
    T rows → (x, [(ck, cv), ...]). The pass is the block's own
    composition (``transformer.block_apply``), causal, so prefill logits
    cannot drift from the full forward. Each block shapes its own cache
    (heads may differ per block; GQA caches hold n_kv_heads)."""
    b = x.shape[0]
    caches = []
    for blk in blocks:
        shape = (b, cache_len, blk.n_kv_heads, blk.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        x = block_apply(blk, blk.params(), x, cache=(ck, cv), causal=True)
        caches.append((ck, cv))
    return x, caches


def _head_logits(head, x_last):
    """Vocabulary head projection of the last positions (…, D) →
    (…, V)."""
    return head(x_last)


def prompt_logits(forwards, prompt) -> numpy.ndarray:
    """Last-position logits (V,) for ``prompt`` through the cached-decode
    prefill path — the float reference a decode is checked against."""
    stack = split_stack(forwards)
    device = forwards.device
    with torch.inference_mode():
        ids = torch.as_tensor(numpy.asarray(prompt, numpy.int64),
                              device=device)[None]
        x = _embed_prompt(stack["stem"], stack["pos_emb"], ids)
        x, _ = _prefill_blocks(stack["blocks"], x, ids.shape[-1])
        return _head_logits(stack["head"], x[0, -1]).cpu().numpy()


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
    with torch.inference_mode():
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
