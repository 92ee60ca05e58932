"""Speculative decoding: draft-model lookahead, target-model verify
(counterpart of ``veles_tpu/nn/speculative.py``).

A small DRAFT stack proposes ``gamma`` tokens one position at a time;
the TARGET stack then scores all of them in ONE multi-position cached
pass (:func:`_block_span`), so the big model runs one pass per round of
up to ``gamma`` tokens instead of one per token.

- Greedy (``temperature <= 0``) is exact: the longest prefix of draft
  tokens that equals the target's argmax is kept and the first mismatch
  emits the target's argmax instead, so the tokens are the target's own
  greedy decode.
- Sampled (``temperature > 0``) is the rejection rule of Leviathan et
  al. (:func:`_stochastic_accept`): every emitted token is distributed
  as the target's softmax at that temperature whatever the draft. Each
  row draws from its own ``torch.Generator`` (seeded as
  ``nn/sampling.generate`` seeds a row), in a fixed order: the first
  token, then each round's ``gamma`` draft draws, ``gamma`` uniforms and
  one residual draw. So a row's tokens depend only on its seed, solo,
  batched or in the engine's pool; they cannot equal the reference's
  threefry draws.

Cache discipline: rejected positions leave stale K/V rows behind; every
read masks strictly by position and every write overwrites from the
accepted head, so a stale row is never read. A round that accepts all
``gamma`` draft tokens emits exactly those ``gamma`` (no bonus token):
the bonus's K/V would be missing from the draft's cache.

The round's helpers are shared with the continuous-batching engine
(``serving/engine.py``), which runs the same arithmetic over its paged
pools (:func:`_block_span_rows`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy
import torch

from ..error import VelesError
from ..telemetry.counters import inc
from ..telemetry.spans import span
from .sampling import (_attend, _embed_ids, _embed_prompt, _embed_rows,
                       _head_logits, _pick, _prefill_blocks,
                       _row_generators, _visible, split_stack)
from .transformer import _rotate, block_norm, block_qkv, rope_angles


def _span_positions(pos0, rows: int, g: int) -> numpy.ndarray:
    """(rows, g) positions ``pos0[r] + j``; an int ``pos0`` is every
    row's."""
    p0 = numpy.broadcast_to(numpy.asarray(pos0, numpy.int64), (rows,))
    return p0[:, None] + numpy.arange(g, dtype=numpy.int64)[None, :]


def _rope_span(x, pos0, base=10000.0):
    """RoPE for consecutive positions: x (B, g, H, Dh), row b at
    ``pos0[b]..pos0[b]+g-1`` (an int ``pos0`` for every row). Built on
    ``rope_angles``, so row j's angles are those of
    ``sampling._rope_at(x, pos0 + j)``, bit for bit."""
    b, g = x.shape[:2]
    pos = _span_positions(pos0, b, g).reshape(-1)
    ang = rope_angles(pos, x.shape[-1], base)
    return _rotate(x.reshape((1, b * g) + tuple(x.shape[2:])),
                   ang).reshape(x.shape)


def _embed_span(stem, pos_emb, ids, pos0):
    """(B, g) token ids at per-row positions ``pos0[b] + j`` → (B, g, D);
    positions clamp to the table."""
    x = _embed_ids(stem, ids)
    if pos_emb is not None:
        idx = torch.as_tensor(_span_positions(pos0, *ids.shape),
                              device=ids.device).clamp(
                                  0, pos_emb.max_len - 1)
        x = x + pos_emb.table[idx]
    return x


def _span_rest(block, p, x, q, cache_k, cache_v, pos):
    """The attention of the g new positions of each row over its cache
    view, causal by GLOBAL position (row b's query j sees cache rows
    <= pos[b, j], and > pos[b, j] - window), then the rest of the
    block."""
    rows = torch.arange(cache_k.shape[1], device=x.device)
    valid = _visible(rows[None, None, :], pos[:, :, None], block.window)
    return _attend(block, p, x, q, cache_k, cache_v,
                   valid[:, None, None])


def _block_span(block, x, cache_k, cache_v, pos0):
    """Multi-position incremental pass over dense caches: x (B, g, D)
    are the tokens at positions ``pos0[b]..pos0[b]+g-1``; their K/V land
    in those cache rows (in place) and the attention reads each row's
    cache causally by global position — the g-wide generalisation of
    ``sampling._block_step`` (g = 1 is its arithmetic at per-row
    positions). Write positions clamp to the cache: a finished row of a
    batch rides along with its answer already taken."""
    p = block.params()
    b, g = x.shape[:2]
    q, k, v = block_qkv(block, p, block_norm(block, p, x, "ln1"))
    if block.rope:
        q = _rope_span(q, pos0, block.rope_base)
        k = _rope_span(k, pos0, block.rope_base)
    pos = torch.as_tensor(_span_positions(pos0, b, g),
                          device=x.device).clamp(max=cache_k.shape[1] - 1)
    rows = torch.arange(b, device=x.device)[:, None]
    cache_k[rows, pos] = k
    cache_v[rows, pos] = v
    return _span_rest(block, p, x, q, cache_k, cache_v, pos)


def _block_span_rows(block, x, pool_k, pool_v, tables, pos0, targets,
                     p=None):
    """:func:`_block_span` over the engine's paged pools: x (S, g, D);
    pools (pages + 1, page_size, KV, Dh); ``tables`` (S, P) page ids;
    ``targets`` = (page ids, in-page offsets), (S, g) each, where each
    new K/V row is written (a masked row's targets are the sink page
    0). Each row then reads its view through its page-table row. ``p``
    overrides the block's parameters (the int8 engine's view)."""
    p = block.params() if p is None else p
    s, g = x.shape[:2]
    q, k, v = block_qkv(block, p, block_norm(block, p, x, "ln1"))
    if block.rope:
        q = _rope_span(q, pos0, block.rope_base)
        k = _rope_span(k, pos0, block.rope_base)
    page, off = targets
    pool_k[page, off] = k
    pool_v[page, off] = v
    cache_k = pool_k[tables].flatten(1, 2)        # (S, P*page_size, ...)
    cache_v = pool_v[tables].flatten(1, 2)
    pos = torch.as_tensor(_span_positions(pos0, s, g), device=x.device)
    return _span_rest(block, p, x, q, cache_k, cache_v, pos)


def _draft_pick(logits, taus, gens) -> Tuple[torch.Tensor, Dict]:
    """A draft step's tokens, (S, V) logits → (S,): argmax for a row
    without a generator, else a draw from softmax(logits / tau) with
    the row's own generator (``sampling._draw``'s arithmetic). Returns
    the tokens and ``{row: its (V,) draft probabilities}`` for the
    sampled rows (the accept rule's ``p_d``)."""
    nxt = torch.argmax(logits, dim=-1)
    probs = {}
    for r, gen in enumerate(gens):
        if gen is None:
            continue
        probs[r] = torch.softmax(logits[r].float() / taus[r], dim=-1)
        nxt[r] = torch.multinomial(probs[r], 1, generator=gen)[0]
    return nxt, probs


def _stochastic_accept(gen, pt, pd, d_toks) -> Tuple[int, int]:
    """The rejection-sampling accept rule (Leviathan et al.): draft
    token j is kept with probability ``min(1, p_t/p_d)`` at that token;
    the first rejected position resamples from the residual
    ``normalize(max(p_t - p_d, 0))``. ``pt`` and ``pd`` (g, V) are the
    target's and the draft's probabilities, ``d_toks`` (g,) the draft
    tokens; the draws come from ``gen``: g uniforms, then one residual
    draw (always, so a row's stream advances the same each round).
    Returns ``(a, fix)``: the accepted prefix length and the token for
    position ``a``. The marginal of the next emitted token is exactly
    p_t."""
    g = d_toks.shape[0]
    ar = torch.arange(g, device=pt.device)
    u = torch.rand(g, generator=gen, device=pt.device)
    # u < p_t/p_d, written multiplicatively: robust when p_d == 0
    acc = (u * pd[ar, d_toks] < pt[ar, d_toks]).cpu().numpy()
    a = g if acc.all() else int(numpy.argmin(acc))
    row = min(a, g - 1)
    resid = torch.clamp(pt[row] - pd[row], min=0.0)
    # p_t == p_d leaves an empty residual, but then the test never fails
    # at that row; the fallback keeps the (measure-zero) branch defined
    if not float(resid.sum()) > 0:
        resid = pt[row]
    fix = int(torch.multinomial(resid, 1, generator=gen)[0])
    return a, fix


def _greedy_accept(t_arg, d_row) -> Tuple[int, int]:
    """The greedy accept rule on host ints: the length ``a`` of the
    longest prefix of ``d_row`` equal to the target's argmax ``t_arg``
    and the target's token at position ``a`` (at ``gamma - 1`` when all
    are kept)."""
    gamma = len(d_row)
    a = 0
    while a < gamma and d_row[a] == t_arg[a]:
        a += 1
    return a, int(t_arg[min(a, gamma - 1)])


def _emission(a: int, fix: int, d_row) -> Tuple[List[int], int]:
    """A round's emitted tokens (the a accepted draft tokens, then the
    fix unless all ``gamma`` were accepted: no bonus token) and the next
    round's seed token."""
    gamma = len(d_row)
    if a < gamma:
        return [int(t) for t in d_row[:a]] + [int(fix)], int(fix)
    return [int(t) for t in d_row], int(d_row[-1])


def _accept_rows(t_logits, d_toks, rows, taus, gens, pd):
    """Accept rule of each row in ``rows``: t_logits (S, g, V) the
    target's logits over the window, d_toks (S, g). A row with a
    generator takes :func:`_stochastic_accept` on softmax(t_logits /
    tau) and its draft probabilities ``pd[row]`` (g, V); the others the
    greedy rule. Returns ``{row: (a, fix)}``."""
    greedy = [r for r in rows if gens[r] is None]
    out = {}
    if greedy:
        t_arg = torch.argmax(t_logits, dim=-1).cpu().numpy()
        d_host = d_toks.cpu().numpy()
        for r in greedy:
            out[r] = _greedy_accept(t_arg[r], d_host[r])
    for r in rows:
        if gens[r] is not None:
            pt = torch.softmax(t_logits[r].float() / taus[r], dim=-1)
            out[r] = _stochastic_accept(gens[r], pt, pd[r], d_toks[r])
    return out


def _spec_stacks(target, draft, t_max: int):
    """Both stacks, split, with their positional tables checked against
    the ``t_max`` positions speculation can reach."""
    tgt, drf = split_stack(target), split_stack(draft)
    for st, which in ((tgt, "target"), (drf, "draft")):
        pe = st["pos_emb"]
        if pe is not None and pe.max_len < t_max:
            raise VelesError(
                "%s PositionalEmbedding table (%d) is shorter than the "
                "%d positions speculation can reach"
                % (which, pe.max_len, t_max))
    return tgt, drf


def generate_speculative(target, draft, prompt, n_new, gamma: int = 4,
                         temperature: float = 0.0, seed=0):
    """Decode ``n_new`` tokens of the ``target`` stack with ``draft``
    speculation. Returns ``(tokens, stats)``; stats carry ``rounds`` and
    ``acceptance``, the mean share of the ``gamma`` draft tokens a round
    kept.

    ``temperature <= 0``: greedy, the tokens of
    ``sampling.generate(target, prompt, n_new, temperature=0)``.
    ``temperature > 0``: rejection-sampling speculation; ``seed`` seeds
    each row's generator as ``sampling.generate`` does.

    ``prompt`` is a flat id list (→ a flat token list) or a batch of B
    EQUAL-length prompts (→ B lists, decoded together, each row
    advancing by its own accepted lengths; per-row ``rounds`` and
    ``acceptance`` lists and their means). Both stacks live on one
    device."""
    if int(gamma) < 1:
        raise ValueError("gamma must be >= 1")
    try:
        prompt = numpy.asarray(prompt, dtype=numpy.int64)
    except ValueError as e:
        raise VelesError(
            "batched speculation needs EQUAL-length prompts (pad or "
            "group by length): %s" % e) from e
    if prompt.ndim not in (1, 2):
        raise VelesError("prompt must be a flat id list or a (B, T_p) "
                         "batch")
    batched = prompt.ndim == 2
    if not batched:
        prompt = prompt[None, :]
    gamma, n_new = int(gamma), int(n_new)
    bsz, t_p = prompt.shape
    tgt, drf = _spec_stacks(target, draft, t_p + n_new + gamma + 1)
    device = target.device
    if draft.device != device:
        raise VelesError("the draft lives on %s, the target on %s"
                         % (draft.device, device))
    greedy = temperature <= 0
    tau = 1.0 if greedy else float(temperature)
    gens = (_row_generators(seed, bsz, device) if not greedy
            else [None] * bsz)
    out: List[List[int]] = [[] for _ in range(bsz)]
    rounds = numpy.zeros(bsz, numpy.int64)
    acc = numpy.zeros(bsz, numpy.int64)
    if n_new > 0:
        with torch.inference_mode(), span("decode.speculative",
                                          batch=bsz, n_new=n_new,
                                          gamma=gamma):
            _speculate(tgt, drf, prompt, n_new, gamma, tau, gens, device,
                       out, rounds, acc)
        inc("veles_decode_tokens_total", n_new * bsz)
    rounds = numpy.maximum(rounds, 1)
    per_row = (acc / (rounds * gamma)).tolist()
    if not batched:
        return out[0], {"rounds": int(rounds[0]),
                        "acceptance": float(per_row[0])}
    return out, {"rounds": [int(r) for r in rounds],
                 "acceptance": [float(a) for a in per_row],
                 "mean_rounds": float(numpy.mean(rounds)),
                 "mean_acceptance": float(numpy.mean(per_row))}


def _speculate(tgt, drf, prompt, n_new, gamma, tau, gens, device, out,
               rounds, acc) -> None:
    """The decode of :func:`generate_speculative` into ``out``,
    ``rounds`` and ``acc`` (per row)."""
    bsz, t_p = prompt.shape
    t_max = t_p + n_new + gamma + 1
    ids = torch.as_tensor(prompt, device=device)
    x, caches_t = _prefill_blocks(tgt["blocks"], _embed_prompt(
        tgt["stem"], tgt["pos_emb"], ids), t_max)
    _, caches_d = _prefill_blocks(drf["blocks"], _embed_prompt(
        drf["stem"], drf["pos_emb"], ids), t_max)
    inc("veles_decode_dispatches_total")
    sampled = gens[0] is not None
    first = _pick(_head_logits(tgt["head"], x[:, -1]),
                  tau if sampled else 0.0, gens if sampled else None)
    tok = first.cpu().numpy()
    for b in range(bsz):
        out[b].append(int(tok[b]))
    pos = numpy.full(bsz, t_p, numpy.int64)
    taus = [tau] * bsz
    while True:
        live = [b for b in range(bsz) if len(out[b]) < n_new]
        if not live:
            return
        row_gens = [gens[b] if b in live else None for b in range(bsz)]
        # -- the draft proposes gamma tokens, one position at a time ----
        cur = torch.as_tensor(tok, device=device)
        d_cols, pd_rows = [], {b: [] for b in live}
        for j in range(gamma):
            xd = _embed_rows(drf["stem"], drf["pos_emb"], cur, pos + j)
            for blk, (ck, cv) in zip(drf["blocks"], caches_d):
                xd = _block_span(blk, xd, ck, cv, pos + j)
            cur, probs = _draft_pick(_head_logits(drf["head"], xd[:, 0]),
                                     taus, row_gens)
            d_cols.append(cur)
            for b, pr in probs.items():
                pd_rows[b].append(pr)
        d_toks = torch.stack(d_cols, dim=1)                 # (B, gamma)
        pd = {b: torch.stack(v) for b, v in pd_rows.items() if v}
        # -- the target verifies the whole window in one pass -----------
        window = torch.cat([torch.as_tensor(tok, device=device)[:, None],
                            d_toks[:, :-1]], dim=1)
        xt = _embed_span(tgt["stem"], tgt["pos_emb"], window, pos)
        for blk, (ck, cv) in zip(tgt["blocks"], caches_t):
            xt = _block_span(blk, xt, ck, cv, pos)
        t_logits = _head_logits(tgt["head"], xt)         # (B, gamma, V)
        inc("veles_decode_dispatches_total")
        verdicts = _accept_rows(t_logits, d_toks, live, taus, row_gens,
                                pd)
        d_host = d_toks.cpu().numpy()
        for b in live:
            a, fix = verdicts[b]
            emitted, tok[b] = _emission(a, fix, d_host[b])
            out[b].extend(emitted)
            del out[b][n_new:]
            pos[b] += len(emitted)
            rounds[b] += 1
            acc[b] += a

