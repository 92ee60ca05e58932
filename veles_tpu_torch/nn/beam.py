"""Beam-search decoding over the KV-cached sampler (counterpart of
``veles_tpu/nn/beam.py``).

W hypotheses advance in lockstep over a batched KV cache; each step
expands W×V continuations, keeps the top W by total log-probability
(float32 ``log_softmax``) and REORDERS the caches by surviving parent.

- Ties: the reference's ``lax.top_k`` puts the lower index first among
  equal values; ``torch.topk`` promises no order, so the top W come
  from a stable descending sort (:func:`_top`).
- ``eos_id``: a finished hypothesis is frozen. Its only continuation is
  ``eos_id`` at zero cost, so its score stays fixed while the others
  extend; the final ranking may divide by ``n_tokens ** alpha``
  (GNMT-style ``length_penalty``).

The first expansion and the step's top-k (:func:`_expand_first`,
:func:`_beam_topk`) are shared with the continuous-batching engine,
which runs beam groups over its paged pool (``serving/engine.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy
import torch

from ..error import VelesError
from .sampling import (_block_step, _embed_prompt, _head_logits,
                       _prefill_blocks, split_stack)


def _top(values, k: int):
    """(…, N) → the k largest (values, indices) along the last axis, the
    lower index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expand_first(logits, beam: int, eos: int):
    """The first expansion from the SINGLE prefix's (V,) logits: the
    top-``beam`` distinct tokens of the float32 log-softmax → (scores,
    tokens, finished), (beam,) each on the logits' device."""
    logp0 = torch.log_softmax(logits.float(), dim=-1)
    scores, toks = _top(logp0, beam)
    return scores, toks, toks == eos


def _beam_topk(logits, scores, finished, eos):
    """One step of G groups: logits (G, W, V) of each hypothesis's next
    position, scores (G, W) float32, finished (G, W), eos (G,) (-1 =
    none) → (tokens, parents, scores, finished), (G, W) each. A finished
    hypothesis continues only with its eos at zero cost; the top W of
    the flat W·V joint scores survive."""
    g, w, v = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    lanes = torch.arange(v, device=logits.device)
    frozen = torch.where(lanes[None, :] == eos[:, None],
                         torch.zeros((), device=logits.device),
                         torch.full((), -float("inf"),
                                    device=logits.device))   # (G, V)
    logp = torch.where(finished[:, :, None], frozen[:, None, :], logp)
    joint = scores[:, :, None] + logp                      # (G, W, V)
    flat, idx = _top(joint.reshape(g, w * v), w)
    parent = idx // v
    tok = idx % v
    fin = torch.gather(finished, 1, parent) | (tok == eos[:, None])
    return tok, parent, flat, fin


def _ranked(toks, scores, eos_id, length_penalty: float):
    """Hypotheses ranked as the reference ranks them: descending score
    (float64), divided by ``n_tokens ** length_penalty`` when asked."""
    scores = numpy.asarray(scores, dtype=numpy.float64)
    lengths = numpy.full(len(scores), toks.shape[1], dtype=numpy.float64)
    if eos_id is not None:
        for bi in range(len(scores)):
            hits = numpy.where(toks[bi] == int(eos_id))[0]
            if hits.size:
                lengths[bi] = hits[0] + 1
    ranked = (scores / lengths ** float(length_penalty)
              if length_penalty else scores)
    return numpy.argsort(-ranked)


def beam_generate(forwards, prompt, n_new, beam: int = 4,
                  eos_id: Optional[int] = None,
                  length_penalty: float = 0.0
                  ) -> Tuple[List[int], Dict[str, object]]:
    """Width-``beam`` search for the most probable ``n_new``-token
    continuation of ``prompt``. Returns ``(best_tokens, stats)``; stats
    carry every hypothesis (``beams``), its total log-probability
    (``scores``) and whether it emitted ``eos_id`` (``finished``), best
    first. ``beam=1`` is greedy decoding."""
    if int(beam) < 1:
        raise ValueError("beam must be >= 1")
    stack = split_stack(forwards)
    vocab = int(stack["head"].vocab_size)
    if int(beam) > vocab:
        raise ValueError("beam=%d exceeds the head's vocab size %d"
                         % (int(beam), vocab))
    if int(n_new) < 1:
        raise ValueError("n_new must be >= 1")
    prompt = numpy.asarray(prompt, dtype=numpy.int64)
    if prompt.ndim != 1:
        raise VelesError("beam search decodes a single prompt")
    beam, n_new, t_p = int(beam), int(n_new), len(prompt)
    # the last step embeds at position t_p + n_new - 2: rows past
    # t_p + n_new - 1 would be dead weight tiled across the beam
    t_max = max(t_p + n_new - 1, t_p)
    pe = stack["pos_emb"]
    if pe is not None and pe.max_len < t_max:
        raise VelesError(
            "beam search to %d positions exceeds the trained "
            "PositionalEmbedding table (%d rows)" % (t_max, pe.max_len))
    eos = -1 if eos_id is None else int(eos_id)
    device = forwards.device
    with torch.inference_mode():
        ids = torch.as_tensor(prompt[None, :], device=device)
        x, caches = _prefill_blocks(stack["blocks"], _embed_prompt(
            stack["stem"], stack["pos_emb"], ids), t_max)
        scores, cur, finished = _expand_first(
            _head_logits(stack["head"], x[0, -1]), beam, eos)
        # prefill once, then tile the caches across the beam
        caches = [(ck.expand(beam, -1, -1, -1).clone(),
                   cv.expand(beam, -1, -1, -1).clone())
                  for ck, cv in caches]
        toks = torch.zeros((beam, n_new), dtype=torch.int64,
                           device=device)
        toks[:, 0] = cur
        eosv = torch.full((1,), eos, device=device)
        for i in range(n_new - 1):
            pos = t_p + i
            x_t = _embed_prompt(stack["stem"], stack["pos_emb"],
                                cur[:, None], pos)
            for blk, (ck, cv) in zip(stack["blocks"], caches):
                x_t = _block_step(blk, x_t, ck, cv, pos)
            tok, parent, scores, finished = _beam_topk(
                _head_logits(stack["head"], x_t[:, 0])[None],
                scores[None], finished[None], eosv)
            tok, parent = tok[0], parent[0]
            scores, finished = scores[0], finished[0]
            toks = toks[parent]
            toks[:, i + 1] = tok
            cur = tok
            # gather, then keep: a cycle of parents never reads a row
            # it already overwrote
            caches = [(ck[parent], cv[parent]) for ck, cv in caches]
        toks = toks.cpu().numpy()
        scores = scores.cpu().numpy()
        finished = finished.cpu().numpy()
    order = _ranked(toks, scores, eos_id, length_penalty)
    best = int(order[0])
    return ([int(t) for t in toks[best]],
            {"beams": [[int(t) for t in toks[i]] for i in order],
             "scores": [float(scores[i]) for i in order],
             "finished": [bool(finished[i]) for i in order]})
