"""Character-level text loader for language models (counterpart of
``veles_tpu/loader/text.py``).

``TextFileLoader`` reads plain text files, builds (or takes) a character
vocabulary with a reserved unknown id one past it, and serves fixed
windows of token ids with their shifted next-token targets, the contract
that ``loss_function="softmax_seq"`` with ``Embedding``/``LMHead``
consumes. Windows do not overlap by default (``stride = seq_len``); a
smaller stride oversamples. The validation windows are the corpus's
tail, so train and validation share no text: with overlapping windows
the validation windows that straddle the boundary are dropped.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy

from ..error import VelesError
from .fullbatch import FullBatchLoaderMSE


class TextFileLoader(FullBatchLoaderMSE):
    """``files``: text file paths (concatenated in order). ``vocab``:
    an explicit string of characters (index = id); by default every
    distinct character of the corpus, sorted. Characters outside the
    vocabulary map to the reserved unk id (``len(vocab)``, counted in
    ``vocab_size``); ``decode`` renders it as ``UNK_CHAR``."""

    MAPPING = "text_loader"

    #: what decode() renders for the reserved unknown id
    UNK_CHAR = "�"

    def __init__(self, workflow, files: Sequence[str] = (),
                 seq_len: int = 128, stride: Optional[int] = None,
                 vocab: Optional[str] = None,
                 validation_ratio: float = 0.1, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if not files:
            raise VelesError("TextFileLoader needs at least one file")
        self.files = list(files)
        self.seq_len = int(seq_len)
        self.stride = int(stride) if stride else self.seq_len
        self.vocab: Optional[str] = vocab
        self.char_to_id: Dict[str, int] = {}
        self.text_validation_ratio = float(validation_ratio)

    # -- vocabulary ----------------------------------------------------------
    @property
    def unk_id(self) -> int:
        """The id of out-of-vocabulary characters: one past the
        vocabulary, never a real character's id."""
        return len(self.vocab or "")

    def encode(self, text: str) -> numpy.ndarray:
        table, unk = self.char_to_id, self.unk_id
        return numpy.fromiter((table.get(c, unk) for c in text),
                              dtype=numpy.int32, count=len(text))

    def decode(self, ids) -> str:
        if not self.vocab:
            raise VelesError("decode before load_data: no vocabulary yet")
        return "".join(self.vocab[i] if 0 <= i < len(self.vocab)
                       else self.UNK_CHAR
                       for i in numpy.asarray(ids).ravel())

    @property
    def vocab_size(self) -> int:
        """len(vocab) + 1: the unk slot is part of the id space, so a
        table sized from here takes every id encode() gives."""
        return len(self.vocab or "") + 1

    # -- loader contract -----------------------------------------------------
    def load_data(self) -> None:
        corpus_parts: List[str] = []
        for path in self.files:
            if not os.path.exists(path):
                raise VelesError("text file missing: %s" % path)
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                corpus_parts.append(f.read())
        corpus = "".join(corpus_parts)
        if len(corpus) < self.seq_len + 1:
            raise VelesError(
                "corpus of %d chars cannot fill one %d-char window"
                % (len(corpus), self.seq_len))
        if self.vocab is None:
            self.vocab = "".join(sorted(set(corpus)))
        self.char_to_id = {c: i for i, c in enumerate(self.vocab)}
        ids = self.encode(corpus)
        n_oov = int((ids == self.unk_id).sum())
        if n_oov:
            # only possible with a user-restricted vocab; loud because
            # every such position trains the model on the unk token
            self.warning(
                "%d of %d corpus characters are outside the supplied "
                "%d-char vocabulary; they map to the reserved unk id "
                "%d (decoded as %r)", n_oov, len(ids),
                len(self.vocab), self.unk_id, self.UNK_CHAR)

        # a window at s consumes ids[s : s+seq_len+1] (input + shifted
        # target), so the last valid start is len - seq_len - 1 —
        # arange's stop is exclusive, hence - seq_len
        starts = numpy.arange(0, len(ids) - self.seq_len, self.stride)
        n = len(starts)
        n_valid = int(round(n * self.text_validation_ratio))
        n_train = n - n_valid
        if n_valid and self.stride < self.seq_len + 1:
            # overlapping windows share text across the split boundary
            # (a window at s covers ids[s : s+seq_len+1] including the
            # shifted target): drop the straddling VALID-side windows
            # until first_valid_start >= last_train_end, so
            # 'train/valid never share text' stays true in
            # oversampling mode
            gap = max(0, -(-(self.seq_len + 1 - self.stride)
                           // self.stride))
            gap = min(gap, n_valid)
            keep = numpy.ones(n, dtype=bool)
            keep[n_train:n_train + gap] = False
            starts = starts[keep]
            n = len(starts)
            n_valid = n - n_train
        if n_train <= 0:
            raise VelesError("validation_ratio %.2f leaves no training "
                             "windows (%d total)"
                             % (self.text_validation_ratio, n))
        x = numpy.stack([ids[s:s + self.seq_len] for s in starts])
        y = numpy.stack([ids[s + 1:s + self.seq_len + 1]
                         for s in starts])
        # validation = the corpus TAIL: no shared text with train
        order = numpy.concatenate([numpy.arange(n_train, n),
                                   numpy.arange(n_train)])
        self.create_originals(x[order], None, targets=y[order])
        self.class_lengths = [0, n_valid, n_train]
        self.info("%s: %d chars, vocab %d, %d windows of %d "
                  "(%d train / %d valid)", self.name, len(corpus),
                  self.vocab_size, n, self.seq_len, n_train, n_valid)
