"""Loaders: the minibatch-serving contract and the full-batch loader."""

from .base import CLASS_NAMES, TEST, TRAIN, VALID, Loader  # noqa: F401
from .fullbatch import FullBatchLoader  # noqa: F401
