"""Loaders: the minibatch-serving contract and the full-batch loader."""

from .base import (CLASS_NAMES, TEST, TRAIN, VALID, Loader,  # noqa: F401
                   LoaderMSE)
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE  # noqa: F401
