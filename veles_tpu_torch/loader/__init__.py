"""Loaders: the minibatch-serving contract, the full-batch loader, the
text loader and the file loaders (counterpart of ``veles_tpu/loader``).

:func:`loader_class` resolves a loader by its registry name
(``MAPPING``) or class name. The streaming loaders of
``veles_tpu/loader/stream.py`` (fed at run time by the classic REST
serving unit or ZeroMQ) are not ported yet: asking for one, by name or
as an attribute of this package, raises a VelesError naming its ROADMAP
item (12).
"""

from ..error import VelesError
from ..units import UnitRegistry
from .base import (CLASS_NAMES, TEST, TRAIN, VALID, Loader,  # noqa: F401
                   LoaderMSE)
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE  # noqa: F401
from .file_loader import FileFilter, FileListScanner, auto_label  # noqa
from .pickles import PicklesLoader                          # noqa: F401
from .hdf5 import HDF5Loader                                # noqa: F401
from .saver import MinibatchesSaver, MinibatchesLoader      # noqa: F401
from .ensemble import EnsembleLoader                        # noqa: F401
from .sound import SoundFileLoader, decode_audio            # noqa: F401
from .kv_store import LMDBLoader, HDFSTextLoader            # noqa: F401
from .text import TextFileLoader                            # noqa: F401

#: the streaming loaders of loader/stream.py, by class and registry name
STREAM_LOADERS = frozenset((
    "StreamLoader", "InteractiveLoader", "RestfulLoader", "ZeroMQLoader",
    "InteractiveImageLoader", "RestfulImageLoader", "LoaderClosed",
    "interactive_loader", "restful_loader", "zeromq_loader",
    "interactive_image_loader", "restful_image_loader"))


def _refuse_stream(name: str) -> None:
    if name in STREAM_LOADERS:
        raise VelesError(
            "loader %r is not ported yet (ROADMAP Queue 1 item 12: classic "
            "REST serving of a trained classifier (RESTfulAPI with "
            "loader/stream.py))" % name)


def loader_class(name: str) -> type:
    """The loader class registered as ``name`` (its ``MAPPING``) or
    named ``name``; a streaming loader raises a VelesError naming its
    ROADMAP item."""
    _refuse_stream(name)
    for key, cls in UnitRegistry.mapping.items():
        if issubclass(cls, Loader) and name in (key, cls.__name__):
            return cls
    raise VelesError("no loader %r (have: %s)" % (name, sorted(
        k for k, c in UnitRegistry.mapping.items() if issubclass(c, Loader))))


def __getattr__(name: str):
    _refuse_stream(name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
