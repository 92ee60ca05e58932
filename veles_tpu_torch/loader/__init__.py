"""Loaders: the minibatch-serving contract, the full-batch loader, the
text, file and image loaders, and the streaming loaders that the classic
REST serving unit feeds (counterpart of ``veles_tpu/loader``).

:func:`loader_class` resolves a loader by its registry name
(``MAPPING``) or class name.
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
from .image import (IMAGE_PATTERNS, ClassImageLoader,       # noqa: F401
                    FileListImageLoader, ImageLoader, ImageLoaderMSE,
                    augment, decode_image, deterministic_split)
from .stream import (InteractiveImageLoader,                # noqa: F401
                     InteractiveLoader, LoaderClosed, RestfulImageLoader,
                     RestfulLoader, StreamLoader, ZeroMQLoader)


def loader_class(name: str) -> type:
    """The loader class registered as ``name`` (its ``MAPPING``) or
    named ``name``."""
    for key, cls in UnitRegistry.mapping.items():
        if issubclass(cls, Loader) and name in (key, cls.__name__):
            return cls
    raise VelesError("no loader %r (have: %s)" % (name, sorted(
        k for k, c in UnitRegistry.mapping.items() if issubclass(c, Loader))))
