"""Key-value-store loaders: LMDB and HDFS text (counterpart of
``veles_tpu/loader/kv_store.py``).

LMDB records use a data-only format, ``value = <i32 label little-endian>
<.npy sample bytes>``, decoded with ``numpy.load(allow_pickle=False)``,
so reading a database never executes code; the older ``value =
pickle((sample, label))`` is readable with ``pickle_records=True``, an
explicit trust statement (unpickling an untrusted database executes
arbitrary code). ``LMDBLoader`` needs the ``lmdb`` package and raises a
VelesError naming it where it is missing.

HDFS text comes over WebHDFS (stdlib HTTP), one sample per line, parsed
by a ``line_parser``.
"""

from __future__ import annotations

import io
import struct
import urllib.parse
import urllib.request
from typing import Callable, List, Optional, Sequence, Tuple

import numpy

from ..error import VelesError
from .fullbatch import FullBatchLoader


def encode_record(sample: numpy.ndarray, label: int) -> bytes:
    """(sample, label) → the data-only LMDB record format."""
    buf = io.BytesIO()
    numpy.save(buf, numpy.asarray(sample))
    return struct.pack("<i", int(label)) + buf.getvalue()


def decode_record(value: bytes) -> Tuple[numpy.ndarray, int]:
    """Inverse of :func:`encode_record`; never unpickles."""
    (label,) = struct.unpack_from("<i", value)
    sample = numpy.load(io.BytesIO(value[4:]), allow_pickle=False)
    return sample, label


def _load_splits(loader: FullBatchLoader, paths, read_fn) -> None:
    """Shared (test, validation, train) aggregation: read each configured
    split with ``read_fn(path) -> (data, labels)`` and install the
    concatenated dataset on ``loader``."""
    datas, lbls, lengths = [], [], []
    for path in paths:
        if not path:
            lengths.append(0)
            continue
        d, l = read_fn(path)
        datas.append(d)
        lbls.append(l)
        lengths.append(len(d))
    if not datas:
        raise VelesError("%s: no databases/paths configured (all three "
                         "split entries are empty)" % loader.name)
    loader.create_originals(numpy.concatenate(datas),
                            numpy.concatenate(lbls))
    loader.class_lengths = lengths


class LMDBLoader(FullBatchLoader):
    """Full-batch loader over (test, validation, train) LMDB
    databases."""

    MAPPING = "lmdb_loader"
    hide_from_registry = False

    def __init__(self, workflow, databases: Sequence[Optional[str]] = (),
                 pickle_records: bool = False, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if len(databases) != 3:
            raise VelesError(
                "databases must be (test, validation, train) paths")
        self.databases = list(databases)
        #: SECURITY: legacy reference-era records are pickled tuples;
        #: enabling this executes whatever the database author pickled.
        self.pickle_records = bool(pickle_records)

    def _read_db(self, path: str) -> Tuple[numpy.ndarray, numpy.ndarray]:
        try:
            import lmdb
        except ImportError:
            raise VelesError(
                "LMDBLoader needs the 'lmdb' package (not installed in "
                "this environment); convert the dataset with "
                "PicklesLoader or FullBatchLoader instead")
        if self.pickle_records:
            import pickle
            decode = pickle.loads
        else:
            decode = decode_record
        samples: List[numpy.ndarray] = []
        labels: List[int] = []
        env = lmdb.open(path, readonly=True, lock=False)
        try:
            with env.begin() as txn:
                for _key, value in txn.cursor():
                    sample, label = decode(value)
                    samples.append(numpy.asarray(sample,
                                                 dtype=numpy.float32))
                    labels.append(int(label))
        finally:
            env.close()
        if not samples:
            raise VelesError("%s: empty LMDB" % path)
        return numpy.stack(samples), numpy.asarray(labels,
                                                   dtype=numpy.int32)

    def load_data(self) -> None:
        _load_splits(self, self.databases, self._read_db)


def parse_tsv_line(line: str) -> Tuple[numpy.ndarray, int]:
    """Default HDFS line parser: tab-separated floats, label last."""
    parts = line.rstrip("\n").split("\t")
    return (numpy.asarray([float(p) for p in parts[:-1]],
                          dtype=numpy.float32), int(parts[-1]))


class HDFSTextLoader(FullBatchLoader):
    """Reads newline-delimited samples from HDFS over WebHDFS."""

    MAPPING = "hdfs_text_loader"
    hide_from_registry = False

    def __init__(self, workflow, namenode: str = "",
                 paths: Sequence[Optional[str]] = (),
                 line_parser: Callable = parse_tsv_line,
                 timeout: float = 30.0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if len(paths) != 3:
            raise VelesError("paths must be (test, validation, train)")
        self.namenode = namenode.rstrip("/")
        self.paths = list(paths)
        self.line_parser = line_parser
        self.timeout = timeout

    def _webhdfs_open(self, path: str) -> str:
        if not self.namenode:
            raise VelesError("HDFSTextLoader needs namenode="
                             "http://host:9870")
        url = "%s/webhdfs/v1%s?op=OPEN" % (
            self.namenode, urllib.parse.quote(path))
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read().decode()

    def parse_text(self, text: str) -> Tuple[numpy.ndarray, numpy.ndarray]:
        samples, labels = [], []
        for line in text.splitlines():
            if not line.strip():
                continue
            sample, label = self.line_parser(line)
            samples.append(sample)
            labels.append(label)
        if not samples:
            raise VelesError("no samples parsed")
        return numpy.stack(samples), numpy.asarray(labels,
                                                   dtype=numpy.int32)

    def load_data(self) -> None:
        _load_splits(self, self.paths,
                     lambda p: self.parse_text(self._webhdfs_open(p)))
