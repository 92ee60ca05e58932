"""Audio ingest: sound files decoded into fixed-length float windows
(counterpart of ``veles_tpu/loader/sound.py``). Decoders in order: the
``soundfile`` package if installed, else a ``ctypes`` binding of
``libsndfile`` (the reference's approach), else the stdlib ``wave``
module (.wav only).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import wave
from typing import List, Optional, Sequence, Tuple

import numpy

from ..error import VelesError
from .fullbatch import FullBatchLoader


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _decode_soundfile(path):
    import soundfile                    # optional dependency
    data, rate = soundfile.read(path, dtype="float32", always_2d=True)
    return data, int(rate)


class _SndfileInfo(ctypes.Structure):
    _fields_ = [("frames", ctypes.c_int64), ("samplerate", ctypes.c_int),
                ("channels", ctypes.c_int), ("format", ctypes.c_int),
                ("sections", ctypes.c_int), ("seekable", ctypes.c_int)]


_sndfile_lib = None


def _load_sndfile():
    global _sndfile_lib
    if _sndfile_lib is None:
        name = ctypes.util.find_library("sndfile")
        if not name:
            raise ImportError("libsndfile not found")
        lib = ctypes.CDLL(name)
        lib.sf_open.restype = ctypes.c_void_p
        lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(_SndfileInfo)]
        lib.sf_readf_float.restype = ctypes.c_int64
        lib.sf_readf_float.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64]
        lib.sf_close.argtypes = [ctypes.c_void_p]
        _sndfile_lib = lib
    return _sndfile_lib


def _decode_libsndfile(path):
    """The ``ctypes`` binding of libsndfile."""
    lib = _load_sndfile()
    info = _SndfileInfo()
    handle = lib.sf_open(path.encode(), 0x10, ctypes.byref(info))  # READ
    if not handle:
        raise VelesError("libsndfile cannot open %s" % path)
    try:
        frames, channels = int(info.frames), int(info.channels)
        buf = numpy.zeros(frames * channels, dtype=numpy.float32)
        got = lib.sf_readf_float(
            handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames)
        return buf[:got * channels].reshape(-1, channels), \
            int(info.samplerate)
    finally:
        lib.sf_close(handle)


def _decode_wave(path):
    with wave.open(path, "rb") as wav:
        n = wav.getnframes()
        width = wav.getsampwidth()
        channels = wav.getnchannels()
        raw = wav.readframes(n)
        rate = wav.getframerate()
    if width == 2:
        data = numpy.frombuffer(raw, dtype="<i2").astype(
            numpy.float32) / 32768.0
    elif width == 1:
        data = (numpy.frombuffer(raw, dtype=numpy.uint8).astype(
            numpy.float32) - 128.0) / 128.0
    elif width == 4:
        data = numpy.frombuffer(raw, dtype="<i4").astype(
            numpy.float32) / 2147483648.0
    else:
        raise VelesError("%s: unsupported sample width %d" % (path, width))
    return data.reshape(-1, channels), rate


def decode_audio(path: str) -> Tuple[numpy.ndarray, int]:
    """→ (float32 samples (frames, channels) in [-1, 1], sample rate)."""
    errors = []
    for dec in (_decode_soundfile, _decode_libsndfile):
        try:
            return dec(path)
        except ImportError as e:
            errors.append(str(e))
        except VelesError:
            raise
    if path.lower().endswith(".wav"):
        return _decode_wave(path)
    raise VelesError("cannot decode %s (no soundfile/libsndfile: %s)" %
                     (path, "; ".join(errors)))


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

class SoundFileLoader(FullBatchLoader):
    """Full-batch loader over audio files, windowed to fixed length.

    Each file is mono-mixed, split into ``window`` -sample frames with
    ``stride`` hop; every frame becomes one sample labelled by the file's
    position in ``files`` (or the given ``labels``): the input of the
    genre-recognition LSTM workflow.
    """

    MAPPING = "sound_file_loader"
    hide_from_registry = False

    def __init__(self, workflow, files: Sequence[str] = (),
                 labels: Optional[Sequence[int]] = None,
                 window: int = 1024, stride: Optional[int] = None,
                 validation_ratio: float = 0.15, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.files: List[str] = list(files)
        self.file_labels = None if labels is None else list(labels)
        self.window = int(window)
        self.stride = int(stride or window)
        self.validation_ratio = float(validation_ratio)
        self.sample_rate: Optional[int] = None

    def windows_of(self, path: str) -> numpy.ndarray:
        data, rate = decode_audio(path)
        if self.sample_rate is None:
            self.sample_rate = rate
        elif rate != self.sample_rate:
            raise VelesError(
                "%s: sample rate %d differs from the dataset's %d — "
                "resample before loading" % (path, rate,
                                             self.sample_rate))
        mono = data.mean(axis=1)
        n = (len(mono) - self.window) // self.stride + 1
        if n <= 0:
            raise VelesError("%s shorter than window %d" %
                             (path, self.window))
        idx = (numpy.arange(self.window)[None, :] +
               self.stride * numpy.arange(n)[:, None])
        return mono[idx].astype(numpy.float32)

    def load_data(self) -> None:
        if not self.files:
            raise VelesError("%s: no files" % self.name)
        chunks, labels = [], []
        for i, path in enumerate(self.files):
            frames = self.windows_of(path)
            label = (self.file_labels[i] if self.file_labels is not None
                     else i)
            chunks.append(frames)
            labels.append(numpy.full(len(frames), label,
                                     dtype=numpy.int32))
        data = numpy.concatenate(chunks)
        lbls = numpy.concatenate(labels)
        # deterministic shuffle before the validation split
        order = numpy.random.RandomState(1).permutation(len(data))
        data, lbls = data[order], lbls[order]
        n_valid = int(len(data) * self.validation_ratio)
        self.create_originals(data, lbls)
        self.class_lengths = [0, n_valid, len(data) - n_valid]
