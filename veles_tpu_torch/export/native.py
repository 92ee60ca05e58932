"""ctypes binding to the C++ inference runtime, ``libveles_infer.so``
(counterpart of ``veles_tpu/export/native.py``).

The runtime is the repository's ``native/`` (the reference's libVeles
equivalent: a package directory in, the forward and cached greedy
generation out, no Python). The port builds it itself from the checkout,
at first use: ``native/src/{json,npy,model}.cc`` with ``native/include``,
by the C++ compiler with ``native/CMakeLists.txt``'s flags, into the
git-ignored ``build/veles_tpu_torch/native/``, in a file named by a hash
of the sources and the flags, under a file lock, so processes that start
together build it once. ``VELES_INFER_LIB`` names a library to use
instead. A runtime that does not build is an error, never a skip.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy

from ..error import VelesError
from ..ops._build import BUILD_DIR

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE = os.path.join(REPO, "native")
NATIVE_BUILD_DIR = os.path.join(BUILD_DIR, "native")
#: the library's sources, as ``native/CMakeLists.txt`` lists them
SOURCES = ("src/json.cc", "src/npy.cc", "src/model.cc")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


def _inputs() -> List[str]:
    """Every file the library is built from: the sources and every header
    under ``native/include`` and ``native/src``."""
    headers = sorted(
        os.path.join(sub, f) for sub in ("include", "src")
        for f in os.listdir(os.path.join(NATIVE, sub)) if f.endswith(".h"))
    return list(SOURCES) + headers


def library_path() -> str:
    """Where the runtime builds to: keyed by its sources' and headers'
    bytes and the flags."""
    digest = hashlib.sha256()
    for rel in _inputs():
        with open(os.path.join(NATIVE, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(NATIVE_BUILD_DIR, "libveles_infer-%s.so"
                        % digest.hexdigest()[:16])


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise VelesError("no C++ compiler found (set CXX): the native runtime "
                     "builds from native/src at first use")


def build_library() -> str:
    """Build ``libveles_infer.so`` unless it exists; returns its path.
    One build at a time across processes (a file lock beside it), into a
    temporary name renamed when done, so no process loads a torn
    library."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(NATIVE_BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = "%s.%d.tmp" % (path, os.getpid())
        cxx = compiler()
        objs = ["%s.%s.o" % (tmp, os.path.basename(src)) for src in SOURCES]
        try:
            # one compiler a source, all started together, then the link
            procs = [subprocess.Popen(
                [cxx, *CXX_FLAGS, "-I", os.path.join(NATIVE, "include"),
                 "-c", os.path.join(NATIVE, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(SOURCES, objs)]
            outs = [(p.communicate()[0], p.returncode) for p in procs]
            link = subprocess.run([cxx, *CXX_FLAGS, *objs, "-o", tmp],
                                  capture_output=True, text=True)
            outs.append((link.stdout + link.stderr, link.returncode))
            failed = [out for out, rc in outs if rc != 0]
            if failed:
                raise VelesError("building the native runtime failed:\n%s"
                                 % "\n".join(failed))
            os.replace(tmp, path)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
    return path


def find_library() -> Optional[str]:
    """``$VELES_INFER_LIB`` when set, else the built library when it
    exists (None before the first build)."""
    env = os.environ.get("VELES_INFER_LIB")
    if env:
        return env if os.path.exists(env) else None
    path = library_path()
    return path if os.path.exists(path) else None


def load_library():
    """The runtime, built at first use and typed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = find_library() or build_library()
        lib = ctypes.CDLL(path)
        lib.vi_load.restype = ctypes.c_void_p
        lib.vi_load.argtypes = [ctypes.c_char_p]
        lib.vi_input_size.restype = ctypes.c_size_t
        lib.vi_input_size.argtypes = [ctypes.c_void_p]
        lib.vi_output_size.restype = ctypes.c_size_t
        lib.vi_output_size.argtypes = [ctypes.c_void_p]
        lib.vi_unit_count.restype = ctypes.c_size_t
        lib.vi_unit_count.argtypes = [ctypes.c_void_p]
        lib.vi_run.restype = ctypes.c_int
        lib.vi_run.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_float)]
        lib.vi_generate.restype = ctypes.c_int
        lib.vi_generate.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float)]
        lib.vi_last_error.restype = ctypes.c_char_p
        lib.vi_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeModel:
    """A package directory loaded into the C++ runtime."""

    def __init__(self, package_dir: str) -> None:
        self._lib = load_library()
        self._handle = self._lib.vi_load(package_dir.encode())
        if not self._handle:
            raise VelesError("native load failed: %s" %
                             self._lib.vi_last_error().decode())
        self.input_size = self._lib.vi_input_size(self._handle)
        self.output_size = self._lib.vi_output_size(self._handle)
        self.unit_count = self._lib.vi_unit_count(self._handle)

    def __call__(self, batch) -> numpy.ndarray:
        """The forward of a batch → (batch, output size) float32."""
        x = numpy.ascontiguousarray(batch, dtype=numpy.float32)
        n = len(x)
        if n == 0 or x.size != n * self.input_size:
            raise VelesError("input size %d != %d per sample"
                             % (x.size // max(n, 1), self.input_size))
        out = numpy.empty((n, self.output_size), dtype=numpy.float32)
        rc = self._lib.vi_run(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc:
            raise VelesError("native run failed: %s" %
                             self._lib.vi_last_error().decode())
        return out

    def generate(self, prompt, n_new: int) -> List[int]:
        """KV-cached greedy decoding (``vi_generate``): any prompt length,
        one cached step a new token — the native twin of
        ``nn.sampling.generate`` at temperature 0."""
        p = numpy.ascontiguousarray(numpy.asarray(prompt).ravel(),
                                    dtype=numpy.float32)
        out = numpy.empty(int(n_new), dtype=numpy.float32)
        rc = self._lib.vi_generate(
            self._handle, p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            p.size, int(n_new),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc:
            raise VelesError("native generate failed: %s" %
                             self._lib.vi_last_error().decode())
        return [int(t) for t in out]

    def close(self) -> None:
        if self._handle:
            self._lib.vi_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass
