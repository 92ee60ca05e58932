"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not minutes. The library lands in the git-ignored
``build/veles_tpu_torch/`` at the repository root, in a file named by a
hash of the source, the headers and the flags, so an edited source or
header rebuilds and an unchanged one loads at once. The build runs at
first use, never at import: the CPU tests import every module on a host
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ..error import VelesError

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "veles_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills of every kernel,
              # kept in the build log beside the library
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise VelesError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                     "build on a host with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source's bytes,
    those of every header in ``csrc/`` (``*.cuh``, which a source may
    include) and the compiler flags."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for path in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:16]))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. The compiler writes to a temporary name that is then
    renamed, so a concurrent build or a killed one never leaves a torn
    library behind."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise VelesError("nvcc failed on %s.cu (exit %d):\n%s%s"
                         % (name, proc.returncode, proc.stdout, proc.stderr))
    with open(path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) from the build of
    ``csrc/<name>.cu``; empty when the library was never built here."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def sources() -> List[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every source (default: all of ``csrc``) at once, one
    ``nvcc`` each, all started together; returns each build's seconds.
    Raises the first failure after every build has ended."""
    names = list(names or sources())
    seconds: Dict[str, float] = {}
    errors: List[BaseException] = []

    def one(name):
        t0 = time.perf_counter()
        try:
            build(name)
        except BaseException as exc:      # re-raised below
            errors.append(exc)
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Build (first use) and load the library of ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
