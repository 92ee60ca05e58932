"""File-scanning helpers (counterpart of
``veles_tpu/loader/file_loader.py``): glob include/exclude filters,
per-class path lists (test, validation, train) and the automatic label of
a file from its directory's name.
"""

from __future__ import annotations

import fnmatch
import os
from typing import List, Optional, Sequence

from ..error import VelesError
from .base import TEST, VALID, TRAIN


class FileFilter:
    """Include/exclude glob patterns over file names."""

    def __init__(self, include: Sequence[str] = ("*",),
                 exclude: Sequence[str] = ()) -> None:
        self.include = list(include)
        self.exclude = list(exclude)

    def matches(self, name: str) -> bool:
        base = os.path.basename(name)
        if not any(fnmatch.fnmatch(base, p) for p in self.include):
            return False
        return not any(fnmatch.fnmatch(base, p) for p in self.exclude)

    def scan(self, path: str) -> List[str]:
        """All matching files under path (recursive, sorted for
        deterministic sample order)."""
        found = []
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames.sort()
            for name in sorted(filenames):
                full = os.path.join(dirpath, name)
                if self.matches(full):
                    found.append(full)
        return found


class FileListScanner:
    """Resolves the (test_paths, validation_paths, train_paths)
    contract into per-class file lists."""

    def __init__(self, train_paths: Sequence[str],
                 validation_paths: Sequence[str] = (),
                 test_paths: Sequence[str] = (),
                 file_filter: Optional[FileFilter] = None) -> None:
        self.paths = {TEST: list(test_paths), VALID: list(validation_paths),
                      TRAIN: list(train_paths)}
        self.filter = file_filter or FileFilter()

    def scan(self) -> List[List[str]]:
        """[test_files, validation_files, train_files]."""
        out: List[List[str]] = [[], [], []]
        for cls in (TEST, VALID, TRAIN):
            for path in self.paths[cls]:
                if not os.path.exists(path):
                    raise VelesError("path %r does not exist" % path)
                if os.path.isfile(path):
                    out[cls].append(path)
                else:
                    out[cls].extend(self.filter.scan(path))
        if not out[TRAIN] and not out[TEST]:
            raise VelesError("no files matched in %s" % self.paths)
        return out


def auto_label(path: str) -> str:
    """Label = name of the containing directory."""
    return os.path.basename(os.path.dirname(path))
