"""Growable array with optional memory-mapped file backing.

The analogue of the reference's GrowableVector (``Vectors.h:38-177``):
orbit stores grow incrementally during computation, either in anonymous
memory or backed by a file whose mapping IS the on-disk orbit — saving
is free because appends already landed in the file.  AddPointOptions
mirror ``Vectors.h:7-12``.

numpy owns the in-memory variant (doubling ndarray); the file variant
is an ``np.memmap`` re-mapped on growth (ftruncate + fresh map), with a
JSON sidecar recording dtype/count written at ``finalize()`` so
``open_existing`` can reconstruct the view.
"""

from __future__ import annotations

import enum
import json
import os

import numpy as np


class AddPointOptions(enum.Enum):
    DONT_SAVE = 0                 # anonymous memory only
    ENABLE_WITH_SAVE = 1          # file-backed; keep the file
    ENABLE_WITHOUT_SAVE = 2       # file-backed scratch; delete on close
    OPEN_EXISTING_WITH_SAVE = 3   # map an existing store read/write


class GrowableArray:
    """Append-only 1-D array, anonymous or file-backed."""

    def __init__(self, dtype=np.float64, path: str | None = None,
                 options: AddPointOptions = AddPointOptions.DONT_SAVE,
                 capacity: int = 4096):
        self.dtype = np.dtype(dtype)
        self.options = options
        self.path = path
        self._n = 0
        if options is AddPointOptions.DONT_SAVE:
            self._buf = np.empty(capacity, self.dtype)
            self._mm = None
        elif options is AddPointOptions.OPEN_EXISTING_WITH_SAVE:
            meta = json.load(open(path + ".meta"))
            self.dtype = np.dtype(meta["dtype"])
            self._n = int(meta["count"])
            cap = max(capacity, self._n)
            self._ensure_file(cap)
            self._buf = self._mm
        else:
            if path is None:
                raise ValueError("file-backed store needs a path")
            self._ensure_file(capacity)
            self._buf = self._mm

    # ---------------------------------------------------------- internals

    def _ensure_file(self, capacity: int):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        nbytes = capacity * self.dtype.itemsize
        with open(self.path, "ab") as f:
            if f.tell() < nbytes:
                f.truncate(nbytes)
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r+",
                             shape=(capacity,))

    def _grow(self, need: int):
        cap = len(self._buf)
        while cap < need:
            cap *= 2
        if self._mm is None:
            nb = np.empty(cap, self.dtype)
            nb[:self._n] = self._buf[:self._n]
            self._buf = nb
        else:
            self._mm.flush()
            self._ensure_file(cap)
            self._buf = self._mm

    # --------------------------------------------------------------- api

    def __len__(self) -> int:
        return self._n

    def append(self, v):
        if self._n + 1 > len(self._buf):
            self._grow(self._n + 1)
        self._buf[self._n] = v
        self._n += 1

    def extend(self, arr):
        arr = np.asarray(arr, self.dtype)
        if self._n + len(arr) > len(self._buf):
            self._grow(self._n + len(arr))
        self._buf[self._n:self._n + len(arr)] = arr
        self._n += len(arr)

    def view(self) -> np.ndarray:
        """Zero-copy view of the valid prefix."""
        return self._buf[:self._n]

    def finalize(self) -> np.ndarray:
        """Flush + write the sidecar (file-backed); return the view."""
        if self._mm is not None:
            self._mm.flush()
            if self.options in (AddPointOptions.ENABLE_WITH_SAVE,
                                AddPointOptions.OPEN_EXISTING_WITH_SAVE):
                with open(self.path + ".meta", "w") as f:
                    json.dump({"dtype": self.dtype.name,
                               "count": self._n}, f)
        return self.view()

    def close(self):
        if self._mm is not None:
            self._mm.flush()
            del self._mm
            self._mm = None
            if self.options is AddPointOptions.ENABLE_WITHOUT_SAVE:
                for p in (self.path, self.path + ".meta"):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    @staticmethod
    def open_existing(path: str) -> "GrowableArray":
        return GrowableArray(
            path=path, options=AddPointOptions.OPEN_EXISTING_WITH_SAVE)
