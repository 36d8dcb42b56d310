"""ctypes bindings of the host example store (``csrc/example_store.cpp``).

Counterpart of ``alphazero_tpu/native.py``'s ``available`` and
``ExampleStore``: the ring-buffered archive of training samples that the
coach mirrors each iteration into and saves as ``{iteration}.examples``
(``coach.py``). The store is host C++ with a plain C interface, compiled
with g++ at first use into ``csrc/build/<hash of source and flags>/`` and
loaded with ``ctypes``; nothing is built when this module is imported. Its
files are the JAX package's, byte for byte.

``available()`` is False only when no g++ is on ``PATH``; a failed build
raises. The JAX module's C++ oracles (``oracle_search``, ``tt_oracle_*``)
are test tools and are not ported (ROADMAP, "Do not port").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "example_store.cpp"
BUILD_DIR = _CSRC / "build"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def available() -> bool:
    """Whether the store can be built here: a g++ on ``PATH``."""
    return shutil.which("g++") is not None


def library() -> ctypes.CDLL:
    """Build (once per source/flags hash) and load the store's library.
    Raises when there is no g++ or the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the example store needs g++ on PATH")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    so_path = out_dir / "libazstore.so"
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as work:
            tmp = Path(work) / so_path.name
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the example store:\n{proc.stderr}")
            os.replace(tmp, so_path)   # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so_path))
    u64, u32, vp = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    lib.az_store_create.restype = vp
    lib.az_store_create.argtypes = [u64, u32, u32]
    lib.az_store_destroy.argtypes = [vp]
    for fn in ("az_store_count", "az_store_total", "az_store_capacity"):
        getattr(lib, fn).restype = u64
        getattr(lib, fn).argtypes = [vp]
    lib.az_store_append.argtypes = [vp, fp, fp, fp, u64]
    lib.az_store_read.restype = u64
    lib.az_store_read.argtypes = [vp, u64, u64, fp, fp, fp]
    lib.az_store_save.restype = ctypes.c_int
    lib.az_store_save.argtypes = [vp, ctypes.c_char_p]
    lib.az_store_load.restype = ctypes.c_int
    lib.az_store_load.argtypes = [vp, ctypes.c_char_p]
    _LIB = lib
    return lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ExampleStore:
    """A FIFO ring of ``capacity`` training samples on the host, each
    ``features[feat_size] | pi[num_actions] | value`` in f32, saved to and
    loaded from the checksummed ``.examples`` format."""

    def __init__(self, capacity: int, feat_size: int, num_actions: int):
        self._lib = library()
        self.feat_size = feat_size
        self.num_actions = num_actions
        self._h = self._lib.az_store_create(capacity, feat_size, num_actions)
        if not self._h:
            raise MemoryError("az_store_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.az_store_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.az_store_count(self._h))

    @property
    def total(self) -> int:
        """Samples appended over the store's life (a loaded file's too)."""
        return int(self._lib.az_store_total(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.az_store_capacity(self._h))

    def append(self, feats: np.ndarray, pis: np.ndarray, values: np.ndarray) -> None:
        """Append ``n`` samples in order; past the capacity the oldest go.
        ``n = 0`` appends nothing (the JAX store's reshape raises there: an
        iteration without a valid sample, ROADMAP queue 3)."""
        n = len(values)
        feats = np.ascontiguousarray(feats, np.float32)
        pis = np.ascontiguousarray(pis, np.float32)
        values = np.ascontiguousarray(values, np.float32).reshape(n)
        if feats.size != n * self.feat_size or pis.size != n * self.num_actions:
            raise ValueError(f"{n} samples of {feats.size} feature and {pis.size} policy floats; "
                             f"the store holds {self.feat_size} features and "
                             f"{self.num_actions} actions a sample")
        self._lib.az_store_append(self._h, _floats(feats), _floats(pis), _floats(values), n)

    def read(self, start: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Samples ``start .. start + n`` in age order (oldest first), cut
        at the live count."""
        feats = np.empty((n, self.feat_size), np.float32)
        pis = np.empty((n, self.num_actions), np.float32)
        values = np.empty((n,), np.float32)
        got = int(self._lib.az_store_read(self._h, start, n, _floats(feats), _floats(pis),
                                          _floats(values)))
        return feats[:got], pis[:got], values[:got]

    def save(self, path: str) -> None:
        rc = self._lib.az_store_save(self._h, os.fspath(path).encode())
        if rc != 0:
            raise IOError(f"az_store_save failed rc={rc}")

    def load(self, path: str) -> None:
        """Append a saved file's samples (rc 3: bad header, 4: another
        geometry, 5: checksum mismatch)."""
        rc = self._lib.az_store_load(self._h, os.fspath(path).encode())
        if rc != 0:
            raise IOError(f"az_store_load failed rc={rc}")
