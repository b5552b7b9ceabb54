"""Native (C++) host components, reached over ctypes.

The port's own copy of the JAX package's corpus pipeline (corpus.cpp:
tokenize + vocab count + index + GloVe co-occurrences, the
VocabConstructor/text-pipeline hot loop). It is host code, not a device
kernel. The shared library is built from this directory's corpus.cpp with
g++ at first use, never at import, into `deeplearning4j_tpu_torch/_build/`,
keyed by a hash of the source and flags; each build writes a file of its
own and renames it into place, so processes that build at once do not
race. With no toolchain the callers take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "corpus.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdl4jcorpus-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = _lib_path()
        if not os.path.exists(so):
            try:
                _build(so)
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning("native corpus build failed (%s); "
                               "falling back to Python paths", e)
                _build_failed = True
                return None
        lib = ctypes.CDLL(so)
        lib.corpus_open.restype = ctypes.c_void_p
        lib.corpus_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.corpus_close.restype = None
        lib.corpus_close.argtypes = [ctypes.c_void_p]
        for fn, ret in (("corpus_total_tokens", ctypes.c_int64),
                        ("corpus_num_sentences", ctypes.c_int64)):
            getattr(lib, fn).restype = ret
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.corpus_vocab_size.restype = ctypes.c_int64
        lib.corpus_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.corpus_vocab_bytes.restype = ctypes.c_int64
        lib.corpus_vocab_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.corpus_vocab_dump.restype = ctypes.c_int64
        lib.corpus_vocab_dump.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.corpus_index.restype = None
        lib.corpus_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.corpus_cooc_build.restype = ctypes.c_int64
        lib.corpus_cooc_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.corpus_cooc_dump.restype = None
        lib.corpus_cooc_dump.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeCorpus:
    """One tokenized file. Exposes (words, counts) in VocabConstructor
    order and the corpus as vocab-indexed sentences."""

    def __init__(self, path: str, lowercase: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native corpus library unavailable")
        self._lib = lib
        self._h = lib.corpus_open(path.encode(), int(lowercase))
        if not self._h:
            raise OSError(f"cannot read corpus file {path!r}")

    def close(self):
        if self._h:
            self._lib.corpus_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def total_tokens(self) -> int:
        return int(self._lib.corpus_total_tokens(self._h))

    @property
    def num_sentences(self) -> int:
        return int(self._lib.corpus_num_sentences(self._h))

    def vocab(self, min_count: int = 1) -> Tuple[List[str], np.ndarray]:
        """(words, counts) sorted by (count desc, word asc)."""
        n = self._lib.corpus_vocab_size(self._h, min_count)
        counts = np.zeros(n, np.int64)
        nbytes = self._lib.corpus_vocab_bytes(self._h, min_count)
        buf = ctypes.create_string_buffer(int(nbytes) + 1)
        written = self._lib.corpus_vocab_dump(
            self._h, min_count, buf, nbytes + 1,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if written < 0:
            raise RuntimeError("vocab dump buffer undersized")
        words = buf.raw[:written].decode().split("\n")[:-1]
        return words, counts

    def cooccurrences(self, min_count: int = 1, window: int = 5,
                      symmetric: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """GloVe co-occurrence COO triple (rows, cols, weights) over the
        filtered vocab: forward-window scan, 1/distance weights,
        mirrored when symmetric."""
        n = self._lib.corpus_cooc_build(
            self._h, min_count, window, int(symmetric))
        rows = np.zeros(n, np.int32)
        cols = np.zeros(n, np.int32)
        vals = np.zeros(n, np.float32)
        self._lib.corpus_cooc_dump(
            self._h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return rows, cols, vals

    def indexed_sentences(self, min_count: int = 1) -> List[np.ndarray]:
        """Sentences as vocab-index arrays, filtered words dropped —
        the exact shape SequenceVectors.train_indexed consumes."""
        total = self.total_tokens
        n_sent = self.num_sentences
        tokens = np.zeros(total, np.int32)
        offsets = np.zeros(n_sent + 1, np.int64)
        self._lib.corpus_index(
            self._h, min_count,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        out = []
        for s in range(n_sent):
            seg = tokens[offsets[s]:offsets[s + 1]]
            seg = seg[seg >= 0]
            if seg.size:
                out.append(seg.astype(np.int64))
        return out
