"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface and loaded with `ctypes`.
Builds happen at first use, never at import, into
`deeplearning4j_tpu_torch/_build/`, keyed by a hash of the sources and
flags, so an unchanged tree reuses its libraries and an edited one
rebuilds. `build_all()` starts one `nvcc` per source at once and waits
for all of them. `entry()` binds one C entry point; `require_hopper()` and
`on_hopper()` are the device checks every kernel wrapper and probe share.

A source may also be built with extra `-D` defines into a library of its
own (`variant_library`): the compile-time knobs a kernel sweep varies
(csrc/bn_stream.cuh). The wrappers always load the plain build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("lstm_step", "lstm_sequence", "lstm_sequence_bwd", "conv1x1_stats",
           "conv_kxk_stats", "bn_apply", "bn_backward", "updater_apply", "ssd_scan")
_HEADERS = ("common.cuh", "conv_bn.cuh", "bn_stream.cuh", "lstm_cluster.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "log": nvcc output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _define_flags(defines) -> list:
    return [f"-D{k}={v}" for k, v in defines]


def _key(name: str, defines=()) -> str:
    """build_info's key: the source's name, with the defines of a variant."""
    return name + "".join(f" {k}={v}" for k, v in defines)


def _lib_path(name: str, defines=()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *_define_flags(defines))).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, defines=()) -> Tuple[str, str, subprocess.Popen]:
    out = _lib_path(name, defines)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names=SOURCES, variants=()) -> Dict[str, dict]:
    """Build every missing library, one `nvcc` per source (and per
    variant: (name, ((define, value), ...))) in parallel. Raises with the
    compiler's output if any build fails."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        running = []
        for name, defines in [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]:
            key = _key(name, defines)
            if os.path.exists(_lib_path(name, defines)):
                build_info.setdefault(key, {"seconds": 0.0, "log": ""})
            else:
                running.append((key, *_start(name, defines)))
        errors = []
        for key, out, tmp, proc in running:
            try:
                log, _ = proc.communicate()
            finally:
                if proc.poll() is None:
                    proc.kill()
            build_info[key] = {"seconds": time.perf_counter() - t0,
                               "log": log}
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {key}:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(build_info)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_lib_path(name))
                lib.dl4j_error_string.argtypes = [ctypes.c_int]
                lib.dl4j_error_string.restype = ctypes.c_char_p
    return lib


def variant_library(name: str, defines) -> ctypes.CDLL:
    """`csrc/<name>.cu` built with `-D` defines ((define, value), ...) into
    a library of its own, built first if needed. Loaded anew on each
    call: only a sweep uses it."""
    defines = tuple(defines)
    build_all((), variants=((name, defines),))
    lib = ctypes.CDLL(_lib_path(name, defines))
    lib.dl4j_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if code != 0:
        msg = lib.dl4j_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_P = ctypes.c_void_p
_I = ctypes.c_int


def entry(lib_name: str, fn_name: str, n_ptr: int, n_int: int):
    """(library, bound function) for a C entry point of the shape every
    kernel here exports: int fn(int dtype, n_ptr pointers, n_int ints,
    void* stream), returning a CUDA error code."""
    lib = library(lib_name)
    return lib, entry_of(lib, fn_name, n_ptr, n_int)


def entry_of(lib: ctypes.CDLL, fn_name: str, n_ptr: int, n_int: int):
    """`entry`'s bound function, from a library already loaded."""
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_I] + [_P] * n_ptr + [_I] * n_int + [_P]
        fn.restype = _I
    return fn


def on_hopper(device) -> bool:
    """True for a CUDA device of compute capability >= 9.0."""
    if device is None:
        return False
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) >= (9, 0))


def require_hopper(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap < (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a; {device} has "
            f"compute capability {cap}")
