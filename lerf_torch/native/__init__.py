"""The host precompute of the dynamic warp in C, compiled at first use.

``warp_precompute.c`` computes the rings of one homography
(:class:`~lerf_torch.ops.resample.WarpRings`) and its validity mask in one
pass per output pixel, bit-equal to the row-blocked numpy path of
:func:`~lerf_torch.ops.resample.warp_serving_host_fused` (its header says
how).

Build: one ``$CC -O3 -march=native -ffp-contract=off -shared`` (``CC``
defaults to ``cc``) at first use, into ``build/native_<key>/`` beside the
CUDA kernels' library (``build/`` is git-ignored), keyed by a hash of the
source, the flags, the compiler and the CPU, so an edited source, another
compiler or another CPU builds anew.  A build that fails raises with the compiler's
output: nothing falls back to numpy behind the caller's back
(``native=False`` asks for the numpy path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from ..ops.kernels._build import BUILD_ROOT

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "warp_precompute.c")
CFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]
_libs = {}                       # library path → loaded handle
_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def _cpu() -> str:
    """The host CPU's model and feature flags (``-march=native`` builds for
    them): part of the build key, so a ``build/`` shared between machines
    never loads another CPU's library."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def _library_path(cc: str) -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join([cc, *CFLAGS, _cpu()]).encode()) \
        .hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"native_{key}", "warp_precompute.so")


def _build(cc: str, so: str):
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as td:
        tmp = os.path.join(td, "out.so")
        try:
            done = subprocess.run([cc, *CFLAGS, "-o", tmp, _SRC, "-lm",
                                   "-pthread"], capture_output=True,
                                  text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {_SRC} with {cc!r}: {e}") \
                from e
        if done.returncode != 0:
            raise RuntimeError(f"cannot build {_SRC} with {cc!r} (exit "
                               f"{done.returncode}):\n{done.stderr}")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        os.replace(tmp, so)       # atomic against a racing build


def get_warp_lib():
    """The loaded library (``ctypes``, argument types set), built on first
    use; raises ``RuntimeError`` with the compiler's output when it cannot
    be built."""
    cc = _compiler()
    so = _library_path(cc)
    with _lock:
        if so in _libs:
            return _libs[so]
        if not os.path.exists(so):
            _build(cc, so)
        lib = ctypes.CDLL(so)
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        fn = lib.warp_operands_fused
        fn.restype = ctypes.c_int
        fn.argtypes = [f64p] + [ctypes.c_int64] * 9 + [ctypes.c_int] * 2 + \
            [i32p, f32p, f32p, u8p,
             ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
        _libs[so] = lib
        return lib


def native_threads() -> int:
    """Worker count for the row-parallel precompute: ``LERF_NATIVE_THREADS``
    if set, else one per visible CPU.  Rows partition disjointly, so the
    result is bit-equal for every thread count."""
    env = os.environ.get("LERF_NATIVE_THREADS", "")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)
