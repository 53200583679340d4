"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``.cu`` under ``lerf_torch/csrc/`` compiles to an object with its own
``nvcc`` (all started together) for ``sm_90a``; the objects link into one
shared library with a plain C interface.  The library lands in
``build/lerf_torch_<hash>/`` beside the package (``build/`` is git-ignored),
keyed by a hash of the sources and flags, so a checkout builds once at
first use and an edited source rebuilds.  Nothing here runs at import.

No ``--use_fast_math`` and no FMA contraction: the decode division, the
``expf``, K3's accumulating adds and K4's requantization stay IEEE
single-precision operations, each rounded on its own, as in the plain
PyTorch twins.  The products of K3 and K4 run on the tensor cores
(``mma.sync``, ``wgmma``), which the flag does not touch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-std=c++17", "-O3", ARCH, "--fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()    # one build and load, whichever thread asks first


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _digest(sources) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:12]


def _run_all(cmds):
    """Start every command, wait for all; raise with the output of any
    that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c)} failed:\n{out}")
    return "".join(outs)


def build():
    """Compile the kernel library if needed.  Returns ``(path, log)``:
    ``log`` is nvcc's output (ptxas register counts), empty when the
    library was already built."""
    sources = _sources()
    out_dir = os.path.join(BUILD_ROOT, f"lerf_torch_{_digest(sources)}")
    lib_path = os.path.join(out_dir, "liblerf_kernels.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                        for s, o in zip(sources, objs)])
        tmp_lib = os.path.join(tmp, "liblerf_kernels.so")
        log += _run_all([[nvcc, ARCH, "-shared", *objs, "-o", tmp_lib]])
        os.replace(tmp_lib, lib_path)       # atomic against a racing build
    return lib_path, log


def _declare(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lerf_steering_resize.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,          # img, codes, out, rows, cols, dx, dy
        vp, vp,                              # mask_x, mask_y (linear mode)
        i32, i32, i32, i32, i32, i32,        # C, H, W, OH, OW, S
        i32, i32, f32, f32, f32,             # antialias, linear, min_scale,
                                             # max_sigma, norm
        i32, i32, i32, i32, i32,             # tile h, w, window rows, cols, u8
        vp, i32]                             # stream, in_type
    lib.lerf_steering_resize.restype = i32
    lib.lerf_steering_resize_bwd.argtypes = [
        vp, vp, vp, vp, vp,                  # img, hyp, grad, g_img, g_hyp
        i32, f32, vp,                        # C, max_sigma, plan (host)
        vp]                                  # stream
    lib.lerf_steering_resize_bwd.restype = i32
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.lerf_steering_warp_batch.argtypes = [
        vp, vp, vp, vp,                      # img, codes, out, mask
        f64p, i32p,                          # invs, pads (host)
        i32, i32, i32, i32, i32, i32, i32,   # frames, C, H, W, OH, OW, S
        i32, f32, f32, i32, i32,             # linear, max_sigma, norm, u8,
                                             # border
        vp, i32, i32, i32]                   # stream, in_type, row0, rows
    lib.lerf_steering_warp_batch.restype = i32
    lib.lerf_warp_geometry.argtypes = [
        vp, vp, vp, vp, f64p,                # corners, dis, masks, valid,
                                             # inv (host)
        i32, i32, i32, i32, i32, i32, i32,   # H, W, OH, OW, pad_r, pad_c, S
        i32,                                 # border
        vp, i32, i32]                        # stream, row0, rows
    lib.lerf_warp_geometry.restype = i32
    lib.lerf_steering_warp_rings.argtypes = [
        vp, vp, vp,                          # img, codes, out
        vp, i32, vp, i32,                    # ring_x, its length, ring_y, its
        vp, vp, vp, vp,                      # corner, dis_x, dis_y, bits
        i32, i32, i32, i32, i32,             # C, H, W, OH, OW
        i32, f32, f32, i32,                  # linear, max_sigma, norm, u8
        vp, i32]                             # stream, in_type
    lib.lerf_steering_warp_rings.restype = i32
    lib.lerf_warp_rings_geometry.argtypes = [
        vp, vp, vp, f64p,                    # corner, dis_x, dis_y, inv (host)
        i32, i32, i32, i32, i32, i32,        # H, W, OH, OW, pad_r, pad_c
        vp]                                  # stream
    lib.lerf_warp_rings_geometry.restype = i32
    lib.lerf_rings_blocks_per_sm.argtypes = []
    lib.lerf_rings_blocks_per_sm.restype = i32
    lib.lerf_lut_stage.argtypes = [
        vp, vp, vp, vp,                      # img, tables, out, members (host)
        i32, i32, i32, i32, i32, i32,        # M, C, H, W, oC, L4
        i32, i32, i32, i32,                  # interval, den, bias, norm
        vp]                                  # stream
    lib.lerf_lut_stage.restype = i32
    lib.lerf_lut_stage_rows.argtypes = [
        vp, vp, vp, vp,                      # img, row pointers (host), out,
                                             # members (host)
        i32, i32, i32, i32, i32, i32,        # M, C, H, W, oC, elem bytes
        i32, i32, i32, i32,                  # interval, den, bias, norm
        vp]                                  # stream
    lib.lerf_lut_stage_rows.restype = i32
    for entry in (lib.lerf_srnet_ensemble, lib.lerf_srnet_ensemble_bf16):
        entry.argtypes = [
            vp, vp,                          # img, out
            *[vp] * 12,                      # w1..w6, b1..b6
            vp, i32, i32, i32, i32, i32, i32,  # members (host), M, C, H, W,
                                             # nf, oC
            f32, vp]                         # half, stream
        entry.restype = i32
    lib.lerf_srnet_ensemble_int8.argtypes = [
        vp, vp,                              # codes, out
        *[vp] * 18,                          # w1..w6, c1..c6, b1..b6
        vp, i32, i32, i32, i32, i32, i32,    # members (host), M, C, H, W, nf, oC
        f32, vp]                             # half, stream
    lib.lerf_srnet_ensemble_int8.restype = i32
    i64 = ctypes.c_longlong
    lib.lerf_imdn_conv.argtypes = [
        vp, i64, vp, vp,                     # x, its frame stride, w, b
        vp, i64, vp, i64, i32,               # out, stride, dist, stride, split
        vp, i64,                             # residual, its frame stride
        i32, i32, i32, i32, i32,             # frames, cin, cout, H, W
        i32, i32, i32, i32,                  # k, group, act, end
        i32, f32, i32, i32,                  # stage, half, oc, vec
        vp]                                  # stream
    lib.lerf_imdn_conv.restype = i32
    lib.lerf_imdn_tail.argtypes = [
        vp, i64, vp, vp, vp,                 # x, its frame stride, w, b, fuse
        vp, i64, i32,                        # dist, its frame stride, n_dist
        vp, i64, vp, i64,                    # residual, stride, h, stride
        vp, i64,                             # out, its frame stride
        i32, i32, i32, i32, i32, i32,        # frames, cin, nf, H, W, vec
        vp]                                  # stream
    lib.lerf_imdn_tail.restype = i32
    lib.lerf_error_string.argtypes = [i32]
    lib.lerf_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(build()[0])
                _declare(lib)
                _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = library().lerf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
