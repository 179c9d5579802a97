"""Build and load the frontend's CUDA library: nvcc -> shared object -> ctypes.

The sources under ``repro_torch/csrc`` have a plain C interface, so one
``nvcc`` call builds them in seconds without PyTorch's headers. The build
runs at first use, into ``build/repro_torch/`` at the root of the checkout,
under a name keyed by a hash of the sources and flags: an edited source
never loads a stale library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("p2m_kernels.cu", "p2m_physics.cuh")
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
# --fmad=false: no contracted multiply-add anywhere, so the device chain
# rounds exactly where the plain PyTorch version does (the dot in kernel A
# asks for its FMAs explicitly). No --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class P2MPhysics(ctypes.Structure):
    """Mirror of ``struct P2MPhysics`` in csrc/p2m_physics.cuh."""
    _fields_ = [("curve", ctypes.c_int32), ("n_redundant", ctypes.c_int32),
                ("majority", ctypes.c_int32), ("saturation", ctypes.c_float),
                ("half_vdd", ctypes.c_float), ("v_sw", ctypes.c_float),
                ("volts_per_unit", ctypes.c_float), ("v_max", ctypes.c_float),
                ("v0", ctypes.c_float), ("v1", ctypes.c_float),
                ("l0", ctypes.c_float), ("l1", ctypes.c_float),
                ("slope_lo", ctypes.c_float), ("slope_hi", ctypes.c_float),
                ("env_factor", ctypes.c_float)]


class ConvGeom(ctypes.Structure):
    """Mirror of ``struct ConvGeom`` in csrc/p2m_physics.cuh."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        "batch", "h", "w", "cin", "ho", "wo", "kernel", "stride", "pad_top",
        "pad_left", "c_out")]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the frontend's CUDA kernels are "
                       "built from csrc/ on a machine with the CUDA toolkit")


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libp2m_{digest()}.so"


def build() -> Path:
    """Compile the library unless this exact source set is already built.
    Returns its path; the compiler's register/spill report is kept beside
    it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


_LIB = None


def load() -> ctypes.CDLL:
    """The loaded library (built on first use), with every entry typed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    p, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    geom, phys = ctypes.POINTER(ConvGeom), ctypes.POINTER(P2MPhysics)
    lib.p2m_rows_per_block.argtypes = []
    lib.p2m_threads_per_block.argtypes = []
    lib.p2m_phase_a_implicit.argtypes = [p, p, p, p, p, geom, phys, p]
    lib.p2m_phase_a_implicit_q8.argtypes = [p, p, p, p, p, p, geom, phys, p]
    lib.p2m_phase_a.argtypes = [p, p, p, p, p, i32, i32, i32, phys, p]
    lib.p2m_phase_b.argtypes = [p, p, p, p, p, i32, i32, u32, u32, phys, p]
    lib.p2m_fused_stream.argtypes = [p, p, p, p, p, p, p, p, p, geom, u32,
                                     u32, phys, p]
    lib.p2m_fused_stream_q8.argtypes = [p, p, p, p, p, p, p, p, p, p, geom,
                                        u32, u32, phys, p]
    lib.p2m_conv.argtypes = [p, p, p, p, p, i32, i32, i32, u32, u32, phys, p]
    for fn in (lib.p2m_rows_per_block, lib.p2m_threads_per_block,
               lib.p2m_phase_a_implicit, lib.p2m_phase_a_implicit_q8,
               lib.p2m_phase_a, lib.p2m_phase_b, lib.p2m_fused_stream,
               lib.p2m_fused_stream_q8, lib.p2m_conv):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
