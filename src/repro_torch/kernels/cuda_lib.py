"""Build and load the port's CUDA libraries: nvcc -> shared object -> ctypes.

The sources under ``repro_torch/csrc`` have a plain C interface, so one
``nvcc`` call per library builds it in seconds without PyTorch's headers.
Five libraries: ``p2m`` (the sensor frontend's seven kernels, five of
them also with a chip grid dimension), ``flash_attention``, its backward
``flash_attention_bwd``, ``rglru_scan`` and ``slstm_scan``. A build runs at first use, into ``build/repro_torch/``
at the root of the checkout, under a name keyed by a hash of the library's
sources and flags: an edited source never loads a stale library. Nothing
here runs at import time. The launch helpers shared by the kernel wrappers
(device dispatch, stream, launch check) live here too, and so does the
port-wide launch count: each wrapper module registers its wrappers, and
``launch_counts()`` reads them all. Each wrapper is marked with
``kernel_wrapper`` and declares the ``Dot`` products its kernel computes
(``declare_dots``), so the op census (``repro_torch.analysis.census``)
counts a wrapper call as one kernel call with those dots, in place of the
tensor ops of its plain version. A wrapper refuses operands that autograd
is recording (``needs_backward``) on the card: its kernel's output has no
graph, so a train forward through a kernel without a backward raises
rather than training a model cut off from its weights.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import importlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    name: str
    sources: Tuple[str, ...]   # the first is compiled; the rest it includes
    flags: Tuple[str, ...]


# --fmad=false: no contracted multiply-add anywhere, so the device chain
# rounds exactly where the plain PyTorch version does (the dot in kernel A
# and the scan ask for their FMAs explicitly; the RG-LRU's fused gates
# round where the eager chain's kernels do). No --use_fast_math in any
# library.
P2M = Library("p2m", ("p2m_kernels.cu", "p2m_physics.cuh"),
              _COMMON_FLAGS + ("--fmad=false",))
FLASH = Library("flash_attention", ("flash_attention.cu",), _COMMON_FLAGS)
FLASH_BWD = Library("flash_attention_bwd", ("flash_attention_bwd.cu",),
                    _COMMON_FLAGS)
RGLRU = Library("rglru_scan", ("rglru_scan.cu",),
                _COMMON_FLAGS + ("--fmad=false",))
# the sLSTM's elementwise chain rounds where the plain version's ops do
SLSTM = Library("slstm_scan", ("slstm_scan.cu",),
                _COMMON_FLAGS + ("--fmad=false",))
LIBRARIES = (P2M, FLASH, FLASH_BWD, RGLRU, SLSTM)


class P2MPhysics(ctypes.Structure):
    """Mirror of ``struct P2MPhysics`` in csrc/p2m_physics.cuh."""
    _fields_ = [("curve", ctypes.c_int32), ("n_redundant", ctypes.c_int32),
                ("majority", ctypes.c_int32), ("saturation", ctypes.c_float),
                ("half_vdd", ctypes.c_float), ("v_sw", ctypes.c_float),
                ("volts_per_unit", ctypes.c_float), ("v_max", ctypes.c_float),
                ("v0", ctypes.c_float), ("v1", ctypes.c_float),
                ("l0", ctypes.c_float), ("l1", ctypes.c_float),
                ("slope_lo", ctypes.c_float), ("slope_hi", ctypes.c_float),
                ("env_factor", ctypes.c_float),
                ("binom", ctypes.c_float * 25)]


class ConvGeom(ctypes.Structure):
    """Mirror of ``struct ConvGeom`` in csrc/p2m_physics.cuh."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        "batch", "h", "w", "cin", "ho", "wo", "kernel", "stride", "pad_top",
        "pad_left", "c_out")]


class FlashGeom(ctypes.Structure):
    """Mirror of ``struct FlashGeom`` in csrc/flash_attention.cu (strides in
    elements; ``seq`` q's length, ``kv_seq`` k's and v's; ``window`` 0 for
    none; ``window`` and ``kv_seq`` last so the other fields keep their
    offsets)."""
    _fields_ = ([(name, ctypes.c_int32) for name in (
        "batch", "seq", "heads", "kv_heads", "causal")]
        + [("scale", ctypes.c_float)]
        + [(f"{t}_{a}", ctypes.c_int64) for t in "qkvo" for a in "bsh"]
        + [("window", ctypes.c_int32), ("kv_seq", ctypes.c_int32)])


class FlashBwdGeom(ctypes.Structure):
    """Mirror of ``struct FlashBwdGeom`` in csrc/flash_attention_bwd.cu
    (every operand contiguous, Sq == Sk)."""
    _fields_ = ([(name, ctypes.c_int32) for name in (
        "batch", "seq", "heads", "kv_heads", "causal")]
        + [("scale", ctypes.c_float)])


class SlstmArgs(ctypes.Structure):
    """Mirror of ``struct SlstmArgs`` in csrc/slstm_scan.cu: the four
    gates' pre-activations, recurrent weights and biases, the carry (c, n,
    h, m) in and out, hs, the geometry, and where the blocks' SM ids go
    (null for nowhere; last, so an older library reads the fields before
    it)."""
    _fields_ = ([(name, ctypes.c_void_p * 4) for name in (
        "x", "r", "b", "carry_in", "carry_out")]
        + [("hs", ctypes.c_void_p)]
        + [(name, ctypes.c_int32) for name in ("batch", "seq", "heads",
                                               "dh")]
        + [("sm_ids", ctypes.c_void_p)])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def digest(lib: Library = P2M) -> str:
    h = hashlib.sha256(" ".join(lib.flags).encode())
    for name in lib.sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(lib: Library = P2M) -> Path:
    return BUILD_DIR / f"lib{lib.name}_{digest(lib)}.so"


def build(lib: Library = P2M) -> Path:
    """Compile ``lib`` unless this exact source set is already built.
    Returns its path; the compiler's register/spill report is kept beside
    it as ``.log``. Safe to call for several libraries at once."""
    out = library_path(lib)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *lib.flags, "-o", str(tmp), str(CSRC / lib.sources[0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib.name} ({res.returncode}):"
                           f"\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def tensor_core_census(path: Path, opcodes: Tuple[str, ...] = ("IMMA",
                                                               "HMMA"),
                       ) -> Dict[str, Tuple[int, ...]]:
    """``{mangled kernel name: (count of each opcode)}`` of a built library,
    from ``cuobjdump -sass``: by default (IMMA, HMMA), which kernels run
    integer and which floating-point ``mma.sync`` tensor-core instructions;
    a ``wgmma`` shows as HGMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    census = {}
    for block in sass.split("Function : ")[1:]:
        census[block.split()[0]] = tuple(block.count(op) for op in opcodes)
    return census


def _bind_p2m(lib: ctypes.CDLL) -> None:
    p, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    geom, phys = ctypes.POINTER(ConvGeom), ctypes.POINTER(P2MPhysics)
    lib.p2m_partial_rows.argtypes = [i32]
    lib.p2m_phase_b_partial_rows.argtypes = [i32, i32]
    lib.p2m_phase_a_warp_tiles.argtypes = [i32, i32]
    lib.p2m_conv_warp_tiles.argtypes = [i32]
    lib.p2m_phase_a_implicit.argtypes = [p, p, p, p, p, geom, phys, p]
    lib.p2m_phase_a_implicit_q8.argtypes = [p, p, p, p, p, p, geom, phys, p]
    lib.p2m_phase_a.argtypes = [p, p, p, p, p, i32, i32, i32, phys, p]
    lib.p2m_phase_b.argtypes = [p, p, p, p, p, i32, i32, u32, u32, phys, p]
    lib.p2m_fused_stream.argtypes = [p, p, p, p, p, p, p, p, p, geom, u32,
                                     u32, phys, p]
    lib.p2m_fused_stream_q8.argtypes = [p, p, p, p, p, p, p, p, p, p, geom,
                                        u32, u32, phys, p]
    # the per-pixel chip map's entries: its pixel count after the map
    lib.p2m_phase_b_pix.argtypes = [p, p, p, i32, p, p, i32, i32, u32, u32,
                                    phys, p]
    lib.p2m_fused_stream_pix.argtypes = [p, p, p, p, p, i32, p, p, p, p,
                                         geom, u32, u32, phys, p]
    lib.p2m_fused_stream_q8_pix.argtypes = [p, p, p, p, p, p, i32, p, p, p,
                                            p, geom, u32, u32, phys, p]
    lib.p2m_conv.argtypes = [p, p, p, p, p, i32, i32, i32, u32, u32, phys, p]
    # the chip axis's entries: the chip count after the geometry (kernel B:
    # after n and C), the (G, 2) key words on the device beside chan
    lib.p2m_phase_a_implicit_fleet.argtypes = [p, p, p, p, p, geom, i32,
                                               phys, p]
    lib.p2m_phase_a_implicit_q8_fleet.argtypes = [p, p, p, p, p, p, geom,
                                                  i32, phys, p]
    lib.p2m_phase_b_fleet.argtypes = [p, p, p, p, p, p, i32, i32, i32, phys,
                                      p]
    lib.p2m_fused_stream_fleet.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                           geom, i32, phys, p]
    lib.p2m_fused_stream_q8_fleet.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                              p, geom, i32, phys, p]
    for fn in (lib.p2m_partial_rows, lib.p2m_phase_b_partial_rows,
               lib.p2m_phase_a_warp_tiles, lib.p2m_conv_warp_tiles,
               lib.p2m_phase_a_implicit, lib.p2m_phase_a_implicit_q8,
               lib.p2m_phase_a, lib.p2m_phase_b, lib.p2m_fused_stream,
               lib.p2m_fused_stream_q8, lib.p2m_phase_b_pix,
               lib.p2m_fused_stream_pix, lib.p2m_fused_stream_q8_pix,
               lib.p2m_conv, lib.p2m_phase_a_implicit_fleet,
               lib.p2m_phase_a_implicit_q8_fleet, lib.p2m_phase_b_fleet,
               lib.p2m_fused_stream_fleet, lib.p2m_fused_stream_q8_fleet):
        fn.restype = ctypes.c_int


def _bind_flash(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, o, dtype, head dim, value dim, geometry, stream)
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32,
                                        ctypes.POINTER(FlashGeom), p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    # (dtype, head dim, value dim, window, seq)
    lib.flash_attention_kernel.argtypes = [i32, i32, i32, i32, i32]
    lib.flash_attention_kernel.restype = ctypes.c_char_p
    # (dtype, head dim, value dim, out): an older source may lack it
    # (scripts/flash_ab.py binds every version)
    if hasattr(lib, "flash_attention_design"):
        lib.flash_attention_design.argtypes = [i32, i32, i32,
                                               ctypes.POINTER(i32)]
        lib.flash_attention_design.restype = i32


def _bind_flash_bwd(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, do, dq, dk, dv, lse, delta, dtype, head dim, geometry,
    # stream)
    lib.flash_attention_bwd.argtypes = [p] * 9 + [
        i32, i32, ctypes.POINTER(FlashBwdGeom), p]
    lib.flash_attention_bwd.restype = i32
    # (dtype, head dim, which: the kernels in launch order)
    lib.flash_attention_bwd_kernel.argtypes = [i32, i32, i32]
    lib.flash_attention_bwd_kernel.restype = ctypes.c_char_p
    # (dtype, head dim, out): an older source lacks it
    # (scripts/flash_bwd_ab.py binds every version)
    if hasattr(lib, "flash_attention_bwd_design"):
        lib.flash_attention_bwd_design.argtypes = [i32, i32,
                                                   ctypes.POINTER(i32)]
        lib.flash_attention_bwd_design.restype = i32


def _bind_rglru(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan.argtypes = [p, p, p, i32, i32, i32, p]
    lib.rglru_scan_gated.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32,
                                     p]
    for fn in (lib.rglru_scan, lib.rglru_scan_gated):
        fn.restype = ctypes.c_int


def _bind_slstm(lib: ctypes.CDLL) -> None:
    i32 = ctypes.c_int
    # (operands, r and b's dtype, stream)
    lib.slstm_scan.argtypes = [ctypes.POINTER(SlstmArgs), i32,
                               ctypes.c_void_p]
    lib.slstm_scan.restype = i32
    # (batch, heads, head dim, r and b's dtype, out): an older source lacks
    # it (scripts/slstm_ab.py binds every version)
    if hasattr(lib, "slstm_scan_design"):
        lib.slstm_scan_design.argtypes = [i32, i32, i32, i32,
                                          ctypes.POINTER(i32)]
        lib.slstm_scan_design.restype = i32


_LOADED: Dict[str, ctypes.CDLL] = {}


def _load(lib: Library, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    if lib.name not in _LOADED:
        handle = ctypes.CDLL(str(build(lib)))
        bind(handle)
        _LOADED[lib.name] = handle
    return _LOADED[lib.name]


def load() -> ctypes.CDLL:
    """The P2M library (built on first use), with every entry typed."""
    return _load(P2M, _bind_p2m)


def load_flash() -> ctypes.CDLL:
    """The flash-attention library (built on first use), entries typed."""
    return _load(FLASH, _bind_flash)


def load_flash_bwd() -> ctypes.CDLL:
    """The flash-attention backward library (built on first use), its
    entries typed."""
    return _load(FLASH_BWD, _bind_flash_bwd)


def load_rglru() -> ctypes.CDLL:
    """The RG-LRU scan library (built on first use), its entries typed."""
    return _load(RGLRU, _bind_rglru)


def load_slstm() -> ctypes.CDLL:
    """The sLSTM recurrence library (built on first use), its entry
    typed."""
    return _load(SLSTM, _bind_slstm)


# ---------------------------------------------------------------------------
# launch helpers shared by the kernel wrappers
# ---------------------------------------------------------------------------

def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand is a CPU tensor (the plain version runs);
    False when all are on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _tensors(operands):
    """The tensors among ``operands`` and one level of lists and tuples in
    them (the sLSTM wrapper takes its gates as sequences)."""
    for x in operands:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (t for t in x if isinstance(t, torch.Tensor))


def needs_backward(*operands) -> bool:
    """True when autograd is recording and an operand (or a tensor in a
    list or tuple of them) requires grad: a kernel's output, which has no
    graph, would cut the gradient off there."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(operands))


def refuse_detached(name: str, args, kwargs) -> None:
    """Raise NotImplementedError where wrapper ``name`` would launch its
    kernel on operands that ``needs_backward``: a CUDA operand while
    autograd records one that requires grad. CPU operands run the plain
    version, which autograd differentiates."""
    operands = (*args, *kwargs.values())
    if needs_backward(*operands) and any(
            t.device.type == "cuda" for t in _tensors(operands)):
        raise NotImplementedError(
            f"{name}: no backward kernel, and autograd is recording an "
            f"operand that requires grad; its output would have no graph. "
            f"Run it under torch.no_grad(), or on the CPU (the plain "
            f"version); its backward kernel is ROADMAP item 16")


def check_launch(err: int, name: str) -> None:
    """Raise on a launch's return code: a cudaError_t, or (flash attention)
    9999 when the driver has no tensor-map encoder and 10000 + the CUresult
    of a tensor map it refused."""
    if err >= 9999:
        raise RuntimeError(f"{name}: tensor map refused (code {err}) at launch")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# launch counts and the census's view of every kernel wrapper of the port
# ---------------------------------------------------------------------------

# the modules whose wrappers register below: one for each library
_WRAPPER_MODULES = ("repro_torch.kernels.p2m_conv",
                    "repro_torch.kernels.flash_attention",
                    "repro_torch.kernels.rglru_scan",
                    "repro_torch.kernels.slstm_scan")
_WRAPPERS: List[Callable] = []
# observers of wrapper calls (``repro_torch.analysis.census``), and how deep
# the current thread is inside a wrapper's body
_OBSERVERS: List[Callable] = []
_INSIDE = threading.local()


@dataclasses.dataclass(frozen=True)
class Dot:
    """Matrix products a kernel computes: lhs (..., M, K), its leading
    axes (chips; batch and heads) each a product of the same shape, rhs
    (K, N), both operands of ``dtype``, summed in ``acc``."""
    lhs: Tuple[int, ...]
    rhs: Tuple[int, int]
    dtype: str
    acc: str

    @property
    def flops(self) -> int:
        return 2 * math.prod(self.lhs) * self.rhs[1]

    @property
    def signature(self) -> str:
        """``4096x27:int8x27x64:int8->int32``, as the reference's census
        writes an int8 dot."""
        return (f"{'x'.join(map(str, self.lhs))}:{self.dtype}x"
                f"{'x'.join(map(str, self.rhs))}:{self.dtype}->{self.acc}")


def kernel_wrapper(fn: Callable) -> Callable:
    """Mark ``fn`` as a kernel wrapper: a census sees each call as one
    kernel call (an observer gets the wrapper and its arguments) and none
    of the tensor ops inside it, kernel launch or plain version
    (``inside_kernel_wrapper()`` is true for the body). A call on CUDA
    operands that autograd records raises (``refuse_detached``)."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        refuse_detached(fn.__name__, args, kwargs)
        if not _OBSERVERS:
            return fn(*args, **kwargs)
        depth = getattr(_INSIDE, "depth", 0)
        if depth == 0:
            for observe in _OBSERVERS:
                observe(call, args, kwargs)
        _INSIDE.depth = depth + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _INSIDE.depth = depth

    return call


def inside_kernel_wrapper() -> bool:
    return getattr(_INSIDE, "depth", 0) > 0


def observe_wrappers(observer: Callable) -> Callable[[], None]:
    """Call ``observer(wrapper, args, kwargs)`` at every outermost wrapper
    call until the returned function is called."""
    _OBSERVERS.append(observer)
    return lambda: _OBSERVERS.remove(observer)


def register(*wrappers: Callable) -> None:
    """Enter kernel wrappers into the port-wide count at 0 launches. Each
    wrapper adds one to its ``.launches`` where it launches its kernel, and
    nowhere else."""
    for fn in wrappers:
        fn.launches = 0
        fn.dots = lambda *args, **kwargs: ()
        _WRAPPERS.append(fn)


def declare_dots(declarations: Dict[Callable, Callable]) -> None:
    """``{wrapper: dots}``: ``dots(*args, **kwargs)``, called with a
    wrapper call's arguments, gives the ``Dot`` products its kernel
    computes (a kernel without a declaration computes none)."""
    for fn, dots in declarations.items():
        fn.dots = dots


def kernel_wrappers() -> Tuple[Callable, ...]:
    """Every kernel wrapper of the port (importing the modules that hold
    them, so the answer does not depend on what was imported before)."""
    for name in _WRAPPER_MODULES:
        importlib.import_module(name)
    return tuple(_WRAPPERS)


def launch_counts() -> Dict[str, int]:
    """``{wrapper name: kernel launches since the last reset}``, over every
    kernel of the port."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0
