"""Op census of every public entry point of the port.

Port of ``repro.analysis.census``. The repo's op-structure claims (DESIGN.md
§11) — "the ADC-less frontend step holds no convolution and one dot", "a
fleet step batches the kernel instead of duplicating it", "the int8 step
has one s8 x s8 -> s32 dot", "no float64 creeps into a step" — are checked
here over a registry of *entry points*: the four frontend backends, the
exact and fused serving steps, the fleet step at two fleet sizes, the int8
fused step and the vision train step, each at the reference's shapes and
seeds.

The reference traces each entry into a jaxpr and an HLO module without
running it. The port runs eagerly, so each entry runs once, on the CPU
(the kernels' plain versions), under a ``TorchDispatchMode`` that sees
every tensor op after PyTorch's decompositions. A kernel wrapper
(``cuda_lib.kernel_wrapper``) counts as one kernel call — the counterpart
of one ``pallas_call`` — with the products its kernel declares
(``cuda_lib.declare_dots``); the ops of its plain version are hidden from
the census by the flag the wrapper sets for its body, as the reference's
jaxpr holds a kernel body as a sub-jaxpr of its own. Each entry's census:

``ops``     ``conv`` (``aten.convolution``, and a ``convolution_backward``
            counted by the gradients it computes), ``dot`` (``mm``,
            ``addmm``, ``bmm``, ``_int_mm`` and their kin, plus the
            kernels' declared products), split by operand dtype into
            ``dot_f32`` / ``dot_i8`` with each int8 product's signature in
            ``dot_i8_sig``; ``kernel_calls``; ``gather`` (``gather``,
            ``index_select``, ``index.Tensor``) and ``scatter``
            (``scatter*``, ``index_put``); ``f64`` (ops that yield
            float64); ``host_sync`` (``_local_scalar_dense``, ``equal``
            and copies to the host); ``rng`` (calls of ``repro_torch.prng``'s
            key functions, the outermost of nested ones); ``op_count``
            (every tensor op, profiler annotations left out — it moves
            with the torch version, so only this port's file pins it);
``flops``   2·M·N·K over the counted convolutions and products:
            ``conv_flops``, ``dot_flops`` and their sum ``matmul_flops``;
``kernels`` calls of each kernel wrapper.

The census is *dynamic* where the reference's HLO census is static: the
reference counts a dot inside a loop once, so where its interpret-mode
kernel's grid holds two steps (kernel A at these shapes) its flops are one
step's. The port counts every product in full (``tests/test_torch_analysis.py``
names each field that differs from the reference's and why).

Checked two ways, as the reference's:

* **structural rules** (``structural_failures``) — the paper's claims at
  the reference's thresholds, in port terms;
* **budgets** — every field pinned in ``budgets.json`` beside this module
  (regenerate with ``python -m repro_torch.analysis --update-budgets
  --device cpu``; named waivers skip fields). A drift either way fails.

On the card (``collect(device="cuda")``) each entry runs once warm, then
once under ``torch.profiler``: the port's kernel launches by symbol, the
device-to-host copies and host syncs, the cuDNN and cuBLAS kernels and
every device event. ``card_failures`` holds the port's own launches equal
to the CPU census's kernel calls; the library kernels depend on their
heuristics and are reported, not pinned.

The reference's bench helpers (``frontend_step_info`` and the ``--quick``
gates) serve its benches, which the port has not taken yet.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import prng
from repro_torch.kernels import cuda_lib

BUDGETS_BASENAME = "budgets.json"

UPDATE_INSTRUCTIONS = (
    "If this drift is intentional, regenerate the budget file:\n"
    "    PYTHONPATH=src python -m repro_torch.analysis --update-budgets "
    "--device cpu\n"
    "then review the src/repro_torch/analysis/budgets.json diff as part of\n"
    "the change (the diff IS the reviewable claim — e.g. a new conv in the\n"
    "cuda frontend step).")

# --- structural rules: the paper's claims at the reference's thresholds -----
EXPECTED_FRONTEND_CENSUS = {
    "frontend.cuda": {"dot": 1, "conv": 0},      # ONE packed product
    "frontend.analog": {"dot": 0, "conv": 1},    # one packed 2-phase conv
    "frontend.device": {"dot": 0, "conv": 1},
    "frontend.ideal": {"dot": 0, "conv": 1},
}
# the int8 fused step (DESIGN.md §14): one product, both operands int8, no
# float32 product, summed in int32 (the kernel's MacQ8Mma, the reference's
# quant.fused_q8_mxu; its interpret-mode quant.fused_q8 sums in float32)
EXPECTED_QUANT_CENSUS = {
    "quant.fused_q8": {"dot_i8": 1, "dot_f32": 0, "acc": "int32"},
}
PALLAS_MATMUL_BUDGET = 1.2     # flops vs ideal census  # analysis: waive=physics-constants (threshold, not the 1.2 V pixel constant)
# the kernel's MAC holds both integration phases (the packed [w+, w-]
# operand, 2C columns), the ideal backend's conv one (C columns), so the
# cuda step's flops are held to the budget times the ideal conv's over
# both phases
PHASES = 2
FLEET_FLOP_BUDGET = 2.05       # G=2 flops vs G=1 (chip axis must batch)

# shapes and seeds the census runs at (budgets pin absolute numbers here)
FRONTEND_BATCH = 16
STREAM_BATCH = 8
FLEET_BATCH = 8
TRAIN_BATCH = 8
FRAME_HW = 32
FUSED_THETA = 0.7              # the fused step's pinned carried threshold
TRAIN_LR = 3e-3

# fields that move with the torch version: compared only under the version
# the budget file was written with
VERSION_FIELDS = ("ops.op_count",)
OP_FIELDS = ("op_count", "conv", "dot", "dot_f32", "dot_i8", "kernel_calls",
             "gather", "scatter", "f64", "host_sync", "rng")

# the key functions of repro_torch.prng the ``rng`` field counts
RNG_FUNCTIONS = ("PRNGKey", "fold_in", "split", "key_data", "counter_words",
                 "random_bits", "uniform", "normal", "randint", "bernoulli")


# --- the dispatch-mode census ------------------------------------------------

_aten = torch.ops.aten
_CONV = _aten.convolution.default
_CONV_BACKWARD = _aten.convolution_backward.default
# product ops: where their two matrix operands sit in the arguments
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "_int_mm": (0, 1), "dot": (0, 1),
         "mv": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2),
         "addmv": (1, 2)}
_GATHERS = {"gather", "index_select", "index"}
_SCATTERS = {"scatter", "scatter_add", "scatter_reduce", "index_put",
             "_index_put_impl"}
_HOST_VALUES = {"_local_scalar_dense", "equal"}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _conv_flops(grad_or_out: torch.Tensor, weight: torch.Tensor,
                transposed: bool, inp: torch.Tensor) -> int:
    """2 x output elements x the contracted extent (input channels of a
    group times the kernel window); a transposed conv contracts over the
    output side."""
    window = math.prod(weight.shape[2:])
    if transposed:
        return 2 * inp.numel() * weight.shape[1] * window
    return 2 * grad_or_out.numel() * weight.shape[1] * window


class Census:
    """The counts of one entry's run (``counting()`` fills one)."""

    def __init__(self):
        self.ops: Dict[str, int] = dict.fromkeys(OP_FIELDS, 0)
        self.flops: Dict[str, int] = {"conv_flops": 0, "dot_flops": 0}
        self.kernels: Dict[str, int] = {}
        self.i8_sigs: List[str] = []

    def _dot(self, dtypes: Sequence[str], flops: int,
             sig: Optional[str] = None) -> None:
        self.ops["dot"] += 1
        if all(d == "int8" for d in dtypes):
            self.ops["dot_i8"] += 1
            self.i8_sigs.append(sig)
        elif "float32" in dtypes:
            self.ops["dot_f32"] += 1
        self.flops["dot_flops"] += flops

    def kernel_call(self, wrapper, args, kwargs) -> None:
        self.ops["kernel_calls"] += 1
        name = wrapper.__name__
        self.kernels[name] = self.kernels.get(name, 0) + 1
        for d in wrapper.dots(*args, **kwargs):
            self._dot((d.dtype, d.dtype), d.flops, d.signature)

    def tensor_op(self, func, args, kwargs, out) -> None:
        if func.namespace == "profiler":     # span annotations, not work
            return
        self.ops["op_count"] += 1
        name = func.overloadpacket.__name__
        base = name.rstrip("_")
        if func is _CONV:
            self.ops["conv"] += 1
            self.flops["conv_flops"] += _conv_flops(out, args[1], args[6],
                                                    args[0])
        elif func is _CONV_BACKWARD:
            fwd = _conv_flops(args[0], args[2], args[7], args[0])
            for computed in args[10][:2]:
                if computed:
                    self.ops["conv"] += 1
                    self.flops["conv_flops"] += fwd
        elif base in _DOTS:
            i, j = _DOTS[base]
            a, b = args[i], args[j]
            n = b.shape[-1] if b.ndim >= 2 else 1
            sig = (f"{'x'.join(map(str, a.shape))}:{_dtype_name(a)}x"
                   f"{'x'.join(map(str, b.shape))}:{_dtype_name(b)}->"
                   f"{_dtype_name(_tensors(out)[0])}")
            self._dot((_dtype_name(a), _dtype_name(b)),
                      2 * a.numel() * n, sig)
        elif base in _GATHERS:
            self.ops["gather"] += 1
        elif base in _SCATTERS:
            self.ops["scatter"] += 1
        if base in _HOST_VALUES or self._copies_to_host(base, args, kwargs):
            self.ops["host_sync"] += 1
        if any(t.dtype == torch.float64 for t in _tensors(out)):
            self.ops["f64"] += 1

    @staticmethod
    def _copies_to_host(base: str, args, kwargs) -> bool:
        if base == "_to_copy":
            dst = kwargs.get("device")
            return (dst is not None and torch.device(dst).type == "cpu"
                    and args[0].device.type != "cpu")
        if base == "copy":
            return (args[0].device.type == "cpu"
                    and isinstance(args[1], torch.Tensor)
                    and args[1].device.type != "cpu")
        return False

    def result(self) -> Dict[str, Dict]:
        ops = dict(self.ops)
        ops["dot_i8_sig"] = ";".join(self.i8_sigs)
        flops = dict(self.flops)
        flops["matmul_flops"] = flops["conv_flops"] + flops["dot_flops"]
        return {"ops": ops, "flops": {k: float(v) for k, v in flops.items()},
                "kernels": dict(sorted(self.kernels.items()))}


class _Mode(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not cuda_lib.inside_kernel_wrapper():
            self.census.tensor_op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def _counting_rng(census: Census) -> Iterator[None]:
    """Count the outermost calls of prng's key functions outside kernel
    wrappers (a wrapper's key words are part of its kernel call)."""
    depth = threading.local()
    originals = {name: getattr(prng, name) for name in RNG_FUNCTIONS}

    def counted(fn):
        def call(*args, **kwargs):
            level = getattr(depth, "n", 0)
            if level == 0 and not cuda_lib.inside_kernel_wrapper():
                census.ops["rng"] += 1
            depth.n = level + 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth.n = level
        return call

    for name, fn in originals.items():
        setattr(prng, name, counted(fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(prng, name, fn)


@contextlib.contextmanager
def counting() -> Iterator[Census]:
    """Count what runs inside the block: ``with counting() as c: f()``,
    then ``c.result()``."""
    census = Census()
    stop = cuda_lib.observe_wrappers(census.kernel_call)
    try:
        with _counting_rng(census), _Mode(census):
            yield census
    finally:
        stop()


def op_census(fn: Callable[[], object]) -> Dict[str, Dict]:
    """Run ``fn()`` once under the census; returns its census."""
    with counting() as census:
        fn()
    return census.result()


# --- entry-point registry ----------------------------------------------------
#
# A group builder sets the entries up once on ``device`` and yields
# (entry_name, fn) pairs, ``fn()`` one run of the entry. Builders are
# deterministic (fixed seeds and shapes) so budgets pin exact numbers.

def _frames(batch: int, device) -> torch.Tensor:
    """The reference's frames: ``jax.random.uniform(PRNGKey(1), ...)``,
    bit for bit."""
    return prng.uniform(prng.PRNGKey(1), (batch, FRAME_HW, FRAME_HW, 3),
                        device=device)


def _census_vision(device):
    from repro_torch.models import vision
    cfg = vision.VisionConfig(name="census", arch="vgg_tiny", num_classes=10)
    return cfg, vision.init_params(0, cfg, device=device)


def _frontend_entries(device):
    from repro_torch import frontend
    from repro_torch.core import p2m
    fe = frontend.SensorFrontend(frontend.FrontendConfig(
        p2m=p2m.P2MConfig(), global_shutter=False))
    params = fe.init(torch.Generator().manual_seed(0), device=device)
    frames = _frames(FRONTEND_BATCH, device)
    key = prng.PRNGKey(2)
    for mode in frontend.list_backends():
        yield (f"frontend.{mode}",
               lambda m=mode: fe(params, frames, key=key, mode=m)[0])


def _stream_entries(device):
    from repro_torch.serving import VisionEngine
    cfg, params = _census_vision(device)
    frames = _frames(STREAM_BATCH, device)
    key = prng.PRNGKey(2)
    # the drift guard's tolerance is opened so the fused entry is the fused
    # step itself, not its data-dependent exact fallback
    eng = VisionEngine(cfg, params, backend="cuda", seed=0, device=device,
                       fused_theta_tol=math.inf)
    yield "stream.exact", lambda: eng._forward(eng.params, frames, key)

    def fused():
        eng._theta_carry = FUSED_THETA
        return eng._fused_classify(eng.params, frames, key)

    yield "stream.fused", fused


def _fleet_entries(device):
    from repro_torch.serving import FleetEngine
    cfg, params = _census_vision(device)
    frames = _frames(FLEET_BATCH, device)
    for g in (1, 2):
        fe = FleetEngine(cfg, params, backend="cuda", seed=0, device=device,
                         chips_per_step=g, fused_stream=False)
        for c in range(g):
            fe.add_chip(c)
        (group,) = fe._group(fe._plan([(c, frames) for c in range(g)]))
        yield f"fleet.g{g}", lambda fe=fe, group=group: fe._run_step(group)


def _train_entries(device):
    from repro_torch.models import vision
    from repro_torch.train.vision import make_step
    cfg = vision.VisionConfig(name="census", arch="vgg_tiny", num_classes=10,
                              frontend_backend="analog")
    params = vision.init_params(0, cfg, device=device)
    batch = {"image": _frames(TRAIN_BATCH, device),
             "label": torch.zeros((TRAIN_BATCH,), dtype=torch.int32,
                                  device=device)}
    step = make_step(cfg, lr=TRAIN_LR)
    key = prng.PRNGKey(2)
    yield "train.step", lambda: step(params, batch, key)


def _quant_entries(device):
    from repro_torch.core import p2m
    from repro_torch.kernels import ops
    cfg = p2m.P2MConfig()
    params = p2m.init_params(torch.Generator().manual_seed(0), cfg,
                             device=device)
    wq = p2m.quantize_weights(params["w"], cfg.weight_bits)
    frames = _frames(FRONTEND_BATCH, device)
    theta = torch.full((), FUSED_THETA, dtype=torch.float32, device=device)
    key = prng.PRNGKey(2)
    yield "quant.fused_q8", lambda: ops.p2m_frontend_fused(
        frames, wq, params["v_th"], theta, key, kernel=cfg.kernel_size,
        stride=cfg.stride, precision="int8")


ENTRY_GROUPS: Dict[str, Callable] = {
    "frontend": _frontend_entries,
    "stream": _stream_entries,
    "fleet": _fleet_entries,
    "train": _train_entries,
    "quant": _quant_entries,
}


def entries(groups: Optional[Sequence[str]] = None, device="cpu"
            ) -> Iterator[tuple]:
    """``(name, fn)`` of every entry of the requested groups (default:
    all), set up on ``device``."""
    names = list(ENTRY_GROUPS) if groups is None else list(groups)
    for g in names:
        if g not in ENTRY_GROUPS:
            raise KeyError(f"unknown census group {g!r}; "
                           f"known: {sorted(ENTRY_GROUPS)}")
        yield from ENTRY_GROUPS[g](torch.device(device))


def collect(groups: Optional[Sequence[str]] = None,
            device="cpu") -> Dict[str, Dict]:
    """Census every entry point of the requested groups (default: all):
    ``{entry: census}``. On the CPU the dispatch-mode census; on a CUDA
    device the profiler census (``card_census``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return {name: card_census(fn) for name, fn in entries(groups, device)}
    return {name: op_census(fn) for name, fn in entries(groups, device)}


# the child's program: the census of argv[1]'s groups (JSON, null for all)
# on argv[2], as one JSON line on its standard output
_CHILD = ("import json, sys\n"
          "from repro_torch.analysis import census\n"
          "out = census.collect(json.loads(sys.argv[1]), sys.argv[2])\n"
          "print(json.dumps(out))\n")
CHILD_TIMEOUT_S = 900


def collect_in_child(groups: Optional[Sequence[str]] = None,
                     device="cpu") -> Dict[str, Dict]:
    """``collect(groups, device)`` in a fresh interpreter, returned through
    JSON (every census is plain dicts of strings and numbers). On the card
    every ``torch.profiler`` session of a process can miss the device
    events of the port's kernels while keeping torch's own (its markers):
    a pytest process, alone or late in a run, and a plain ``python``
    process did so in most runs; a child started by a running Python
    process held in every run. The child starts with an empty tile table,
    as a fresh process does."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    arg = json.dumps(None if groups is None else list(groups))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, arg, str(torch.device(device))],
        capture_output=True, text=True, env=env, timeout=CHILD_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"the census child failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.splitlines()[-1])


# --- the card census ---------------------------------------------------------

# the port's kernels (csrc/), by the name their device symbol holds
PORT_KERNELS = ("phase_a_kernel", "phase_a_warp_kernel",
                "phase_a_q8_warp_kernel", "phase_a_q8_fleet_warp_kernel",
                "phase_b_kernel", "phase_b_pix_kernel",
                "phase_b_fleet_kernel", "fused_stream_kernel",
                "fused_stream_pix_kernel", "legacy_conv_kernel",
                "legacy_warp_kernel", "flash_wgmma_kernel",
                "flash_ffma_kernel", "rglru_scan_kernel", "slstm_scan_kernel")
_PORT_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(PORT_KERNELS)
                      + r")(?![A-Za-z0-9_])")
# library kernels by their names: cuDNN's convolutions, cuBLAS's products
_CONV_KERNEL_WORDS = ("cudnn", "conv", "fprop", "dgrad", "wgrad")
_GEMM_KERNEL_WORDS = ("gemm", "gemv", "cutlass", "xmma", "cublas")
_SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
               "cudaEventSynchronize")
_MARKER = "spin_kernel"        # torch.cuda._sleep's kernel
_RANGE = "census_entry"        # the host range around a profiled call
PROFILE_TRIES = 6


def _classify_kernel(name: str) -> str:
    m = _PORT_RE.search(name)
    if m:
        return m.group(1)
    low = name.lower()
    if any(w in low for w in _CONV_KERNEL_WORDS):
        return "cudnn"
    if any(w in low for w in _GEMM_KERNEL_WORDS):
        return "gemm"
    return "other"


def _symbol(name: str) -> str:
    """A device kernel's name without its namespace qualifiers and its
    parameter list: ``phase_a_kernel<ImplicitRows, MacQ8Mma>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def _profile_once(run: Callable[[], object]):
    """One ``torch.profiler`` session of ``run()``, bracketed by two marker
    kernels on the device and by a ``record_function`` range on the host.
    Returns the names of the device events between the session's last two
    markers (None when it kept fewer than two: the tracer now and then
    drops a session's device events) and the host syncs inside the range;
    events an earlier session left behind lie before both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        with record_function(_RANGE):
            run()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = prof.events()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and e.name != _RANGE), key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(device) if _MARKER in e.name]
    ranges = [e.time_range for e in events
              if e.device_type == DeviceType.CPU and e.name == _RANGE]
    if len(marks) < 2 or not ranges:
        return None, 0
    rng = ranges[-1]
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.name in _SYNC_CALLS
                and rng.start <= e.time_range.start <= rng.end)
    return [e.name for e in device[marks[-2] + 1:marks[-1]]], syncs


def card_census(fn: Callable[[], object]) -> Dict[str, object]:
    """One entry on the card: a warm call, then one profiled call. The
    wrappers' launch counts of that call, the port's kernels by symbol,
    every device event, the cuDNN and cuBLAS kernels, the device-to-host
    copies and the host syncs of the call. A session whose profile lost
    events (fewer markers than two, or fewer of the port's kernels than
    the wrappers launched) is run again, up to ``PROFILE_TRIES`` sessions;
    ``sessions`` says how many it took."""
    fn()
    for session in range(1, PROFILE_TRIES + 1):
        before = cuda_lib.launch_counts()
        names, syncs = _profile_once(fn)
        launched = {k: v - before[k] for k, v in cuda_lib.launch_counts()
                    .items() if v != before[k]}
        kinds: Dict[str, int] = {}
        symbols: Dict[str, int] = {}
        copies = 0
        for n in names or ():
            if n.startswith("Memcpy DtoH"):
                copies += 1
            if n.startswith(("Memcpy", "Memset")):
                continue
            kind = _classify_kernel(n)
            kinds[kind] = kinds.get(kind, 0) + 1
            if kind in PORT_KERNELS:
                symbols[_symbol(n)] = symbols.get(_symbol(n), 0) + 1
        if names is not None \
                and sum(symbols.values()) == sum(launched.values()):
            break
    return {"launches": dict(sorted(launched.items())),
            "kernel_launches": sum(symbols.values()),
            "symbols": dict(sorted(symbols.items())),
            "cudnn": kinds.get("cudnn", 0), "gemm": kinds.get("gemm", 0),
            "device_events": len(names or ()), "dtoh_copies": copies,
            "host_syncs": syncs, "sessions": session}


def card_failures(cpu: Dict[str, Dict], card: Dict[str, Dict]) -> List[str]:
    """The card census against the CPU census of the same entries: every
    wrapper launched as often as the CPU census called it, as many of the
    port's kernels in the profile, ``fleet.g2`` launching what ``fleet.g1``
    does and ``frontend.cuda`` no cuDNN convolution and no product."""
    fails: List[str] = []
    for entry, got in sorted(card.items()):
        want = cpu[entry]
        if got["launches"] != want["kernels"]:
            fails.append(f"{entry}.launches: the card launched "
                         f"{got['launches']}, the CPU census called "
                         f"{want['kernels']}")
        if got["kernel_launches"] != want["ops"]["kernel_calls"]:
            fails.append(f"{entry}.kernel_launches: {got['kernel_launches']}"
                         f" of the port's kernels in the profile "
                         f"({got['symbols']}), the CPU census has "
                         f"{want['ops']['kernel_calls']} kernel calls")
    one, two = card.get("fleet.g1"), card.get("fleet.g2")
    if one is not None and two is not None:
        for field in ("launches", "symbols"):
            if one[field] != two[field]:
                fails.append(f"fleet.{field}: G=1 launched {one[field]}, "
                             f"G=2 {two[field]} — the chip axis must batch "
                             "the kernel, not duplicate it")
    fe = card.get("frontend.cuda")
    if fe is not None:
        for field in ("cudnn", "gemm"):
            if fe[field]:
                fails.append(f"frontend.cuda.{field}: {fe[field]} library "
                             "kernel(s) on the ADC-less step (expected 0)")
    return fails


# --- structural rules --------------------------------------------------------

def structural_failures(results: Dict[str, Dict]) -> List[str]:
    """The paper's claims at the reference's thresholds, for the entries
    present in ``results`` (a caller that collected just the "frontend"
    group gets just the frontend rules)."""
    fails: List[str] = []
    for entry, want in EXPECTED_FRONTEND_CENSUS.items():
        got = results.get(entry, {}).get("ops")
        if got is None:
            continue
        for field, val in want.items():
            if got[field] != val:
                fails.append(f"{entry}.ops.{field}: expected {val}, "
                             f"got {got[field]}")
    for entry, want in EXPECTED_QUANT_CENSUS.items():
        got = results.get(entry, {}).get("ops")
        if got is None:
            continue
        for field in ("dot_i8", "dot_f32"):
            if got[field] != want[field]:
                fails.append(f"{entry}.ops.{field}: expected "
                             f"{want[field]}, got {got[field]}")
        sig = got.get("dot_i8_sig", "")
        if want["dot_i8"] and not sig.endswith("->" + want["acc"]):
            fails.append(f"{entry}.ops.dot_i8_sig: accumulator must be "
                         f"{want['acc']}, got {sig!r}")
    ideal = results.get("frontend.ideal", {}).get("flops")
    cuda = results.get("frontend.cuda", {}).get("flops")
    if ideal is not None and cuda is not None:
        budget = PALLAS_MATMUL_BUDGET * PHASES * ideal["matmul_flops"]
        if cuda["matmul_flops"] > budget:
            fails.append(
                f"frontend.cuda.flops.matmul_flops: "
                f"{cuda['matmul_flops']:.0f} exceeds {PALLAS_MATMUL_BUDGET}x "
                f"the ideal census over {PHASES} phases "
                f"({PHASES} x {ideal['matmul_flops']:.0f})")
    one, two = results.get("fleet.g1"), results.get("fleet.g2")
    if one is not None and two is not None:
        for field in ("dot", "conv", "kernel_calls"):
            if one["ops"][field] != two["ops"][field]:
                fails.append(f"fleet.ops.{field}: G=1 has "
                             f"{one['ops'][field]}, G=2 has "
                             f"{two['ops'][field]} — the chip axis must "
                             "batch the kernel, not duplicate it")
        if one["kernels"] != two["kernels"]:
            fails.append(f"fleet.kernels: G=1 calls {one['kernels']}, G=2 "
                         f"calls {two['kernels']}")
        f1, f2 = one["flops"]["matmul_flops"], two["flops"]["matmul_flops"]
        if f2 > FLEET_FLOP_BUDGET * f1:
            fails.append(
                f"fleet.flops.matmul_flops: G=2 ({f2:.0f}) exceeds "
                f"{FLEET_FLOP_BUDGET}x G=1 ({f1:.0f}) — the chip axis is "
                "duplicating work, not batching it")
    return fails


# --- budgets -----------------------------------------------------------------

def default_budgets_path() -> str:
    """The port's budget file, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        BUDGETS_BASENAME)


def load_budgets(path: Optional[str] = None) -> Dict:
    path = path or default_budgets_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — generate it with\n"
            "    PYTHONPATH=src python -m repro_torch.analysis "
            "--update-budgets --device cpu")
    with open(path) as f:
        return json.load(f)


def check_waivers(budgets: Dict) -> None:
    """Every census waiver must say why."""
    for w in budgets.get("waivers", {}).get("census", []):
        if not w.get("reason"):
            raise ValueError(f"census waiver {w!r} has no reason — every "
                             "waiver must say why")


def update_budgets(results: Dict[str, Dict],
                   path: Optional[str] = None) -> str:
    """Write ``results`` as the new budget file, keeping its waivers."""
    path = path or default_budgets_path()
    prev: Dict = {}
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
    doc = {
        "_readme": [
            "Op-census budgets of the PyTorch port (DESIGN.md §11): 'census'",
            "pins the CPU dispatch-mode census of every entry point; any",
            "drift fails python -m repro_torch.analysis. Regenerate with",
            "  PYTHONPATH=src python -m repro_torch.analysis "
            "--update-budgets --device cpu",
            "and REVIEW THE DIFF: it is the op-structure claim of the change.",
            "op_count moves with the torch version: it is compared only",
            "under 'torch_version'.",
            "'waivers.census' skips {entry, field} pairs; 'waivers.ast'",
            "skips {rule, path} pairs of the AST pass. Every waiver needs",
            "a reason.",
        ],
        "census": results,
        "torch_version": torch.__version__,
        "waivers": prev.get("waivers", {"census": [], "ast": []}),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def _flatten(d: Dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _values_differ(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        return abs(fa - fb) > 1e-6 * max(abs(fa), abs(fb), 1.0)
    return a != b


def budget_failures(results: Dict[str, Dict], budgets: Dict) -> List[str]:
    """Exact per-field diff of the census against the budget file. Any
    mismatch, either way, fails: a regression means the code grew ops the
    paper says it does not have; an improvement means the budget is stale
    and must be regenerated, so the next regression is caught at the new
    baseline. Under another torch version than the file's, the
    ``VERSION_FIELDS`` are not compared."""
    check_waivers(budgets)
    fails: List[str] = []
    budget_census: Dict[str, Dict] = budgets.get("census", {})
    waived = {(w.get("entry"), w.get("field"))
              for w in budgets.get("waivers", {}).get("census", [])}
    other_torch = budgets.get("torch_version", torch.__version__) \
        != torch.__version__

    def is_waived(entry: str, field: str) -> bool:
        return ((entry, field) in waived or (entry, None) in waived
                or (entry, "*") in waived
                or (other_torch and field in VERSION_FIELDS))

    for entry, want in sorted(budget_census.items()):
        if entry not in results:
            continue                      # the caller collected a subset
        got_flat = _flatten(results[entry])
        want_flat = _flatten(want)
        for field, val in sorted(want_flat.items()):
            if is_waived(entry, field):
                continue
            if field not in got_flat:
                fails.append(f"{entry}.{field}: in budget ({val!r}) but "
                             "missing from the census — stale budget")
            elif _values_differ(got_flat[field], val):
                fails.append(f"{entry}.{field}: budget {val!r}, "
                             f"current {got_flat[field]!r}")
        for field in sorted(set(got_flat) - set(want_flat)):
            if not is_waived(entry, field):
                fails.append(f"{entry}.{field}: censused "
                             f"({got_flat[field]!r}) but absent from the "
                             "budget — stale budget")
    for entry in sorted(set(results) - set(budget_census)):
        fails.append(f"{entry}: censused entry point has no budget — stale "
                     "budget file")
    return fails


def check(results: Dict[str, Dict],
          budgets: Optional[Dict] = None) -> List[str]:
    """Structural rules + (when ``budgets`` is given) the budget diff; the
    returned failure list already carries the regeneration instructions."""
    fails = structural_failures(results)
    if budgets is not None:
        fails += budget_failures(results, budgets)
    if fails:
        fails.append(UPDATE_INSTRUCTIONS)
    return fails
