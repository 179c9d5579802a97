"""The repo's AST rules over the port (``src/repro_torch``).

Port of ``repro.analysis.astlint``, each rule in its PyTorch meaning:

``physics-constants``  floats of two or more significant digits defined in
                       ``repro_torch/core/`` appear nowhere else in the
                       package (anti-fork: a drifted copy of a device
                       constant silently changes the device)
``no-wallclock``       the single-clock rule: no ``time.time`` (not
                       monotonic), and ``time.perf_counter`` only in
                       ``repro_torch/obs/clock.py``; everything else takes
                       its timestamps from ``repro_torch.obs.clock.now()``
``no-host-rng``        no ``numpy.random``, no ``random``, no global
                       ``torch.manual_seed``; no ``torch.rand*`` /
                       ``randn*`` / ``randint*`` / ``randperm`` /
                       ``bernoulli`` / ``multinomial`` / ``normal`` /
                       ``poisson`` and no in-place sampler (``x.normal_()``
                       ...) without ``generator=``; no
                       ``prng.PRNGKey(<literal>)`` in library code — host
                       RNG breaks reproducibility and a baked seed hides
                       the key-threading bug class
``frozen-config``      ``*Config`` / ``*Params`` dataclasses must be
                       ``frozen=True`` (hashable, no aliasing)
``orphan-module``      every module under ``src/repro_torch`` is reachable
                       from the import graph of ``tests/``, ``scripts/``,
                       ``examples/``, ``benchmarks/``, ``chip_smoke.py``
                       or a declared ``python -m`` root
``q8-f32-dot``         in ``kernels/`` functions whose name holds ``q8``,
                       no matrix product (``@``, ``matmul``, ``mm``,
                       ``bmm``, ``einsum``, ``F.linear``): the int8 plain
                       versions accumulate in an integer dtype, as the
                       kernels' int32 MAC does (PyTorch has no integer
                       matmul on the card, so such a product runs in
                       floating point); ``torch._int_mm`` is allowed

The reference's ``vmap-needs-jit`` (``jax.vmap`` outside a jitted inner
re-traces per call) has no meaning here: the port runs eagerly and uses no
``vmap``. It comes back the day the port uses ``torch.vmap``.

Waive a finding inline (``# analysis: waive=<rule>`` on the flagged line)
or with a ``{rule, path, reason}`` entry under ``waivers.ast`` in the
port's budget file (``analysis/budgets.json``); a waiver without a reason
is refused.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PACKAGE = "repro_torch"

# python -m entry points with no importer: reachable by declaration
CLI_ROOTS = (
    "repro_torch.launch.train",       # python -m repro_torch.launch.train
    "repro_torch.launch.serve",       # python -m repro_torch.launch.serve
    "repro_torch.serve_lm",           # python -m repro_torch.serve_lm
    "repro_torch.analysis.__main__",  # python -m repro_torch.analysis
    "repro_torch.obs.__main__",       # python -m repro_torch.obs smoke
    "repro_torch.quickstart",         # python -m repro_torch.quickstart
    "repro_torch.train_p2m_vision",   # python -m repro_torch.train_p2m_vision
)
# files and directories whose imports make a module reachable
IMPORT_ROOTS = ("tests", "scripts", "examples", "benchmarks", "chip_smoke.py")

# the ONE file allowed to call time.perf_counter (the single-clock rule)
CLOCK_MODULE = "src/repro_torch/obs/clock.py"

RULES = ("physics-constants", "no-wallclock", "no-host-rng", "frozen-config",
         "orphan-module", "q8-f32-dot")

# torch's samplers: each must be given a generator
_TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "bernoulli",
                   "multinomial", "normal", "poisson", "rand_like",
                   "randn_like", "randint_like")
_INPLACE_SAMPLERS = ("normal_", "uniform_", "bernoulli_", "random_",
                     "exponential_", "geometric_", "log_normal_", "cauchy_")
# matrix products a q8 function must not hold
_PRODUCTS = ("matmul", "mm", "bmm", "einsum", "linear", "addmm", "baddbmm",
             "tensordot", "inner", "dot", "mv")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, e.g. "src/repro_torch/quickstart.py"
    lineno: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: [{self.rule}] {self.message}"


# --- helpers -----------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.nn.functional.linear' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _sig_digits(value: float) -> int:
    text = repr(abs(value))
    if "e" in text or "E" in text:
        text = text.split("e")[0].split("E")[0]
    digits = text.replace(".", "").strip("0")
    return len(digits)


def _rel(path: str) -> str:
    return path.replace(os.sep, "/")


class _FileLint:
    """Runs the per-file rules (everything except the import graph)."""

    def __init__(self, path: str, rel: str, source: str,
                 protected_constants: Dict[float, str]):
        self.rel = _rel(rel)
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.protected = protected_constants
        self.in_core = f"/{PACKAGE}/core/" in self.rel
        self.in_kernels = f"/{PACKAGE}/kernels/" in self.rel
        self.is_clock = self.rel == CLOCK_MODULE
        self.violations: List[Violation] = []
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        lineno = getattr(node, "lineno", 0)
        line = (self.source_lines[lineno - 1]
                if 0 < lineno <= len(self.source_lines) else "")
        if (f"analysis: waive={rule}" in line
                or "analysis: waive=all" in line):
            return
        self.violations.append(Violation(rule, self.rel, lineno, message))

    def _ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        while node in self.parents:
            node = self.parents[node]
            yield node

    # -- rules ---------------------------------------------------------------
    def _check_wallclock(self, node: ast.AST) -> None:
        if isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for alias in node.names:
                    if alias.name in ("time", "perf_counter"):
                        self._check_clock_name(node, f"time.{alias.name}")
            return
        self._check_clock_name(node, _dotted(node))

    def _check_clock_name(self, node: ast.AST, d: Optional[str]) -> None:
        if d == "time.time":
            self._flag("no-wallclock", node,
                       "time.time() is not monotonic; route timestamps "
                       "through repro_torch.obs.clock.now()")
        elif d == "time.perf_counter" and not self.is_clock:
            self._flag("no-wallclock", node,
                       "only repro_torch.obs.clock may call "
                       "time.perf_counter() (single-clock rule); use "
                       "repro_torch.obs.clock.now()")

    def _check_host_rng(self, node: ast.AST) -> None:
        if isinstance(node, ast.Attribute):
            # the exact `np.random` node (a subexpression of every
            # `np.random.*` use), so each use flags once
            d = _dotted(node)
            if d in ("numpy.random", "np.random"):
                self._flag("no-host-rng", node,
                           f"{d}: host-side RNG in library code — draw "
                           "from a repro_torch.prng key instead")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            if any(m.split(".")[0] == "random" for m in mods):
                self._flag("no-host-rng", node,
                           "the random module: host-side RNG in library "
                           "code — draw from a repro_torch.prng key instead")
        elif isinstance(node, ast.Call):
            self._check_sampler_call(node)

    def _check_sampler_call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if d == "torch.manual_seed":
            self._flag("no-host-rng", node,
                       "torch.manual_seed seeds the process-global "
                       "generator — pass a seeded torch.Generator instead")
        elif (d is not None and d.startswith("torch.")
              and d.split(".", 1)[1] in _TORCH_SAMPLERS and not has_gen):
            self._flag("no-host-rng", node,
                       f"{d}() draws from the global generator — pass "
                       "generator= (or draw from a repro_torch.prng key)")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _INPLACE_SAMPLERS and not has_gen):
            self._flag("no-host-rng", node,
                       f".{node.func.attr}() draws from the global "
                       "generator — pass generator=")
        elif (d is not None and d.split(".")[-1] == "PRNGKey"
              and len(node.args) == 1
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, (int, float))):
            self._flag("no-host-rng", node,
                       f"PRNGKey({node.args[0].value!r}) with a literal "
                       "seed in library code — accept a key from the "
                       "caller")

    def _check_frozen_config(self, node: ast.ClassDef) -> None:
        if not (node.name.endswith("Config") or node.name.endswith("Params")):
            return
        for dec in node.decorator_list:
            is_bare = (_dotted(dec) or "").split(".")[-1] == "dataclass"
            is_call = (isinstance(dec, ast.Call)
                       and (_dotted(dec.func) or "").split(".")[-1]
                       == "dataclass")
            if not (is_bare or is_call):
                continue
            frozen = (not is_bare) and any(
                kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in dec.keywords)
            if not frozen:
                self._flag("frozen-config", node,
                           f"dataclass {node.name} must be frozen=True "
                           "(hashable; no post-construction mutation)")
            return

    def _in_q8_function(self, node: ast.AST) -> bool:
        return any(isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and "q8" in anc.name for anc in self._ancestors(node))

    def _check_q8_dot(self, node: ast.AST) -> None:
        if not self.in_kernels:
            return
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            what = "the @ product"
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            if node.func.attr not in _PRODUCTS:
                return
            what = f"{_dotted(node.func) or '.' + node.func.attr}()"
        else:
            return
        if self._in_q8_function(node):
            self._flag("q8-f32-dot", node,
                       f"{what} in a q8 kernel path runs in floating point "
                       "(PyTorch has no integer matmul on the card) — "
                       "accumulate the int8 operands in an integer dtype, "
                       "as the kernels' int32 MAC does")

    def _check_constants(self, node: ast.Constant) -> None:
        if self.in_core or not isinstance(node.value, float):
            return
        if node.value in self.protected:
            self._flag("physics-constants", node,
                       f"literal {node.value!r} duplicates the physics "
                       f"constant defined in {self.protected[node.value]} — "
                       "import it from repro_torch.core instead of forking "
                       "the value")

    def run(self) -> List[Violation]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Attribute, ast.ImportFrom)):
                self._check_wallclock(node)
            if isinstance(node, (ast.Attribute, ast.Call, ast.Import,
                                 ast.ImportFrom)):
                self._check_host_rng(node)
            if isinstance(node, (ast.BinOp, ast.Call)):
                self._check_q8_dot(node)
            if isinstance(node, ast.ClassDef):
                self._check_frozen_config(node)
            if isinstance(node, ast.Constant):
                self._check_constants(node)
        return self.violations


# --- protected physics constants ---------------------------------------------

def collect_physics_constants(core_dir: str) -> Dict[float, str]:
    """Float literals with >= 2 significant digits defined in ``core/``.

    The significance filter keeps generic values (0.9 momentum, 0.5, 2.0)
    out of the protected set: only device-specific numbers (0.062 V,
    0.9717 polarization, ...) are protected.
    """
    protected: Dict[float, str] = {}
    for fname in sorted(os.listdir(core_dir)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(core_dir, fname)) as f:
            tree = ast.parse(f.read(), filename=fname)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, float)
                    and _sig_digits(node.value) >= 2):
                protected.setdefault(node.value, f"core/{fname}")
    return protected


# --- import-graph reachability -----------------------------------------------

def _module_name(rel: str) -> str:
    """'src/repro_torch/core/mtj.py' -> 'repro_torch.core.mtj'."""
    parts = _rel(rel).split("/")
    parts = parts[parts.index(PACKAGE):]
    parts[-1] = parts[-1][:-3]                       # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imported_modules(tree: ast.AST, importer: str) -> Set[str]:
    """All absolute 'repro_torch.*' module names a module's imports name."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == PACKAGE:
                    out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                # level 1 -> the importer's own package, 2 -> its parent
                # (callers pass "pkg.__init__" for package inits)
                pkg = importer.split(".")[:-node.level]
                base = ".".join(pkg)
                if node.module:
                    base = f"{base}.{node.module}" if base else node.module
            if not base or base.split(".")[0] != PACKAGE:
                continue
            out.add(base)
            for alias in node.names:
                out.add(f"{base}.{alias.name}")
    return out


def _parse(path: str) -> ast.AST:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _root_files(repo_root: str) -> Iterable[str]:
    for top in IMPORT_ROOTS:
        p = os.path.join(repo_root, top)
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for dirpath, _dn, filenames in os.walk(p):
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        yield os.path.join(dirpath, fname)


def orphan_modules(repo_root: str) -> List[Violation]:
    """Modules under src/repro_torch unreachable from the import roots and
    the declared CLI roots."""
    modules: Dict[str, str] = {}                     # name -> rel path
    trees: Dict[str, ast.AST] = {}
    for dirpath, _dn, filenames in os.walk(
            os.path.join(repo_root, "src", PACKAGE)):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, repo_root)
            name = _module_name(rel)
            modules[name] = rel
            trees[name] = _parse(full)

    def resolve(imported: str) -> Set[str]:
        """An import of 'pkg.a.b' marks pkg, pkg.a and pkg.a.b."""
        parts = imported.split(".")
        return {".".join(parts[:i]) for i in range(1, len(parts) + 1)
                if ".".join(parts[:i]) in modules}

    edges: Dict[str, Set[str]] = {}
    for name, tree in trees.items():
        is_pkg = modules[name].endswith("__init__.py")
        importer = name + ".__init__" if is_pkg else name
        targets: Set[str] = set()
        for imp in _imported_modules(tree, importer):
            targets |= resolve(imp)
        edges[name] = targets - {name}

    roots: Set[str] = {m for r in CLI_ROOTS for m in resolve(r)}
    for path in _root_files(repo_root):
        for imp in _imported_modules(_parse(path), importer="external"):
            roots |= resolve(imp)

    reachable = set(roots)
    frontier = list(roots)
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in reachable:
                reachable.add(nxt)
                frontier.append(nxt)

    return [Violation(
        "orphan-module", _rel(modules[name]), 1,
        f"module {name} is unreachable from {', '.join(IMPORT_ROOTS)} or "
        "any declared CLI root — wire it in, delete it, or waive it with a "
        "reason") for name in sorted(set(modules) - reachable)]


# --- driver ------------------------------------------------------------------

def lint_repo(repo_root: str) -> List[Violation]:
    """All per-file rules over src/repro_torch plus the import-graph check."""
    pkg = os.path.join(repo_root, "src", PACKAGE)
    protected = collect_physics_constants(os.path.join(pkg, "core"))
    violations: List[Violation] = []
    for dirpath, _dn, filenames in os.walk(pkg):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, repo_root)
            with open(full) as f:
                source = f.read()
            violations += _FileLint(full, rel, source, protected).run()
    violations += orphan_modules(repo_root)
    return violations


def apply_waivers(violations: Sequence[Violation],
                  waivers: Sequence[Dict]) -> Tuple[List[Violation],
                                                    List[Violation]]:
    """Split into (remaining, waived); a waiver matches on (rule, path)
    and MUST carry a non-empty reason."""
    index: Set[Tuple[str, str]] = set()
    for w in waivers:
        if not w.get("reason"):
            raise ValueError(f"AST waiver {w!r} has no reason — every "
                             "waiver must say why")
        index.add((w["rule"], _rel(w["path"])))
    remaining: List[Violation] = []
    waived: List[Violation] = []
    for v in violations:
        (waived if (v.rule, _rel(v.path)) in index else remaining).append(v)
    return remaining, waived


def run(repo_root: str,
        waivers: Sequence[Dict] = ()) -> Tuple[List[Violation],
                                               List[Violation]]:
    """Lint the port and apply waivers; returns (remaining, waived)."""
    return apply_waivers(lint_repo(repo_root), waivers)
