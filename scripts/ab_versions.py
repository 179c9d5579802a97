"""What the A/B scripts share (``flash_ab.py``, ``p2m_ab.py``): versions of
one kernel library built side by side, copies of a source with one stage
left out, and device times taken in turns on one card.

Nothing here needs a card except the libraries' loading and timing.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def import_checkout() -> None:
    """Put this checkout's ``chip_smoke.py`` and ``src/`` first on the path."""
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def diagnostic_sources(source: str, out_dir: str, diagnostics: dict) -> list:
    """Write one copy of ``source`` per ``{name: (old text, new text)}``
    entry, the old text replaced, into ``out_dir``; returns their paths.
    Each old text must be in the source exactly once."""
    text = open(source).read()
    paths = []
    for name, (old, new) in diagnostics.items():
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to replace is not in {source}"
                             " exactly once")
        path = os.path.join(out_dir, f"diag_{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        paths.append(path)
    return paths


def build_versions(sources: list, flags, out_dir: str,
                   include: dict = None) -> dict:
    """Compile every source at once (one nvcc each) with ``flags`` into
    ``out_dir``; ``include`` maps a source to the directory of its headers
    (by default its own). Returns ``{source: (ctypes.CDLL, nvcc log)}``."""
    from repro_torch.kernels import cuda_lib
    include = include or {}
    os.makedirs(out_dir, exist_ok=True)
    builds = []
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"lib_{i}.so")
        cmd = [cuda_lib._nvcc(), *flags, "-I",
               include.get(src, os.path.dirname(os.path.abspath(src))),
               "-o", so, src]
        builds.append((src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for src, so, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        out[src] = (ctypes.CDLL(so), log)
    return out


def sass_by_kernel(path: str) -> dict:
    """``{kernel: machine code}`` of a built library, from ``cuobjdump
    -sass``, the anonymous namespace's per-file name left out of both, so
    that one kernel built from two sources compares equal where its code
    is."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    sass = re.sub(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_anon_", sass)
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, _, code = block.partition("\n")
        out[name.strip()] = " ".join(code.split())
    return out


def in_turns(sources: list, rounds: int, load, measure) -> dict:
    """``{source: [measure() of each round]}``: the versions in order, then
    in reverse, round after round (A B B A ...), each loaded with
    ``load(source)`` before it is measured, so that versions are compared on
    one card within one run."""
    out = {src: [] for src in sources}
    for rnd in range(rounds):
        for src in (sources if rnd % 2 == 0 else sources[::-1]):
            load(src)
            out[src].append(measure())
    return out
