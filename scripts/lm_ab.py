#!/usr/bin/env python3
"""Run chip_smoke.py's full-depth LM phase on versions of the port, in turns.

    python3 scripts/lm_ab.py [--arch stablelm-3b] SRC_A SRC_B ...

Each SRC is a ``src`` directory that holds a ``repro_torch`` package: this
checkout's, or one unpacked from another commit with ``git archive`` into a
directory that ``.gitignore`` lists. Each run is its own process that
imports ``repro_torch`` from SRC (which builds its kernels into that
checkout's ``build/``) and runs ``chip_smoke.lm_phase`` for the arch: full
width and depth, seeded weights drawn on the card, ``generate`` of 4
prompts of 2048 tokens for 32 new tokens, its launch and teacher-forcing
checks, then the ``lm`` and ``lm_profile`` lines. The sources run in
order, then in reverse (A B B A for two), so that versions are compared on
one card within one call. Prints every run's lines tagged with its source
and round, then the card's ``nvidia-smi`` line. Each arch runs as
``chip_smoke.py`` runs it (``phase_args``): recurrentgemma-2b with the
hybrid's launch counts (``chip_smoke.PATH_KERNELS["lm_rg"]``: its scan is
the gated instance, or in a port from before it the ungated one),
xlstm-350m with the sLSTM kernel's (``"lm_xlstm"``: no flash launch),
whisper-base on ``"lm_whisper"`` at its own shape (16 clips of 1500 frames,
a 224-token prompt), the MoE models cut in depth as there. Needs a CUDA
card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 2


def phase_args(arch: str) -> dict:
    """The path (whose launch counts are checked), depth cut and, where it
    differs from the default, the shape with which ``chip_smoke.py`` runs
    ``arch``'s LM phase."""
    import chip_smoke as cs
    path = {cs.LM_RG_ARCH: "lm_rg", cs.LM_XLSTM_ARCH: "lm_xlstm",
            cs.LM_WHISPER_ARCH: "lm_whisper"}
    layers = {cs.LM_MLA_ARCH: cs.LM_MLA_LAYERS,
              cs.LM_KIMI_ARCH: cs.LM_KIMI_LAYERS}
    shape = {cs.LM_WHISPER_ARCH: dict(batch=cs.LM_WHISPER_BATCH,
                                      prompt=cs.LM_WHISPER_PROMPT)}
    return dict(path=path.get(arch, "lm"), layers=layers.get(arch, 0),
                **shape.get(arch, {}))


def child(src: str, arch: str) -> int:
    """One run: the LM phase of ``chip_smoke.py`` with the port from src."""
    sys.path[:0] = [os.path.abspath(src), ROOT]
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.lm_phase(torch.device("cuda"), cs.nvidia_smi_line(), arch,
                **phase_args(arch))
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="stablelm-3b")
    parser.add_argument("--child", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if args.child:
        return child(args.sources[0], args.arch)
    import torch
    if not torch.cuda.is_available() or not args.sources:
        print("usage: lm_ab.py [--arch A] SRC_A SRC_B ... (on a machine "
              "with a CUDA card)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    for rnd in range(ROUNDS):
        order = args.sources if rnd % 2 == 0 else args.sources[::-1]
        for src in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--arch", args.arch, src], capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": ""})
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                raise RuntimeError(f"the LM phase failed for {src}")
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"source": src, "round": rnd,
                                      **json.loads(line)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
