#!/usr/bin/env python3
"""Time a served vgg16 classify on versions of the port, in turns.

    python3 scripts/vision_ab.py [--rounds 2] [--reps 50] SRC_A SRC_B ...

Each SRC is a ``src`` directory that holds a ``repro_torch`` package: this
checkout's, or one unpacked from another commit with ``git archive`` into a
directory that ``.gitignore`` lists. Each run is its own process that
imports ``repro_torch`` from SRC (which builds its kernels into that
checkout's ``build/``), builds ``chip_smoke.py``'s f32 vgg16 engine (batch
16, seeded weights, the ``cuda`` backend), warms it up with 10 classifies
and times ``reps`` more (synchronized host clock, the engine's
``wall_ms``). The sources run in order, then in reverse, for ``rounds``
rounds (A B B A for two sources and two rounds), so that versions are
compared on one card within one call. Prints
one JSON line per run with the median and quartiles, tagged with its
source and round, then the card's ``nvidia-smi`` line. Needs a CUDA card
and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(src: str, reps: int) -> int:
    """One run: the served classify with the port from src."""
    sys.path[:0] = [os.path.abspath(src), ROOT]
    import torch
    import chip_smoke as cs
    _, _, frames, engine = cs.vision_engine(torch.device("cuda"))
    for _ in range(10):
        engine.classify(frames[0])
    walls = [engine.classify(frames[0])["wall_ms"] for _ in range(reps)]
    q = statistics.quantiles(walls, n=4)
    print(json.dumps({"classify_wall_ms_median": statistics.median(walls),
                      "quartiles_ms": [q[0], q[2]], "reps": reps}))
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--child", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if args.child:
        return child(args.sources[0], args.reps)
    import torch
    if not torch.cuda.is_available() or not args.sources:
        print("usage: vision_ab.py [--rounds R] [--reps N] SRC_A SRC_B ... "
              "(on a machine with a CUDA card)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    for rnd in range(args.rounds):
        order = args.sources if rnd % 2 == 0 else args.sources[::-1]
        for src in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--reps", str(args.reps), src], capture_output=True,
                text=True, env={**os.environ, "PYTHONPATH": ""})
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                raise RuntimeError(f"the classify run failed for {src}")
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"source": src, "round": rnd,
                                      **json.loads(line)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
