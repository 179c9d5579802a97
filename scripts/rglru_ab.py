#!/usr/bin/env python3
"""Time versions of the RG-LRU scan library against each other on one card.

    python3 scripts/rglru_ab.py [--rounds N] A.cu B.cu ...

Each argument is a version of ``src/repro_torch/csrc/rglru_scan.cu`` (the
file from another commit, or an edited copy). All are compiled at once with
the port's flags (one nvcc each, into ``build/rglru_ab/``), each version's
register and spill report printed. Then, at recurrentgemma-2b's prefill (B
4, S 2048, R 2560; ``chip_smoke.RGLRU_SERVING``), each version is held and
timed in turns (the versions in order, then in reverse, round after round,
on one card within one run):

* ``scan``: ``rglru_scan(a, b)`` in float32 with a near 1, held against its
  plain version at ``chip_smoke.RGLRU_TOL``;
* ``chain``: the unfused chain of a prefill's RG-LRU layer in bf16 (the
  gates' float32 tail in PyTorch ops, ``rglru_scan``, the cast to bf16);
* ``gated`` (versions that have it): ``rglru_scan_gated`` on the same bf16
  gates, held bit for bit against that chain with the same version's scan.

Prints one JSON line per version (its device times, median of each
``chip_smoke.device_ms``, per round and their medians), then one with the
two bounds (bytes over the memory rate), the card's name and its
``nvidia-smi`` line. Needs a CUDA card and exits non-zero without one. The
building and the turns are ``ab_versions.py``'s, shared with
``flash_ab.py`` and ``p2m_ab.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

import ab_versions

ROUNDS = 3


def bind(lib) -> bool:
    """Type a built version's entries; True where it has the gated one."""
    from repro_torch.kernels import cuda_lib
    try:
        lib.rglru_scan_gated
    except AttributeError:      # a version from before the gated instance
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan.argtypes = [p, p, p, i32, i32, i32, p]
        lib.rglru_scan.restype = ctypes.c_int
        return False
    cuda_lib._bind_rglru(lib)
    return True


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or not args.sources:
        print("usage: rglru_ab.py A.cu B.cu ... (on a machine with a CUDA "
              "card)", file=sys.stderr)
        return 1
    ab_versions.import_checkout()
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import rglru_scan as rs

    out_dir = os.path.join(ab_versions.ROOT, "build", "rglru_ab")
    libs, gated = {}, {}
    for src, (lib, log) in ab_versions.build_versions(
            args.sources, cuda_lib.RGLRU.flags, out_dir).items():
        libs[src], gated[src] = lib, bind(lib)
        print(json.dumps({"source": src, "gated": gated[src], "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]}), flush=True)

    dev = torch.device("cuda")
    b, s, r = (cs.RGLRU_SERVING[x] for x in ("batch", "seq", "width"))
    gen = torch.Generator().manual_seed(37)
    sp = torch.rand(r, generator=gen) * 0.099 + 0.001    # softplus(lam)
    a = torch.exp(-8 * sp * torch.rand(b, s, r, generator=gen))
    x = torch.sqrt(1 - a * a) * torch.randn(b, s, r, generator=gen)
    a, x = a.to(dev), x.to(dev)
    plain = rs.rglru_scan_plain(a, x)
    bf16 = torch.bfloat16
    rg, ig = (torch.sigmoid(torch.randn(b, s, r, generator=gen)).to(
        device=dev, dtype=bf16) for _ in range(2))
    u = torch.randn(b, s, r, generator=gen).to(device=dev, dtype=bf16)
    c = (-0.008 - 0.792 * torch.rand(r, generator=gen)).to(dev)

    def chain():
        return rs.rglru_scan(*rs.rglru_ab(rg, ig, u, c)).to(bf16)

    current = {}

    def load(src):
        cuda_lib._LOADED[cuda_lib.RGLRU.name] = libs[src]
        current["src"] = src

    def measure():
        src = current["src"]
        err = cs.max_abs(rs.rglru_scan(a, x), plain)
        cs.check(err <= cs.RGLRU_TOL, f"{src}: rglru_scan max-abs {err} "
                 "against the plain version")
        out = {"scan": cs.device_ms(lambda: rs.rglru_scan(a, x), dev),
               "chain": cs.device_ms(chain, dev)}
        if gated[src]:
            cs.check(torch.equal(rs.rglru_scan_gated(rg, ig, u, c)[0],
                                 chain()),
                     f"{src}: rglru_scan_gated != the unfused chain")
            out["gated"] = cs.device_ms(
                lambda: rs.rglru_scan_gated(rg, ig, u, c), dev)
        return out

    turns = ab_versions.in_turns(args.sources, args.rounds, load, measure)
    for src, rounds in turns.items():
        ms = {key: [rnd[key] for rnd in rounds] for key in rounds[0]}
        print(json.dumps({"source": src, "ms": ms, "median_ms": {
            key: statistics.median(t) for key, t in ms.items()}}),
              flush=True)
    n = b * s * r
    print(json.dumps({
        "geometry": f"B{b} S{s} R{r}",
        "scan_bytes": 3 * n * 4, "scan_bound_ms": cs.bound(3 * n * 4,
                                                           2 * n)[0],
        "gated_bytes": 4 * n * 2 + 4 * r + 4 * b * r,
        "gated_bound_ms": cs.bound(4 * n * 2 + 4 * r + 4 * b * r, 10 * n,
                                   exps=2 * n)[0],
        "nvidia_smi": cs.nvidia_smi_line(),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
