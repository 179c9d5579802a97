#!/usr/bin/env python3
"""Time versions of the flash-attention library against each other on one card.

    python3 scripts/flash_ab.py A.cu B.cu [...]

Each argument is a version of ``src/repro_torch/csrc/flash_attention.cu``
(the file from another commit, or an edited copy). All are compiled at
once with the port's flags (one nvcc each, into ``build/flash_ab/``). Then,
at the LM serving geometry of ``chip_smoke.py`` (B 4, S 2048, H 32/8, D 128,
bf16), each version is held against the plain version (max-abs 2e-2) and
its device time is taken causal and non-causal, in turns: the versions in
order, then in reverse, for three rounds, so that versions are compared on
one card within one run. Prints one JSON line per version (its times and
any ptxas warning that the wgmmas were serialized) and one for
``scaled_dot_product_attention`` on the same inputs. Needs a CUDA card and
exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3


def main(sources) -> int:
    import torch
    if not torch.cuda.is_available() or not sources:
        print("usage: flash_ab.py A.cu B.cu ... (on a machine with a CUDA "
              "card)", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa

    out_dir = os.path.join(ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    builds = []
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"lib_{i}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.FLASH.flags, "-o", so, src]
        builds.append((src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, serialized = {}, {}
    for src, so, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        serialized[src] = [ln.strip() for ln in log.splitlines()
                           if "serialized" in ln]
        lib = ctypes.CDLL(so)
        cuda_lib._bind_flash(lib)
        libs[src] = lib

    geom = cs.FLASH_SERVING
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    plain = fa.flash_attention_plain(q, k, v, causal=True).float()
    times = {src: {"causal": [], "noncausal": []} for src in sources}
    for rnd in range(ROUNDS):
        for src in (sources if rnd % 2 == 0 else sources[::-1]):
            cuda_lib._LOADED[cuda_lib.FLASH.name] = libs[src]
            err = float((fa.flash_attention(q, k, v).float() - plain)
                        .abs().max())
            cs.check(err <= cs.FLASH_TOL["bfloat16"],
                     f"{src}: max-abs {err} against the plain version")
            for key, causal in (("causal", True), ("noncausal", False)):
                times[src][key].append(cs.device_ms(
                    lambda: fa.flash_attention(q, k, v, causal=causal), dev))
    for src in sources:
        print(json.dumps({"source": src, "ms": times[src],
                          "median_ms": {key: statistics.median(t)
                                        for key, t in times[src].items()},
                          "wgmma_serialized": serialized[src]}))
    sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), dev)
    print(json.dumps({"sdpa_causal_ms": sdpa,
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
