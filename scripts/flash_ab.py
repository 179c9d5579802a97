#!/usr/bin/env python3
"""Time versions of the flash-attention library against each other on one card.

    python3 scripts/flash_ab.py [--geometry NAME ...] [--diagnose] A.cu ...

Each argument is a version of ``src/repro_torch/csrc/flash_attention.cu``
(the file from another commit, or an edited copy). All are compiled at
once with the port's flags (one nvcc each, into ``build/flash_ab/``). Then,
at each geometry (by default all of ``geometries()``: granite-8b's
prefill, B 4, S 2048, H 32/8, D 128; stablelm-3b's at B 4 and B 1, S 2048,
H 32 MHA, D 80; the same at D 64 and D 128; all bf16), each version is held
against the plain version (max-abs 2e-2) and its device time is taken causal and
non-causal, in turns: the versions in order, then in reverse, for three
rounds, so that versions are compared on one card within one run. Prints
one JSON line per version and geometry (its times and any ptxas warning
that the wgmmas were serialized) and one per geometry for
``scaled_dot_product_attention`` on the same inputs. With ``--diagnose``,
copies of the first source that each leave one stage of the per-tile work
out (``DIAGNOSTICS``) are timed beside it, unchecked: their outputs are
wrong by design, and their times say what that stage costs. Needs a CUDA
card and exits non-zero without one. The building and the turns are
``ab_versions.py``'s, shared with ``p2m_ab.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import ab_versions

ROUNDS = 3
# (old text, new text) of flash_attention.cu for each diagnostic copy
DIAGNOSTICS = {
    # e^x without the special-function unit: the exponent's FMA alone
    "no_exp": ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
               '"f"(fmaf(s, c, -mc)));', "y = fmaf(s, c, -mc);"),
    # no online softmax at all: P is the raw scores, alpha 1
    "no_softmax": ("const FlashGeom& g, const int (&rows)[2], int k0, int "
                   "tig, bool edge) {",
                   "const FlashGeom& g, const int (&rows)[2], int k0, int "
                   "tig, bool edge) {\n  alpha[0] = alpha[1] = 1.f;\n"
                   "  return;"),
    # no O += P V product
    "no_pv": ("    wgmma_rs<D>(acc, pa[kk], smem_desc(v_tile + kk * 2048, "
              "kBoxBytes, 1024));", "    ;"),
}


def geometries() -> dict:
    ab_versions.import_checkout()
    import chip_smoke as cs
    d80 = cs.FLASH_D80_SERVING
    return {"granite_d128_b4": cs.FLASH_SERVING,
            "stablelm_d80_b4": d80,
            "stablelm_d80_b1": {**d80, "batch": 1},
            "mha_d64_b4": {**d80, "head_dim": 64},
            "mha_d128_b4": {**d80, "head_dim": 128}}


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", action="append", default=None)
    parser.add_argument("--diagnose", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or not args.sources:
        print("usage: flash_ab.py [--geometry NAME] A.cu B.cu ... (on a "
              "machine with a CUDA card)", file=sys.stderr)
        return 1
    geoms = geometries()
    names = args.geometry or list(geoms)
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa

    sources = list(args.sources)
    out_dir = os.path.join(ab_versions.ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    unchecked = (set(ab_versions.diagnostic_sources(sources[0], out_dir,
                                                    DIAGNOSTICS))
                 if args.diagnose else set())
    sources += sorted(unchecked)
    libs, serialized = {}, {}
    for src, (lib, log) in ab_versions.build_versions(
            sources, cuda_lib.FLASH.flags, out_dir).items():
        serialized[src] = [ln.strip() for ln in log.splitlines()
                           if "serialized" in ln]
        cuda_lib._bind_flash(lib)
        libs[src] = lib

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    for name in names:
        geom = geoms[name]
        gen = torch.Generator().manual_seed(23)
        b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                             "kv_heads", "head_dim"))
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, d)))
        plain = fa.flash_attention_plain(q, k, v, causal=True).float()
        current = {}

        def load(src):
            cuda_lib._LOADED[cuda_lib.FLASH.name] = libs[src]
            current["src"] = src

        def measure():
            src = current["src"]
            err = float((fa.flash_attention(q, k, v).float() - plain)
                        .abs().max())
            cs.check(src in unchecked or err <= cs.FLASH_TOL["bfloat16"],
                     f"{src}: max-abs {err} against the plain version at "
                     f"{name}")
            return {key: cs.device_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), dev)
                    for key, causal in (("causal", True),
                                        ("noncausal", False))}

        turns = ab_versions.in_turns(sources, ROUNDS, load, measure)
        times = {src: {key: [r[key] for r in rounds]
                       for key in ("causal", "noncausal")}
                 for src, rounds in turns.items()}
        for src in sources:
            print(json.dumps({"geometry": name, "source": src,
                              "checked": src not in unchecked,
                              "ms": times[src],
                              "median_ms": {key: statistics.median(t)
                                            for key, t in times[src].items()},
                              "wgmma_serialized": serialized[src]}),
                  flush=True)
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=h != hkv), dev)
        print(json.dumps({"geometry": name, "sdpa_causal_ms": sdpa,
                          "nvidia_smi": smi,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
