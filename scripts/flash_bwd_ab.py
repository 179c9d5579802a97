#!/usr/bin/env python3
"""Time versions of the flash-attention backward library against each other.

    python3 scripts/flash_bwd_ab.py [--geometry NAME ...] [--rounds N]
        [--diagnose] A.cu ...

Each argument is a version of ``src/repro_torch/csrc/flash_attention_bwd.cu``
(the file from another commit, or an edited copy). All are compiled at once
with the port's flags (one nvcc each, into ``build/flash_bwd_ab/``) and
driven through this checkout's wrapper, ``flash_attention_bwd``. For each
version the script prints the compiler's report of its ``flash_bwd_``
kernels (registers, spill bytes, any warning that the wgmmas were
serialized) and their tensor-core instructions (HMMA, HGMMA) from the
machine code. Then, at each geometry (by default all of
``chip_smoke.FLASH_BWD_GEOMS``: stablelm-3b's training step, B 4, S 2048,
H 32, D 80; granite-8b's, H 32/8, D 128, both bf16 and causal; the reduced
configs' float32 D 16), every version is held against the plain version
(``chip_smoke.grad_row_err`` within ``chip_smoke.FLASH_BWD_TOL``, finite,
two launches bit for bit equal) and its device time is taken in turns: the
versions in order, then in reverse, for ``--rounds`` rounds, so that
versions are compared on one card within one run. Prints one JSON line per
version and geometry (its times, their median, each kernel's device ms
from a profiler session, its gradient errors) and
one per geometry with the bound (``chip_smoke.flash_bwd_work``), the
backward of ``scaled_dot_product_attention`` on the same inputs
(torch.autograd, the library's yardstick) and the card's ``nvidia-smi``
line. With ``--diagnose``, copies of the first source that each leave one
stage out (``DIAGNOSTICS``: the exponentials, the later loads of either
kernel's ring) are timed beside it, unchecked: their gradients are wrong by
design, and their times say what that stage costs. Needs a CUDA card and
exits non-zero without one. The building and the turns are
``ab_versions.py``'s, shared with ``flash_ab.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import ab_versions

ROUNDS = 3
# (old text, new text) of flash_attention_bwd.cu for each diagnostic copy
# (--diagnose): their gradients are wrong by design, their times say what
# the left-out stage costs
DIAGNOSTICS = {
    # e^x without the special-function unit: the exponent's FMA alone
    "no_exp": ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = x;"),
    # the dq kernel's ring loads K and V in its first round only
    "no_kv_loads": ("        mbar_expect_tx(full + 8 * s, L::kDqStage);",
                    "        if (round > 0) {\n          mbar_arrive(full + 8 "
                    "* s);\n          continue;\n        }\n        "
                    "mbar_expect_tx(full + 8 * s, L::kDqStage);"),
    # the dk / dv kernel's ring loads q, do, lse and delta in its first
    # round only
    "no_q_loads": ("          mbar_expect_tx(full + 8 * s, 2 * L::kQTile + 2 "
                   "* L::kStatBytes);",
                   "          if (round > 0) {\n            mbar_arrive(full "
                   "+ 8 * s);\n            continue;\n          }\n        "
                   "  mbar_expect_tx(full + 8 * s, 2 * L::kQTile + 2 * "
                   "L::kStatBytes);"),
}


def geometries() -> dict:
    ab_versions.import_checkout()
    import chip_smoke as cs
    return dict(cs.FLASH_BWD_GEOMS)


def kernel_report(log: str, census: dict) -> dict:
    """``{kernel: {"registers", "spill_bytes", "hmma", "hgmma"}}`` of the
    ``flash_bwd_`` kernels of one build, from its ``-Xptxas -v`` log and
    its tensor-core census (mangled names)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1) if "flash_bwd_" in found.group(1) else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out.setdefault(name, {})["spill_bytes"] = int(
                spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.setdefault(name, {})["registers"] = int(used.group(1))
            name = None
    for kernel, (hmma, hgmma) in census.items():
        out.setdefault(kernel, {}).update(hmma=hmma, hgmma=hgmma)
    return out


def kernel_ms(run, calls: int = 5) -> dict:
    """``{kernel: device ms a call}`` of the ``flash_bwd_`` kernels that
    ``run()`` launches, from a ``torch.profiler`` session over ``calls``
    calls (``chip_smoke.profile_session``)."""
    import chip_smoke as cs
    prof, _ = cs.profile_session(lambda: [run() for _ in range(calls)],
                                 cpu=False, expect="flash_bwd_")
    return {e.key: cs.event_us(e) / 1e3 / calls
            for e in prof.key_averages() if "flash_bwd_" in e.key}


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", action="append", default=None)
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("--diagnose", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or not args.sources:
        print("usage: flash_bwd_ab.py [--geometry NAME] A.cu B.cu ... (on a "
              "machine with a CUDA card)", file=sys.stderr)
        return 1
    geoms = geometries()
    names = args.geometry or list(geoms)
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa

    sources = list(args.sources)
    out_dir = os.path.join(ab_versions.ROOT, "build", "flash_bwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    unchecked = set()
    if args.diagnose:
        unchecked = set(ab_versions.diagnostic_sources(
            sources[0], out_dir, DIAGNOSTICS))
        sources += sorted(unchecked)
    libs = {}
    for src, (lib, log) in ab_versions.build_versions(
            sources, cuda_lib.FLASH_BWD.flags, out_dir,
            include={s_: os.path.dirname(os.path.abspath(sources[0]))
                     for s_ in unchecked}).items():
        cuda_lib._bind_flash_bwd(lib)
        libs[src] = lib
        census = cuda_lib.tensor_core_census(lib._name, ("HMMA", "HGMMA"))
        print(json.dumps({"source": src, "kernels": kernel_report(
            log, {k: v for k, v in census.items() if "flash_bwd_" in k}),
            "wgmma_serialized": [ln.strip() for ln in log.splitlines()
                                 if "serialized" in ln]}), flush=True)

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    for name in names:
        geom = geoms[name]
        h, hkv = geom["heads"], geom["kv_heads"]
        causal, tol = geom["causal"], cs.FLASH_BWD_TOL[geom["dtype"]]
        q, k, v, do = cs.flash_bwd_operands(geom, dev)
        ref = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal)
        current, errors = {}, {}

        def load(src):
            cuda_lib._LOADED[cuda_lib.FLASH_BWD.name] = libs[src]
            current["src"] = src

        def measure():
            src = current["src"]
            if src in unchecked:
                return cs.device_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, do, causal=causal), dev)
            got = fa.flash_attention_bwd(q, k, v, do, causal=causal)
            errs = {n_: cs.grad_row_err(g_, r_)
                    for n_, g_, r_ in zip(("dq", "dk", "dv"), got, ref)}
            cs.check(all(bool(torch.isfinite(g_).all()) for g_ in got)
                     and max(errs.values()) <= tol,
                     f"{src}: gradient rows {errs} against the plain "
                     f"version at {name} (limit {tol})")
            cs.check(all(torch.equal(a, b_) for a, b_ in zip(
                got, fa.flash_attention_bwd(q, k, v, do, causal=causal))),
                f"{src}: two launches differ at {name}")
            errors[src] = errs
            del got
            return cs.device_ms(lambda: fa.flash_attention_bwd(
                q, k, v, do, causal=causal), dev)

        turns = ab_versions.in_turns(sources, args.rounds, load, measure)
        for src in sources:
            load(src)
            per_kernel = kernel_ms(lambda: fa.flash_attention_bwd(
                q, k, v, do, causal=causal))
            print(json.dumps({"geometry": name, "source": src,
                              "ms": turns[src],
                              "median_ms": statistics.median(turns[src]),
                              "kernel_ms": per_kernel,
                              "grad_row_rel_err": errors.get(src)}),
                  flush=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=h != hkv)
        sdpa = cs.device_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), dev)
        print(json.dumps({"geometry": name, **geom, "sdpa_bwd_ms": sdpa,
                          **cs.flash_bwd_work(geom), "nvidia_smi": smi,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del q, k, v, do, ref, qt, kt, vt, ot
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
