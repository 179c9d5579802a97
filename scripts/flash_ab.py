#!/usr/bin/env python3
"""Time versions of the flash-attention library against each other on one card.

    python3 scripts/flash_ab.py [--geometry NAME ...] [--diagnose] A.cu ...

Each argument is a version of ``src/repro_torch/csrc/flash_attention.cu``
(the file from another commit, or an edited copy). All are compiled at once
with the port's flags (one nvcc each, into ``build/flash_ab/``). Then, at
each geometry (by default all of ``geometries()``: granite-8b's prefill, B
4, S 2048, H 32/8, D 128; stablelm-3b's at B 4 and B 1, S 2048, H 32 MHA, D
80; the same at D 64 and D 128, all bf16 and causal; ``chip_smoke.py``'s
two toy geometries of the narrow bf16 and the float32 routes, non-causal;
granite-8b's prefill traffic at bf16 D 32 and 16 and in float32 at D 128
and 16; deepseek-v2's MLA prefill, B 4, S 2048, H 128, qk 192 over v 128,
and kimi-k2's, H 64/8, D 112), each version is held against the plain
version (``chip_smoke.FLASH_TOL`` of the geometry's dtype) and its device
time is taken in the geometry's own mode and, for a causal geometry, non-
causal too, in turns: the versions in order, then in reverse, for three
rounds, so that versions are compared on one card within one run. Prints
one JSON line per version and geometry (its times and any ptxas warning
that the wgmmas were serialized) and one per geometry with the bound
(``chip_smoke.flash_work``) and ``scaled_dot_product_attention`` on the
same inputs in the same mode, after one line per checked version naming the
kernels whose machine code (``cuobjdump -sass``) equals the first version's
(an instance without the window flag, ``flash_wgmma_kernel<D, false>``, is
held to a first version's ``flash_wgmma_kernel<D>`` where that version
predates the flag), and how many of the first version's kernels it has with
equal code. The windowed geometries (recurrentgemma-2b's D 256 prefill at S
2048 and 8192, ``rg_*``) time the window's instances and so need versions
that have them; a version without a geometry's instance (an older source at
``mla_*`` or ``kimi_*``) is left out there. A source from before the value
dim (its ``flash_attention_fwd`` takes no ``v_dim``) is
built with a shim appended (``with_value_dim``), so one binding serves
every version. With ``--diagnose``, copies of the first source that each
leave one stage of the per-tile work out (``DIAGNOSTICS``) are timed beside
it, unchecked: their outputs are wrong by design, and their times say what
that stage costs. Needs a CUDA card and exits non-zero without one. The
building and the turns are ``ab_versions.py``'s, shared with ``p2m_ab.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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
    "no_pv": ("    wgmma_rs<Dv>(acc, pa[kk], smem_desc(v_tile + kk * 2048, "
              "kBoxBytes, 1024));", "    ;"),
    # no rescale of the accumulator by alpha after each kv tile
    "no_rescale": ("#pragma unroll\n  for (int i = 0; i < N; ++i) "
                   "acc[i] *= alpha[(i >> 1) & 1];\n", ""),
    # no K / V loads past a block's first ring of stages: the producer
    # completes each later stage's barriers without a copy, and the
    # products read the stale tiles (L2 to shared traffic left out)
    "no_kv_loads": (
        "          mbar_expect_tx(full_k + 8 * s, kTileBytes);\n",
        "          if (round > 0) {\n"
        "            mbar_wait(empty_v + 8 * s, (round - 1) & 1);\n"
        "            mbar_arrive(full_k + 8 * s);\n"
        "            mbar_arrive(full_v + 8 * s);\n"
        "            continue;\n"
        "          }\n"
        "          mbar_expect_tx(full_k + 8 * s, kTileBytes);\n"),
    # the FFMA kernel (float32): e^x as the exponent's FMA alone
    "f32_no_exp": ("          float p = exp_diff(s[i][cc], c, mc);",
                   "          float p = fmaf(s[i][cc], c, -mc);"),
    # no P V product (its loads go with it)
    "f32_no_pv": (
        "              acc[r][4 * ch + 0] = fmaf(p, vv.x, acc[r][4 * ch + 0]);\n"
        "              acc[r][4 * ch + 1] = fmaf(p, vv.y, acc[r][4 * ch + 1]);\n"
        "              acc[r][4 * ch + 2] = fmaf(p, vv.z, acc[r][4 * ch + 2]);\n"
        "              acc[r][4 * ch + 3] = fmaf(p, vv.w, acc[r][4 * ch + 3]);",
        "              (void)p;"),
    # no K / V loads past the first tile (every tile reuses the first)
    "f32_no_loads": ("    const bool more = j + 1 < t.n_kv;",
                     "    const bool more = false;"),
    # no S = Q K^T product (scores 0; its loads go with it)
    "f32_no_scores": (
        "            s[i][cc] = fmaf(qv.x, kv[cc].x, s[i][cc]);\n"
        "            s[i][cc] = fmaf(qv.y, kv[cc].y, s[i][cc]);\n"
        "            s[i][cc] = fmaf(qv.z, kv[cc].z, s[i][cc]);\n"
        "            s[i][cc] = fmaf(qv.w, kv[cc].w, s[i][cc]);", ""),
}


# the shim that gives a source from before the value dim this tree's C
# interface: its two entries renamed by the preprocessor, then wrappers of
# the new signatures that take Dv == D only
SHIM_HEAD = ("#define flash_attention_fwd flash_attention_fwd_no_dv\n"
             "#define flash_attention_kernel flash_attention_kernel_no_dv\n")
SHIM_TAIL = """
#undef flash_attention_fwd
#undef flash_attention_kernel
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   int head_dim, int v_dim,
                                   const FlashGeom* g, void* stream) {
  if (v_dim != head_dim) return static_cast<int>(cudaErrorInvalidValue);
  return flash_attention_fwd_no_dv(q, k, v, o, dtype, head_dim, g, stream);
}
extern "C" const char* flash_attention_kernel(int dtype, int head_dim,
                                              int v_dim, int window,
                                              int seq) {
  if (v_dim != head_dim) return nullptr;
  return flash_attention_kernel_no_dv(dtype, head_dim, window, seq);
}
"""


def with_value_dim(source: str, out_dir: str, i: int) -> str:
    """``source`` itself if its ``flash_attention_fwd`` takes a value dim,
    else a copy with the shim (``SHIM_HEAD`` / ``SHIM_TAIL``) in
    ``out_dir``."""
    text = open(source).read()
    if "int head_dim, int v_dim" in text:
        return source
    path = os.path.join(out_dir, f"shim_{i}.cu")
    with open(path, "w") as f:
        f.write(SHIM_HEAD + text + SHIM_TAIL)
    return path


def geometries() -> dict:
    ab_versions.import_checkout()
    import chip_smoke as cs
    d80 = cs.FLASH_D80_SERVING
    return {"granite_d128_b4": cs.FLASH_SERVING,
            "stablelm_d80_b4": d80,
            "stablelm_d80_b1": {**d80, "batch": 1},
            "mha_d64_b4": {**d80, "head_dim": 64},
            "mha_d128_b4": {**d80, "head_dim": 128},
            "narrow_d32_toy": cs.FLASH_NARROW_TOY,
            "f32_d128_toy": cs.FLASH_F32_TOY,
            **cs.FLASH_B4,
            "rg_d256_b4": cs.FLASH_RG_SERVING,
            "rg_d256_s8192": cs.FLASH_WINDOWED[1],
            "mla_d192_v128_b4": cs.FLASH_MLA_SERVING,
            "kimi_d112_b4": cs.FLASH_KIMI_SERVING}


def ptxas_usage(log: str) -> dict:
    """``{"wgmma<D, W>" or "ffma<D, W>": [registers, spill store bytes +
    spill load bytes]}`` of each flash kernel instance, from nvcc's
    ``-Xptxas -v`` log (a setmaxnreg kernel reports its launch bound's
    registers)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?\S*flash_(wgmma|ffma)_kernelILi(\d+)ELb([01])E",
                      line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out.setdefault(name, [0, 0])[1] = int(spill.group(1)) + int(
                spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.setdefault(name, [0, 0])[0] = int(used.group(1))
            name = None
    return out


def first_name(kernel: str, first: dict) -> str:
    """The first version's name of ``kernel``: its own, or, for an instance
    without the window flag (``...ILi128ELb0EE...``) where the first
    version predates the flag, the flagless one (``...ILi128EE...``)."""
    return kernel if kernel in first else kernel.replace("Lb0E", "", 1)


def checked_tolerance(geom: dict) -> float:
    """The max-abs limit a checked version is held to at ``geom``: that of
    the geometry's dtype in ``chip_smoke.py``."""
    ab_versions.import_checkout()
    import chip_smoke as cs
    return cs.FLASH_TOL[geom["dtype"]]


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
    built = {with_value_dim(src, out_dir, i): src
             for i, src in enumerate(sources)}
    libs, serialized, usage = {}, {}, {}
    for path, (lib, log) in ab_versions.build_versions(
            list(built), cuda_lib.FLASH.flags, out_dir).items():
        src = built[path]
        serialized[src] = [ln.strip() for ln in log.splitlines()
                           if "serialized" in ln]
        usage[src] = ptxas_usage(log)
        cuda_lib._bind_flash(lib)
        libs[src] = lib

    # which kernels of each version have the first version's machine code
    sass = {src: ab_versions.sass_by_kernel(lib._name)
            for src, lib in libs.items() if src not in unchecked}
    first = sass[sources[0]]
    for src in sass:
        equal = {k: code == first[first_name(k, first)]
                 for k, code in sass[src].items()
                 if first_name(k, first) in first}
        print(json.dumps({"source": src, "sass_equal_to_first": equal,
                          "kernels_equal": sum(equal.values()),
                          "kernels_in_both": len(equal),
                          "kernels_not_in_first": sorted(
                              set(sass[src]) - set(equal))}), flush=True)

    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    for name in names:
        geom = geoms[name]
        gen = torch.Generator().manual_seed(23)
        b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                             "kv_heads", "head_dim"))
        dv = geom.get("v_dim", d)
        dtype, causal = getattr(torch, geom["dtype"]), geom["causal"]
        window = geom.get("window", 0)
        tol = checked_tolerance(geom)
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, dv)))
        # the versions that have this geometry's instance
        code = 1 if dtype == torch.bfloat16 else 0
        here = [src for src in sources if libs[src].flash_attention_kernel(
            code, d, dv, window, s) is not None]
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window).float()
        modes = (("causal", True), ("noncausal", False)) if causal else (
            ("noncausal", False),)
        current = {}

        def load(src):
            cuda_lib._LOADED[cuda_lib.FLASH.name] = libs[src]
            current["src"] = src

        def measure():
            src = current["src"]
            err = float((fa.flash_attention(q, k, v, causal=causal,
                                            window=window).float()
                         - plain).abs().max())
            cs.check(src in unchecked or err <= tol,
                     f"{src}: max-abs {err} against the plain version at "
                     f"{name}")
            return {key: cs.device_ms(
                lambda: fa.flash_attention(q, k, v, causal=c,
                                           window=window if c else 0), dev)
                    for key, c in modes}

        turns = ab_versions.in_turns(here, ROUNDS, load, measure)
        times = {src: {key: [r[key] for r in rounds] for key, _ in modes}
                 for src, rounds in turns.items()}
        for src in here:
            print(json.dumps({"geometry": name, "source": src,
                              "checked": src not in unchecked,
                              "ms": times[src],
                              "median_ms": {key: statistics.median(t)
                                            for key, t in times[src].items()},
                              "wgmma_serialized": serialized[src],
                              "registers_spill_bytes": {
                                  k: u for k, u in usage[src].items()
                                  if f"<{d}, " in k}}),
                  flush=True)
        if dv != d:
            backend, sdpa = cs.sdpa_backend_ms(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal, dev)
        else:
            backend = "default"
            sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=h != hkv), dev)
        print(json.dumps({"geometry": name, **geom, "sdpa_backend": backend,
                          "sdpa_ms": sdpa, **cs.flash_work(geom),
                          "nvidia_smi": smi,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
