#!/usr/bin/env python3
"""Time versions of the P2M kernel library against each other on one card.

    python3 scripts/p2m_ab.py [--geometry NAME ...] [--kernel NAME ...]
                              [--rounds N] [--diagnose] [--unchecked C.cu]
                              [--served] A/p2m_kernels.cu B/p2m_kernels.cu ...

Each argument is a version of ``src/repro_torch/csrc/p2m_kernels.cu`` with
its own ``p2m_physics.cuh`` beside it (another commit's ``csrc`` unpacked
into a directory that ``.gitignore`` lists, or an edited copy). All are
compiled at once with the port's flags (one nvcc each, into
``build/p2m_ab/``) and driven through this checkout's wrappers. At each
geometry (by default all of ``geometries()``: the serving shape, the odd
ones of ``chip_smoke.py``, C 48 among them, and the ImageNet frame size;
``CROSSOVER``'s only by name) every checked version passes
``chip_smoke.kernel_checks`` (the plain versions and the sibling checks)
and is held to the first version (equal u and equal fused draws at both
precisions). Then each kernel's device
time is taken in turns: the versions in order, then in reverse, for
``--rounds`` rounds. Prints one JSON line per version, geometry and kernel
(its times per round, their median and spread, and its own duration from
``torch.profiler``), for each version which kernels' machine code equals
the first version's, and the card's ``nvidia-smi`` line. With
``--diagnose``, copies of the first source that each leave one stage of
the row-tile kernels out (``DIAGNOSTICS``) are timed beside it, unchecked:
their outputs are wrong by design, and their times say what that stage
costs; ``--unchecked`` adds hand-made copies timed the same way. With
``--served``, each version serves ``SERVED_STEPS`` classify steps and a
stream of as many fused steps of ``chip_smoke.py``'s full-width vgg16
engine at each precision in turns, and the device time of each frontend
kernel inside those steps (where it starts cold between the backbone's
kernels) is printed like the kernel times; without ``--geometry`` it times no kernel back to back. Needs a
CUDA card and exits non-zero without one. The building and
the turns are ``ab_versions.py``'s, shared with ``flash_ab.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import ab_versions

ROUNDS = 3
# classify steps a version serves in each profiled turn of --served
SERVED_STEPS = 10
# each kernel wrapper and the device kernel family it launches (kernel A:
# phase_a_kernel, or phase_a_warp_kernel / phase_a_q8_warp_kernel on
# warp-owned tiles; the legacy kernel: legacy_conv_kernel, or
# legacy_warp_kernel)
KERNELS = {"p2m_fused_stream": "fused_stream_kernel",
           "p2m_fused_stream_q8": "fused_stream_kernel",
           "p2m_phase_a_implicit": "phase_a_",
           "p2m_phase_a_implicit_q8": "phase_a_",
           "p2m_phase_b": "phase_b_kernel", "p2m_conv": "legacy_",
           "p2m_phase_a": "phase_a_"}
# (old text, new text) of p2m_kernels.cu for each diagnostic copy
DIAGNOSTICS = {
    # the row-tile kernels' statistics: no warp sums, barrier or partials
    "no_reductions": ("    if (Epi::kStats > 0) {\n",
                      "    if (Epi::kStats < 0) {\n"),
    # the device chain: the draw is u > theta, v is u
    "no_chain": ("    const float draw = p2m_chain(ph, u, th, chan4,\n"
                 "                                 static_cast<uint32_t>(flat)"
                 ", k0, k1, &v);\n",
                 "    v = u;\n"
                 "    const float draw = u > th ? 1.0f : 0.0f;\n"),
    # the implicit gather: every patch value is a constant
    "const_gather": ("      cp_async4(dst + col, ok ? img + origin + "
                     "tab[kTab * col] : img, ok);\n",
                     "      dst[col] = ok ? 0.25f : 0.0f;\n"),
    # the f32 MAC's circuit curves (two tanhf and two divisions an output)
    "no_curve": ("      u[i] = p2m_curve(ph, a_pos[i]) - p2m_curve(ph, "
                 "a_neg[i]);\n",
                 "      u[i] = a_pos[i] - a_neg[i];\n"),
    # the f32 MAC over the first four k only
    "short_mac": ("    const float* x0 = xs + r0 * xstride;\n",
                  "    const float* x0 = xs + r0 * xstride;\n"
                  "    kk = kk < 4 ? kk : 4;\n"),
    # kernel A's u left unstored
    "no_store": ("    dst[flat] = u;\n    const float zc = clip01(u / vth);\n",
                 "    if (u == 1234.5f) dst[flat] = u;\n"
                 "    const float zc = clip01(u / vth);\n"),
    # kernel B's warp sums: each tile's partial row is lane 0's own values
    "b_no_reductions": ("    v_sum = warp_reduce(v_sum, SumOp());\n"
                        "    v_min = warp_reduce(v_min, MinOp());\n"
                        "    v_max = warp_reduce(v_max, MaxOp());\n", ""),
    # kernel B without its chain: the draw is u > theta, v is u
    "b_no_chain": ("      const float draw = p2m_chain(ph, x[i], th, chan4,\n"
                   "                                   static_cast<uint32_t>"
                   "(idx), k0, k1, &v);\n",
                   "      v = x[i];\n"
                   "      const float draw = x[i] > th ? 1.0f : 0.0f;\n"),
    # kernel B's channel rows as constants, not read from shared memory
    "b_const_chan": ("        const float chan4[4] = {chan_s[kChanUGain * c + ch],"
                     "\n",
                     "        const float chan4[4] = {1.0f, 0.0f, 1.0f, 0.0f};"
                     "\n        const float unused[4] = {chan_s[kChanUGain * c"
                     " + ch],\n"),
    # int8 kernel A's warp butterflies: each warp sum is its lane 0's rows
    "q8_no_reductions": ("    const float abs_w8 = warp_sums(abs_w, lane);\n"
                         "    const float sq_w8 = warp_sums(sq_w, lane);\n",
                         "    const float abs_w8 = abs_w[0];\n"
                         "    const float sq_w8 = sq_w[0];\n"),
    # int8 kernel A's gather: every patch value is a constant
    "q8_const_gather": ("          x[r] = ok ? __ldg(src.img + o.base + t[0])"
                        " : 0.0f;\n",
                        "          x[r] = ok ? 0.25f : 0.0f;\n"),
    # int8 kernel A's u left unstored
    "q8_no_store": ("            u_chip[static_cast<int64_t>(row0 + r) * c"
                    " + ch] = u;\n",
                    "            if (u == 1234.5f) u_chip[static_cast<int64_t>("
                    "row0 + r) * c + ch] = u;\n"),
    # f32 kernel A's warp-owned tiles (f32_phase_a_loop): no warp sums, each
    # warp sum is its lane 0's rows
    "f32_no_reductions": ("    const float abs_t = warp_sums(abs_w, lane);\n"
                          "    const float sq_t = warp_sums(sq_w, lane);\n",
                          "    const float abs_t = abs_w[0];\n"
                          "    const float sq_t = sq_w[0];\n"),
    # their implicit gather: every patch value is a constant
    "f32_const_gather": ("      cp_async4(dst + col, ok ? img + o.base + "
                         "tab[kTab * col] : img, ok);\n",
                         "      dst[col] = ok ? 0.25f : 0.0f;\n"),
    # their circuit curves
    "f32_no_curve": ("  const bool tanh_curve = ph.curve == 1;\n",
                     "  const bool tanh_curve = false;\n"),
    # their u left unstored
    "f32_no_store": ("            u_row[r * c] = u[r];\n",
                     "            if (u[r] == 1234.5f) u_row[r * c] = u[r];\n"),
    # their MAC over the first four k only
    "f32_short_mac": ("  float a_pos[kTileRows], a_neg[kTileRows];\n",
                      "  float a_pos[kTileRows], a_neg[kTileRows];\n"
                      "  kk = kk < 4 ? kk : 4;\n"),
    # the legacy kernel's warp-owned tiles (legacy_warp_kernel): the device
    # chain left out, the draw is u > theta
    "legacy_no_chain": ("        chain_tile<M>(ph, u, th, chan4, "
                        "static_cast<uint32_t>(idx0), c, k0,\n",
                        "        for (int r = 0; r < kTileRows; ++r)\n"
                        "          draws[r] = u[r] > th ? 1.0f : 0.0f;\n"
                        "        if (false) chain_tile<M>(ph, u, th, chan4, "
                        "static_cast<uint32_t>(idx0), c, k0,\n"),
    # their MAC over the first four k only
    "legacy_short_mac": ("        f32_u_tile(ph, wp + ch, xs, xstride, kk, c, "
                         "u);\n",
                         "        f32_u_tile(ph, wp + ch, xs, xstride, "
                         "kk < 4 ? kk : 4, c, u);\n"),
    # their draws left unstored
    "legacy_no_store": ("          if (r < live) dst[r * c] = draws[r];\n",
                        "          if (r < live && u[r] == 1234.5f) "
                        "dst[r * c] = draws[r];\n"),
    # the int8 kernels' circuit curves (two tanhf and two divisions an output)
    "q8_no_curve": ("  return p2m_curve(ph, static_cast<float>(a_pos) * dq[ch])\n"
                    "         - p2m_curve(ph, static_cast<float>(a_neg) * "
                    "dq[c + ch]);\n",
                    "  return static_cast<float>(a_pos) * dq[ch]\n"
                    "         - static_cast<float>(a_neg) * dq[c + ch];\n"),
}


# 16 frames of 40² to 160² (400, 576, 784, 1,024, 1,089, 1,296, 1,600,
# 2,304, 3,136, 4,096 and 6,400 row tiles): where kernel A's and the legacy
# kernel's warp-owned tiles and their block-shared ones cross over. Timed
# only when named with --geometry.
CROSSOVER = {f"frames{h}": dict(batch=16, h=h, w=h, kernel=3, stride=2, c=32)
             for h in (40, 48, 56, 64, 66, 72, 80, 96, 112, 128, 160)}


def geometries() -> dict:
    ab_versions.import_checkout()
    import chip_smoke as cs
    odd = {f"odd_k{g['kernel']}s{g['stride']}_c{g['c']}": g
           for g in cs.ODD_GEOMETRIES}
    return {"serving": cs.SERVING, **odd, "imagenet": cs.IMAGENET}


def calls(x: dict) -> dict:
    """Kernel name -> a no-argument call of its wrapper on the operands of
    ``chip_smoke.kernel_checks``."""
    from repro_torch.kernels import p2m_conv as pk
    im, wm, w8, dq, v_th, kw, key = (x[n] for n in ("images", "wm", "w8", "dq",
                                                    "v_th", "kw", "key"))
    return {
        "p2m_fused_stream": lambda: pk.p2m_fused_stream(
            im, wm, v_th, x["theta"], key, **kw),
        "p2m_fused_stream_q8": lambda: pk.p2m_fused_stream_q8(
            im, w8, dq, v_th, x["theta8"], key, **kw),
        "p2m_phase_a_implicit": lambda: pk.p2m_phase_a_implicit(
            im, wm, v_th, **kw),
        "p2m_phase_a_implicit_q8": lambda: pk.p2m_phase_a_implicit_q8(
            im, w8, dq, v_th, **kw),
        "p2m_phase_b": lambda: pk.p2m_phase_b(x["u"], x["theta"], key),
        "p2m_conv": lambda: pk.p2m_conv(x["patches"], wm, x["theta"], key),
        "p2m_phase_a": lambda: pk.p2m_phase_a(x["patches"], wm, v_th),
    }


def served_turns(sources, rounds: int, load) -> dict:
    """``{source: [{"<precision>:<kernel>": in-step ms}, ...]}``, one dict
    a round: each version serves SERVED_STEPS classify steps, then a stream
    of SERVED_STEPS fused steps, at f32 and at int8 (the tile table's entry
    at the serving key) under the profiler, in turns; the frontend
    kernels' device ms per launch inside them."""
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import autotune
    _, _, frames, engine = cs.vision_engine(torch.device("cuda"))

    def measure():
        out = {}
        for precision in ("f32", "int8"):
            autotune.clear()
            if precision == "int8":
                autotune.put(*cs.SERVING_KEY, autotune.TileChoice(
                    fused=True, precision="int8"))
            # a library's first launch of a kernel loads its module
            for _ in range(2):
                engine.classify(frames[0])
            prof, _ = cs.profile_session(
                lambda: [engine.classify(frames[0])
                         for _ in range(SERVED_STEPS)],
                expect=cs.KERNEL_SYMBOLS[cs.STEP_KERNELS[precision][0]])
            out.update({f"{precision}:{k}": v for k, v in
                        cs.step_kernel_ms(prof, precision).items()})
            # a stream's steps after its first run the fused kernel
            fused = cs.FUSED_KERNEL[precision]
            prof, _ = cs.profile_session(
                lambda: list(engine.stream([frames[1]] * (SERVED_STEPS + 1))),
                expect=cs.KERNEL_SYMBOLS[fused])
            out[f"{precision}:{fused}"] = cs.kernel_event_ms(
                prof, cs.KERNEL_SYMBOLS[fused])
        autotune.clear()
        return out
    return ab_versions.in_turns(sources, rounds, load, measure)


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", action="append", default=None)
    parser.add_argument("--kernel", action="append", default=None)
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("--diagnose", action="store_true")
    # hand-made copies timed beside the others, unchecked like --diagnose's
    parser.add_argument("--unchecked", action="append", default=[])
    parser.add_argument("--served", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or not args.sources:
        print("usage: p2m_ab.py [--geometry NAME] [--kernel NAME] "
              "[--diagnose] A.cu B.cu ... (on a machine with a CUDA card)",
              file=sys.stderr)
        return 1
    geoms = {**geometries(), **CROSSOVER}
    kernels = args.kernel or list(KERNELS)
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib

    sources = [os.path.abspath(s) for s in args.sources]
    out_dir = os.path.join(ab_versions.ROOT, "build", "p2m_ab")
    os.makedirs(out_dir, exist_ok=True)
    unchecked = (ab_versions.diagnostic_sources(sources[0], out_dir,
                                                DIAGNOSTICS)
                 if args.diagnose else [])
    # a diagnostic copy includes the header beside the source it copies
    include = {src: os.path.dirname(sources[0]) for src in unchecked}
    unchecked += [os.path.abspath(s) for s in args.unchecked]
    sources += unchecked
    libs, ptxas = {}, {}
    for src, (lib, log) in ab_versions.build_versions(
            sources, cuda_lib.P2M.flags, out_dir, include).items():
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln or "Compiling" in ln]
        cuda_lib._bind_p2m(lib)
        libs[src] = lib

    def load(src):
        cuda_lib._LOADED[cuda_lib.P2M.name] = libs[src]

    # which kernels' machine code each version shares with the first
    sass = {src: ab_versions.sass_by_kernel(lib._name)
            for src, lib in libs.items() if src not in unchecked}
    for src in sass:
        print(json.dumps({"source": src, "sass_equal_to_first": {
            k: code == sass[sources[0]][k] for k, code in sass[src].items()
            if k in sass[sources[0]]}}), flush=True)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    for src in sources:
        print(json.dumps({"source": src, "checked": src not in unchecked,
                          "ptxas": ptxas[src]}), flush=True)
    if args.served:
        turns = served_turns(sources, args.rounds, load)
        for src in sources:
            for k in turns[src][0]:
                t = [r[k] for r in turns[src]]
                known = [x for x in t if x is not None]
                print(json.dumps({
                    "served": k, "steps": SERVED_STEPS, "source": src,
                    "checked": src not in unchecked, "ms": t,
                    "median_ms": statistics.median(known) if known else None,
                    "spread_ms": max(known) - min(known) if known else None}),
                      flush=True)
    for name in args.geometry or ([] if args.served else list(geometries())):
        first = None
        for src in sources:
            if src in unchecked:
                continue
            load(src)
            got = cs.kernel_checks(geoms[name], dev)
            first = first or got
            for out in ("u", "acts_f", "u8", "acts8_f"):
                cs.check(torch.equal(got[out], first[out]),
                         f"{src}: {out} differs from {sources[0]} at {name}")
        fns = calls(first)
        turns = ab_versions.in_turns(
            sources, args.rounds, load,
            lambda: {k: cs.device_ms(fns[k], dev) for k in kernels})
        for src in sources:
            load(src)
            for k in kernels:
                t = [r[k] for r in turns[src]]
                print(json.dumps({
                    "geometry": name, "shape": geoms[name], "source": src,
                    "checked": src not in unchecked, "kernel": k, "ms": t,
                    "median_ms": statistics.median(t),
                    "spread_ms": max(t) - min(t),
                    "profiler_ms": cs.profiled_ms(fns[k], KERNELS[k])}),
                      flush=True)
    print(json.dumps({"nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
