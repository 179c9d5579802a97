#!/usr/bin/env python3
"""Time versions of the sLSTM recurrence library against each other on one card.

    python3 scripts/slstm_ab.py [--rounds N] [--geometry NAME] [--diagnose]
                                A.cu B.cu ...

Each argument is a version of ``src/repro_torch/csrc/slstm_scan.cu`` (the
file from another commit, e.g. ``git show HEAD~:src/repro_torch/csrc/
slstm_scan.cu``, or an edited copy). All are compiled at once with the
port's flags (one nvcc each, into ``build/slstm_ab/``), each version's
register and spill report printed, and, where the version reports it
(``slstm_scan_design``), the design it launches and how many of its
clusters the card holds at once. Then, at a geometry of ``chip_smoke.py``
(``geometries()``; by default ``serving``, xlstm-350m's prefill: B 4, S
2048, 4 heads of 256, bf16 weights), each version runs in turns (the
versions in order, then in reverse, round after round, on one card within
one run):

* ``prefill``: one call over the whole sequence from no carry;
* ``decode``: one one-token call that advances a drawn carry in place
  (alone behind a sleep kernel; as one of ``DECODE_ROW`` calls back to
  back, ``decode_in_a_row``; and the kernel's own duration from
  ``torch.profiler``, ``decode_profiler``).

Each version's hs and carry of both calls are compared with the first
version's with ``torch.equal`` (``equal_to_first``), and the first
version's are held against the plain version at ``chip_smoke.SLSTM_TOL``.
With ``--diagnose``, copies of this checkout's source (``DIAGNOSTICS``)
are timed beside them: ``no_fma`` (the dot left out: what a step costs
without its FMAs, the exchange and wait floor with the update),
``no_h_loads`` (h read once a weight chunk and not once a d),
``no_chain`` (the gates' update left out) and ``no_staging`` (no weights
read from global memory), wrong by design and unchecked, and
``cluster16`` (clusters of 16 blocks of 16 columns, a non-portable size:
the same arithmetic, so held equal too). Prints one JSON line per version
(device ms, median of each ``chip_smoke.device_ms``, per round and their
medians, the prefill's us a step, the decode call's us, and the distinct
SMs of one prefill's blocks where the version launches this tree's
design), then one
with the bounds (``chip_smoke.slstm_work``), the card's name and its
``nvidia-smi`` line. Needs a CUDA card and exits non-zero without one. The
building and the turns are ``ab_versions.py``'s, shared with
``flash_ab.py``, ``p2m_ab.py`` and ``rglru_ab.py``.
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
DECODE_ROW = 10       # decode calls timed back to back
SOURCE = os.path.join(ab_versions.ROOT, "src", "repro_torch", "csrc",
                      "slstm_scan.cu")
# (old text, new text) of slstm_scan.cu for each diagnostic copy
DIAGNOSTICS = {
    # no dot: the pre-activations are x and b alone
    "no_fma": ("    column_dots<W, kRows>(w_s, h_s + (t & 1) * dh * kRows, "
               "dh, acc);\n", ""),
    # h loaded once a weight chunk, not once a d
    "no_h_loads": ("      load_h<kRows>(h_p + i * kRows, h[i]);",
                   "      load_h<kRows>(h_p, h[i]);"),
    # no update chain: h is one pre-activation
    "no_chain": ("      if (ok[j]) h[j] = update(x[j], pre[j], bias, c[j], "
                 "n[j], m[j]);", "      if (ok[j]) h[j] = x[j][0] + "
                 "pre[j][0];"),
    # no weights read from global memory (the chunks hold junk)
    "no_staging": ("          v[k][i] = d < dh ? __ldg(src + d * dh) : "
                   "Bits(0);", "          v[k][i] = Bits(d);"),
    # clusters of up to 16 blocks, a block keeping 16 columns
    "cluster16": ("constexpr int kMaxCluster = 8, kMinCols = 32;",
                  "constexpr int kMaxCluster = 16, kMinCols = 16;"),
}
# the diagnostics whose arithmetic is the kernel's (held equal to the first)
EXACT = ("cluster16",)


def geometries() -> dict:
    """``chip_smoke.py``'s sLSTM geometries by name."""
    ab_versions.import_checkout()
    import chip_smoke as cs
    return {"serving": cs.SLSTM_SERVING, "f32_dh256": cs.SLSTM_F32,
            "narrow": cs.SLSTM_NARROW}


def bind(lib) -> bool:
    """Type a built version's entries; True where it reports its design."""
    from repro_torch.kernels import cuda_lib
    cuda_lib._bind_slstm(lib)
    return hasattr(lib, "slstm_scan_design")


def library_design(lib, geom: dict) -> dict:
    """What a built version launches at ``geom`` (its ``slstm_scan_design``
    report), or the code it returned."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    out = (ctypes.c_int * len(ss.LIBRARY_DESIGN_FIELDS))()
    n = lib.slstm_scan_design(geom["batch"], geom["heads"], geom["head_dim"],
                              ss._W_DTYPES[getattr(torch, geom["w_dtype"])],
                              out)
    return dict(zip(ss.LIBRARY_DESIGN_FIELDS, out)) if n > 0 else {"code": n}


def main(argv) -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("--geometry", default="serving")
    parser.add_argument("--diagnose", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or not args.sources:
        print("usage: slstm_ab.py [--geometry NAME] [--diagnose] A.cu B.cu "
              "... (on a machine with a CUDA card)", file=sys.stderr)
        return 1
    ab_versions.import_checkout()
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import slstm_scan as ss

    geom = geometries()[args.geometry]
    out_dir = os.path.join(ab_versions.ROOT, "build", "slstm_ab")
    sources = list(args.sources)
    diag = {}
    if args.diagnose:
        os.makedirs(out_dir, exist_ok=True)
        paths = ab_versions.diagnostic_sources(SOURCE, out_dir, DIAGNOSTICS)
        diag = dict(zip(paths, DIAGNOSTICS))
        sources += paths
    libs, designs = {}, {}
    for src, (lib, log) in ab_versions.build_versions(
            sources, cuda_lib.SLSTM.flags, out_dir).items():
        libs[src] = lib
        designs[src] = library_design(lib, geom) if bind(lib) else None
        print(json.dumps({
            "source": src, "diagnostic": diag.get(src),
            "design": designs[src],
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln]}), flush=True)

    dev = torch.device("cuda")
    b, s, h, dh = (geom[x] for x in ("batch", "seq", "heads", "head_dim"))
    xs, rs_, bs = cs.slstm_operands(geom, dev, 41 + dh)
    gen = torch.Generator().manual_seed(47 + dh)
    draw = [torch.randn(b, h, dh, generator=gen) for _ in range(4)]
    carry0 = tuple(t.to(dev) for t in (draw[0], 0.5 + draw[1].abs(),
                                       torch.tanh(draw[2]), draw[3]))
    x_1 = [x[:, :1].contiguous() for x in xs]
    scratch = tuple(t.clone() for t in carry0)
    first, current = {}, {}

    def load(src):
        cuda_lib._LOADED[cuda_lib.SLSTM.name] = libs[src]
        current["src"] = src

    def measure():
        src = current["src"]
        hs, last = ss.slstm_scan(xs, rs_, bs)
        state = tuple(t.clone() for t in carry0)
        h_1, _ = ss.slstm_scan(x_1, rs_, bs, state)
        got = (hs, *last, h_1, *state)
        if not first:
            hs_p, last_p = ss.slstm_scan_plain(xs, rs_, bs)
            err = max(cs.max_abs(a, b_) for a, b_ in zip(got, (hs_p,
                                                               *last_p)))
            cs.check(err <= cs.SLSTM_TOL, f"{src}: max-abs {err} against "
                     "the plain version")
            first["out"] = got
        equal = all(torch.equal(a, b_) for a, b_ in zip(got, first["out"]))
        cs.check(equal or diag.get(src) not in (None, *EXACT),
                 f"{src}: hs or carry differ from the first version's")
        def decode():
            return ss.slstm_scan(x_1, rs_, bs, scratch)

        # the SMs one prefill's blocks ran on, where the version launches
        # this tree's design (and so records them)
        want = ss.design(b, h, dh, rs_[0].dtype)
        sms = None
        if (designs[src] or {}).get("blocks") == want["blocks"]:
            ids = torch.full((want["blocks"],), -1, dtype=torch.int32,
                             device=dev)
            ss.slstm_scan(xs, rs_, bs, sm_ids=ids)
            sms = len(set(ids.tolist()))

        return {"prefill": cs.device_ms(lambda: ss.slstm_scan(xs, rs_, bs),
                                        dev),
                "decode": cs.device_ms(decode, dev),
                # back to back, each launch behind the last
                "decode_in_a_row": cs.device_ms(
                    lambda: [decode() for _ in range(DECODE_ROW)],
                    dev) / DECODE_ROW,
                "decode_profiler": cs.profiled_ms(decode, "slstm_"),
                "equal_to_first": equal, "sms": sms}

    turns = ab_versions.in_turns(sources, args.rounds, load, measure)
    for src, rounds in turns.items():
        ms = {key: [rnd[key] for rnd in rounds]
              for key in ("prefill", "decode", "decode_in_a_row",
                          "decode_profiler")}
        # (the profiler's time is None where every session lost the kernel)
        med = {key: None if None in t else statistics.median(t)
               for key, t in ms.items()}
        print(json.dumps({
            "source": src, "diagnostic": diag.get(src), "ms": ms,
            "median_ms": med, "us_per_step": med["prefill"] * 1e3 / s,
            "decode_us": med["decode"] * 1e3,
            "equal_to_first": all(r["equal_to_first"] for r in rounds),
            "sms": rounds[0]["sms"]}),
            flush=True)
    work, one = cs.slstm_work(geom), cs.slstm_work(dict(geom, seq=1),
                                                   carry_in=True)
    print(json.dumps({
        "geometry": f"B{b} S{s} H{h} dh{dh} weights {geom['w_dtype']}",
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
        "decode_bound_us": one["bound_ms"] * 1e3,
        "decode_bound_by": one["bound_by"],
        "nvidia_smi": cs.nvidia_smi_line(),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
