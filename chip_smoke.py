#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it against itself.

    python3 chip_smoke.py

Needs one CUDA card and exits non-zero without one. It builds the frontend
kernels from ``src/repro_torch/csrc`` (nvcc, into ``build/repro_torch/``),
then, printing one JSON object per line:

1. ``env``: torch/CUDA versions and the card's name and power limit;
2. ``build``: seconds for the nvcc build and the compiler's register report;
3. one ``kernel`` line per kernel (A, B, fused) and geometry: the serving
   shape (16, 32, 32, 3) -> (4096, 32) and two odd geometries. Each kernel is
   held against its plain PyTorch version on the same card tensors (u at
   atol 3e-6, theta at rtol 1e-5, draws by the word-boundary rule, fused at a
   pinned theta == A -> B bit for bit) and timed (device time, median of 30)
   beside its plain version, its bound and, for A, a cuDNN conv yardstick;
4. ``engine``: full-width vgg16 at CIFAR-10 geometry, seeded random weights:
   ``classify`` on 16 frames and ``stream`` of 4 batches of 16, with every
   kernel's launch count read from that run alone; the classify result is
   held against the same engine on the CPU;
5. ``profile``: device time of a classify step by kernel family;
6. the card's ``nvidia-smi`` line, the ``kernels`` summary line, and last the
   ``{"ok": true, "device": ...}`` line.

Any failed check raises, so the exit code is non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # non-tensor-core float32 (the kernels use FFMA)
# rough per-element operation counts of the elementwise stages, used only
# for the operation side of the bound (the byte side dominates)
EPILOGUE_A_OPS = 12         # two curves, subtract, z, clip, two partial sums
DEVICE_CHAIN_OPS = 60       # chan rows, voltage map, logit fit, sigmoid,
                            # majority polynomial, draw hash and compare
REPS = 30

SERVING = dict(batch=16, h=32, w=32, kernel=3, stride=2, c=32)
ODD_GEOMETRIES = (dict(batch=4, h=16, w=16, kernel=3, stride=1, c=32),
                  dict(batch=4, h=13, w=11, kernel=5, stride=3, c=32))
REPLACES = {
    "p2m_phase_a_implicit":
        "src/repro/kernels/p2m_conv.py:255 (p2m_phase_a_implicit_pallas)",
    "p2m_phase_b": "src/repro/kernels/p2m_conv.py:417 (p2m_phase_b_pallas)",
    "p2m_fused_stream":
        "src/repro/kernels/p2m_conv.py:531 (p2m_fused_stream_pallas)",
}
SOURCE = "src/repro_torch/csrc/p2m_kernels.cu"


def emit(kind: str, **fields) -> None:
    print(json.dumps({"phase": kind, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, device) -> float:
    """Median device time of ``fn()`` in ms over REPS runs. On a card each
    run is queued behind a ~1 ms sleep kernel, so the event pair brackets
    the device work and not Python's enqueue time."""
    import torch
    if device.type != "cuda":
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_draws(acts, q, bits, max_frac: float = 1e-3) -> int:
    """Word-boundary rule: draws that differ from ``bits * 2^-16 < q`` must
    be rare and sit within one uint16 word of q. Returns the mismatches."""
    import torch
    expected = (bits.to(torch.float32) * (1.0 / 65536) < q).to(torch.float32)
    mismatch = acts != expected
    n = int(mismatch.sum())
    check(n <= max(8, max_frac * acts.numel()),
          f"{n} draw mismatches: beyond word-boundary noise")
    if n:
        near = (q.double() * 65536.0 - bits.double()).abs() <= 1.0
        check(not bool((mismatch & ~near).any()),
              "draw mismatch away from the uint16 word boundary")
    return n


def kernel_phase(geom: dict, device):
    """Hold the three kernels against their plain versions at one geometry
    and time them; returns one summary row per kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import blocking
    from repro_torch.kernels import p2m_conv as pk

    gen = torch.Generator().manual_seed(7)
    b, h, w, k, s, c = (geom[x] for x in ("batch", "h", "w", "kernel",
                                          "stride", "c"))
    images = torch.rand((b, h, w, 3), generator=gen).to(device)
    wt = torch.randn((k, k, 3, c), generator=gen) * (2.0 / (k * k * 3)) ** 0.5
    wq = p2m.quantize_weights(wt, 4).to(device)
    wm = pk.pack_phase_weights(wq.reshape(k * k * 3, c)).contiguous()
    v_th = torch.ones((), device=device)
    key = prng.fold_in(prng.PRNGKey(3), 5)
    ho, wo = blocking.conv_out_hw(h, s), blocking.conv_out_hw(w, s)
    n, kk = b * ho * wo, k * k * 3
    tag = f"{b}x{h}x{w}x3 k{k} s{s} -> ({n}, {c})"
    kw = dict(kernel=k, stride=s)

    # kernel A
    u, hp = pk.p2m_phase_a_implicit(images, wm, v_th, **kw)
    u_p, hp_p = pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw)
    err_u = float((u - u_p).abs().max())
    theta = pk.combine_hoyer_partials(hp, v_th)
    theta_p = pk.combine_hoyer_partials(hp_p, v_th)
    check(err_u <= 3e-6, f"kernel A u error {err_u} > 3e-6 at {tag}")
    rel_theta = abs(float(theta) - float(theta_p)) / abs(float(theta_p))
    check(rel_theta <= 1e-5, f"kernel A theta rel error {rel_theta} at {tag}")

    # kernel B on A's u and theta
    acts, vp = pk.p2m_phase_b(u, theta, key)
    q, v = pk.device_chain_q(u, theta, None)
    bits = pk.draw_bits(key, n, c, device=device)
    acts_p, vp_p = pk.p2m_phase_b_plain(u, theta, key)
    flips_b = assert_draws(acts, q, bits)
    v_k = pk.combine_v_conv_partials(vp, n, c)
    v_p = pk.combine_v_conv_partials(vp_p, n, c)
    for name in v_k:
        check(abs(float(v_k[name]) - float(v_p[name])) <= 1e-5,
              f"kernel B {name} differs at {tag}")

    # fused kernel at the exact path's theta: A -> B bit for bit
    acts_f, hf, vf, rf = pk.p2m_fused_stream(images, wm, v_th, theta, key,
                                             **kw)
    check(torch.equal(acts_f, acts), f"pinned-theta fused != A -> B at {tag}")
    theta_f = pk.combine_hoyer_partials(hf, v_th)
    check(torch.equal(theta_f, theta), f"fused fresh theta != A's at {tag}")
    check(torch.equal(rf.sum(0), acts_f.sum(0)), f"fused rates wrong at {tag}")
    acts_fp = pk.p2m_fused_stream_plain(images, wm, v_th, theta, key, **kw)[0]
    flips_f = assert_draws(acts_f, pk.device_chain_q(u_p, theta, None)[0],
                           bits)
    err_acts_fp = float((acts_f - acts_fp).abs().max())

    checks = {
        "p2m_phase_a_implicit": dict(max_abs_err_u=err_u,
                                     theta_rel_err=rel_theta),
        "p2m_phase_b": dict(draw_mismatches=flips_b,
                            v_conv={k_: float(v_) for k_, v_ in v_k.items()}),
        "p2m_fused_stream": dict(draw_mismatches_vs_plain=flips_f,
                                 pinned_theta_equals_two_kernel=True),
    }

    # device times and bounds (each input read once, each output written
    # once; operations: the MAC FMAs plus the per-element estimates above)
    f32 = 4
    img_bytes, w_bytes = images.numel() * f32, wm.numel() * f32
    g_a, g_b = hp.shape[0], vp.shape[0]
    a_bytes = img_bytes + w_bytes + f32 + n * c * f32 + g_a * 2 * f32
    a_ops = 2 * n * kk * 2 * c + EPILOGUE_A_OPS * n * c
    b_bytes = n * c * f32 * 2 + 4 * c * f32 + f32 + g_b * 3 * f32
    b_ops = DEVICE_CHAIN_OPS * n * c
    fu_bytes = (img_bytes + w_bytes + 4 * c * f32 + 2 * f32 + n * c * f32
                + g_a * (2 + 3 + c) * f32)
    fu_ops = a_ops + b_ops

    (pt, pb), (pl, pr) = blocking.same_pads(h, w, k, s)
    img_nchw = F.pad(images.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous()
    w_oihw = wm.reshape(k, k, 3, 2 * c).permute(3, 2, 0, 1).contiguous()

    def conv_library():
        # the yardstick for A: one cuDNN conv of the padded frames with the
        # packed 2C weights, TF32 off — the matmul part only
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            F.conv2d(img_nchw, w_oihw, stride=s)

    rows = []
    for name, fn, plain, lib, nbytes, ops, err in (
            ("p2m_phase_a_implicit",
             lambda: pk.p2m_phase_a_implicit(images, wm, v_th, **kw),
             lambda: pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw),
             conv_library, a_bytes, a_ops, err_u),
            ("p2m_phase_b", lambda: pk.p2m_phase_b(u, theta, key),
             lambda: pk.p2m_phase_b_plain(u, theta, key), None, b_bytes,
             b_ops, float((acts - acts_p).abs().max())),
            ("p2m_fused_stream",
             lambda: pk.p2m_fused_stream(images, wm, v_th, theta, key, **kw),
             lambda: pk.p2m_fused_stream_plain(images, wm, v_th, theta, key,
                                               **kw),
             None, fu_bytes, fu_ops, err_acts_fp)):
        t_bound, by = bound(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": err, "ms": device_ms(fn, device),
               "plain_ms": device_ms(plain, device),
               "bound_ms": t_bound, "bound_by": by,
               "library_ms": (device_ms(lib, device) if lib is not None
                              else None)}
        rows.append(row)
        emit("kernel", geometry=tag, **{k_: v_ for k_, v_ in row.items()
                                         if k_ != "launches"},
             bound_us=t_bound * 1e3, bytes=nbytes, ops=ops, **checks[name])
    return rows


def engine_phase(device):
    """Full-width vgg16 through classify and stream; returns launch counts."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.frontend import SensorFrontend
    from repro_torch.kernels import p2m_conv as pk
    from repro_torch.models import params as mparams
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine

    cfg = vision.VisionConfig()          # vgg16, CIFAR-10 geometry
    params = vision.init_params(0, cfg, device=device)
    gen = torch.Generator().manual_seed(11)
    frames = [torch.rand((16, 32, 32, 3), generator=gen) for _ in range(5)]
    engine = VisionEngine(cfg, params, seed=0, device=device, microbatch=16)

    pk.reset_launch_counts()
    out = engine.classify(frames[0])
    stream_outs = list(engine.stream(frames[1:]))
    counts = pk.launch_counts()
    if device.type == "cuda":
        for name, cnt in counts.items():
            check(cnt >= 1, f"{name} was not launched on the main path")
    for o in [out, *stream_outs]:
        check(tuple(o["probs"].shape) == (16, 10), "probs shape")
        check(bool(torch.isfinite(o["probs"]).all()), "non-finite probs")
        check(abs(float(o["probs"].sum()) - 16.0) < 1e-3, "probs not normed")
    check(engine.fused_step_count >= 1, "no fused stream step ran")

    # the same engine on the CPU: frontend draws by the word-boundary rule,
    # probs where every frontend activation agrees
    cpu = torch.device("cpu")
    params_cpu = mparams.to_device(params, cpu)
    engine_cpu = VisionEngine(cfg, params_cpu, seed=0, device=cpu)
    out_cpu = engine_cpu.classify(frames[0])
    key = prng.fold_in(prng.PRNGKey(0), 0)
    fe = SensorFrontend(cfg.frontend)
    acts_dev, aux_dev = fe(params["p2m"], frames[0].to(device), key=key)
    acts_cpu, aux_cpu = fe(params_cpu["p2m"], frames[0], key=key)
    wq = p2m.quantize_weights(params_cpu["p2m"]["w"], 4)
    wm = pk.pack_phase_weights(wq.reshape(27, 32))
    u_cpu, _ = pk.p2m_phase_a_implicit_plain(frames[0], wm,
                                             params_cpu["p2m"]["v_th"],
                                             kernel=3, stride=2)
    q_cpu = pk.device_chain_q(u_cpu, aux_cpu["theta"], None)[0]
    bits = pk.draw_bits(key, u_cpu.shape[0], 32)
    flips = assert_draws(acts_dev.cpu().reshape(-1, 32), q_cpu, bits)
    same = (acts_dev.cpu() == acts_cpu).reshape(16, -1).all(dim=1)
    probs_err = float((out["probs"].cpu() - out_cpu["probs"])[same].abs()
                      .max()) if bool(same.any()) else None
    check(probs_err is None or probs_err <= 1e-3,
          f"classify probs differ from the CPU engine by {probs_err}")
    check(int(same.sum()) >= 12, "frontend activations differ on most frames")

    emit("engine", model="vgg16", batch=16, launches=counts,
         classify_wall_ms=out["wall_ms"],
         classify_throughput_fps=out["throughput_fps"],
         stream_wall_ms=[o["wall_ms"] for o in stream_outs],
         stream_fused=[float(o["stream_fused"]) for o in stream_outs],
         fused_step_count=engine.fused_step_count,
         fused_fallback_count=engine.fused_fallback_count,
         theta=float(out["theta"]), p2m_sparsity=float(out["p2m_sparsity"]),
         vs_cpu=dict(frontend_draw_mismatches=flips,
                     frames_with_equal_frontend=int(same.sum()),
                     max_probs_err_on_those=probs_err,
                     labels_equal=int((out["labels"].cpu()
                                       == out_cpu["labels"]).sum()),
                     theta_dev=float(aux_dev["theta"]),
                     theta_cpu=float(aux_cpu["theta"])))

    # steady-state walls after the counted run (the first steps above
    # include cuDNN's first-use set-up)
    walls = [engine.classify(frames[0])["wall_ms"] for _ in range(20)]
    engine_s = VisionEngine(cfg, params, seed=0, device=device, microbatch=16,
                            fused_theta_tol=1e9)
    steps = list(engine_s.stream([frames[1]] * 21))[1:]
    emit("engine_steady", model="vgg16", batch=16,
         classify_wall_ms_median=statistics.median(walls),
         classify_fps_median=16 / (statistics.median(walls) / 1e3),
         fused_step_wall_ms_median=statistics.median(
             o["wall_ms"] for o in steps),
         fused_steps=engine_s.fused_step_count)
    return counts, engine, frames


def profile_phase(engine, frames, device):
    """Device time of one classify and one fused stream step, by family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def families(prof):
        fam = {"frontend_kernels": 0.0, "backbone_conv": 0.0, "other": 0.0}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            if not us:
                continue
            name = evt.key
            if any(k in name for k in ("phase_a_kernel", "phase_b_kernel",
                                       "fused_stream_kernel")):
                fam["frontend_kernels"] += us
            elif any(k in name.lower() for k in ("conv", "xmma", "gemm",
                                                 "implicit", "cudnn")):
                fam["backbone_conv"] += us
            else:
                fam["other"] += us
        return {k: v / 1e3 for k, v in fam.items()}    # ms

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof_c:
        engine.classify(frames[0])
    with profile(activities=acts) as prof_s:
        list(engine.stream([frames[1], frames[1]]))
    emit("profile", classify_device_ms=families(prof_c),
         stream_exact_plus_fused_device_ms=families(prof_s))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import p2m_conv as pk

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvidia_smi=smi,
         device=torch.cuda.get_device_name(0),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         matmul_precision=torch.get_float32_matmul_precision())
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log").read_text().splitlines()
    emit("build", seconds=build_s, library=str(lib_path.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in log if "Used" in ln or "spill" in ln])

    rows = kernel_phase(SERVING, device)
    for geom in ODD_GEOMETRIES:
        kernel_phase(geom, device)
    counts, engine, frames = engine_phase(device)
    profile_phase(engine, frames, device)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
