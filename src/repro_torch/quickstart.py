"""Quickstart: the paper's P2M pipeline end to end through the port.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Runs on the GPU unless ``--device`` names another device (``cpu`` runs the
kernels' plain PyTorch versions). It walks the device-circuit-algorithm
story as ``examples/quickstart.py`` does:
  1. the VC-MTJ device model (switching probabilities at the measured
     points),
  2. multi-MTJ majority redundancy (Fig. 5),
  3. the SensorFrontend: one API, four backends over the in-pixel layer
     (analog / cuda / device / ideal),
  4. the global-shutter stage (burst read + reset accounting),
  5. the bandwidth / energy / latency figures (Eq. 3, Fig. 9, §3.4).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import frontend, prng
from repro_torch.core import energy, mtj
from repro_torch.devices import resolve_device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    device = resolve_device(parser.parse_args(argv).device)

    print("=" * 70)
    print("1. VC-MTJ device model (measured: 6.2% @0.7V, 92.4% @0.8V, "
          "97.17% @0.9V)")
    for v in (0.7, 0.8, 0.9):
        p = mtj.switching_probability(torch.tensor(v, device=device))
        print(f"   P_sw({v:.1f} V, 700 ps) = {float(p):.4f}")

    print("\n2. multi-MTJ majority (8 devices, >=4 votes)  [Fig. 5]")
    p_low, p_high = mtj.MEASURED_P_SW[0], mtj.MEASURED_P_SW[1]
    fail, false = mtj.majority_error_rates(p_high, p_low, n=8, majority=4)
    print(f"   fail-to-activate: {float(fail) * 100:.4f}%   "
          f"false-activate: {float(false) * 100:.4f}%   "
          "(paper: both < 0.1%)")

    print("\n3. SensorFrontend: one API, four backends "
          f"{frontend.list_backends()}")
    fe = frontend.SensorFrontend(frontend.FrontendConfig(backend="analog"))
    params = fe.init(torch.Generator().manual_seed(0), device=device)
    frame = prng.uniform(prng.PRNGKey(1), (1, 32, 32, 3), device)
    outs = {}
    for mode in frontend.list_backends():
        acts, aux = fe(params, frame, key=prng.PRNGKey(2), mode=mode)
        outs[mode] = (acts, aux)
        print(f"   {mode:7s} {tuple(acts.shape)}  sparsity "
              f"{float(aux['sparsity']) * 100:5.1f}%  "
              f"V_CONV mean {float(aux['v_conv_mean']):.3f} V")
    agree = float(torch.mean((outs["analog"][0] == outs["device"][0])
                             .to(torch.float32)))
    print(f"   device (stochastic MTJs) agreement with analog: "
          f"{agree * 100:.1f}%")

    print("\n4. global shutter  [Fig. 6: non-volatile MTJ storage + burst "
          "read]")
    _, aux = outs["device"]
    print(f"   activated fraction: {float(aux['activated_fraction']) * 100:.1f}%"
          f"  reset pulses: {int(aux['reset_pulses'])}")
    print(f"   read energy: {float(aux['read_energy_pj']) / 1e3:.1f} nJ   "
          f"reset energy: {float(aux['reset_energy_pj']):.2f} pJ")

    print("\n5. system wins  [Eq. 3 / Fig. 9 / §3.4]")
    rep = energy.energy_report()
    lat = energy.frame_latency_us()
    print(f"   bandwidth reduction: {rep['bandwidth_reduction']:.1f}x "
          "(paper 6x)")
    print(f"   front-end energy:    "
          f"{rep['frontend_improvement_vs_baseline']:.1f}x vs baseline "
          "(paper 8.2x)")
    print(f"   communication:       {rep['comm_improvement']:.1f}x "
          "(paper 8.5x)")
    print(f"   frame latency:       {lat['total_us']:.1f} us (paper < 70 us), "
          f"{lat['fps']:.0f} FPS global shutter")
    print("=" * 70)


if __name__ == "__main__":
    main()
