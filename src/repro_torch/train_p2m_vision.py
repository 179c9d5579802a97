"""Train the paper's sparse-BNN vision model (P2M first layer + Hoyer
binary activations) on synthetic data, then evaluate it on hardware.

    PYTHONPATH=src python -m repro_torch.train_p2m_vision [--steps 200] \\
        [--device cpu]

Port of ``examples/train_p2m_vision.py``: reports accuracy (vs 10% chance),
P2M output sparsity (paper: 72-84%) and the accuracy retained under
hardware (stochastic 8-MTJ majority) evaluation, through the shared loops
of ``repro_torch.train.vision`` that ``repro_torch.launch.train`` runs.
Runs on the GPU unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

from repro_torch import prng
from repro_torch.data import ImageStream
from repro_torch.devices import resolve_device
from repro_torch.models import vision
from repro_torch.train import vision as vision_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="resnet20",
                    choices=("vgg16", "resnet18", "resnet20"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = vision.VisionConfig(name="demo", arch=args.arch, num_classes=10,
                              frontend_backend="analog")
    params = vision.init_params(0, cfg, device=device)
    stream = ImageStream(hw=32, num_classes=10, global_batch=64,
                         device=device)
    params = vision_loop.fit(params, cfg, stream, args.steps, lr=3e-3,
                             key=prng.PRNGKey(42),
                             log_every=max(args.steps // 10, 1))

    # hardware-mode evaluation: stochastic VC-MTJ switching + majority vote
    ev = ImageStream(hw=32, num_classes=10, global_batch=64, seed=99,
                     device=device)
    acc_ideal, n = vision_loop.evaluate(params, cfg, ev, n_batches=4)
    ev = ImageStream(hw=32, num_classes=10, global_batch=64, seed=99,
                     device=device)
    acc_hw, _ = vision_loop.evaluate(params, cfg, ev, n_batches=4,
                                     backend="device", key=prng.PRNGKey(7))
    print(f"\neval ({n} examples): {cfg.frontend_backend} "
          f"{acc_ideal * 100:.1f}%  hardware(8-MTJ majority) "
          f"{acc_hw * 100:.1f}%  (paper: no significant drop)")


if __name__ == "__main__":
    main()
