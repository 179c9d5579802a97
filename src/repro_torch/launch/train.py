"""Training launcher for the P2M sparse-BNN vision models.

    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg_tiny \\
        --steps 30 --batch 32 [--device cpu]

Port of ``repro.launch.train``'s vision path: SGD through the
SensorFrontend's ``analog`` (or ``ideal``) backend with straight-through
gradients, then accuracy on held-out batches through the training backend
and through a hardware backend (``--eval-backend device``, or ``cuda``, the
kernels; ``pallas``, the reference's name for it, is read as ``cuda``).
Runs on the GPU unless ``--device`` names another device. LM training is
not ported: an LM arch exits non-zero.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import frontend, prng
from repro_torch.data import ImageStream
from repro_torch.devices import resolve_device
from repro_torch.models import vision
from repro_torch.obs.clock import now
from repro_torch.train import vision as vision_loop

VISION_ARCHS = ("vgg16", "vgg_tiny", "resnet18", "resnet20")
# the reference's hardware-eval backend names that the port serves as cuda
EVAL_ALIASES = {"pallas": "cuda"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_vision(args) -> None:
    """Train a P2M sparse-BNN: SensorFrontend first layer + binary convs."""
    trainable = frontend.differentiable_backends()
    if args.frontend_backend not in trainable:
        raise SystemExit(
            f"--frontend-backend {args.frontend_backend!r} has no gradient "
            f"path (stochastic device sampling); train with one of "
            f"{trainable} and use --eval-backend for hardware eval")
    eval_backend = EVAL_ALIASES.get(args.eval_backend, args.eval_backend)
    frontend.get_backend(eval_backend)   # fail fast on typos
    device = resolve_device(args.device)
    cfg = vision.VisionConfig(name=args.arch, arch=args.arch, num_classes=10,
                              frontend_backend=args.frontend_backend)
    params = vision.init_params(0, cfg, device=device)
    stream = ImageStream(hw=32, num_classes=10, global_batch=args.batch,
                         device=device)

    t0 = now()
    params = vision_loop.fit(params, cfg, stream, args.steps, lr=args.lr,
                             key=prng.PRNGKey(1),
                             log_every=max(args.steps // 10, 1))
    _sync(device)
    dt = now() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({1e3 * dt / max(args.steps, 1):.0f} ms/step)")

    # eval through the hardware backend (stochastic MTJ majority)
    ev = ImageStream(hw=32, num_classes=10, global_batch=args.batch, seed=99,
                     device=device)
    acc_train, _ = vision_loop.evaluate(params, cfg, ev, n_batches=4)
    ev = ImageStream(hw=32, num_classes=10, global_batch=args.batch, seed=99,
                     device=device)
    acc_hw, _ = vision_loop.evaluate(params, cfg, ev, n_batches=4,
                                     backend=eval_backend,
                                     key=prng.PRNGKey(2))
    print(f"eval: {cfg.frontend_backend} {acc_train * 100:.1f}%  "
          f"{eval_backend} {acc_hw * 100:.1f}%")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--frontend-backend", default="analog",
                    help="SensorFrontend backend for vision training")
    ap.add_argument("--eval-backend", default="device",
                    help="SensorFrontend backend for vision hardware eval")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.arch not in VISION_ARCHS:
        raise SystemExit(f"--arch {args.arch!r}: the port trains the vision "
                         f"archs {list(VISION_ARCHS)}; LM training is "
                         "ROADMAP item 14")
    train_vision(args)


if __name__ == "__main__":
    main()
