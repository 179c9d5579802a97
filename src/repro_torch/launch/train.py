"""End-to-end training launcher: port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --steps 200 --scale tiny --batch 8 --seq 128 [--device cpu]

Vision archs (the paper's P2M sparse-BNNs) train through the
SensorFrontend:

    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg_tiny \\
        --steps 30 --batch 32 [--device cpu]

The LM path: ``--scale tiny`` trains the reduced config, ``--scale full``
the full config on one card (the reference's production mesh has no
counterpart on one card: sharding is ROADMAP item 15), with the
reference's weights (``lm.init_params_from_key(PRNGKey(seed))``), its
``TokenStream`` and its ``Trainer``, AdamW with a warmup of
min(20, steps / 5). Fault tolerance as the reference's: a checkpoint every
``--ckpt-every`` steps under ``--ckpt-dir/<arch>`` (by default under the
temporary directory), re-running the same command resumes from the
latest one, and SIGTERM checkpoints at the next step boundary. A config
whose train forward reaches a kernel without a backward raises on the
card (``lm.check_trainable``); on the CPU every config trains.

The vision path: SGD through the SensorFrontend's ``analog`` (or
``ideal``) backend with straight-through gradients, then accuracy on
held-out batches through the training backend and through a hardware
backend (``--eval-backend device``, or ``cuda``, the kernels; ``pallas``,
the reference's name for it, is read as ``cuda``).

Runs on the GPU unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile

import torch

from repro_torch import configs, frontend, prng
from repro_torch.configs.base import OptimizerConfig, RunConfig
from repro_torch.configs.reduced import reduced
from repro_torch.data import ImageStream, TokenStream
from repro_torch.devices import resolve_device
from repro_torch.models import lm, vision
from repro_torch.obs.clock import now
from repro_torch.train import Trainer
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


def train_lm(args) -> Trainer:
    """Train an LM config with the reference's ``Trainer``; prints the
    logged metrics and the step rate; returns the trainer (its
    ``history``)."""
    device = resolve_device(args.device)
    cfg = configs.get_arch(args.arch)
    if args.scale == "tiny":
        cfg = reduced(cfg)
    run = RunConfig(
        arch=cfg,
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=min(20, args.steps // 5),
                                  grad_compression=args.grad_compression),
        microbatches=args.microbatches,
        checkpoint_dir=os.path.join(args.ckpt_dir, args.arch),
        checkpoint_every=args.ckpt_every,
        log_every=max(1, args.steps // 20),
    )
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, device=device)
    trainer = Trainer(run, stream, device=device)
    signal.signal(signal.SIGTERM, lambda *_: trainer.request_stop())

    params, opt, start = trainer.restore_or_init(
        lambda: lm.init_params_from_key(prng.PRNGKey(run.seed), cfg,
                                        device=device))
    if start:
        print(f"resumed from checkpoint at step {start}")
    t0 = now()
    params, opt, step = trainer.fit(params, opt, start, args.steps)
    _sync(device)
    dt = now() - t0
    for h in trainer.history:
        print({k: round(v, 4) for k, v in h.items()})
    steps_done = max(step - start, 1)
    print(f"\n{steps_done} steps in {dt:.1f}s "
          f"({1e3 * dt / steps_done:.0f} ms/step); final loss "
          f"{trainer.history[-1]['loss']:.4f}" if trainer.history else "")
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--frontend-backend", default="analog",
                    help="SensorFrontend backend for vision training")
    ap.add_argument("--eval-backend", default="device",
                    help="SensorFrontend backend for vision hardware eval")
    ap.add_argument("--scale", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.arch in VISION_ARCHS:
        train_vision(args)
        return None
    return train_lm(args)


if __name__ == "__main__":
    main()
