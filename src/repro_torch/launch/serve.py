"""Batched serving launcher: port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --batch 4 --prompt-len 32 --new-tokens 16 [--temperature 0.8] \\
        [--device cpu]

The reduced config with the reference's keys: the weights from key 0
(``lm.init_params_from_key``), the prompts ``prng.randint`` from key 1, an
encoder-decoder's frame embeddings ``prng.normal`` from key 2, and with
``--temperature > 0`` the sampling key 3. Runs on the GPU unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, prng
from repro_torch.configs.reduced import reduced
from repro_torch.devices import resolve_device
from repro_torch.models import lm
from repro_torch.obs.clock import now
from repro_torch.serving import ServingEngine


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(configs.get_arch(args.arch))
    params = lm.init_params_from_key(prng.PRNGKey(0), cfg, device=device)
    engine = ServingEngine(cfg, params,
                           max_len=args.prompt_len + args.new_tokens + 8,
                           temperature=args.temperature, device=device)
    prompts = prng.randint(prng.PRNGKey(1), (args.batch, args.prompt_len),
                           0, cfg.vocab_size, device)
    enc = None
    if cfg.is_encdec:
        enc = prng.normal(prng.PRNGKey(2),
                          (args.batch, cfg.encoder_seq, cfg.d_model), device)
    t0 = now()
    out = engine.generate(prompts, args.new_tokens, encoder_embeddings=enc,
                          rng=prng.PRNGKey(3)
                          if args.temperature > 0 else None)
    dt = now() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print(out[:, :12].cpu())
    return out


if __name__ == "__main__":
    main()
