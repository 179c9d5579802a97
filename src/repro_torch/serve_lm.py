"""Batched serving example: prefill + KV-cache decode on a reduced backbone.

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch glm4-9b] \\
        [--device cpu]

Port of ``examples/serve_lm.py``: the production decode path (MLA latent
caches for deepseek-v2, ring buffers for recurrentgemma-2b's local
attention, O(1) state for xlstm-350m) on the reduced config, with the
reference's weights (key 0), 16-token prompts (key 1) and, for an
encoder-decoder, frame embeddings (key 2). Runs on the GPU unless
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
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(configs.get_arch(args.arch))
    params = lm.init_params_from_key(prng.PRNGKey(0), cfg, device=device)
    engine = ServingEngine(cfg, params, max_len=96, device=device)
    prompts = prng.randint(prng.PRNGKey(1), (args.batch, 16), 0,
                           cfg.vocab_size, device)
    enc = None
    if cfg.is_encdec:
        enc = prng.normal(prng.PRNGKey(2),
                          (args.batch, cfg.encoder_seq, cfg.d_model), device)
    t0 = now()
    out = engine.generate(prompts, args.new_tokens, encoder_embeddings=enc)
    dt = now() - t0
    print(f"{args.arch} (reduced): generated {tuple(out.shape)} tokens in "
          f"{dt:.2f}s ({args.batch * args.new_tokens / dt:.0f} tok/s, "
          f"batch={args.batch})")
    print("first sequence:", list(map(int, out[0, :16])))
    return out


if __name__ == "__main__":
    main()
