"""Temperature sampling and the serving launchers, held against the JAX
package on the CPU.

* ``engine.gumbel``: its uniforms are jax's bit for bit, the noise within
  4e-6 of ``jax.random.gumbel`` (PyTorch's log is within an ulp of XLA's);
  ``engine.categorical`` equals ``jax.random.categorical`` wherever the
  top-2 margin of noise plus logits exceeds 1e-4 (asserted for every
  compared row);
* sampled ``ServingEngine.generate`` (reduced glm4-9b and granite-8b,
  float32, temperature 0.8) equals the reference engine's tokens at the
  same key, step i drawn with ``fold_in(rng, i)``, the first token the
  prefill's argmax; without a key both decode greedily;
* ``python -m repro_torch.launch.serve`` and ``python -m
  repro_torch.serve_lm`` with ``--device cpu`` give the reference
  launcher's and example's tokens (the same keys 0-3).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.reduced import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import prng, serve_lm
from repro_torch.configs.reduced import reduced as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

TINY = float(np.finfo(np.float32).tiny)


def test_gumbel_matches_jax():
    key = prng.PRNGKey(11)
    u = jax.random.uniform(jax.random.PRNGKey(11), (64, 300), minval=TINY,
                           maxval=1.0)
    ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (64, 300)))
    g = tengine.gumbel(key, (64, 300))
    # the same uniforms: exp(-exp(-g)) recovers them to the logs' ulps
    np.testing.assert_allclose(np.exp(-np.exp(-g.numpy().astype(np.float64))),
                               np.asarray(u), rtol=2e-6)
    np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=4e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).normal(size=(32, 256)).astype(
        np.float32) * 3
    ref = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                            jnp.asarray(logits)))
    got = tengine.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    noisy = np.sort(np.asarray(jax.random.gumbel(
        jax.random.PRNGKey(seed), logits.shape)) + logits, axis=-1)
    assert (noisy[:, -1] - noisy[:, -2] > 1e-4).all()
    np.testing.assert_array_equal(got.numpy(), ref)


def _model(arch):
    """The reduced config in both packages and the same seeded weights
    (the port's draw; the reference's eager ``init_params`` takes
    seconds)."""
    cfg = treduced(tconfigs.get_arch(arch))
    jcfg = jreduced(jconfigs.get_arch(arch))
    tp = tlm.init_params(0, cfg)
    return cfg, jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp), tp


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
def test_sampled_generate_matches_reference_engine(arch):
    cfg, jcfg, jp, tp = _model(arch)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (3, 12),
                                            0, cfg.vocab_size))
    ref_engine = jengine.ServingEngine(jcfg, jp, max_len=40, temperature=0.8)
    engine = ServingEngine(cfg, tp, max_len=40, temperature=0.8,
                           device="cpu")
    ref = np.asarray(ref_engine.generate(jnp.asarray(prompts), 10,
                                         rng=jax.random.PRNGKey(3)))
    got = engine.generate(torch.from_numpy(prompts), 10,
                          rng=prng.PRNGKey(3))
    np.testing.assert_array_equal(got.numpy(), ref)
    greedy = engine.generate(torch.from_numpy(prompts), 10)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(
        ref_engine.generate(jnp.asarray(prompts), 10)))
    assert torch.equal(got[:, 0], greedy[:, 0])   # the prefill's argmax
    assert not torch.equal(got, greedy)           # sampling moved a token


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_launcher_matches_reference(temperature, monkeypatch, capsys):
    argv = ["--arch", "glm4-9b", "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "6", "--temperature", temperature]
    got = tserve.main(argv + ["--device", "cpu"])
    assert "generated (2, 6)" in capsys.readouterr().out
    seen = []
    real = jengine.ServingEngine.generate

    def generate(self, *args, **kwargs):
        seen.append(np.asarray(real(self, *args, **kwargs)))
        return seen[-1]

    monkeypatch.setattr(jengine.ServingEngine, "generate", generate)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    np.testing.assert_array_equal(got.numpy(), seen[0])


def test_serve_lm_example_matches_reference(capsys):
    got = serve_lm.main(["--batch", "2", "--new-tokens", "6",
                         "--device", "cpu"])
    assert "glm4-9b (reduced): generated (2, 6)" in capsys.readouterr().out
    # the example's weights: the reference's draw from key 0
    cfg = treduced(tconfigs.get_arch("glm4-9b"))
    jcfg = jreduced(jconfigs.get_arch("glm4-9b"))
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                 cfg.vocab_size)
    ref = jengine.ServingEngine(jcfg, jp, max_len=96).generate(prompts, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
