"""whisper-base (encoder-decoder) in the port held against the JAX package.

Reduced whisper-base (``reduced()``: d 64, 4 heads of 16, 2 encoder and 2
decoder layers, 24 encoder frames, the GELU MLP) in float32, with the
reference's ``lm.init_params(PRNGKey(0))`` tree carried over by
``params.from_numpy``, and the same seeded numpy frame embeddings and
prompts on both sides: the model and cache trees (full width too), the
encoder's output, one cross-attention block in train and decode mode,
``forward`` in train mode with and without embeddings, the prefill's
logits and whole cache (``enc_k`` / ``enc_v`` included), decode steps and
``ServingEngine.generate`` (greedy tokens equal). Float32 tolerances
(1e-5) cover summation order; bf16 rounds every intermediate after each
side's own order (5e-2, as tests/test_torch_lm.py's bf16 case).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sharding
from repro.configs.reduced import reduced as jreduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.configs.reduced import reduced as treduced
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

ARCH = "whisper-base"
ATOL = 1e-5


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _cfgs(**over):
    return (dataclasses.replace(treduced(tconfigs.get_arch(ARCH)), **over),
            dataclasses.replace(jreduced(jconfigs.get_arch(ARCH)), **over))


def _rules(jcfg):
    return sharding.ShardingRules.make(dict(jcfg.rule_overrides))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, tparams.from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _frames(seed, b, cfg):
    """Seeded frame embeddings (B, encoder_seq, d), as the reference's
    launcher draws them from a normal distribution."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _spec_shapes(tree):
    if isinstance(tree, tparams.ParamSpec):
        return tree.shape
    return {k: _spec_shapes(v) for k, v in tree.items()}


def _assert_tree_close(port, ref, atol):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            _assert_tree_close(port[k], ref[k], atol)
        return
    assert tuple(port.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _jnp(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_model_and_cache_specs_match_reference(reduce):
    """The encoder tree (its body stacked over the encoder's layers, its
    norm), the decoder layers' ``ln_x`` / ``cross`` and the cache's
    per-layer ``enc_k`` / ``enc_v``: keys and shapes as the reference's."""
    cfg, jcfg = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    if reduce:
        cfg, jcfg = treduced(cfg), jreduced(jcfg)
    spec = lambda t: jax.tree.map(lambda s: s.shape, t,  # noqa: E731
                                  is_leaf=jparams.is_spec)
    ports = _spec_shapes(tlm.model_spec(cfg))
    assert ports == spec(jlm.model_spec(jcfg))
    assert ports["encoder"]["body"]["l0"]["mixer"]["wq"][0] == \
        cfg.encoder_layers
    assert "cross" in ports["decoder"]["body"]["l0"]
    cache = _spec_shapes(tlm.cache_spec(cfg, 2, 40))
    assert cache == spec(jlm.cache_spec(jcfg, 2, 40))
    assert cache["decoder"]["body"]["l0"]["enc_k"] == (
        cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads,
        cfg.resolved_head_dim)


def test_encoder_output_matches_reference(model):
    cfg, jcfg, jp, tp = model
    emb = _frames(0, 2, cfg)
    out = tlm._run_encoder(tp, torch.from_numpy(emb), cfg)
    ref = jlm._run_encoder(jp, jnp.asarray(emb), jcfg, None, _rules(jcfg))
    assert tuple(out.shape) == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_cross_attention_block_matches_reference(model, mode):
    """One cross block over projected encoder K/V: q not rotated (the
    positions must not matter), non-causal over every frame; decode
    attends the whole override and hands the cache back unchanged."""
    cfg, jcfg, jp, tp = model
    rng = np.random.default_rng(1)
    s = 1 if mode == "decode" else 7
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    ek = rng.normal(size=(2, cfg.encoder_seq, cfg.num_kv_heads,
                          cfg.resolved_head_dim)).astype(np.float32)
    ev = rng.normal(size=ek.shape).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["decoder"]["body"]["l0"]["cross"])
    tlp = tparams.from_numpy(jax.tree.map(np.asarray, lp))
    pos = np.arange(s)[None, :] + 5
    cache = {} if mode == "decode" else None
    out, nc = tblocks.attn_apply(
        tlp, torch.from_numpy(x), torch.from_numpy(pos), cfg, causal=False,
        mode=mode, cache=cache,
        kv_override=(torch.from_numpy(ek), torch.from_numpy(ev)))
    ref, jnc = jblocks.attn_apply(
        lp, jnp.asarray(x), jnp.asarray(pos), jcfg, None, _rules(jcfg),
        causal=False, mode=mode, cache=cache,
        kv_override=(jnp.asarray(ek), jnp.asarray(ev)))
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=ATOL)
    assert nc is cache and jnc == cache
    other, _ = tblocks.attn_apply(
        tlp, torch.from_numpy(x), torch.from_numpy(pos * 3), cfg,
        causal=False, mode=mode, cache=cache,
        kv_override=(torch.from_numpy(ek), torch.from_numpy(ev)))
    assert torch.equal(other, out)


@pytest.mark.parametrize("with_frames", [True, False],
                         ids=["frames", "no_frames"])
def test_forward_train_matches_reference(model, with_frames):
    """With embeddings every decoder layer runs its cross block; without
    them train mode runs the decoder alone, as the reference's."""
    cfg, jcfg, jp, tp = model
    toks = _tokens(2, 2, 12, cfg.vocab_size)
    emb = _frames(3, 2, cfg) if with_frames else None
    out, cache = tlm.forward(
        tp, torch.from_numpy(toks), cfg,
        encoder_embeddings=None if emb is None else torch.from_numpy(emb))
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg,
                         encoder_embeddings=None if emb is None
                         else jnp.asarray(emb))
    assert cache is None
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=ATOL)


def test_prefill_cache_and_decode_steps_match_reference(model):
    """The prefill's logits and whole cache (the self-attention K/V and the
    encoder's ``enc_k`` / ``enc_v`` of every layer), then three decode
    steps (their logits, the cache after them); decode returns the same
    ``enc_k`` / ``enc_v`` tensors it was given."""
    cfg, jcfg, jp, tp = model
    toks = _tokens(4, 2, 10, cfg.vocab_size)
    emb = _frames(5, 2, cfg)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill",
                             encoder_embeddings=torch.from_numpy(emb))
    ref, jcache = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill",
                              encoder_embeddings=jnp.asarray(emb))
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=ATOL)
    _assert_tree_close(cache, jcache, ATOL)

    cache = tengine.pad_prefill_cache(cfg, cache, 2, 16)
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 16)
    _assert_tree_close(cache, jcache, ATOL)
    enc_k = cache["decoder"]["body"]["l0"]["enc_k"]
    nxt = _tokens(6, 2, 3, cfg.vocab_size)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        out, cache = tlm.forward(tp, torch.from_numpy(tok), cfg,
                                 mode="decode", cache=cache)
        ref, jcache = jlm.forward(jp, jnp.asarray(tok), jcfg, mode="decode",
                                  cache=jcache)
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=ATOL)
        assert cache["decoder"]["body"]["l0"]["enc_k"] is enc_k
    _assert_tree_close(cache, jcache, ATOL)
    assert int(cache["pos"]) == 13


def test_generate_greedy_equals_reference_engine(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(7, 2, 8, cfg.vocab_size)
    emb = _frames(8, 2, cfg)
    ref = jengine.ServingEngine(jcfg, jp, max_len=32).generate(
        jnp.asarray(prompts), 6, encoder_embeddings=jnp.asarray(emb))
    eng = ServingEngine(cfg, tp, max_len=32, device="cpu")
    out = eng.generate(prompts, 6, encoder_embeddings=emb)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # teacher forcing: the prefill's logits are a train forward's last row
    logits, _ = tlm.forward(tp, torch.from_numpy(prompts), cfg,
                            encoder_embeddings=torch.from_numpy(emb))
    torch.testing.assert_close(eng.prefill_logits, logits[:, -1], rtol=0,
                               atol=1e-6)


def test_generate_needs_frame_embeddings(model):
    """The reference fails in ``pad_prefill_cache`` without embeddings
    (its cache tree lacks ``enc_k``); the port says why."""
    cfg, _, _, tp = model
    eng = ServingEngine(cfg, tp, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="encoder_embeddings"):
        eng.generate(_tokens(9, 1, 4, cfg.vocab_size), 2)


def test_bf16_prefill_matches_reference_loosely():
    cfg, jcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    toks = _tokens(10, 2, 12, cfg.vocab_size)
    emb = _frames(11, 2, cfg)
    out, _ = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill",
                         encoder_embeddings=torch.from_numpy(emb))
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill",
                         encoder_embeddings=jnp.asarray(emb))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=5e-2)
