"""The port's LM serving path held against the JAX package on the CPU.

Configs: every field of every architecture equal to the reference's
(``dataclasses.asdict`` against ``dataclasses.asdict``). Blocks: ``rmsnorm``,
``rope``, ``decode_attention`` and ``mlp_apply`` on the same numpy inputs.
The model: ``reduced(granite-8b)`` in float32 (and a GQA variant) with the
JAX ``lm.init_params(PRNGKey(0))`` tree carried over by ``from_numpy``:
``forward`` in train and prefill mode (logits within 1e-5, the prefill cache
within 1e-6), three decode steps (logits within 1e-5), ``pad_prefill_cache``
and ``ServingEngine.generate`` (greedy tokens equal). Float32 tolerances
cover summation order; the bfloat16 case is looser (see its test). The
refusals of what this slice does not port raise. recurrentgemma-2b's trees
are held here at full width; its model is tests/test_torch_recurrent.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
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

DENSE = ["granite-8b", "yi-34b", "stablelm-3b", "glm4-9b", "chameleon-34b"]
# every config the port serves: the dense ones, the hybrid, the MoE ones
# (MLA and MoE: tests/test_torch_mla_moe.py) and the encoder-decoder
# (tests/test_torch_whisper.py)
SERVED = DENSE + ["recurrentgemma-2b", "deepseek-v2-236b", "kimi-k2-1t-a32b",
                  "whisper-base"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

def test_registry_holds_the_same_archs():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert [dataclasses.asdict(s) for s in tconfigs.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in jconfigs.ALL_SHAPES]


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_config_fields_equal_reference(name):
    port, ref = tconfigs.get_arch(name), jconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(treduced(port)) == dataclasses.asdict(
        jreduced(ref))
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.dtype == getattr(torch, ref.compute_dtype)


@pytest.mark.parametrize("name", SERVED)
def test_model_and_cache_specs_match_reference(name):
    """Same tree, shapes and leaf dtypes, full width (no arrays made)."""
    cfg, jcfg = tconfigs.get_arch(name), jconfigs.get_arch(name)
    t_shapes = _spec_shapes(tlm.model_spec(cfg))
    j_shapes = jax.tree.map(lambda s: s.shape, jlm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
    assert t_shapes == j_shapes
    t_cache = _spec_shapes(tlm.cache_spec(cfg, 2, 64))
    j_cache = jax.tree.map(lambda s: s.shape, jlm.cache_spec(jcfg, 2, 64),
                           is_leaf=jparams.is_spec)
    assert t_cache == j_cache
    assert [s.name for s in tlm.segment_plan(cfg)] == [
        s.name for s in jlm.segment_plan(jcfg)]


def _spec_shapes(tree):
    if isinstance(tree, tparams.ParamSpec):
        return tree.shape
    return {k: _spec_shapes(v) for k, v in tree.items()}


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 1e-2)])
def test_rmsnorm_and_rope_match_reference(dtype, atol):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(12)[None, :] + 5
    xj, xt = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    out = tblocks.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-5)
    ref = jblocks.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-5)
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=atol * 4)
    out = tblocks.rope(xt, torch.from_numpy(pos), 10000.0)
    ref = jblocks.rope(xj, jnp.asarray(pos), 10000.0)
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=atol * 4)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6),
                                        ("bfloat16", 2e-2)])
def test_decode_attention_matches_reference(dtype, atol):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    jo = lambda a: jnp.asarray(a).astype(dtype)                   # noqa: E731
    for cur in (1, 13, 20):
        out = tblocks.decode_attention(to(q), to(kc), to(vc),
                                       torch.tensor(cur))
        ref = jblocks.decode_attention(jo(q), jo(kc), jo(vc),
                                       jnp.asarray(cur))
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    cfg = dataclasses.replace(treduced(tconfigs.get_arch("granite-8b")),
                              mlp_gated=gated)
    jcfg = dataclasses.replace(jreduced(jconfigs.get_arch("granite-8b")),
                               mlp_gated=gated)
    p = jparams.init_tree(jax.random.PRNGKey(3), jblocks.mlp_spec(jcfg),
                          jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 5, 64)).astype(np.float32)
    out = tblocks.mlp_apply(tparams.from_numpy(jax.tree.map(np.asarray, p)),
                            torch.from_numpy(x), cfg)
    ref = jblocks.mlp_apply(p, jnp.asarray(x), jcfg, None, None)
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)


# ----------------------------------------------------------------------------
# the model and the engine, reduced granite-8b
# ----------------------------------------------------------------------------

KV_HEADS = [0, 2]      # 0: reduced() as it is (MHA 4/4); 2: GQA 4/2


def _cfgs(kv: int, **over):
    jcfg = jreduced(jconfigs.get_arch("granite-8b"))
    cfg = treduced(tconfigs.get_arch("granite-8b"))
    if kv:
        over["num_kv_heads"] = kv
    return (dataclasses.replace(cfg, **over),
            dataclasses.replace(jcfg, **over))


@pytest.fixture(scope="module", params=KV_HEADS, ids=["mha", "gqa"])
def model(request):
    cfg, jcfg = _cfgs(request.param)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, tparams.from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _assert_tree_close(port, ref, atol):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            _assert_tree_close(port[k], ref[k], atol)
        return
    assert tuple(port.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _jnp(ref), rtol=0, atol=atol)


def test_forward_train_matches_reference(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(0, 2, 40, cfg.vocab_size)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    assert cache is None
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)


def test_prefill_and_three_decode_steps_match_reference(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(1, 2, 24, cfg.vocab_size)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, jcache = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill")
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
    _assert_tree_close(cache, jcache, 1e-6)

    cache = tengine.pad_prefill_cache(cfg, cache, 2, 32)
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 32)
    _assert_tree_close(cache, jcache, 1e-6)
    nxt = _tokens(2, 2, 3, cfg.vocab_size)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        out, cache = tlm.forward(tp, torch.from_numpy(tok), cfg,
                                 mode="decode", cache=cache)
        ref, jcache = jlm.forward(jp, jnp.asarray(tok), jcfg, mode="decode",
                                  cache=jcache)
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
    _assert_tree_close(cache, jcache, 1e-5)
    assert int(cache["pos"]) == 27


def test_generate_greedy_equals_reference_engine(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(3, 2, 8, cfg.vocab_size)
    ref = jengine.ServingEngine(jcfg, jp, max_len=64).generate(
        jnp.asarray(prompts), max_new_tokens=5)
    eng = ServingEngine(cfg, tp, max_len=64, device="cpu")
    out = eng.generate(prompts, max_new_tokens=5)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert set(eng.stats) == {"prefill_ms", "decode_ms_per_token",
                              "tokens_per_s"}
    # teacher forcing: the first token is the train forward's argmax
    logits, _ = tlm.forward(tp, torch.from_numpy(prompts), cfg)
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(),
                                  out[:, 0].numpy())
    torch.testing.assert_close(eng.prefill_logits, logits[:, -1], rtol=0,
                               atol=1e-6)


def test_head_dim_80_generate_equals_reference_engine():
    """stablelm-3b's head dim, 80 (d_model 2560 over 32 heads), which the
    card serves through the wgmma kernel: reduced stablelm-3b with
    ``head_dim=80``, the CPU engine against the JAX engine with the granite
    case's tolerances (greedy tokens equal, logits within 1e-5)."""
    assert tconfigs.get_arch("stablelm-3b").resolved_head_dim == 80
    cfg = dataclasses.replace(treduced(tconfigs.get_arch("stablelm-3b")),
                              head_dim=80)
    jcfg = dataclasses.replace(jreduced(jconfigs.get_arch("stablelm-3b")),
                               head_dim=80)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    prompts = _tokens(6, 2, 8, cfg.vocab_size)
    ref = jengine.ServingEngine(jcfg, jp, max_len=64).generate(
        jnp.asarray(prompts), max_new_tokens=5)
    eng = ServingEngine(cfg, tp, max_len=64, device="cpu")
    out = eng.generate(prompts, max_new_tokens=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    logits, _ = tlm.forward(tp, torch.from_numpy(prompts), cfg)
    jlogits, _ = jlm.forward(jp, jnp.asarray(prompts), jcfg)
    np.testing.assert_allclose(_np(logits), _jnp(jlogits), rtol=0, atol=1e-5)
    torch.testing.assert_close(eng.prefill_logits, logits[:, -1], rtol=0,
                               atol=1e-6)


def test_bf16_forward_matches_reference_loosely():
    """bfloat16 weights and activations: each side rounds every
    intermediate to bf16 after its own summation order, so the logits
    (|logit| < 4 here) agree to a few bf16 ulps, 0.05."""
    cfg, jcfg = _cfgs(2, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["embed"]["w"].dtype == torch.bfloat16
    toks = _tokens(4, 2, 32, cfg.vocab_size)
    out, _ = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=5e-2)


def test_one_layer_body_is_not_stacked():
    """A single repeat keeps unstacked leaves, as the reference's plan."""
    cfg, jcfg = _cfgs(0, num_layers=1)
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["decoder"]["body"]["l0"]["mixer"]["wq"].ndim == 3
    toks = _tokens(5, 1, 16, cfg.vocab_size)
    out, _ = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)


# ----------------------------------------------------------------------------
# init and the numpy bridge
# ----------------------------------------------------------------------------

def test_init_params_is_seeded_typed_and_shaped():
    cfg = dataclasses.replace(treduced(tconfigs.get_arch("granite-8b")),
                              param_dtype="bfloat16", num_layers=4)
    a, b = tlm.init_params(0, cfg), tlm.init_params(0, cfg)
    c = tlm.init_params(1, cfg)
    wq = a["decoder"]["body"]["l0"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == (4, 64, 4, 16)
    assert torch.equal(wq, b["decoder"]["body"]["l0"]["mixer"]["wq"])
    assert not torch.equal(wq, c["decoder"]["body"]["l0"]["mixer"]["wq"])
    assert not torch.equal(wq[0], wq[1])          # one draw per layer
    # the reference's scale: 1/sqrt(fan-in over the stacked shape)
    assert abs(float(wq.float().std()) - (4 * 64 * 4) ** -0.5) < 0.01
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64,
                                                            dtype=torch.bfloat16))
    cache = tlm.init_cache(cfg, 2, 8)
    assert cache["pos"].dtype == torch.int32
    assert cache["decoder"]["body"]["l0"]["mixer"]["pos"].shape == (4,)
    # the cache is in the compute dtype (float32 here), not the param dtype
    assert cache["decoder"]["body"]["l0"]["mixer"]["k"].dtype == cfg.dtype
    assert cfg.dtype == torch.float32


def test_from_numpy_carries_bf16_bits():
    x = jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32)).astype(
        jnp.bfloat16)
    t = tparams.from_numpy({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), _jnp(x))


# ----------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------

def test_mesh_temperature_and_missing_card_raise():
    cfg, _ = _cfgs(0)
    params = tlm.init_params(0, cfg)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="mesh"):
        tlm.forward(params, toks, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(cfg, params, mesh=object(), device="cpu")
    # temperature sampling is ported: without a key the engine decodes
    # greedily, as the reference's does (sampled tokens:
    # tests/test_torch_sampling.py)
    prompts = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    hot = ServingEngine(cfg, params, max_len=16, temperature=0.7,
                        device="cpu").generate(prompts, 4)
    cold = ServingEngine(cfg, params, max_len=16,
                         device="cpu").generate(prompts, 4)
    assert torch.equal(hot, cold)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(cfg, params)
