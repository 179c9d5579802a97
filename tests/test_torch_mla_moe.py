"""The port's MLA and MoE (deepseek-v2, kimi-k2) held against the JAX package
on the CPU.

Configs: the reference's ``reduced`` deepseek-v2 (MLA, qk width 24 = 16 nope
+ 8 rope over a v width of 16, q and kv latents of rank 32, 8 experts top-2
with 1 shared, a dense first layer of ``dense_d_ff``) and kimi-k2 (GQA
attention at head dim 16, the same MoE), in float32, with the JAX
``lm.init_params(PRNGKey(0))`` tree carried over by ``from_numpy``. Held
against the reference: ``mla_apply`` in train / prefill / decode (1e-5; the
prefill cache 1e-6), the plain flash at qk 24 / v 16 against the reference's
``blocks.flash_attention`` (1e-6), ``moe_apply`` at the config's capacity
factor and at 0.5, where assignments drop (1e-5), the routing itself (the
top-k indices and the dispatch rows, dropped ones included, read from the
reference's own ``_moe_local`` trace: equal), ``forward`` in train and
prefill mode and three decode steps (logits and the model's caches 1e-5),
``pad_prefill_cache`` (equal) and ``ServingEngine.generate`` (greedy tokens
equal). Every routing these comparisons take has no near tie (the gap
between the k-th and the (k+1)-th router logit, and between any two of the
top k, above 1e-4, asserted; the token seeds are ones that have none), so
that a pass means the same routing and not luck. In bfloat16 two experts tie
exactly: the port orders them as ``jax.lax.top_k`` does. Float32 tolerances
cover summation order.
"""
import dataclasses
import functools

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
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
GAP = 1e-4           # the least router-logit gap a compared routing has


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _cfgs(name: str, **over):
    return (dataclasses.replace(treduced(tconfigs.get_arch(name)), **over),
            dataclasses.replace(jreduced(jconfigs.get_arch(name)), **over))


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


def _min_gap(logits: np.ndarray, k: int) -> float:
    """The least gap between consecutive sorted router logits among each
    token's k + 1 largest: the top-k set and its order both hang on it."""
    top = -np.sort(-np.asarray(logits, np.float64), axis=-1)[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


@pytest.fixture
def routed(monkeypatch):
    """Records every router-logit matrix the port's ``moe_route`` sees."""
    seen = []
    route = tblocks.moe_route

    def recording(logits, k, capacity):
        seen.append((logits.detach().float().numpy().copy(), k))
        return route(logits, k, capacity)

    monkeypatch.setattr(tblocks, "moe_route", recording)
    return seen


def _assert_no_near_tie(seen):
    assert seen, "no MoE layer ran"
    for logits, k in seen:
        assert _min_gap(logits, k) > GAP


# ----------------------------------------------------------------------------
# configs, trees, init
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_reduced_configs_are_the_ones_described(name):
    cfg, _ = _cfgs(name)
    kinds = cfg.layer_kinds()
    assert kinds[0][1] == "dense" and all(m == "moe" for _, m in kinds[1:])
    assert (cfg.num_experts, cfg.top_k, cfg.num_shared_experts) == (8, 2, 1)
    if name.startswith("deepseek"):
        assert kinds[0][0] == "mla"
        assert (cfg.resolved_head_dim + cfg.rope_head_dim,
                cfg.resolved_head_dim) == (24, 16)
    tlm.check_supported(cfg)


@pytest.mark.parametrize("name", MOE)
def test_from_numpy_carries_the_mla_and_moe_trees(name):
    """The JAX tree crosses over leaf for leaf: the MLA projections and
    norms, the router, the stacked expert leaves (L, E, D, F) and the
    shared expert; the leading dense layer takes ``dense_d_ff``."""
    cfg, jcfg = _cfgs(name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    _assert_tree_close(tp, jp, 0.0)
    moe = tp["decoder"]["body"]["l0"]["mlp"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    reps = cfg.num_layers - cfg.first_dense_layers
    assert tuple(moe["w1"].shape) == (reps, e, d, f)
    assert tuple(moe["w2"].shape) == (reps, e, f, d)
    assert tuple(moe["shared"]["w1"].shape) == (reps, d, f)
    assert tuple(tp["decoder"]["prefix0"]["l0"]["mlp"]["w1"].shape) == (
        d, cfg.dense_d_ff)
    if name.startswith("deepseek"):
        mla = tp["decoder"]["prefix0"]["l0"]["mixer"]
        assert sorted(mla) == ["kv_norm", "q_norm", "wdkv", "wdq", "wkr",
                               "wo", "wuk", "wuq", "wuv"]
    spec = jax.tree.map(lambda s: s.shape, jlm.model_spec(jcfg),
                        is_leaf=jparams.is_spec)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == spec


def test_init_draws_expert_leaves_one_expert_at_a_time():
    """An expert leaf is drawn an (L, E) slice at a time from the tree's
    generator, a stacked non-expert leaf a layer at a time as before: the
    same numbers as those slices' draws in order, so no config without
    experts moves, and the float32 draw never exceeds one slice."""
    gen = torch.Generator().manual_seed(5)
    spec = tparams.stack_specs({"w": tparams.ParamSpec((3, 4, 8),
                                                       experts=True)}, 2)
    w = tparams.init_tree(gen, spec)["w"]
    std = (2 * 3 * 4) ** -0.5
    ref = torch.Generator().manual_seed(5)
    want = torch.stack([torch.randn((4, 8), generator=ref) * std
                        for _ in range(6)]).reshape(2, 3, 4, 8)
    assert torch.equal(w, want)
    gen = torch.Generator().manual_seed(6)
    w = tparams.init_tree(gen, tparams.stack_specs(
        {"w": tparams.ParamSpec((4, 8))}, 3))["w"]
    ref = torch.Generator().manual_seed(6)
    assert torch.equal(w, torch.stack([
        torch.randn((4, 8), generator=ref) * (3 * 4) ** -0.5
        for _ in range(3)]))


# ----------------------------------------------------------------------------
# MLA
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_layer():
    cfg, jcfg = _cfgs("deepseek-v2-236b")
    jp = jparams.init_tree(jax.random.PRNGKey(7), jblocks.mla_spec(jcfg),
                           jnp.float32)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(8).normal(size=(2, 12, 64)).astype(np.float32)
    return cfg, jcfg, jp, tp, x


def test_mla_train_and_prefill_match_reference(mla_layer):
    cfg, jcfg, jp, tp, x = mla_layer
    pos = np.arange(12)[None, :]
    for mode in ("train", "prefill"):
        out, cache = tblocks.mla_apply(tp, torch.from_numpy(x),
                                       torch.from_numpy(pos), cfg, mode=mode)
        ref, jcache = jblocks.mla_apply(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, None, None, mode=mode)
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
        if mode == "train":
            assert cache is None
        else:
            assert int(cache["pos"]) == 12 == int(jcache["pos"])
            assert tuple(cache["c_kv"].shape) == (2, 12, cfg.kv_lora_rank)
            assert tuple(cache["k_rope"].shape) == (2, 12, cfg.rope_head_dim)
            _assert_tree_close(cache, jcache, 1e-6)


def test_mla_decode_matches_reference_in_place(mla_layer):
    """Three weight-absorbed decode steps against the reference's from the
    same latent cache; the port writes each latent row in place."""
    cfg, jcfg, jp, tp, x = mla_layer
    spec = tblocks.mla_cache_spec(cfg, 2, 16)
    cache = tparams.init_tree(torch.Generator(), spec)
    jcache = jax.tree.map(jnp.asarray, tparams.to_numpy(cache))
    c_kv = cache["c_kv"]
    for i in range(3):
        xi = x[:, i:i + 1]
        pos = np.full((2, 1), i)
        out, cache = tblocks.mla_apply(tp, torch.from_numpy(xi),
                                       torch.from_numpy(pos), cfg,
                                       mode="decode", cache=cache)
        ref, jcache = jblocks.mla_apply(jp, jnp.asarray(xi), jnp.asarray(pos),
                                        jcfg, None, None, mode="decode",
                                        cache=jcache)
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
    assert cache["c_kv"] is c_kv and int(cache["pos"]) == 3
    _assert_tree_close(cache, jcache, 1e-6)


def test_mla_prefill_then_decode_equals_train_forward(mla_layer):
    """Decode from a prefill's latent cache gives the next position's
    train-mode output: the absorbed form is the expanded one."""
    cfg, _, _, tp, x = mla_layer
    xt = torch.from_numpy(x)
    full, _ = tblocks.mla_apply(tp, xt, torch.arange(12)[None], cfg)
    _, cache = tblocks.mla_apply(tp, xt[:, :11], torch.arange(11)[None], cfg,
                                 mode="prefill")
    cache = {k: (torch.nn.functional.pad(v, (0, 0, 0, 5)) if v.ndim == 3
                 else v) for k, v in cache.items()}
    out, _ = tblocks.mla_apply(tp, xt[:, 11:], torch.full((1, 1), 11), cfg,
                               mode="decode", cache=cache)
    torch.testing.assert_close(out, full[:, 11:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_at_mla_widths_matches_reference(causal):
    """qk 24 over v 16, scaled by 24^-0.5: the port's plain flash and
    model layer against the reference's ``blocks.flash_attention``."""
    rng = np.random.default_rng(9)
    q, k = (rng.normal(size=(2, 40, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    ref = jblocks.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, q_chunk=8,
                                  kv_chunk=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert tuple(plain.shape) == (2, 40, 4, 16)
    np.testing.assert_allclose(_np(plain), _jnp(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(tblocks.flash_attention(tq, tk, tv, causal=causal, kv_chunk=16)),
        _jnp(ref), rtol=0, atol=1e-6)
    assert torch.equal(fa.flash_attention(tq, tk, tv, causal=causal), plain)


# ----------------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------------

def _moe_layer(name, seed, **over):
    cfg, jcfg = _cfgs(name, **over)
    jp = jparams.init_tree(jax.random.PRNGKey(seed), jblocks.moe_spec(jcfg),
                           jnp.float32)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(size=(2, 24, 64)).astype(
        np.float32)
    return cfg, jcfg, jp, tp, x


def _reference_dispatch(x_flat, logits, w1, w2, w3, k, capacity):
    """The reference's own routing, read from a trace of its ``_moe_local``:
    the indices ``jax.lax.top_k`` returns and the rows each round of its
    scatter-add writes to (the trash row for a dropped assignment)."""
    e = logits.shape[1]
    fn = functools.partial(jblocks._moe_local, e_start=0, e_local=e,
                           top_k=k, capacity=capacity)
    closed = jax.make_jaxpr(fn)(x_flat, logits, w1, w2, w3)
    env = dict(zip(closed.jaxpr.constvars, closed.consts))
    env.update(zip(closed.jaxpr.invars, (x_flat, logits, w1, w2, w3)))

    def read(v):
        return v.val if type(v).__name__ == "Literal" else env[v]

    idx, rows = None, []
    for eqn in closed.jaxpr.eqns:
        vals = [read(v) for v in eqn.invars]
        outs = eqn.primitive.bind(*vals, **eqn.params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
        if eqn.primitive.name == "top_k":
            idx = np.asarray(outs[1])
        elif eqn.primitive.name == "scatter-add":
            rows.append(np.asarray(vals[1])[:, 0])
    assert idx is not None and len(rows) == k
    return idx, np.stack(rows)


@pytest.mark.parametrize("factor", [None, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_moe_routing_equals_reference(name, factor):
    """Top-k indices, every assignment's dispatch row and the set of
    dropped assignments equal the reference's on the same logits; at a
    capacity factor of 0.5 some assignments drop."""
    over = {} if factor is None else {"capacity_factor": factor}
    cfg, jcfg, jp, tp, x = _moe_layer(name, 11, **over)
    x_flat = jnp.asarray(x.reshape(-1, 64))
    logits = x_flat @ jp["router"]
    assert _min_gap(logits, cfg.top_k) > GAP
    t, e, k = x_flat.shape[0], cfg.num_experts, cfg.top_k
    cap = int(np.ceil(t * k / e * cfg.capacity_factor))
    idx, rows = _reference_dispatch(x_flat, logits, jp["w1"], jp["w2"],
                                    jp["w3"], k, cap)
    gates, tidx, slots, keeps = tblocks.moe_route(
        torch.from_numpy(np.array(logits)), k, cap)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(slots.numpy(), rows)
    np.testing.assert_array_equal(keeps.numpy(), rows != e * cap)
    if factor == 0.5:
        assert int((~keeps).sum()) > 0
    np.testing.assert_allclose(
        _np(gates), _jnp(jax.nn.softmax(jax.lax.top_k(logits, k)[0], -1)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", [None, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference(name, factor):
    over = {} if factor is None else {"capacity_factor": factor}
    cfg, jcfg, jp, tp, x = _moe_layer(name, 12, **over)
    out = tblocks.moe_apply(tp, torch.from_numpy(x), cfg)
    ref = jblocks.moe_apply(jp, jnp.asarray(x), jcfg, None, None)
    assert _min_gap(x.reshape(-1, 64) @ np.asarray(jp["router"]),
                    cfg.top_k) > GAP
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)


def test_moe_without_shared_experts_matches_reference():
    cfg, jcfg, jp, tp, x = _moe_layer("deepseek-v2-236b", 13,
                                      num_shared_experts=0)
    assert "shared" not in tp
    np.testing.assert_allclose(
        _np(tblocks.moe_apply(tp, torch.from_numpy(x), cfg)),
        _jnp(jblocks.moe_apply(jp, jnp.asarray(x), jcfg, None, None)),
        rtol=0, atol=1e-5)


def test_bf16_ties_route_as_jax_top_k():
    """bfloat16 router weights whose columns 3 and 5 are equal, so those
    experts' logits tie exactly for every token, across the top-k boundary
    for some: the port's top-k equals ``jax.lax.top_k`` (the lower index
    first), where ``torch.topk`` promises no order; the layer's output
    matches the eager reference within 1e-2 of its largest magnitude (each
    side rounds to bf16 after its own summation order)."""
    cfg, jcfg, jp, tp, x = _moe_layer("deepseek-v2-236b", 14)
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg, jcfg = (dataclasses.replace(c, **bf) for c in (cfg, jcfg))
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 3]
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                      {**jp, "router": router})
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    logits = xb.reshape(-1, 64) @ jp["router"]
    assert bool((logits[:, 3] == logits[:, 5]).all())
    top = np.asarray(jax.lax.top_k(logits, 3)[1])
    assert ((top == 3) | (top == 5)).any(axis=1).sum() > 5
    # the tie decides the top-2 set of tokens whose 2nd and 3rd are 3 and 5
    assert (np.sort(top[:, 1:3], axis=1) == [3, 5]).all(axis=1).any()
    for k in (2, 3):
        tl = tparams.from_numpy({"l": np.asarray(logits)})["l"]
        np.testing.assert_array_equal(tblocks.top_k(tl, k)[1].numpy(),
                                      np.asarray(jax.lax.top_k(logits, k)[1]))
    out = tblocks.moe_apply(tp, tparams.from_numpy(
        {"x": np.asarray(xb)})["x"], cfg)
    ref = _jnp(jblocks.moe_apply(jp, xb, jcfg, None, None))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("name", MOE)
def test_bf16_forward_matches_reference_loosely(name):
    """bfloat16 weights and activations through the whole model: each side
    rounds every intermediate to bf16 after its own summation order, and
    the expert and shared FFNs' silu is one fused ``F.silu`` where the
    eager reference rounds x * sigmoid(x) op by op, so the logits (|logit|
    < 5 here) agree to a few bf16 ulps, 0.05, as the dense bf16 test's."""
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg, jcfg = _cfgs(name, **bf)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    toks = _tokens(0, 2, 32, cfg.vocab_size)
    out, _ = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    assert out.dtype == torch.bfloat16
    assert np.abs(_jnp(ref)).max() < 5
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=5e-2)


# ----------------------------------------------------------------------------
# the model and the engine
# ----------------------------------------------------------------------------

MODELS = [("deepseek-v2-236b", 0), ("kimi-k2-1t-a32b", 0),
          ("kimi-k2-1t-a32b", 2)]
MODEL_IDS = ["deepseek-v2", "kimi-k2", "kimi-k2-gqa"]


@pytest.fixture(scope="module", params=MODELS, ids=MODEL_IDS)
def model(request):
    name, kv = request.param
    cfg, jcfg = _cfgs(name, **({"num_kv_heads": kv} if kv else {}))
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jp, tparams.from_numpy(jax.tree.map(np.asarray, jp))


def test_forward_train_matches_reference(model, routed):
    cfg, jcfg, jp, tp = model
    toks = _tokens(0, 2, 24, cfg.vocab_size)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    assert cache is None
    _assert_no_near_tie(routed)
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)


def test_prefill_pad_and_three_decode_steps_match_reference(model, routed):
    cfg, jcfg, jp, tp = model
    toks = _tokens(21, 2, 20, cfg.vocab_size)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, jcache = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill")
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
    # past the first layer the caches carry the layers' float32 summation
    # orders (a few ulps of values ~2): the logits' limit; one layer's own
    # cache is held at 1e-6 (test_mla_train_and_prefill_match_reference)
    _assert_tree_close(cache, jcache, 1e-5)

    cache = tengine.pad_prefill_cache(cfg, cache, 2, 32)
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 32)
    _assert_tree_close(cache, jcache, 1e-5)
    nxt = _tokens(22, 2, 3, cfg.vocab_size)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        out, cache = tlm.forward(tp, torch.from_numpy(tok), cfg,
                                 mode="decode", cache=cache)
        ref, jcache = jlm.forward(jp, jnp.asarray(tok), jcfg, mode="decode",
                                  cache=jcache)
        np.testing.assert_allclose(_np(out), _jnp(ref), rtol=0, atol=1e-5)
    _assert_tree_close(cache, jcache, 1e-5)
    assert int(cache["pos"]) == 23
    _assert_no_near_tie(routed)


def test_pad_prefill_cache_grows_the_mla_latent():
    """An MLA layer's ``c_kv`` / ``k_rope`` grow along S to max_len, the
    prefill's rows first, zeros after, as the reference's."""
    cfg, jcfg = _cfgs("deepseek-v2-236b")
    rng = np.random.default_rng(15)
    spec = jlm.cache_spec(jcfg, 2, 10)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape),
                                                jnp.float32)
                          if s.shape else jnp.asarray(10, jnp.int32),
                          spec, is_leaf=jparams.is_spec)
    cache = tparams.from_numpy(jax.tree.map(np.asarray, jcache))
    got = tengine.pad_prefill_cache(cfg, cache, 2, 32)
    want = jengine.pad_prefill_cache(jcfg, jcache, 2, 32)
    mla = got["decoder"]["prefix0"]["l0"]["mixer"]
    assert tuple(mla["c_kv"].shape) == (2, 32, cfg.kv_lora_rank)
    assert tuple(mla["k_rope"].shape) == (2, 32, cfg.rope_head_dim)
    _assert_tree_close(got, want, 0.0)


def test_generate_greedy_equals_reference_engine(model, routed):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(3, 2, 8, cfg.vocab_size)
    ref = jengine.ServingEngine(jcfg, jp, max_len=32).generate(
        jnp.asarray(prompts), max_new_tokens=5)
    eng = ServingEngine(cfg, tp, max_len=32, device="cpu")
    out = eng.generate(prompts, max_new_tokens=5)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    _assert_no_near_tie(routed)
    logits, _ = tlm.forward(tp, torch.from_numpy(prompts), cfg)
    torch.testing.assert_close(eng.prefill_logits, logits[:, -1], rtol=0,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# the card wrapper's pairs (CPU tensors: the check reads dtype and shapes)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_card_operands_take_the_full_width_models(name):
    """deepseek-v2's MLA prefill (qk 192 over v 128) and kimi-k2's heads
    (112) pass the card check at full width; a pair no kernel is built for
    raises, naming the pairs that exist."""
    cfg = tconfigs.get_arch(name)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d = dh + (cfg.rope_head_dim if cfg.kv_lora_rank else 0)
    q = torch.zeros((1, 8, h, d), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, hkv, d), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, hkv, dh), dtype=torch.bfloat16)
    fa._check_shapes(q, k, v)
    fa._check_card_operands(q, k, v)
    assert (d, dh) in fa.HEAD_DIM_PAIRS[torch.bfloat16]
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        fa._check_card_operands(q, k, v[..., :dh - 16])
    with pytest.raises(ValueError, match="head dim"):
        fa._check_card_operands(q.float(), k.float(), v.float())
