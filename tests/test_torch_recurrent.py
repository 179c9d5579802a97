"""The port's RG-LRU mixer and recurrentgemma-2b held against the JAX package
on the CPU.

Reduced recurrentgemma-2b (3 layers: rglru, rglru, local_attn; d 64, 4
heads over 1 kv head of 16, window 16, float32), the JAX
``lm.init_params(PRNGKey(0))`` tree carried over by ``from_numpy``, with
every ``lam`` redrawn so that softplus(lam) lies in [0.001, 0.1]: a =
exp(-8 softplus(lam) r) then lies in (0.45, 1), where the seeded lam = 1
gives a ~ 0.005 and a scan that dropped its carry would pass. Inputs are
drawn with numpy from a seed. The model is held to the reference's
``forward`` jitted once per mode, except in bfloat16, where the port
follows the eager reference's op-by-op rounding (jit fuses, and rounds
elsewhere).

Modules: ``_causal_conv1d`` (with and without a state), ``_rglru_gates``,
``rglru_apply`` in train, prefill and decode, each against the
reference's function at 1e-6 of the output's largest magnitude (float32
rounding: the matmuls sum in another order); the scan's plain version
against ``jax.lax.associative_scan`` (the same products in the same
order: equal bit for bit), and a scan that drops the carry lies far off;
the gates split in two (``_rglru_gate_inputs``, ``_rglru_ab``) equal to
the unsplit function bit for bit, and the gated scan's plain version
against the reference's chain in float32 and bfloat16.
The model: ``forward`` train, then prefill and three decode steps, at
1e-5 (logits up to ~5), the prefill and padded caches leaf for leaf at
1e-6 of each leaf's largest magnitude (1e-5 after three steps);
``ServingEngine.generate`` against the reference's engine (greedy
tokens equal) at prompts of 12 and 16, the window's length; past the
window (a 24-token prompt) each decode step's logits against the
reference's train-mode forward over the prompt and the tokens so far, at
1e-5 (the reference's engine is off there: its ``pad_prefill_cache``
keeps the first ``window`` keys, ROADMAP §3); bfloat16 loosely (5e-2; see
its test).
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
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.models import recurrent as jrec
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.configs.reduced import reduced as treduced
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import rglru_scan as rs
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import recurrent as trec
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

ARCH = "recurrentgemma-2b"
MODULE_RTOL = 1e-6     # of the output's largest magnitude, float32
MODEL_ATOL = 1e-5      # logits, float32
CACHE_RTOL = 1e-6      # of a cache leaf's largest magnitude (or of 1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close_rel(port, ref, rtol=MODULE_RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(port), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


def _set_lam(tree, rng):
    """Every ``lam`` leaf redrawn so that softplus(lam) ~ U[0.001, 0.1]."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_lam(v, rng)
        elif k == "lam":
            y = rng.uniform(0.001, 0.1, np.shape(v))
            tree[k] = np.log(np.expm1(y)).astype(np.float32)


_JITTED = {}


def _ref(jcfg, mode="train"):
    """The reference's ``lm.forward`` in ``mode``, jitted once per mode (a
    first eager call compiles op by op, ~9 s; the float32 results differ
    from eager ones by float32 rounding, within the model tolerances)."""
    if (jcfg, mode) not in _JITTED:
        _JITTED[jcfg, mode] = jax.jit(functools.partial(jlm.forward,
                                                        cfg=jcfg, mode=mode))
    return _JITTED[jcfg, mode]


def _cfgs(**over):
    return (dataclasses.replace(treduced(tconfigs.get_arch(ARCH)), **over),
            dataclasses.replace(jreduced(jconfigs.get_arch(ARCH)), **over))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, jax params, port params) of reduced recurrentgemma-2b."""
    cfg, jcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    _set_lam(jp, np.random.default_rng(0))
    return cfg, jcfg, jax.tree.map(jnp.asarray, jp), tparams.from_numpy(jp)


@pytest.fixture(scope="module")
def mixer(model):
    """One RG-LRU layer's parameters, both sides, and its a near 1."""
    cfg, _, jp, tp = model
    return jp["decoder"]["body"]["l0"]["mixer"], \
        tp["decoder"]["body"]["l0"]["mixer"]


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _x(seed, b, s, d=64):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


# ----------------------------------------------------------------------------
# the mixer's modules
# ----------------------------------------------------------------------------

def test_specs_match_reference():
    """Leaves, shapes, inits and dtypes of the mixer and its cache, at full
    width (no arrays made)."""
    cfg, jcfg = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    for port, ref in ((trec.rglru_spec(cfg), jrec.rglru_spec(jcfg)),
                      (trec.rglru_cache_spec(cfg, 4),
                       jrec.rglru_cache_spec(jcfg, 4))):
        assert sorted(port) == sorted(ref)
        for k in port:
            assert (port[k].shape, port[k].init, port[k].scale,
                    port[k].dtype) == (ref[k].shape, ref[k].init,
                                       ref[k].scale, ref[k].dtype), k
    assert isinstance(jrec.rglru_spec(jcfg)["lam"], jparams.ParamSpec)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = rng.normal(size=(4, 64)).astype(np.float32)
    st = rng.normal(size=(2, 3, 64)).astype(np.float32) if with_state \
        else None
    out, state = trec._causal_conv1d(
        torch.from_numpy(u), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st))
    ref, jstate = jrec._causal_conv1d(jnp.asarray(u), jnp.asarray(w),
                                      None if st is None else jnp.asarray(st))
    _close_rel(out, ref)
    np.testing.assert_array_equal(_np(state), np.asarray(jstate))


def test_rglru_gates_match_reference(mixer):
    jm, tm = mixer
    u = _x(2, 2, 11)
    a, b = trec._rglru_gates(tm, torch.from_numpy(u))
    ja, jb = jrec._rglru_gates(jm, jnp.asarray(u))
    assert a.dtype == b.dtype == torch.float32
    _close_rel(a, ja)
    _close_rel(b, jb)
    # lam set as the module says: a near 1, far from the seeded lam's 0.005
    assert 0.45 < float(a.min()) and float(a.max()) < 1.0
    assert float(a.mean()) > 0.8


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_apply_matches_reference(model, mixer, mode):
    cfg, jcfg, _, _ = model
    jm, tm = mixer
    s = 1 if mode == "decode" else 13
    x = _x(3, 2, s)
    cache = jcache = None
    if mode == "decode":
        rng = np.random.default_rng(4)
        h = rng.normal(size=(2, 64)).astype(np.float32)
        conv = rng.normal(size=(2, 3, 64)).astype(np.float32)
        jcache = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        cache = {"h": torch.from_numpy(h.copy()),
                 "conv": torch.from_numpy(conv.copy())}
    y, nc = trec.rglru_apply(tm, torch.from_numpy(x), cfg, mode=mode,
                             cache=cache)
    ref, jnc = jrec.rglru_apply(jm, jnp.asarray(x), jcfg, None, None,
                                mode=mode, cache=jcache)
    _close_rel(y, ref)
    if mode == "train":
        assert nc is None and jnc is None
        return
    assert sorted(nc) == sorted(jnc) == ["conv", "h"]
    assert nc["h"].dtype == torch.float32
    _close_rel(nc["h"], jnc["h"])
    _close_rel(nc["conv"], jnc["conv"])
    if mode == "decode":    # written in place into the cache it was given
        assert nc["h"] is cache["h"] and nc["conv"] is cache["conv"]


def test_scan_plain_equals_the_associative_scan():
    """The plain version is the reference's recursion, product for product:
    equal to ``jax.lax.associative_scan`` at odd and even lengths."""
    rng = np.random.default_rng(5)
    for s in (1, 2, 7, 100):
        a = rng.uniform(0.45, 1.0, (2, s, 8)).astype(np.float32)
        b = rng.normal(size=(2, s, 8)).astype(np.float32)
        _, ref = jax.lax.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        out = rs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
        assert out.shape == (2, s, 8)
        _close_rel(out, ref)


def test_a_scan_without_its_carry_is_far_off(mixer):
    """At these gates the carry is most of h: a scan that dropped it (h =
    b) misses the reference by far more than the tolerance."""
    jm, tm = mixer
    u = _x(6, 2, 64)
    a, b = trec._rglru_gates(tm, torch.from_numpy(u))
    ja, jb = jrec._rglru_gates(jm, jnp.asarray(u))
    _, ref = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]), (ja, jb),
        axis=1)
    ref = np.asarray(ref)
    _close_rel(rs.rglru_scan(a, b), ref)
    dropped = np.abs(_np(b) - ref).max() / np.abs(ref).max()
    assert dropped > 1e4 * MODULE_RTOL, dropped


def test_cpu_tensors_never_launch_the_scan():
    cuda_lib.reset_launch_counts()
    a = torch.rand(1, 5, 3)
    rs.rglru_scan(a, a)
    assert cuda_lib.launch_counts()["rglru_scan"] == 0
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="one shape"):
        rs.rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="no kernel"):
        rs.rglru_scan(a.to("meta"), a.to("meta"))


def _gate_params(rng, r):
    """Float32 mixer gate parameters, both sides, whose projections are the
    identity (exact in any dtype, so both sides' r and i are the sigmoid of
    the same sums), with drawn biases and lam as ``_set_lam`` draws it."""
    p = {"w_a": np.eye(r, dtype=np.float32),
         "w_i": np.eye(r, dtype=np.float32),
         "b_a": rng.normal(size=r).astype(np.float32),
         "b_i": rng.normal(size=r).astype(np.float32),
         "lam": np.log(np.expm1(rng.uniform(0.001, 0.1, r))).astype(
             np.float32)}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _old_rglru_gates(params, u):
    """``_rglru_gates`` as one function, before it was split in two."""
    f32 = torch.float32
    r = trec._sigmoid(u @ params["w_a"].to(u.dtype)
                      + params["b_a"].to(u.dtype))
    i = trec._sigmoid(u @ params["w_i"].to(u.dtype)
                      + params["b_i"].to(u.dtype))
    log_a = -8.0 * trec._softplus(params["lam"].to(f32)) * r.to(f32)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, beta * (i * u).to(f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_gates_equal_the_old_gates(mixer, dtype):
    """``_rglru_ab`` on ``_rglru_gate_inputs`` (and ``_rglru_gates``, the
    two together) equals the unsplit function bit for bit."""
    _, tm = mixer
    u = torch.from_numpy(_x(7, 2, 11)).to(getattr(torch, dtype))
    a0, b0 = _old_rglru_gates(tm, u)
    r, i, c = trec._rglru_gate_inputs(tm, u)
    assert r.dtype == i.dtype == u.dtype and c.dtype == torch.float32
    for a, b in (trec._rglru_ab(r, i, u, c), trec._rglru_gates(tm, u)):
        assert torch.equal(a, a0) and torch.equal(b, b0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_scan_plain_matches_the_reference_chain(dtype):
    """``rglru_scan_gated_plain`` against the reference's chain
    (``_rglru_gates``, ``jax.lax.associative_scan``, ``astype``) on the
    same gates: h_last at MODULE_RTOL of its largest magnitude, hs there
    in float32 and within one bf16 ulp in bfloat16 (h, equal to float32
    rounding on both sides, may round to either neighbour); h_last is the
    float32 chain's last step bit for bit."""
    rng = np.random.default_rng(8)
    tp, jp = _gate_params(rng, 24)
    x = rng.normal(size=(2, 37, 24)).astype(np.float32)
    u = torch.from_numpy(x).to(getattr(torch, dtype))
    ju = jnp.asarray(x).astype(dtype)
    r, i, c = trec._rglru_gate_inputs(tp, u)
    hs, h_last = rs.rglru_scan_gated_plain(r, i, u, c)
    _, ref = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
        jrec._rglru_gates(jp, ju), axis=1)
    assert hs.dtype == u.dtype and h_last.dtype == torch.float32
    _close_rel(h_last, np.asarray(ref)[:, -1])
    ref_hs = np.asarray(ref.astype(dtype), np.float32)
    if dtype == "float32":
        _close_rel(hs, ref_hs)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref_hs), 1e-30)))
                      - 7)
        assert (np.abs(_np(hs) - ref_hs) <= ulp).all()
    h = rs.rglru_scan_plain(*trec._rglru_ab(r, i, u, c))
    assert torch.equal(h_last, h[:, -1]) and torch.equal(hs, h.to(u.dtype))


def test_cpu_tensors_never_launch_either_scan_instance():
    cuda_lib.reset_launch_counts()
    a = torch.rand(1, 5, 3)
    rs.rglru_scan(a, a)
    rs.rglru_scan_gated(a, a, a, torch.full((3,), -0.1))
    rs.rglru_scan_gated(*(a.bfloat16(),) * 3, torch.full((3,), -0.1))
    counts = cuda_lib.launch_counts()
    assert counts["rglru_scan"] == counts["rglru_scan_gated"] == 0
    with pytest.raises(TypeError, match="bfloat16"):
        rs.rglru_scan_gated(a.double(), a.double(), a.double(),
                            torch.zeros(3))
    with pytest.raises(ValueError, match="one shape"):
        rs.rglru_scan_gated(a, a, a, torch.zeros(4))
    with pytest.raises(ValueError, match="no kernel"):
        rs.rglru_scan_gated(*(a.to("meta"),) * 3, torch.zeros(3).to("meta"))


# ----------------------------------------------------------------------------
# the model and the engine
# ----------------------------------------------------------------------------

def _assert_tree_close(port, ref, rtol):
    """Leaf for leaf: the same keys, shapes and dtypes, values within rtol
    of each leaf's largest magnitude (or of 1)."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            _assert_tree_close(port[k], ref[k], rtol)
        return
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.dtype == getattr(torch, str(ref.dtype))
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(_np(port), ref, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


def test_forward_train_matches_reference(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(10, 2, 40)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = _ref(jcfg)(jp, jnp.asarray(toks))
    assert cache is None
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                               atol=MODEL_ATOL)


def test_prefill_and_three_decode_steps_match_reference(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(11, 2, 12)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, jcache = _ref(jcfg, "prefill")(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                               atol=MODEL_ATOL)
    _assert_tree_close(cache, jcache, CACHE_RTOL)

    cache = tengine.pad_prefill_cache(cfg, cache, 2, 32)
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 32)
    _assert_tree_close(cache, jcache, CACHE_RTOL)
    ring = cache["decoder"]["body"]["l2"]["mixer"]["k"]
    assert ring.shape[1] == cfg.window          # min(window, max_len) slots
    nxt = _tokens(12, 2, 3)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        out, cache = tlm.forward(tp, torch.from_numpy(tok), cfg,
                                 mode="decode", cache=cache)
        ref, jcache = _ref(jcfg, "decode")(jp, jnp.asarray(tok),
                                           cache=jcache)
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                                   atol=MODEL_ATOL)
    _assert_tree_close(cache, jcache, 10 * CACHE_RTOL)
    assert int(cache["pos"]) == 15


@pytest.mark.parametrize("prompt", [12, 16])
def test_generate_greedy_equals_reference_engine(model, prompt):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(13 + prompt, 2, prompt)
    ref = jengine.ServingEngine(jcfg, jp, max_len=32).generate(
        jnp.asarray(prompts), max_new_tokens=6)
    eng = ServingEngine(cfg, tp, max_len=32, device="cpu")
    out = eng.generate(prompts, max_new_tokens=6)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_past_the_window_matches_the_train_forward(model):
    """A 24-token prompt at window 16: each decode step's logits equal the
    reference's train-mode forward over the prompt and the tokens so far
    (the ring holds position p at slot p % 16). The reference's own engine
    misses there: its padded cache keeps positions 0-15."""
    cfg, jcfg, jp, tp = model
    prompts = _tokens(30, 2, 24)
    eng = ServingEngine(cfg, tp, max_len=40, device="cpu")
    out = eng.generate(prompts, max_new_tokens=5).numpy()
    ring = eng.prefill(tp, torch.from_numpy(prompts))[1]
    k = ring["decoder"]["body"]["l2"]["mixer"]["k"]
    assert k.shape[1] == cfg.window
    seq = np.concatenate([prompts, out], axis=1)
    teacher, _ = _ref(jcfg)(jp, jnp.asarray(seq))
    teacher = np.asarray(teacher)
    # the engine's tokens are the teacher's argmax at every step
    np.testing.assert_array_equal(out, teacher[:, 23:28].argmax(-1))
    # and each decode step's logits are the teacher's row
    _, cache = tlm.forward(tp, torch.from_numpy(prompts), cfg,
                           mode="prefill")
    cache = tengine.pad_prefill_cache(cfg, cache, 2, 40)
    for i in range(4):
        logits, cache = tlm.forward(tp, torch.from_numpy(out[:, i:i + 1]),
                                    cfg, mode="decode", cache=cache)
        np.testing.assert_allclose(_np(logits[:, 0]), teacher[:, 24 + i],
                                   rtol=0, atol=MODEL_ATOL)
    # the reference's engine path, for the record: off by far more
    _, jcache = _ref(jcfg, "prefill")(jp, jnp.asarray(prompts))
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 40)
    jlogits, _ = _ref(jcfg, "decode")(jp, jnp.asarray(out[:, :1]),
                                      cache=jcache)
    assert np.abs(np.asarray(jlogits)[:, 0] - teacher[:, 24]).max() > 1e-2


def test_bf16_forward_matches_reference_loosely():
    """bfloat16 weights and activations, the granite test's draw (tokens
    of seed 4): logits (|logit| < 5) within 0.05. The RG-LRU rounds where
    the eager reference does, op by op (the conv's taps, the gates'
    sigmoid chains, i u, the gelu: its output equals the reference's bit
    for bit); the MLP's silu is one fused ``F.silu`` where the reference
    rounds four times, which moves a logit by up to ~2 bf16 ulps (0.0547
    at one of 16,384 logits for tokens of seed 14). The reference's own
    jitted forward lies up to 0.086 from its eager one on this model."""
    cfg, jcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    toks = _tokens(4, 2, 32)
    out, _ = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, mode="prefill")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), rtol=0,
                               atol=5e-2)
