"""The port's mLSTM and sLSTM mixers and xlstm-350m held against the JAX
package on the CPU.

Reduced xlstm-350m (8 layers: 7 mLSTM and 1 sLSTM, d 64, 4 heads of 16,
float32), the JAX ``lm.init_params(PRNGKey(0))`` tree carried over by
``from_numpy``, with the sLSTM biases (zeros at init) redrawn from a numpy
seed so that the bias path counts. Inputs are drawn with numpy from a
seed. The model is held to the reference's ``forward`` jitted once per
mode and shape; the reference's outputs are computed once per module, in
fixtures.

Modules: the specs and cache specs of both mixers equal the reference's at
full width; ``mlstm_apply`` in train, prefill and three decode steps at
``chunk`` 4 over S 16 (four chunks, so the carry between chunks counts),
``slstm_apply`` in train, prefill and decode, and ``slstm_scan_plain``
against the reference's ``_slstm_step`` scan from a drawn carry, each at
1e-6 of the output's largest magnitude (float32 rounding: the products sum
in another order), caches leaf for leaf at 1e-6 of each leaf's largest
magnitude (or of 1). The model: ``forward`` train at S 16 and at S 512
(two 256-token chunks of the mLSTM: the carry between them is held), then
prefill and three decode steps, at 1e-5 (logits up to ~4);
``ServingEngine.generate`` against the reference's engine (greedy tokens
equal); a 300-token prompt (more than a chunk, not a whole number of
them) refused by both; CPU tensors never launch the kernel, and a given
carry is advanced in place.
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
from repro.models import recurrent as jrec
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.configs.reduced import reduced as treduced
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import slstm_scan as ss
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import recurrent as trec
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

ARCH = "xlstm-350m"
MODULE_RTOL = 1e-6     # of the output's largest magnitude, float32
MODEL_ATOL = 1e-5      # logits, float32
CACHE_RTOL = 1e-6      # of a cache leaf's largest magnitude (or of 1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close_rel(port, ref, rtol=MODULE_RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(port), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


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


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _x(seed, b, s, d=64):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _ref(mode):
    """The reference's ``lm.forward`` in ``mode``, jitted once per mode."""
    jcfg = jreduced(jconfigs.get_arch(ARCH))
    return jax.jit(functools.partial(jlm.forward, cfg=jcfg, mode=mode))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, jax params, port params) of reduced xlstm-350m, the
    sLSTM biases redrawn."""
    cfg = treduced(tconfigs.get_arch(ARCH))
    jcfg = jreduced(jconfigs.get_arch(ARCH))
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    rng = np.random.default_rng(0)
    mix = jp["decoder"]["body"]["l7"]["mixer"]
    for g in trec.GATES:
        mix[f"b_{g}"] = (0.5 * rng.normal(size=mix[f"b_{g}"].shape)).astype(
            np.float32)
    return cfg, jcfg, jax.tree.map(jnp.asarray, jp), tparams.from_numpy(jp)


@pytest.fixture(scope="module")
def mixers(model):
    """The (jax, port) parameters of an mLSTM layer and of the sLSTM
    layer."""
    _, _, jp, tp = model
    body_j, body_t = jp["decoder"]["body"], tp["decoder"]["body"]
    return {"mlstm": (body_j["l0"]["mixer"], body_t["l0"]["mixer"]),
            "slstm": (body_j["l7"]["mixer"], body_t["l7"]["mixer"])}


# ----------------------------------------------------------------------------
# the mixers' modules
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mlstm_spec", "mlstm_cache_spec",
                                  "slstm_spec", "slstm_cache_spec"])
def test_specs_match_reference(name):
    """Leaves, shapes, inits, scales and dtypes at full width (no arrays
    made)."""
    cfg, jcfg = tconfigs.get_arch(ARCH), jconfigs.get_arch(ARCH)
    args = (4,) if "cache" in name else ()
    port = getattr(trec, name)(cfg, *args)
    ref = getattr(jrec, name)(jcfg, *args)
    assert sorted(port) == sorted(ref)
    for k in port:
        assert (port[k].shape, port[k].init, port[k].scale,
                port[k].dtype) == (ref[k].shape, ref[k].init, ref[k].scale,
                                   ref[k].dtype), k


@pytest.fixture(scope="module")
def mlstm_runs(model, mixers):
    """Both sides' mLSTM at chunk 4 over S 16: train, then prefill and
    three decode steps from its cache (the port's written in place)."""
    cfg, jcfg, _, _ = model
    jm, tm = mixers["mlstm"]
    x = _x(3, 2, 16)
    runs = {"train": (trec.mlstm_apply(tm, torch.from_numpy(x), cfg,
                                       chunk=4),
                      jrec.mlstm_apply(jm, jnp.asarray(x), jcfg, None, None,
                                       chunk=4))}
    y, cache = trec.mlstm_apply(tm, torch.from_numpy(x), cfg,
                                mode="prefill", chunk=4)
    ref, jcache = jrec.mlstm_apply(jm, jnp.asarray(x), jcfg, None, None,
                                   mode="prefill", chunk=4)
    runs["prefill"] = ((y, {k: v.clone() for k, v in cache.items()}),
                       (ref, jcache))
    for i in range(3):
        xt = _x(20 + i, 2, 1)
        given = cache
        y, cache = trec.mlstm_apply(tm, torch.from_numpy(xt), cfg,
                                    mode="decode", cache=cache)
        assert all(cache[k] is given[k] for k in ("C", "n", "m"))
        ref, jcache = jrec.mlstm_apply(jm, jnp.asarray(xt), jcfg, None, None,
                                       mode="decode", cache=jcache)
        runs[f"decode{i}"] = ((y, {k: v.clone() for k, v in cache.items()}),
                              (ref, jcache))
    return runs


@pytest.mark.parametrize("run", ["train", "prefill", "decode0", "decode1",
                                 "decode2"])
def test_mlstm_apply_matches_reference(mlstm_runs, run):
    (y, cache), (ref, jcache) = mlstm_runs[run]
    _close_rel(y, ref)
    if run == "train":
        assert cache is None and jcache is None
        return
    assert sorted(cache) == sorted(jcache) == ["C", "m", "n"]
    _assert_tree_close(cache, jcache, CACHE_RTOL)


def test_mlstm_chunks_carry_their_state(model, mixers):
    """At chunk 4 over S 16 the output differs from a run whose chunks each
    start from zero by far more than the tolerance: the carry counts."""
    cfg, _, _, _ = model
    _, tm = mixers["mlstm"]
    x = torch.from_numpy(_x(3, 2, 16))
    whole, _ = trec.mlstm_apply(tm, x, cfg, chunk=4)
    cut = torch.cat([trec.mlstm_apply(tm, x[:, j:j + 4], cfg, chunk=4)[0]
                     for j in range(0, 16, 4)], dim=1)
    scale = float(whole.abs().max())
    assert float((whole - cut).abs().max()) > 1e3 * MODULE_RTOL * scale


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_slstm_apply_matches_reference(model, mixers, mode):
    cfg, jcfg, _, _ = model
    jm, tm = mixers["slstm"]
    s = 1 if mode == "decode" else 13
    x = _x(4, 2, s)
    cache = jcache = None
    if mode == "decode":
        rng = np.random.default_rng(5)
        leaves = {k: rng.normal(size=(2, 4, 16)).astype(np.float32)
                  for k in ("c", "h", "m")}
        leaves["n"] = rng.uniform(0.5, 2.0, (2, 4, 16)).astype(np.float32)
        jcache = {k: jnp.asarray(v) for k, v in leaves.items()}
        cache = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    y, nc = trec.slstm_apply(tm, torch.from_numpy(x), cfg, mode=mode,
                             cache=cache)
    ref, jnc = jrec.slstm_apply(jm, jnp.asarray(x), jcfg, None, None,
                                mode=mode, cache=jcache)
    _close_rel(y, ref)
    if mode == "train":
        assert nc is None and jnc is None
        return
    assert sorted(nc) == sorted(jnc) == ["c", "h", "m", "n"]
    _assert_tree_close(nc, jnc, CACHE_RTOL)
    if mode == "decode":    # written in place into the cache it was given
        assert all(nc[k] is cache[k] for k in cache)


def test_slstm_scan_plain_matches_the_reference_scan():
    """The plain version against ``jax.lax.scan`` of the reference's
    ``_slstm_step`` from a drawn carry, with drawn weights and biases:
    hs and the last carry."""
    rng = np.random.default_rng(6)
    b, s, h, dh = 2, 21, 3, 16
    xs = [rng.normal(size=(b, s, h, dh)).astype(np.float32)
          for _ in range(4)]
    params = {}
    for g in trec.GATES:
        params[f"r_{g}"] = (0.3 * rng.normal(size=(h, dh, dh))).astype(
            np.float32)
        params[f"b_{g}"] = rng.normal(size=(h, dh)).astype(np.float32)
    carry = [rng.normal(size=(b, h, dh)).astype(np.float32)
             for _ in range(4)]
    carry[1] = np.abs(carry[1]) + 0.5
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jlast, jhs = jax.lax.scan(
        lambda c, xg: jrec._slstm_step(jp, c, xg),
        tuple(jnp.asarray(c) for c in carry),
        tuple(jnp.moveaxis(jnp.asarray(x), 1, 0) for x in xs))
    hs, last = ss.slstm_scan_plain(
        [torch.from_numpy(x) for x in xs],
        [torch.from_numpy(params[f"r_{g}"]) for g in trec.GATES],
        [torch.from_numpy(params[f"b_{g}"]) for g in trec.GATES],
        tuple(torch.from_numpy(c) for c in carry))
    _close_rel(hs, np.moveaxis(np.asarray(jhs), 0, 1))
    for port, ref in zip(last, jlast):
        _close_rel(port, ref)


def test_cpu_tensors_never_launch_the_kernel():
    cuda_lib.reset_launch_counts()
    xs = [torch.rand(1, 3, 2, 16) for _ in range(4)]
    rs = [torch.rand(2, 16, 16) for _ in range(4)]
    bs = [torch.rand(2, 16) for _ in range(4)]
    carry = tuple(torch.zeros(1, 2, 16) for _ in range(4))
    hs, last = ss.slstm_scan(xs, rs, bs)
    hs_b, _ = ss.slstm_scan(xs, [r.bfloat16() for r in rs],
                            [b.bfloat16() for b in bs])
    hs_c, last_c = ss.slstm_scan(xs, rs, bs, carry)   # written in place
    assert cuda_lib.launch_counts()["slstm_scan"] == 0
    assert torch.equal(hs, hs_c) and all(a is b for a, b in zip(last_c,
                                                                 carry))
    assert all(torch.equal(a, b) for a, b in zip(last, carry))
    assert hs.shape == (1, 3, 2, 16) and hs_b.dtype == torch.float32
    with pytest.raises(ValueError, match="even head dim from 16 to 256"):
        ss.slstm_scan([x[..., :8] for x in xs], [r[:, :8, :8] for r in rs],
                      [b[:, :8] for b in bs])
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        ss.slstm_scan(xs, [r.double() for r in rs], bs)
    with pytest.raises(TypeError, match="float32"):
        ss.slstm_scan([x.double() for x in xs], rs, bs)
    with pytest.raises(ValueError, match="contiguous"):
        ss.slstm_scan(xs, rs, bs, tuple(torch.zeros(1, 16, 2).transpose(1, 2)
                                        for _ in range(4)))
    with pytest.raises(ValueError, match="no kernel"):
        ss.slstm_scan([x.to("meta") for x in xs], [r.to("meta") for r in rs],
                      [b.to("meta") for b in bs])


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", range(1, 10))
def test_slstm_design_covers_every_shape_it_takes(w_dtype, batch):
    """At every even head dim from 16 to 256 and 1 to 4 heads: the block's
    shared memory fits 227 KB, the cluster (at most 8, a power of two)
    splits the head dim's columns so that every block owns some and they
    cover dh exactly (evenly where C divides dh), a warp takes 8 columns,
    and the row groups (at most 8 rows, computed as 1, 2, 4 or 8) cover
    the batch exactly; the kernel's name carries the row count."""
    w_size = 2 if w_dtype == torch.bfloat16 else 4
    for dh in range(16, 257, 2):
        for heads in range(1, 5):
            d = ss.design(batch, heads, dh, w_dtype)
            assert d["smem_bytes"] <= 227 * 1024
            assert d["smem_bytes"] == (d["warps"] * 32 * 16
                                       * -(-dh * w_size // 16)
                                       + 2 * dh * d["slots"] * 4 + 16)
            assert d["cluster"] in (1, 2, 4, 8)
            assert (d["cluster"] - 1) * d["cols"] < dh <= (d["cluster"]
                                                          * d["cols"])
            if dh % d["cluster"] == 0:
                assert d["cols"] * d["cluster"] == dh
            assert d["cols"] >= 16 and d["warps"] == -(-d["cols"] // 8)
            assert d["threads"] == 32 * d["warps"] <= 256
            assert d["rows"] <= 8 and d["slots"] in (1, 2, 4, 8)
            assert d["rows"] <= d["slots"] < 2 * d["rows"]
            assert (d["groups"] - 1) * d["rows"] < batch <= (d["groups"]
                                                            * d["rows"])
            assert d["grid"] == (d["cluster"], heads, d["groups"])
            assert d["blocks"] == d["cluster"] * heads * d["groups"]
        assert ss.kernel_symbol(w_dtype, batch).endswith(
            f", {d['slots']}>")
    with pytest.raises(ValueError, match="even head dim from 16 to 256"):
        ss.design(batch, 4, 258, w_dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss.design(batch, 4, 256, torch.float16)


def test_slstm_design_at_xlstm_350m():
    """xlstm-350m's sLSTM (4 heads of 256, bf16 weights, 4 prompts): one
    cluster of 8 blocks a head, 32 columns a block (64 KB of weights), one
    row group of the 4 rows; in float32 the same, 128 KB of weights."""
    cfg = tconfigs.get_arch("xlstm-350m")
    dh = cfg.d_model // cfg.num_heads
    d = ss.design(4, cfg.num_heads, dh, cfg.pdtype)
    assert (cfg.pdtype, cfg.num_heads, dh) == (torch.bfloat16, 4, 256)
    assert (d["cluster"], d["cols"], d["groups"], d["rows"], d["slots"]) == (
        8, 32, 1, 4, 4)
    assert d["smem_bytes"] == 64 * 1024 + 2 * 256 * 4 * 4 + 16
    assert d["blocks"] == 32 and d["threads"] == 128
    f32 = ss.design(4, 4, 256, torch.float32)
    assert (f32["cluster"], f32["smem_bytes"]) == (8, 128 * 1024 + 8208)
    assert ss.kernel_symbol(torch.bfloat16, 4) == (
        "slstm_cluster_kernel<__nv_bfloat16, 4>")


# ----------------------------------------------------------------------------
# the model and the engine
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("b,s", [(2, 16), (1, 512)])
def test_forward_train_matches_reference(model, b, s):
    """At S 16 (one chunk) and S 512 (two 256-token chunks)."""
    cfg, _, jp, tp = model
    toks = _tokens(10 + s, b, s)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg)
    ref, _ = _ref("train")(jp, jnp.asarray(toks))
    assert cache is None
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                               atol=MODEL_ATOL)


def test_prefill_and_three_decode_steps_match_reference(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(11, 2, 12)
    out, cache = tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    ref, jcache = _ref("prefill")(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                               atol=MODEL_ATOL)
    _assert_tree_close(cache, jcache, CACHE_RTOL)

    cache = tengine.pad_prefill_cache(cfg, cache, 2, 32)
    jcache = jengine.pad_prefill_cache(jcfg, jcache, 2, 32)
    _assert_tree_close(cache, jcache, CACHE_RTOL)
    nxt = _tokens(12, 2, 3)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        out, cache = tlm.forward(tp, torch.from_numpy(tok), cfg,
                                 mode="decode", cache=cache)
        ref, jcache = _ref("decode")(jp, jnp.asarray(tok), cache=jcache)
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                                   atol=MODEL_ATOL)
    _assert_tree_close(cache, jcache, 10 * CACHE_RTOL)
    assert int(cache["pos"]) == 15


def test_generate_greedy_equals_reference_engine(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(13, 2, 12)
    ref = jengine.ServingEngine(jcfg, jp, max_len=24).generate(
        jnp.asarray(prompts), max_new_tokens=6)
    eng = ServingEngine(cfg, tp, max_len=24, device="cpu")
    cuda_lib.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=6)
    assert cuda_lib.launch_counts()["slstm_scan"] == 0
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_a_prompt_of_partial_chunks_is_refused(model):
    """300 tokens: more than one 256-token chunk and not a whole number of
    them. The reference's chunk reshape fails; the port raises rather than
    drop the last 44 tokens."""
    cfg, jcfg, jp, tp = model
    toks = _tokens(14, 1, 300)
    with pytest.raises(ValueError, match="whole number of 256-token"):
        tlm.forward(tp, torch.from_numpy(toks), cfg, mode="prefill")
    with pytest.raises(TypeError, match="reshape"):
        jlm.forward(jp, jnp.asarray(toks), dataclasses.replace(jcfg),
                    mode="prefill")
