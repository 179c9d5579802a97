"""The port's vision training path against the JAX package, on the CPU.

Inputs come from numpy seeds (or the reference's own init and streams,
carried across with ``from_numpy``) and go through both packages:

* the straight-through estimator of ``quantize_weights`` (its gradient is
  ``jax.grad``'s exactly: the identity), ``spike``'s VJP and ``clip01``'s
  gradient at its edges (exactly), ``hoyer_spike``'s gradients in ``u`` and
  ``v_th`` (float32 sums in another order: ``SUM_RTOL``);
* ``_conv_apply(train=True)``: the binary map, the EMA stats and the VJP
  against ``jax.vjp``, binary and the ResNets' non-binary ``proj``;
* ``loss_fn`` and its gradient (vgg_tiny and resnet20 at small width,
  batch 4, through ``analog``: without flips, with the Fig. 8 flips and on
  a sampled chip), one ``make_step`` and three ``fit`` steps;
* ``evaluate`` through ``analog`` and ``device``; the launcher's refusals;
  every new entry point raising without a GPU unless given ``device="cpu"``.

Ambiguous units. Convs that sum in another order move a pre-activation by
ulps, so a unit whose z lies within 4 float32 ulps (of max(|edge|, 1)) of
its spike threshold may spike on one side only, and one within 4 ulps of
the straight-through window's edges (z = 0, z = 1) may pass its gradient on
one side only. Such units are common at z = 0: the 4-bit weights on binary
maps give a channel few distinct conv values, and where one of them is the
batch mean BN puts a whole set of units at +-1e-7. The whole-model tests
record the reference's z and threshold at every spike (an ordered
``jax.debug.callback``), check that the port differs from them only at such
units, and resolve those units to the reference's side (the forward value
and the window) before comparing: everything else must agree at
``GRAD_TOL``. The layer tests zero the cotangent at those units instead.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hoyer as j_hoyer
import repro.core.p2m as j_p2m
import repro.data.synthetic as j_synthetic
from repro.data import ImageStream as JaxImageStream
from repro.models import vision as jv
from repro.train import vision as jloop
from repro.variation import chip as j_chip
from repro_torch import prng
from repro_torch.core import hoyer as t_hoyer
from repro_torch.core import p2m as t_p2m
from repro_torch.data import ImageStream
from repro_torch.launch import train as t_launch
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch import train_p2m_vision
from repro_torch.train import vision as tloop
from repro_torch.variation import chip as t_chip

# a unit this close to an edge (threshold, 0 or 1) may fall either side
EDGE_ULPS = 4 * np.finfo(np.float32).eps
# a gradient or an SGD update: max |port - ref| over the RMS of the ref
# (float32 convs and reductions that sum in another order)
GRAD_TOL = 1e-4
# losses, Hoyer terms and BN statistics (float32 sums in another order)
SUM_RTOL = 1e-5
LR = 3e-3
PROFILE = dict(sigma_column=0.15, sigma_logit_offset=0.4,
               sigma_logit_slope=0.05, sigma_pixel_gain=0.05,
               sigma_pixel_offset=0.25, sigma_r_p=0.05, sigma_tmr=0.05)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    rms = np.sqrt(np.mean(ref ** 2))
    err = np.abs(ref - got).max() if ref.size else 0.0
    return err / rms if rms > 0 else err


# --- the straight-through pieces ----------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_quantize_weights_gradient_is_jax_grad_exactly(bits):
    """The reference's ``w + stop_gradient(wq - w)`` has the identity as
    its gradient; so must the port's (it had the round's zero plus a term
    through max|w| before ``.detach()``)."""
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    c = rng.normal(size=w.shape).astype(np.float32)
    g_ref = jax.grad(lambda w_: jnp.sum(jnp.asarray(c) * j_p2m
                                        .quantize_weights(w_, bits)))(
        jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    (g,) = torch.autograd.grad(
        torch.sum(torch.tensor(c) * t_p2m.quantize_weights(wt, bits)), wt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(
        t_p2m.quantize_weights(wt, bits).detach().numpy(),
        np.asarray(j_p2m.quantize_weights(jnp.asarray(w), bits)))


def test_relu_split_pack_gradient_splits_ties_as_jax():
    """A quantized weight is often exactly 0: ``jnp.maximum`` sends half
    its gradient to each phase."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, 2, 3, 6)).astype(np.float32)
    w[0, 0, :, :3] = 0.0
    c = rng.normal(size=(2, 2, 3, 12)).astype(np.float32)
    g_ref = jax.grad(lambda w_: jnp.sum(jnp.asarray(c) * j_p2m
                                        .relu_split_pack(w_)))(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(c)
                                         * t_p2m.relu_split_pack(wt)), wt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))


def _edge_values(rng, n=512):
    z = rng.normal(size=n).astype(np.float32)
    z[:8] = [0.0, 1.0, -0.0, 0.5, -1e-8, 1 + 1e-7, 2.0, -2.0]
    return z


def test_spike_vjp_is_jax_exactly():
    rng = np.random.default_rng(2)
    z = _edge_values(rng)
    g = rng.normal(size=z.shape).astype(np.float32)
    thr = np.float32(0.37)
    o_ref, vjp = jax.vjp(j_hoyer.spike, jnp.asarray(z), jnp.asarray(thr))
    gz_ref, gthr_ref = vjp(jnp.asarray(g))
    zt = torch.tensor(z, requires_grad=True)
    tt = torch.tensor(thr, requires_grad=True)
    o = t_hoyer.spike(zt, tt)
    gz, gthr = torch.autograd.grad(o, [zt, tt], grad_outputs=torch.tensor(g))
    np.testing.assert_array_equal(o.detach().numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(gz.numpy(), np.asarray(gz_ref))
    assert float(gthr) == float(gthr_ref) == 0.0


def test_clip01_gradient_at_its_edges_is_jax_exactly():
    """``jnp.clip`` passes half the gradient at z = 0 and z = 1;
    ``torch.clamp`` would pass all of it."""
    z = np.asarray([-0.5, 0.0, 0.25, 1.0, 1.5, -0.0], np.float32)
    g_ref = jax.grad(lambda z_: jnp.sum(j_hoyer.clip01(z_)))(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    (g,) = torch.autograd.grad(t_hoyer.clip01(zt).sum(), zt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(g.numpy()[[1, 3]], [0.5, 0.5])


def test_hoyer_spike_gradients_in_u_and_v_th():
    rng = np.random.default_rng(3)
    u = (rng.normal(size=(4, 6, 6, 8)) * 0.7).astype(np.float32)
    u[0, 0, 0, :4] = 0.0                    # z exactly 0: |z|' and clip'
    v_th = np.float32(1.3)
    g_o = rng.normal(size=u.shape).astype(np.float32)
    g_h = np.float32(0.25)
    (o_ref, h_ref), vjp = jax.vjp(j_hoyer.hoyer_spike, jnp.asarray(u),
                                  jnp.asarray(v_th))
    gu_ref, gv_ref = vjp((jnp.asarray(g_o), jnp.asarray(g_h)))
    ut = torch.tensor(u, requires_grad=True)
    vt = torch.tensor(v_th, requires_grad=True)
    o, h = t_hoyer.hoyer_spike(ut, vt)
    gu, gv = torch.autograd.grad([o, h], [ut, vt],
                                 grad_outputs=[torch.tensor(g_o),
                                               torch.tensor(g_h)])
    np.testing.assert_array_equal(o.detach().numpy(), np.asarray(o_ref))
    np.testing.assert_allclose(h.item(), float(h_ref), rtol=SUM_RTOL)
    assert _rel_err(gu_ref, gu.numpy()) <= GRAD_TOL
    np.testing.assert_allclose(float(gv), float(gv_ref), rtol=SUM_RTOL)


# --- one backbone layer in train mode ------------------------------------

def _layer(rng, cin, cout, k):
    return {"w": (rng.normal(size=(k, k, cin, cout))
                  * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32),
            "bn_scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "bn_bias": (rng.normal(size=cout) * 0.1).astype(np.float32),
            "bn_mean": (rng.normal(size=cout) * 0.1).astype(np.float32),
            "bn_var": rng.uniform(0.5, 2.0, cout).astype(np.float32),
            "v_th": np.float32(1.1)}


@pytest.mark.parametrize("binary,k,float_input", [
    (True, 3, False), (True, 3, True), (False, 1, False)],
    ids=["binary", "binary-float-input", "proj"])
def test_conv_apply_train_matches_jax_vjp(binary, k, float_input):
    rng = np.random.default_rng(4 + k)
    lp = _layer(rng, 16, 24, k)
    x = (rng.uniform(size=(4, 8, 8, 16)) > 0.7).astype(np.float32)
    if float_input:                       # a ResNet block's h + sc
        x = x + (rng.uniform(size=x.shape) > 0.5)
    cot = rng.normal(size=(4, 8, 8, 24)).astype(np.float32)
    g_h = np.float32(0.3)

    def ref(p, x_):
        o, h, st = jv._conv_apply(p, x_, 1, 4, binary=binary, train=True)
        return (o, h), st

    (o_ref, h_ref), vjp, st_ref = jax.vjp(
        ref, jax.tree.map(jnp.asarray, lp), jnp.asarray(x), has_aux=True)
    # the reference's pre-activation, its threshold, and the units at an
    # edge: the threshold (binary), the window's 0 and 1 (binary) or the
    # ReLU's 0 (proj)
    w_q = j_p2m.quantize_weights(jnp.asarray(lp["w"]), 4)
    yc = jax.lax.conv_general_dilated(jnp.asarray(x), w_q, (1, 1), "SAME",
                                      dimension_numbers=("NHWC", "HWIO",
                                                         "NHWC"))
    mu, var = jnp.mean(yc, axis=(0, 1, 2)), jnp.var(yc, axis=(0, 1, 2))
    y = _np((yc - mu) / jnp.sqrt(var + 1e-5) * lp["bn_scale"]
            + lp["bn_bias"])
    if binary:
        z = y / max(float(lp["v_th"]), 1e-6)
        thr = float(j_hoyer.hoyer_extremum(j_hoyer.clip01(jnp.asarray(z))))
        at_thr = np.abs(z - thr) <= EDGE_ULPS * max(abs(thr), 1.0)
        at_edge = (np.abs(z) <= EDGE_ULPS) | (np.abs(z - 1.0) <= EDGE_ULPS)
    else:
        at_thr = np.zeros(y.shape, bool)
        at_edge = np.abs(y) <= EDGE_ULPS
    cot = np.where(at_edge, 0.0, cot).astype(np.float32)
    g_ref, gx_ref = vjp((jnp.asarray(cot), jnp.asarray(g_h)))

    pt = {n: torch.tensor(v, requires_grad=True) for n, v in lp.items()}
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    o, h, st = tv._conv_apply(pt, xt, 1, 4, binary=binary, train=True)
    o_nhwc = _np(o.permute(0, 2, 3, 1))
    if binary:
        assert not ((o_nhwc != np.asarray(o_ref)) & ~at_thr).any()
    else:
        np.testing.assert_allclose(o_nhwc, np.asarray(o_ref), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(h.item(), float(h_ref), rtol=SUM_RTOL,
                               atol=1e-12)
    for name in ("bn_mean", "bn_var"):
        assert st[name].grad_fn is None
        np.testing.assert_allclose(_np(st[name]), np.asarray(st_ref[name]),
                                   rtol=SUM_RTOL, atol=1e-7)
    names = ["w", "bn_scale", "bn_bias", "v_th"]
    outs = [o, h] if binary else [o]
    cots = [torch.tensor(cot).permute(0, 3, 1, 2)]
    if binary:
        cots.append(torch.tensor(g_h))
    grads = torch.autograd.grad(outs, [pt[n] for n in names] + [xt],
                                grad_outputs=cots, allow_unused=True)
    for name, g in zip(names, grads):
        g = np.zeros_like(lp[name]) if g is None else g.numpy()
        assert _rel_err(g_ref[name], g) <= GRAD_TOL, name
    assert _rel_err(gx_ref, _np(grads[-1].permute(0, 2, 3, 1))) <= GRAD_TOL


def test_forward_train_returns_detached_bn_state_and_apply_is_pure():
    cfg = tv.VisionConfig(name="t", arch="resnet20", in_hw=16,
                          frontend_backend="analog",
                          p2m=t_p2m.P2MConfig(out_channels=8))
    params = tv.init_params(0, cfg, device="cpu")
    frames = torch.rand((2, 16, 16, 3), generator=torch.Generator()
                        .manual_seed(0))
    _, _, aux = tv.forward(params, frames, cfg, train=True)
    state = aux["bn_state"]
    assert set(state) == set(params["layers"])
    assert set(state["s1b0"]) == {"c1", "c2", "proj"}
    new = tv.apply_bn_state(params, state)
    assert new is not params and new["layers"] is not params["layers"]
    for blk, st in state.items():
        for conv, stats in st.items():
            for name, v in stats.items():
                assert v.grad_fn is None
                assert new["layers"][blk][conv][name] is v
                assert params["layers"][blk][conv][name] is not v
    assert tv.apply_bn_state(params, None) is params
    _, _, aux_eval = tv.forward(params, frames, cfg)
    assert "bn_state" not in aux_eval


# --- whole models: ambiguous units resolved to the reference's side -------

def _n_spikes(arch: str) -> int:
    """Spike calls per forward: the frontend, then each binary conv."""
    if arch.startswith("vgg"):
        return 1 + sum(1 for it in jv._VGG_PLANS[arch] if it != "M")
    return 1 + 2 * sum(jv._RESNET_PLAN[arch])


class _RefSpikes:
    """Record the reference's (z, threshold) at every ``hoyer_spike``, in
    order, from inside its jitted code."""

    def __enter__(self):
        self.records = []
        self._orig = j_hoyer.hoyer_spike

        def spike(u, v_th):
            z = u / jnp.maximum(v_th, 1e-6)
            thr = j_hoyer.hoyer_extremum(j_hoyer.clip01(z))
            jax.debug.callback(lambda z_, t_: self.records.append(
                (np.asarray(z_), float(t_))), z, thr, ordered=True)
            return self._orig(u, v_th)

        j_hoyer.hoyer_spike = spike
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        j_hoyer.hoyer_spike = self._orig


class _Resolve:
    """The port's ``hoyer_spike`` with its ambiguous units resolved to the
    reference's side, call by call: a unit may spike differently only
    within ``EDGE_ULPS`` of the reference's threshold and pass its gradient
    differently only within ``EDGE_ULPS`` of 0 or 1, else the test fails.
    The spike is the port's; the resolution adds a forward correction
    (no gradient) and a window correction (no value)."""

    def __init__(self, records, per_forward):
        self.records, self.per_forward = records, per_forward
        self.calls = self.resolved_fwd = self.resolved_window = 0

    def __enter__(self):
        self._orig = t_hoyer.hoyer_spike
        t_hoyer.hoyer_spike = self
        return self

    def __exit__(self, *exc):
        t_hoyer.hoyer_spike = self._orig

    def __call__(self, u, v_th):
        z_ref, thr = self.records[self.calls]
        z_ref = torch.tensor(z_ref)
        if self.calls % self.per_forward:      # backbone: NCHW in the port
            z_ref = z_ref.permute(0, 3, 1, 2)
        self.calls += 1
        o, h = self._orig(u, v_th)
        z = u / torch.clamp(v_th, min=1e-6)
        o_ref = (z_ref >= thr).to(o.dtype)
        near_thr = (z_ref - thr).abs() <= EDGE_ULPS * max(abs(thr), 1.0)
        differ = o.detach() != o_ref
        assert not bool((differ & ~near_thr).any()), \
            "a unit spikes differently away from its threshold"
        win_ref = ((z_ref >= 0) & (z_ref <= 1)).to(o.dtype)
        win = ((z.detach() >= 0) & (z.detach() <= 1)).to(o.dtype)
        near_edge = ((z_ref.abs() <= EDGE_ULPS)
                     | ((z_ref - 1.0).abs() <= EDGE_ULPS))
        assert not bool(((win != win_ref) & ~near_edge).any()), \
            "a unit's straight-through window differs away from its edges"
        self.resolved_fwd += int(differ.sum())
        self.resolved_window += int((win != win_ref).sum())
        o = o + ((o_ref - o) * differ).detach() + (z - z.detach()) * (
            win_ref - win)
        return o, h


def _configs(arch, noise=0.0, chip=False):
    kw = dict(name="t", arch=arch, num_classes=10, in_hw=16,
              frontend_backend="analog")
    pj = dict(out_channels=8, noise_p_fail=noise, noise_p_false=noise)
    if chip:
        kw.update(chip_id=2)
    cfg_j = jv.VisionConfig(p2m=j_p2m.P2MConfig(**pj), **kw, **(
        dict(variation=j_chip.VariationConfig(**PROFILE)) if chip else {}))
    cfg_t = tv.VisionConfig(p2m=t_p2m.P2MConfig(**pj), **kw, **(
        dict(variation=t_chip.VariationConfig(**PROFILE)) if chip else {}))
    return cfg_j, cfg_t


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    """The reference's init, once an arch (its eager draws compile on
    first use); the tree depends on the arch and the P2M width alone."""
    return jv.init_params(jax.random.PRNGKey(0), _configs(arch)[0])


def _setup(arch, noise=0.0, chip=False):
    cfg_j, cfg_t = _configs(arch, noise, chip)
    pj = _ref_init(arch)
    return cfg_j, cfg_t, pj, tp.from_numpy(jax.tree.map(np.asarray, pj))


@pytest.fixture(autouse=True)
def _compiled_reference_batches(monkeypatch):
    """The reference's ``ImageStream`` draws its batches through one
    compiled ``make_image_batch`` (its eager ops each compile on first use;
    the draws are the same, the images within a few ulps)."""
    monkeypatch.setattr(j_synthetic, "make_image_batch",
                        _jit_image_batch(j_synthetic.make_image_batch))


@functools.lru_cache(maxsize=None)
def _jit_image_batch(fn):
    return jax.jit(fn, static_argnums=(1, 2, 3, 4))


def _streams(seed, batch=4):
    return (JaxImageStream(hw=16, global_batch=batch, seed=seed),
            ImageStream(hw=16, global_batch=batch, seed=seed, device="cpu"))


def _paths(tree):
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_updates_close(old, ref, got):
    """The new tree against the reference's: the same leaves, the BN stats
    at SUM_RTOL, and every other leaf within GRAD_TOL of the RMS of the
    reference's update, plus the two float32 roundings of ``w - lr * g``
    (one ulp of the new weight on each side)."""
    ref, got, old = _paths(ref), _paths(tp.to_numpy(got)), _paths(old)
    assert ref.keys() == got.keys()
    for path in ref:
        assert got[path].dtype == ref[path].dtype, path
        if path[-1] in ("bn_mean", "bn_var"):
            np.testing.assert_allclose(got[path], ref[path],
                                       rtol=SUM_RTOL, atol=1e-7,
                                       err_msg=str(path))
            continue
        upd = (ref[path] - old[path]).astype(np.float64)
        slack = (GRAD_TOL * np.sqrt(np.mean(upd ** 2))
                 + 2 * np.spacing(np.abs(ref[path])))
        assert (np.abs(got[path].astype(np.float64) - ref[path])
                <= slack).all(), path


@pytest.mark.parametrize("arch,noise,chip", [
    ("vgg_tiny", 0.0, False), ("vgg_tiny", 0.05, False),
    ("vgg_tiny", 0.0, True), ("resnet20", 0.0, False)],
    ids=["vgg_tiny", "vgg_tiny-flips", "vgg_tiny-chip", "resnet20"])
def test_loss_fn_and_gradient_match_jax(arch, noise, chip):
    cfg_j, cfg_t, pj, pt = _setup(arch, noise, chip)
    sj, st = _streams(1)
    bj, bt = sj.next_batch(), st.next_batch()
    vg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jv.loss_fn(p, b, cfg_j, k), has_aux=True))
    with _RefSpikes() as rec:
        (l_ref, aux_ref), g_ref = vg(pj, bj, jax.random.PRNGKey(5))
    with _Resolve(rec.records, _n_spikes(arch)) as res:
        loss, aux, grads = tloop.value_and_grad(pt, bt, cfg_t,
                                                prng.PRNGKey(5))
    assert res.calls == len(rec.records) == _n_spikes(arch)
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=SUM_RTOL)
    for name in ("loss", "acc", "p2m_sparsity", "theta"):
        np.testing.assert_allclose(float(aux[name]), float(aux_ref[name]),
                                   rtol=SUM_RTOL, err_msg=name)
    for path, g in _paths(g_ref).items():
        got = grads.get(path)
        got = np.zeros_like(g) if got is None else got.numpy()
        assert _rel_err(g, got) <= GRAD_TOL, path
    # the BN stats of the train-mode forward, leaf for leaf
    stats_ref = _paths(aux_ref["bn_state"])
    stats = _paths(tp.to_numpy(aux["bn_state"]))
    assert stats.keys() == stats_ref.keys()
    for path in stats:
        np.testing.assert_allclose(stats[path], stats_ref[path],
                                   rtol=SUM_RTOL, atol=1e-7)


@pytest.mark.parametrize("arch", ["vgg_tiny"])
def test_make_step_matches_jax(arch):
    """One SGD step from the reference's init, carried across and back
    with the numpy bridge (a trained tree with its BN running stats). The
    ResNets' step, ``proj`` stats included, is held by the ``fit`` test."""
    cfg_j, cfg_t, pj, pt = _setup(arch, noise=0.02)
    sj, st = _streams(2)
    bj, bt = sj.next_batch(), st.next_batch()
    with _RefSpikes() as rec:
        new_j, l_ref, aux_ref = jloop.make_step(cfg_j, LR)(
            pj, bj, jax.random.PRNGKey(7))
    with _Resolve(rec.records, _n_spikes(arch)):
        new_t, loss, aux = tloop.make_step(cfg_t, LR)(pt, bt,
                                                      prng.PRNGKey(7))
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=SUM_RTOL)
    assert "bn_state" not in aux and "bn_state" not in aux_ref
    assert set(aux) == set(aux_ref)
    _assert_updates_close(pj, new_j, new_t)
    # the step is pure: the tree passed in is unchanged
    for path, v in _paths(tp.to_numpy(pt)).items():
        np.testing.assert_array_equal(v, _paths(pj)[path])
    back = tp.from_numpy(tp.to_numpy(new_t))
    for path, v in _paths(tp.to_numpy(back)).items():
        np.testing.assert_array_equal(v, _paths(tp.to_numpy(new_t))[path])


@pytest.mark.parametrize("arch", ["vgg_tiny", "resnet20"])
def test_fit_three_steps_match_jax(arch):
    """``fit`` folds the key per step (the Fig. 8 flips are on) and draws
    one batch a step."""
    cfg_j, cfg_t, pj, pt = _setup(arch, noise=0.02)
    sj, st = _streams(3)
    with _RefSpikes() as rec:
        pj3 = jloop.fit(pj, cfg_j, sj, 3, lr=LR,
                        key=jax.random.PRNGKey(11))
    history = []
    with _Resolve(rec.records, _n_spikes(arch)) as res:
        pt3 = tloop.fit(pt, cfg_t, st, 3, lr=LR, key=prng.PRNGKey(11),
                        log_every=1, log_fn=lambda s: None, history=history)
    assert res.calls == 3 * _n_spikes(arch)
    assert st.step == sj.step == 3
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    _assert_updates_close(pj, pj3, pt3)


@pytest.mark.parametrize("backend", ["analog", "device"])
def test_evaluate_matches_jax(backend, monkeypatch):
    # the reference's loop over its forward, compiled once (eager, each op
    # compiles on first use)
    monkeypatch.setattr(jv, "forward", jax.jit(
        jv.forward, static_argnums=2, static_argnames=("backend", "train")))
    cfg_j, cfg_t, pj, pt = _setup("vgg_tiny")
    key_j = jax.random.PRNGKey(2) if backend == "device" else None
    key_t = prng.PRNGKey(2) if backend == "device" else None
    sj, st = _streams(99, batch=8)
    acc_ref, n_ref = jloop.evaluate(pj, cfg_j, sj, n_batches=1,
                                    backend=backend, key=key_j)
    acc, n = tloop.evaluate(pt, cfg_t, st, n_batches=1, backend=backend,
                            key=key_t)
    assert n == n_ref == 8
    assert acc == acc_ref
    # the labels the two streams drew are equal
    sj, st = _streams(99, batch=8)
    np.testing.assert_array_equal(st.next_batch()["label"].numpy(),
                                  np.asarray(sj.next_batch()["label"]))


def test_train_step_census_matches_the_reference_budget():
    """``ANALYSIS_BUDGETS.json`` pins the reference's ``train.step``
    (vgg_tiny, batch ``census.TRAIN_BATCH``) at 11 convs, 3 dots and no
    ``pallas_call``. The port's step, in the port's op census
    (``repro_torch.analysis.census``): 11 convolutions (4 forward; each
    ``convolution_backward`` counted by the gradients it computes, input
    and weight), 3 matmuls, and no kernel wrapper called."""
    import json
    from pathlib import Path

    from repro.analysis import census
    from repro_torch.analysis import census as t_census

    budget = json.loads((Path(__file__).resolve().parents[1]
                         / "ANALYSIS_BUDGETS.json").read_text())
    budget = budget["census"]["train.step"]["jaxpr"]
    cfg = tv.VisionConfig(name="census", arch="vgg_tiny", num_classes=10,
                          frontend_backend="analog")
    params = tv.init_params(0, cfg, device="cpu")
    batch = {"image": torch.rand((census.TRAIN_BATCH, 32, 32, 3),
                                 generator=torch.Generator().manual_seed(1)),
             "label": torch.zeros((census.TRAIN_BATCH,), dtype=torch.int32)}
    key = prng.PRNGKey(2)
    step = tloop.make_step(cfg, LR)
    counted = t_census.op_census(lambda: step(params, batch, key))["ops"]
    assert counted["kernel_calls"] == budget["pallas_call"] == 0
    assert counted["conv"] == budget["conv"] == 11
    assert counted["dot"] == budget["dot_general"] == 3


# --- entry points ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["device", "cuda"])
def test_launcher_refuses_backends_without_a_gradient(backend, capsys):
    with pytest.raises(SystemExit) as exc:
        t_launch.main(["--arch", "vgg_tiny", "--frontend-backend", backend,
                       "--device", "cpu"])
    assert str(exc.value) == (
        f"--frontend-backend {backend!r} has no gradient path (stochastic "
        "device sampling); train with one of ['analog', 'ideal'] and use "
        "--eval-backend for hardware eval")


def test_launcher_refuses_lm_archs():
    """On the card the launcher refuses an LM arch whose train forward
    reaches a kernel without a backward (recurrentgemma-2b's RG-LRU scan
    and windowed attention), before any step and before the card is
    touched (so this runs without one); on the CPU it trains every LM arch
    (tests/test_torch_train_lm.py)."""
    with pytest.raises(NotImplementedError) as exc:
        t_launch.main(["--arch", "recurrentgemma-2b", "--device", "cuda"])
    assert "ROADMAP item 16" in str(exc.value)
    assert "rglru_scan_gated" in str(exc.value)


def test_launcher_trains_and_evaluates_on_the_cpu(capsys):
    t_launch.main(["--arch", "vgg_tiny", "--steps", "2", "--batch", "4",
                   "--eval-backend", "pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 steps in" in out and "eval: analog" in out and " cuda " in out


def test_entry_points_need_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ImageStream(),
                 lambda: t_launch.main(["--arch", "vgg_tiny"]),
                 lambda: train_p2m_vision.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_config_copies_match_the_reference():
    cfg_j, cfg_t = _configs("vgg_tiny")
    for f in dataclasses.fields(cfg_t):
        if f.name in ("p2m", "variation"):
            continue
        assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
