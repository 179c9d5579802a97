"""The port's frontend kernels against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
have no CPU mode); those plain versions are held here against the Pallas
kernels run in interpret mode, on identical numpy inputs. The kernels
themselves are held against the plain versions on the card, by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.

Tolerances: u at atol 3e-6 (the implicit-im2col parity bound of the
reference's own tests: the MAC sums in another order); theta at rtol 1e-5;
draws by the reference's word-boundary rule (XLA:CPU and PyTorch evaluate
tanh/exp with different polynomials, so q may move by ulps and flip a draw
only when its word sits within one step of q).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draw_asserts import assert_draws_match_modulo_word_boundary
from repro.core import hoyer as j_hoyer
from repro.kernels import ops as j_ops
from repro.kernels import p2m_conv as jk
from repro.kernels import ref as j_ref
from repro_torch import prng
from repro_torch.core import mtj as t_mtj
from repro_torch.core import pixel as t_pixel
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import p2m_conv as tk

GEOMETRIES = [
    (3, 2, 32, 32),    # the paper geometry
    (3, 1, 16, 16),    # non-default stride
    (3, 3, 18, 18),    # stride > half kernel
    (5, 2, 12, 12),    # larger kernel
    (3, 2, 15, 15),    # odd extent: asymmetric SAME padding
    (3, 2, 14, 10),    # non-square frames
    (5, 3, 13, 11),    # everything non-default at once
]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(kernel, h, w, c=8, b=2, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    wt = (rng.normal(size=(kernel, kernel, 3, c)) * 0.3).astype(np.float32)
    return images, wt.reshape(-1, c)


def _chan(c, identity, seed=3):
    if identity:
        return None
    rng = np.random.default_rng(seed)
    return np.stack([1.0 + 0.05 * rng.normal(size=c),
                     0.05 * rng.normal(size=c),
                     1.0 + 0.1 * rng.normal(size=c),
                     0.3 * rng.normal(size=c)]).astype(np.float32)


@pytest.mark.parametrize("kernel,stride,h,w", GEOMETRIES)
def test_phase_a_matches_pallas(kernel, stride, h, w):
    images, wm = _inputs(kernel, h, w)
    wp = np.asarray(jk.pack_phase_weights(jnp.asarray(wm)))
    uj, hj = jk.p2m_phase_a_implicit_pallas(
        jnp.asarray(images), jnp.asarray(wp), jnp.ones((1, 1)),
        kernel=kernel, stride=stride, block_n=64)
    v_th = torch.ones(())
    ut, ht = tk.p2m_phase_a_implicit(_t(images), tk.pack_phase_weights(
        _t(wm)), v_th, kernel=kernel, stride=stride)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=3e-6)
    np.testing.assert_allclose(
        float(tk.combine_hoyer_partials(ht, v_th)),
        float(jk.combine_hoyer_partials(hj, jnp.asarray(1.0))), rtol=1e-5)


@pytest.mark.parametrize("kernel,stride,h,w", GEOMETRIES[:3])
def test_im2col_rows_match_reference(kernel, stride, h, w):
    images, _ = _inputs(kernel, h, w)
    np.testing.assert_array_equal(
        t_ops.im2col(_t(images), kernel, stride).numpy(),
        np.asarray(j_ops.im2col(jnp.asarray(images), kernel, stride)))


@pytest.mark.parametrize("identity", [True, False])
def test_phase_b_matches_pallas(identity):
    rng = np.random.default_rng(1)
    n, c = 512, 16
    u = rng.normal(size=(n, c)).astype(np.float32)
    theta = np.float32(0.45)
    chan = _chan(c, identity)
    kj, kt = jax.random.fold_in(jax.random.PRNGKey(4), 2), prng.fold_in(
        prng.PRNGKey(4), 2)
    bits = j_ops.draw_bits(kj, n, c)
    aj, vj = jk.p2m_phase_b_pallas(
        jnp.asarray(u), jnp.asarray(theta).reshape(1, 1), bits, n_valid=n,
        c_valid=c, chan=None if chan is None else jnp.asarray(chan),
        block_n=128)
    at, vt = tk.p2m_phase_b(_t(u), _t(theta), kt,
                            chan=None if chan is None else _t(chan))
    q_ref, _ = j_ref._device_chain_q(jnp.asarray(u), jnp.asarray(theta),
                                     None if chan is None
                                     else jnp.asarray(chan),
                                     jk.pixel_model.DEFAULT_PIXEL,
                                     jk.mtj_model.DEFAULT_MTJ)
    assert_draws_match_modulo_word_boundary(at.numpy(), q_ref, bits)
    assert_draws_match_modulo_word_boundary(np.asarray(aj), q_ref, bits)
    stats_j = jk.combine_v_conv_partials(vj, n, c)
    stats_t = tk.combine_v_conv_partials(vt, n, c)
    for k in stats_j:
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("identity", [True, False])
def test_fused_matches_pallas(identity):
    images, wm = _inputs(3, 16, 16, c=16, b=2, seed=5)
    chan = _chan(16, identity)
    theta = np.float32(0.6)
    kj, kt = jax.random.PRNGKey(9), prng.PRNGKey(9)
    wp = jk.pack_phase_weights(jnp.asarray(wm))
    n = 2 * 8 * 8
    bits = j_ops.draw_bits(kj, n, 16)
    oj, hj, vj, rj = jk.p2m_fused_stream_pallas(
        jnp.asarray(images), wp, jnp.ones((1, 1)),
        jnp.asarray(theta).reshape(1, 1), bits,
        None if chan is None else jnp.asarray(chan), kernel=3, stride=2)
    v_th = torch.ones(())
    ot, ht, vt, rt = tk.p2m_fused_stream(
        _t(images), tk.pack_phase_weights(_t(wm)), v_th, _t(theta), kt,
        None if chan is None else _t(chan), kernel=3, stride=2)
    uj, _ = jk.p2m_phase_a_implicit_pallas(
        jnp.asarray(images), wp, jnp.ones((1, 1)), kernel=3, stride=2)
    q_ref, _ = j_ref._device_chain_q(uj, jnp.asarray(theta),
                                     None if chan is None
                                     else jnp.asarray(chan),
                                     jk.pixel_model.DEFAULT_PIXEL,
                                     jk.mtj_model.DEFAULT_MTJ)
    assert_draws_match_modulo_word_boundary(ot.numpy(), q_ref, bits)
    np.testing.assert_allclose(
        float(tk.combine_hoyer_partials(ht, v_th)),
        float(jk.combine_hoyer_partials(hj, jnp.asarray(1.0))), rtol=1e-5)
    np.testing.assert_array_equal(rt.sum(0).numpy(), ot.sum(0).numpy())
    # the rate counts follow the draws exactly; the draws agree with the
    # reference up to word-boundary flips
    assert np.abs(rt.sum(0).numpy() - np.asarray(rj).sum(0)).sum() <= 8
    stats_j = jk.combine_v_conv_partials(vj, n, 16)
    stats_t = tk.combine_v_conv_partials(vt, n, 16)
    for k in stats_j:
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=1e-5, err_msg=k)


def test_pinned_theta_fused_equals_two_kernel():
    """Within the port: the fused step at the exact step's theta gives the
    exact step's activations bit for bit, and its fresh theta is the same."""
    rng = np.random.default_rng(11)
    images = _t(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32))
    w = _t((rng.normal(size=(3, 3, 3, 32)) * 0.3).astype(np.float32))
    v_th = torch.ones(())
    key = prng.PRNGKey(9)
    o, aux = t_ops.p2m_frontend(images, w, v_th, key)
    of, auxf = t_ops.p2m_frontend_fused(images, w, v_th, aux["theta"], key)
    assert torch.equal(of, o)
    assert torch.equal(auxf["theta"], aux["theta"])
    np.testing.assert_allclose(auxf["channel_rates"].numpy(),
                               o.mean(dim=(0, 1, 2)).numpy(), atol=1e-6)
    for k in ("v_conv_mean", "v_conv_min", "v_conv_max"):
        np.testing.assert_allclose(float(auxf[k]), float(aux[k]), rtol=1e-6)


def test_frontend_matches_reference_pipeline():
    """``ops.p2m_frontend`` end to end against the reference's."""
    rng = np.random.default_rng(12)
    images = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32)) * 0.3).astype(np.float32)
    kj, kt = jax.random.fold_in(jax.random.PRNGKey(2), 3), prng.fold_in(
        prng.PRNGKey(2), 3)
    oj, auxj = j_ops.p2m_frontend(jnp.asarray(images), jnp.asarray(w),
                                  jnp.asarray(1.0), kj)
    ot, auxt = t_ops.p2m_frontend(_t(images), _t(w), torch.ones(()), kt)
    assert ot.shape == tuple(oj.shape)
    u = j_ref.p2m_phase_a_ref(j_ops.im2col(jnp.asarray(images), 3, 2),
                              jnp.asarray(w.reshape(27, 32)),
                              jnp.asarray(1.0), block_n=128)[0]
    q_ref, _ = j_ref._device_chain_q(u, auxj["theta"], None,
                                     jk.pixel_model.DEFAULT_PIXEL,
                                     jk.mtj_model.DEFAULT_MTJ)
    assert_draws_match_modulo_word_boundary(
        ot.numpy().reshape(-1, 32), q_ref, j_ops.draw_bits(kj, 128, 32))
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(j_hoyer.hoyer_extremum(j_hoyer.clip01(u))) == pytest.approx(
        float(auxt["theta"]), rel=1e-5)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_per_pixel_chan_matches_reference(precision):
    """The (4, N_pix, C) per-pixel operand through the plain versions of
    kernel B (the exact step) and of the fused kernels against the
    reference's 3-D ``chan``: draws by the word-boundary rule against the
    reference oracle's q, aux at rtol 1e-5; and a per-pixel map constant
    across pixels gives the (4, C) rows' outputs bit for bit."""
    rng = np.random.default_rng(14)
    images = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 16)) * 0.3).astype(np.float32)
    n_pix, c = 64, 16
    chan3 = _chan(n_pix * c, False, seed=5).reshape(4, n_pix, c)
    theta = np.float32(0.6)
    kj, kt = jax.random.PRNGKey(17), prng.PRNGKey(17)
    bits = j_ops.draw_bits(kj, 2 * n_pix, c)
    wj = jnp.asarray(w)
    if precision == "int8":
        wq, dq = j_ops.quantize_frontend_weights(
            jk.pack_phase_weights(wj.reshape(27, c)))
        u_ref = jk.p2m_phase_a_implicit_q8_pallas(
            jnp.asarray(images), wq, dq, jnp.ones((1, 1)), kernel=3,
            stride=2)[0]
    else:
        u_ref = jk.p2m_phase_a_implicit_pallas(
            jnp.asarray(images), jk.pack_phase_weights(wj.reshape(27, c)),
            jnp.ones((1, 1)), kernel=3, stride=2)[0]
    kw = dict(chan=_t(chan3), precision=precision)
    for name, run_j, run_t in (
            ("exact",
             lambda: j_ops.p2m_frontend(jnp.asarray(images), wj,
                                        jnp.asarray(1.0), kj,
                                        chan=jnp.asarray(chan3),
                                        precision=precision),
             lambda **k: t_ops.p2m_frontend(_t(images), _t(w), torch.ones(()),
                                            kt, **k)),
            ("fused",
             lambda: j_ops.p2m_frontend_fused(
                 jnp.asarray(images), wj, jnp.asarray(1.0),
                 jnp.asarray(theta), kj, chan=jnp.asarray(chan3),
                 precision=precision),
             lambda **k: t_ops.p2m_frontend_fused(
                 _t(images), _t(w), torch.ones(()), _t(theta), kt, **k))):
        oj, auxj = run_j()
        ot, auxt = run_t(**kw)
        th = auxj["theta"] if name == "exact" else jnp.asarray(theta)
        q_ref, _ = j_ref._device_chain_q(u_ref, th, jnp.asarray(chan3),
                                         jk.pixel_model.DEFAULT_PIXEL,
                                         jk.mtj_model.DEFAULT_MTJ)
        assert_draws_match_modulo_word_boundary(
            ot.numpy().reshape(-1, c), q_ref, bits)
        assert set(auxt) == set(auxj)
        for k in auxj:
            np.testing.assert_allclose(np.asarray(auxt[k]),
                                       np.asarray(auxj[k]), rtol=1e-5,
                                       atol=1e-6 if k == "channel_rates"
                                       else 0, err_msg=f"{name} {k}")
        rows = _t(chan3[:, 0])
        const = rows[:, None, :].expand(4, n_pix, c).contiguous()
        oc, auxc = run_t(chan=const, precision=precision)
        orow, auxr = run_t(chan=rows, precision=precision)
        assert torch.equal(oc, orow), name
        for k in auxr:
            assert torch.equal(auxc[k], auxr[k]), f"{name} {k}"


@pytest.mark.parametrize("kernel,stride,h,w", [GEOMETRIES[0], GEOMETRIES[4],
                                               GEOMETRIES[6]])
def test_explicit_phase_a_matches_pallas(kernel, stride, h, w):
    """Explicit-patch kernel A (plain) against ``p2m_phase_a_pallas`` on the
    same im2col rows, and against the port's implicit kernel A: same rows,
    same MAC, so u and the partials are equal."""
    images, wm = _inputs(kernel, h, w, b=4)
    patches = np.array(j_ops.im2col(jnp.asarray(images), kernel, stride))
    n = patches.shape[0]
    block = 16 if n % 16 == 0 else n
    uj, hj = jk.p2m_phase_a_pallas(jnp.asarray(patches), jnp.asarray(wm),
                                   jnp.ones((1, 1)), block_n=block)
    v_th = torch.ones(())
    wp = tk.pack_phase_weights(_t(wm))
    ut, ht = tk.p2m_phase_a(_t(patches), wp, v_th)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=3e-6)
    np.testing.assert_allclose(
        float(tk.combine_hoyer_partials(ht, v_th)),
        float(jk.combine_hoyer_partials(hj, jnp.asarray(1.0))), rtol=1e-5)
    ui, hi = tk.p2m_phase_a_implicit(_t(images), wp, v_th, kernel=kernel,
                                     stride=stride)
    assert torch.equal(ut, ui) and torch.equal(ht, hi)


@pytest.mark.parametrize("kernel,stride,h,w", [GEOMETRIES[0], GEOMETRIES[6]])
def test_legacy_conv_matches_reference(kernel, stride, h, w):
    """``ops.p2m_conv`` (the legacy baseline) against the reference's: the
    draws by the word-boundary rule against ``ref.p2m_conv_ref_q``; at
    kernel A's theta they equal the pinned-theta fused step's."""
    images, wm = _inputs(kernel, h, w, c=16, b=2, seed=21)
    w4 = wm.reshape(kernel, kernel, 3, 16)
    theta = np.float32(0.55)
    kj, kt = jax.random.fold_in(jax.random.PRNGKey(6), 1), prng.fold_in(
        prng.PRNGKey(6), 1)
    oj = j_ops.p2m_conv(jnp.asarray(images), jnp.asarray(w4),
                        jnp.asarray(theta), kj, kernel=kernel, stride=stride,
                        block_n=16)
    ot = t_ops.p2m_conv(_t(images), _t(w4), _t(theta), kt, kernel=kernel,
                        stride=stride)
    assert ot.shape == tuple(oj.shape)
    patches = j_ops.im2col(jnp.asarray(images), kernel, stride)
    q_ref = j_ref.p2m_conv_ref_q(patches, jnp.asarray(wm), jnp.asarray(theta))
    bits = j_ops.draw_bits(kj, patches.shape[0], 16)
    assert_draws_match_modulo_word_boundary(ot.numpy().reshape(-1, 16),
                                            q_ref, bits)
    assert_draws_match_modulo_word_boundary(np.asarray(oj).reshape(-1, 16),
                                            q_ref, bits)
    _, aux = t_ops.p2m_frontend(_t(images), _t(w4), torch.ones(()), kt,
                                kernel=kernel, stride=stride)
    of, _ = t_ops.p2m_frontend_fused(_t(images), _t(w4), torch.ones(()),
                                     aux["theta"], kt, kernel=kernel,
                                     stride=stride)
    assert torch.equal(t_ops.p2m_conv(_t(images), _t(w4), aux["theta"], kt,
                                      kernel=kernel, stride=stride), of)


def test_cpu_tensors_never_launch():
    cuda_lib.reset_launch_counts()
    rng = np.random.default_rng(13)
    images = _t(rng.uniform(size=(2, 8, 8, 3)).astype(np.float32))
    w = _t((rng.normal(size=(3, 3, 3, 8)) * 0.3).astype(np.float32))
    for prec in ("f32", "int8"):
        o, aux = t_ops.p2m_frontend(images, w, torch.ones(()),
                                    prng.PRNGKey(0), precision=prec)
        t_ops.p2m_frontend_fused(images, w, torch.ones(()), aux["theta"],
                                 prng.PRNGKey(0), precision=prec)
        keys = [prng.PRNGKey(0), prng.PRNGKey(1)]
        o, aux_f = t_ops.p2m_frontend_fleet(images[None].expand(2, -1, -1,
                                                                -1, -1),
                                            w, torch.ones(()), keys,
                                            precision=prec)
        t_ops.p2m_frontend_fused_fleet(images[None].expand(2, -1, -1, -1,
                                                           -1),
                                       w, torch.ones(()), aux_f["theta"],
                                       keys, precision=prec)
    t_ops.p2m_conv(images, w, aux["theta"], prng.PRNGKey(0))
    tk.p2m_phase_a(t_ops.im2col(images, 3, 2),
                   tk.pack_phase_weights(w.reshape(27, 8)), torch.ones(()))
    assert cuda_lib.launch_counts() == {fn.__name__: 0
                                  for fn in cuda_lib.kernel_wrappers()}
    assert set(cuda_lib.launch_counts()) == {
        "p2m_phase_a_implicit", "p2m_phase_b", "p2m_fused_stream",
        "p2m_phase_a_implicit_q8", "p2m_fused_stream_q8", "p2m_phase_a",
        "p2m_conv", "flash_attention", "flash_attention_bwd", "rglru_scan",
        "rglru_scan_gated",
        "slstm_scan",
        "p2m_phase_a_implicit_fleet",
        "p2m_phase_a_implicit_q8_fleet", "p2m_phase_b_fleet",
        "p2m_fused_stream_fleet", "p2m_fused_stream_q8_fleet"}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    images = torch.rand(2, 8, 8, 3)
    w = torch.rand(3, 3, 3, 8)
    wm = tk.pack_phase_weights(w.reshape(27, 8))
    with pytest.raises(ValueError, match="odd kernel"):
        tk.p2m_phase_a_implicit(images, tk.pack_phase_weights(
            torch.rand(12, 8)), torch.ones(()), kernel=2, stride=1)
    with pytest.raises(ValueError, match="w_packed"):
        tk.p2m_phase_a_implicit(images, wm[:20], torch.ones(()), kernel=3,
                                stride=2)
    # the per-pixel chip operand is taken when its pixels divide the rows
    # of u into whole frames, and refused otherwise, as is any other shape
    acts, _ = tk.p2m_phase_b(torch.rand(64, 8), torch.ones(()),
                             prng.PRNGKey(0), chan=torch.ones(4, 16, 8))
    assert acts.shape == (64, 8)
    with pytest.raises(ValueError, match="whole frames"):
        tk.p2m_phase_b(torch.rand(64, 8), torch.ones(()), prng.PRNGKey(0),
                       chan=torch.ones(4, 48, 8))
    for bad in ((4, 16, 9), (3, 8), (4, 9), (2, 4, 16, 8)):
        with pytest.raises(ValueError, match="chan must be"):
            tk.p2m_phase_b(torch.rand(64, 8), torch.ones(()),
                           prng.PRNGKey(0), chan=torch.ones(bad))
    with pytest.raises(ValueError, match="whole frames"):
        tk.p2m_fused_stream(images, wm, torch.ones(()), torch.ones(()),
                            prng.PRNGKey(0), torch.ones(4, 15, 8), kernel=3,
                            stride=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.p2m_phase_b(torch.rand(64, 8, device="meta"),
                       torch.ones((), device="meta"), prng.PRNGKey(0))
    with pytest.raises(ValueError, match="patches"):
        tk.p2m_phase_a(images, wm, torch.ones(()))
    with pytest.raises(ValueError, match="w_packed"):
        tk.p2m_conv(t_ops.im2col(images, 3, 2), wm[:20], torch.ones(()),
                    prng.PRNGKey(0))
    with pytest.raises(ValueError):
        t_ops.p2m_frontend(images, w, torch.ones(()), prng.PRNGKey(0),
                           precision="bf16")


@pytest.mark.parametrize("rows", [16, 1])
@pytest.mark.parametrize("n", [1, 16, 37, 200, 4096])
def test_v_partials_per_warp_tile_combine_to_the_one_row_result(n, rows):
    """Kernel B writes one (sum, min, max) row per warp tile of ``rows`` rows
    of u (16 where its tiles fill the card, 1 at the serving shape):
    the plain version's voltages cut into such rows, with a tail tile that
    holds no valid row (0, +inf, -inf), combine to its one-row result."""
    rng = np.random.default_rng(n)
    c = 32
    u = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32) * 0.3)
    theta = torch.tensor(0.4)
    chan = _t(_chan(c, identity=False))
    _, v = tk.device_chain_q(u, theta, chan)
    tiles = [torch.stack([x.sum(), x.min(), x.max()])
             for x in torch.split(v, rows)]
    tiles.append(torch.tensor([0.0, math.inf, -math.inf]))
    got = tk.combine_v_conv_partials(torch.stack(tiles), n, c)
    want = tk.combine_v_conv_partials(
        tk.p2m_phase_b_plain(u, theta, prng.PRNGKey(1), chan=chan)[1], n, c)
    torch.testing.assert_close(got["v_conv_mean"], want["v_conv_mean"],
                               rtol=1e-6, atol=0)
    assert torch.equal(got["v_conv_min"], want["v_conv_min"])
    assert torch.equal(got["v_conv_max"], want["v_conv_max"])


@pytest.mark.parametrize("n", range(1, 25))
def test_physics_args_carry_exact_binomials(n):
    """The kernels' majority polynomial reads C(n, k) from the host: every
    coefficient equals math.comb (exact in float32 up to n 24), the unused
    slots stay 0."""
    mtj = dataclasses.replace(t_mtj.DEFAULT_MTJ, n_redundant=n)
    phys = tk.physics_args(t_pixel.DEFAULT_PIXEL, mtj)
    assert phys.n_redundant == n and phys.majority == n // 2
    assert list(phys.binom) == [float(math.comb(n, k)) if k <= n else 0.0
                                for k in range(25)]


@pytest.mark.parametrize("n", [0, 25, 64])
def test_physics_args_refuse_what_the_binomials_do_not_hold(n):
    mtj = dataclasses.replace(t_mtj.DEFAULT_MTJ, n_redundant=n)
    with pytest.raises(ValueError, match="n_redundant <= 24"):
        tk.physics_args(t_pixel.DEFAULT_PIXEL, mtj)
