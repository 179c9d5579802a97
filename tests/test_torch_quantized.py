"""The port's int8 frontend path against the JAX package.

On the CPU the int8 wrappers run their plain PyTorch versions (the CUDA
kernels are held against those on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``). Here the same numpy inputs go through the
JAX function (Pallas in interpret mode) and the port's counterpart.

Tolerances: the q8 helpers are integer and power-of-two arithmetic, so they
must be equal; int8 kernel A's u at atol 1e-5 (the reference's own bound
for its q8 kernel against its oracle) and theta at rtol 1e-5; draws by the
word-boundary rule (XLA:CPU and PyTorch evaluate tanh/exp with different
polynomials); the fused int8 step at the exact int8 theta equal to the
exact step bit for bit, aux at rtol 1e-6. On power-of-two grid inputs every
MAC is exact at both precisions, so the port's f32 and int8 paths and the
JAX int8 path agree bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draw_asserts import assert_draws_match_modulo_word_boundary
from repro.core import hoyer as j_hoyer
from repro.core import p2m as j_p2m
from repro.kernels import autotune as j_autotune
from repro.kernels import ops as j_ops
from repro.kernels import p2m_conv as jk
from repro.kernels import ref as j_ref
from repro.models import vision as jv
from repro.serving import VisionEngine as JaxEngine
from repro_torch import prng
from repro_torch.core import p2m as t_p2m
from repro_torch.kernels import autotune as t_autotune
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import p2m_conv as tk
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(seed, shape=(27, 32)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.3).astype(np.float32)


def _frames(seed, b=2, hw=16):
    return np.random.default_rng(seed).uniform(
        size=(b, hw, hw, 3)).astype(np.float32)


def _q8_operands(w):
    """(k*k*cin, C) signed weights -> both sides' (wq, dq) operands."""
    wj, dj = j_ops.quantize_frontend_weights(
        jk.pack_phase_weights(jnp.asarray(w)))
    wt, dt = t_ops.quantize_frontend_weights(tk.pack_phase_weights(_t(w)))
    return (wj, dj), (wt, dt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weight_quantization_matches_reference(seed):
    w = _weights(seed)
    w[:, 3] = 0.0                      # an all-zero column hits the guard
    wm = np.asarray(jk.pack_phase_weights(jnp.asarray(w)))
    wq_j, scale_j = j_p2m.quantize_packed_weights(jnp.asarray(wm))
    wq_t, scale_t = t_p2m.quantize_packed_weights(_t(wm))
    assert wq_t.dtype == torch.int8 and scale_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))
    np.testing.assert_array_equal(
        t_p2m.packed_dequant_row(scale_t).numpy(),
        np.asarray(j_p2m.packed_dequant_row(scale_j)))
    np.testing.assert_array_equal(
        t_p2m.dequantize_packed_weights(wq_t, scale_t).numpy(),
        np.asarray(j_p2m.dequantize_packed_weights(wq_j, scale_j)))
    (wj, dj), (wt, dt) = _q8_operands(w)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("grid", ["uniform", "1/256", "clipped"])
def test_act_quantization_matches_reference(grid):
    rng = np.random.default_rng(4)
    x = {"uniform": rng.uniform(size=4096),
         # x * 128 lands on .5 for every odd k: round half to even
         "1/256": np.arange(257) / 256.0,
         "clipped": rng.uniform(-2.0, 2.0, size=4096)}[grid]
    x = x.astype(np.float32)
    got = t_p2m.quantize_acts_q8(_t(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_p2m.quantize_acts_q8(
                                      jnp.asarray(x))))


@pytest.mark.parametrize("kernel,stride,h,w", [(3, 2, 16, 16), (3, 1, 12, 12),
                                               (5, 3, 13, 11)])
def test_q8_kernel_a_matches_pallas(kernel, stride, h, w):
    images = np.random.default_rng(5).uniform(
        size=(2, h, w, 3)).astype(np.float32)
    (wj, dj), (wt, dt) = _q8_operands(_weights(6, (kernel * kernel * 3, 16)))
    uj, hj = jk.p2m_phase_a_implicit_q8_pallas(
        jnp.asarray(images), wj, dj, jnp.ones((1, 1)), kernel=kernel,
        stride=stride, block_n=64)
    v_th = torch.ones(())
    ut, ht = tk.p2m_phase_a_implicit_q8(_t(images), wt, dt, v_th,
                                        kernel=kernel, stride=stride)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(tk.combine_hoyer_partials(ht, v_th)),
        float(jk.combine_hoyer_partials(hj, jnp.asarray(1.0))), rtol=1e-5)


def test_int8_frontend_matches_reference():
    images = _frames(7, b=2, hw=32)
    w = _weights(8, (3, 3, 3, 32))
    kj, kt = jax.random.PRNGKey(13), prng.PRNGKey(13)
    oj, auxj = j_ops.p2m_frontend(jnp.asarray(images), jnp.asarray(w),
                                  jnp.asarray(1.0), kj, precision="int8")
    ot, auxt = t_ops.p2m_frontend(_t(images), _t(w), torch.ones(()), kt,
                                  precision="int8")
    assert ot.shape == tuple(oj.shape)
    (wq, dq), _ = _q8_operands(w.reshape(27, 32))
    patches = j_ops.im2col(jnp.asarray(images), 3, 2)
    q_ref = j_ref.p2m_conv_ref_q8_q(patches, wq, dq, auxj["theta"])
    bits = j_ops.draw_bits(kj, patches.shape[0], 32)
    assert_draws_match_modulo_word_boundary(ot.numpy().reshape(-1, 32), q_ref,
                                            bits)
    assert set(auxt) == set(auxj)
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, err_msg=k)
    u_ref, _ = j_ref.p2m_phase_a_q8_ref(patches, wq, dq, jnp.asarray(1.0),
                                        block_n=patches.shape[0])
    assert float(j_hoyer.hoyer_extremum(j_hoyer.clip01(u_ref))) == \
        pytest.approx(float(auxt["theta"]), rel=1e-5)


def test_fused_q8_pinned_theta_equals_exact_q8():
    images = _t(_frames(9, b=2, hw=32))
    w = _t(_weights(10, (3, 3, 3, 32)))
    v_th, key = torch.ones(()), prng.PRNGKey(17)
    o, aux = t_ops.p2m_frontend(images, w, v_th, key, precision="int8")
    of, auxf = t_ops.p2m_frontend_fused(images, w, v_th, aux["theta"], key,
                                        precision="int8")
    assert torch.equal(of, o)
    np.testing.assert_allclose(float(auxf["theta"]), float(aux["theta"]),
                               rtol=1e-6)
    for k in ("v_conv_mean", "v_conv_min", "v_conv_max"):
        np.testing.assert_allclose(float(auxf[k]), float(aux[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(auxf["channel_rates"].numpy(),
                               o.mean(dim=(0, 1, 2)).numpy(), atol=1e-6)
    assert set(auxf) == {"theta", "theta_used", "channel_rates",
                         "v_conv_mean", "v_conv_min", "v_conv_max"}


def _grid_inputs(seed, b=2, hw=16, cout=8):
    """The reference's power-of-two construction: integer * 2^-9 weights
    with +-127 pinned in every channel (every packed scale is exactly 2^-9)
    and frames on the 1/128 grid."""
    rng = np.random.default_rng(seed)
    w_int = rng.integers(-126, 127, size=(3, 3, 3, cout))
    w_int[0, 0, 0, :], w_int[0, 0, 1, :] = 127, -127
    frames = rng.integers(0, 128, size=(b, hw, hw, 3)) / 128.0
    return (w_int * 2.0 ** -9).astype(np.float32), frames.astype(np.float32)


@pytest.mark.parametrize("path", ["exact", "fused"])
def test_power_of_two_grid_is_bit_identical(path):
    w, frames = _grid_inputs(seed=1 if path == "exact" else 2)
    kj, kt = jax.random.PRNGKey(23), prng.PRNGKey(23)

    def run_t(prec):
        if path == "exact":
            return t_ops.p2m_frontend(_t(frames), _t(w), torch.ones(()), kt,
                                      precision=prec)
        return t_ops.p2m_frontend_fused(_t(frames), _t(w), torch.ones(()),
                                        torch.tensor(0.7), kt,
                                        precision=prec)

    o32, aux32 = run_t("f32")
    o8, aux8 = run_t("int8")
    assert torch.equal(o8, o32)
    for k in aux32:
        assert torch.equal(aux8[k], aux32[k]), k
    if path == "exact":
        oj, auxj = j_ops.p2m_frontend(jnp.asarray(frames), jnp.asarray(w),
                                      jnp.asarray(1.0), kj, precision="int8")
    else:
        oj, auxj = j_ops.p2m_frontend_fused(
            jnp.asarray(frames), jnp.asarray(w), jnp.asarray(1.0),
            jnp.asarray(0.7, jnp.float32), kj, precision="int8")
    np.testing.assert_array_equal(o8.numpy(), np.asarray(oj))
    np.testing.assert_allclose(float(aux8["theta"]), float(auxj["theta"]),
                               rtol=1e-6)


def test_q8_wrappers_refuse_what_the_kernels_do_not_take():
    images = torch.rand(2, 8, 8, 3)
    wq, dq = t_ops.quantize_frontend_weights(
        tk.pack_phase_weights(torch.randn(27, 8)))
    with pytest.raises(ValueError, match="dequant_row"):
        tk.p2m_phase_a_implicit_q8(images, wq, dq[:, :8], torch.ones(()),
                                   kernel=3, stride=2)
    with pytest.raises(ValueError, match="w_packed"):
        tk.p2m_fused_stream_q8(images, wq[:20], dq, torch.ones(()),
                               torch.ones(()), prng.PRNGKey(0), kernel=3,
                               stride=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.p2m_phase_a_implicit_q8(images.to("meta"), wq.to("meta"),
                                   dq.to("meta"), torch.ones((),
                                                             device="meta"),
                                   kernel=3, stride=2)


def _engine_tables(tmp_path, monkeypatch, shapes):
    """int8 at each (N, K, C) in both packages' tables, each package's
    process table emptied for this test (the tables are process-global)."""
    monkeypatch.setattr(j_autotune, "_TABLE", {})
    monkeypatch.setattr(t_autotune, "_TABLE", {})
    for key in shapes:
        j_autotune.put(*key, dataclasses.replace(
            j_autotune.default_choice(*key), precision="int8"))
        t_autotune.put(*key, t_autotune.TileChoice(precision="int8"))
    j_path, t_path = tmp_path / "jax_tiles.json", tmp_path / "port_tiles.json"
    j_autotune.save_table(str(j_path))
    t_autotune.save_table(str(t_path))
    j_autotune.clear()
    t_autotune.clear()
    return str(j_path), str(t_path)


def _compare(oj, ot, n_frontend):
    assert set(ot) == set(oj)
    np.testing.assert_array_equal(ot["labels"].numpy(),
                                  np.asarray(oj["labels"]))
    # every frontend draw agrees at these seeds (the per-frame activation
    # counts are equal), so probs agree to float32 rounding
    np.testing.assert_allclose(float(ot["activated_fraction"]),
                               float(oj["activated_fraction"]), rtol=0,
                               atol=0.5 / n_frontend)
    np.testing.assert_allclose(ot["probs"].numpy(), np.asarray(oj["probs"]),
                               rtol=0, atol=1e-6)
    for k in ("theta", "theta_used", "v_conv_mean", "v_conv_min",
              "v_conv_max", "p2m_sparsity"):
        if k in oj:
            np.testing.assert_allclose(float(ot[k]), float(oj[k]),
                                       rtol=1e-5, err_msg=k)


def test_int8_engine_matches_reference_engine(tmp_path, monkeypatch):
    cfg_j = jv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10)
    cfg_t = tv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10)
    pj = jv.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tp.from_numpy(jax.tree.map(np.asarray, pj))
    key = (4 * 16 * 16, 27, 32)            # 4 frames of 32x32 -> (1024, 27, 32)
    j_path, t_path = _engine_tables(tmp_path, monkeypatch, [key])
    ej = JaxEngine(cfg_j, pj, backend="pallas", seed=3, microbatch=4,
                   tile_table=j_path)
    et = VisionEngine(cfg_t, pt, backend="cuda", seed=3, device="cpu",
                      microbatch=4, tile_table=t_path)
    assert t_autotune.lookup(*key).precision == "int8"
    frames = np.random.default_rng(0).uniform(
        size=(4, 32, 32, 3)).astype(np.float32)
    cuda_lib.reset_launch_counts()
    _compare(ej.classify(jnp.asarray(frames)), et.classify(frames),
             4 * 16 * 16 * 32)
    batches = [frames, (0.9 * frames).astype(np.float32)]
    outs_j = list(ej.stream([jnp.asarray(f) for f in batches]))
    outs_t = list(et.stream(batches))
    for oj, ot in zip(outs_j, outs_t):
        _compare(oj, ot, 4 * 16 * 16 * 32)
    assert (et.fused_step_count, et.fused_fallback_count) == \
        (ej.fused_step_count, ej.fused_fallback_count)
    assert et.fused_step_count == 1
    # CPU tensors run the plain versions: nothing launched
    assert set(cuda_lib.launch_counts().values()) == {0}
