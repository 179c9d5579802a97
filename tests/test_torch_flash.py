"""The port's flash attention held against the JAX package on the CPU.

The same numpy inputs go to the reference's Pallas kernel (through
``repro.kernels.ops.flash_attention``, in interpret mode, as
tests/test_kernels.py runs it), to its oracle ``ref.flash_attention_ref``
and to the JAX model layer ``blocks.flash_attention``, and to their
counterparts in the port: ``flash_attention_plain``, the port's
``ops.flash_attention`` (whose wrapper runs the plain version for CPU
tensors) and the port's ``blocks.flash_attention``. Tolerances: 2e-5 for
float32 (summation order), 2e-2 for bfloat16 outputs (one bf16 ulp of the
output plus another kv-tile order), as in tests/test_kernels.py.
Unequal q and kv lengths (whisper-base's cross-attention: its decoder's
tokens over its encoder's frames) against the JAX model layer, which
takes them where the Pallas kernel does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro_torch import configs as tconfigs
from repro_torch.analysis import census
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ops as tops
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, s, h, hkv, d, dtype="float32", sk=None, dv=None):
    """numpy float32 draws, cast to ``dtype`` on both sides (both round to
    nearest even)."""
    rng = np.random.default_rng(seed)
    sk = sk or s
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, dv or d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("d", [16, 64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_causal_matches_pallas_kernel_and_oracle(s, d, dtype):
    (qj, kj, vj), (q, k, v) = _inputs(s + d, 2, s, 2, 2, d, dtype)
    kern = jops.flash_attention(qj, kj, vj, causal=True, block_q=32,
                                block_kv=32)
    oracle = jref.flash_attention_ref(qj, kj, vj, causal=True)
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    op = tops.flash_attention(q, k, v, causal=True)
    assert plain.dtype == q.dtype and torch.equal(op, plain)
    _close(plain, kern, TOL[dtype])
    _close(plain, oracle, TOL[dtype])


def test_non_causal():
    (qj, kj, vj), (q, k, v) = _inputs(1, 1, 128, 4, 4, 32)
    kern = jops.flash_attention(qj, kj, vj, causal=False, block_q=32,
                                block_kv=64)
    _close(tops.flash_attention(q, k, v, causal=False), kern, 2e-5)
    _close(tops.flash_attention(q, k, v, causal=False),
           jref.flash_attention_ref(qj, kj, vj, causal=False), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_reads_kv_head_without_repeat(dtype):
    """GQA 8/2: the reference repeats the kv heads; the port indexes them."""
    (qj, kj, vj), (q, k, v) = _inputs(2, 1, 64, 8, 2, 16, dtype)
    kern = jops.flash_attention(qj, kj, vj, causal=True, block_q=16,
                                block_kv=16)
    _close(tops.flash_attention(q, k, v, causal=True), kern, TOL[dtype])


@pytest.mark.parametrize("s", [77, 130])
def test_ragged_length(s):
    """Any S: the reference kernel needs S % block == 0, so the oracle (kv
    heads repeated) and the JAX model layer are the references here."""
    (qj, kj, vj), (q, k, v) = _inputs(s, 2, s, 4, 2, 32)
    oracle = jref.flash_attention_ref(qj, jnp.repeat(kj, 2, axis=2),
                                      jnp.repeat(vj, 2, axis=2), causal=True)
    out = tops.flash_attention(q, k, v, causal=True)
    _close(out, oracle, 2e-5)
    _close(out, jblocks.flash_attention(qj, kj, vj, causal=True,
                                        q_chunk=16, kv_chunk=16), 2e-5)


@pytest.mark.parametrize("window", [1, 63, 64, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_across_every_kernel_tile_boundary(window, dtype):
    """The plain version with a sliding window against the JAX model
    layer's scan: windows of 1 (a row sees itself), one short of the FFMA
    kernel's 64-row kv tile and the D 256 wgmma kernel's, exactly one
    tile, and several tiles, at S 1000 (a ragged tail past 128-row tiles);
    the port's ``ops`` wrapper and model layer pass the window on."""
    (qj, kj, vj), (q, k, v) = _inputs(window, 1, 1000, 4, 1, 16, dtype)
    ref = jblocks.flash_attention(qj, kj, vj, causal=True, window=window,
                                  q_chunk=200, kv_chunk=200)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    _close(plain, ref, TOL[dtype])
    assert torch.equal(tops.flash_attention(q, k, v, causal=True,
                                            window=window), plain)
    _close(tblocks.flash_attention(q, k, v, causal=True, window=window,
                                   kv_chunk=200), ref, TOL[dtype])


def test_card_operands_by_dtype_and_head_dim():
    """bf16 takes head dim 256 (recurrentgemma-2b), 112 (kimi-k2) and the
    MLA pair, qk 192 over v 128 (deepseek-v2); float32 takes none of them;
    a negative window is refused (CPU tensors: the check reads dtype,
    shape, strides and alignment only)."""
    assert fa.HEAD_DIM_PAIRS[torch.bfloat16] == (
        (16, 16), (32, 32), (64, 64), (80, 80), (112, 112), (128, 128),
        (192, 128), (256, 256))
    assert fa.HEAD_DIM_PAIRS[torch.float32] == (
        (16, 16), (32, 32), (64, 64), (80, 80), (128, 128))
    q = torch.zeros((1, 8, 10, 256), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 256), dtype=torch.bfloat16)
    fa._check_card_operands(q, k, k, window=2048)
    with pytest.raises(ValueError, match="head dim 256"):
        fa._check_card_operands(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="window"):
        fa._check_card_operands(q, k, k, window=-1)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_model_layer_matches_jax_scan(window, causal):
    (qj, kj, vj), (q, k, v) = _inputs(3, 2, 64, 4, 2, 16)
    kw = dict(causal=causal, window=window, kv_chunk=16)
    _close(tblocks.flash_attention(q, k, v, **kw),
           jblocks.flash_attention(qj, kj, vj, q_chunk=16, **kw), 2e-5)


def test_model_layer_offset_queries_and_value_dim():
    """Unequal lengths, a q offset and Dv != D (the reference's cross /
    MLA shapes): the CPU path computes them as the JAX scan does."""
    (qj, kj, vj), (q, k, v) = _inputs(4, 1, 16, 4, 4, 16, sk=48, dv=8)
    kw = dict(causal=True, q_offset=32, kv_chunk=16)
    _close(tblocks.flash_attention(q, k, v, **kw),
           jblocks.flash_attention(qj, kj, vj, q_chunk=8, **kw), 2e-5)


def test_model_layer_bf16_matches_jax_scan():
    (qj, kj, vj), (q, k, v) = _inputs(5, 2, 64, 4, 1, 32, "bfloat16")
    kw = dict(causal=True, kv_chunk=32)
    _close(tblocks.flash_attention(q, k, v, **kw),
           jblocks.flash_attention(qj, kj, vj, q_chunk=16, **kw), 2e-2)


# (Sq, Sk, D): kv longer and shorter than q, ragged against the kernels'
# 128-row q tiles and 64 / 128-row kv tiles, and whisper-base's cross
# geometry (a 130-row slice of queries over its 1500 frames at D 64)
UNEQUAL = [(8, 24, 16), (24, 8, 16), (33, 150, 16), (130, 1500, 64)]


@pytest.mark.parametrize("sq,sk,d", UNEQUAL)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unequal_lengths_match_jax_model_layer(sq, sk, d, dtype):
    """Non-causal attention of Sq queries over Sk keys: the plain version,
    the port's ``ops`` wrapper (CPU tensors: the plain version) and its
    model layer against the JAX model layer's scan."""
    (qj, kj, vj), (q, k, v) = _inputs(sq + sk, 2, sq, 4, 2, d, dtype, sk=sk)
    ref = jblocks.flash_attention(qj, kj, vj, causal=False)
    plain = fa.flash_attention_plain(q, k, v, causal=False)
    assert tuple(plain.shape) == (2, sq, 4, d)
    _close(plain, ref, TOL[dtype])
    assert torch.equal(tops.flash_attention(q, k, v, causal=False), plain)
    _close(tblocks.flash_attention(q, k, v, causal=False), ref, TOL[dtype])


def test_shapes_take_unequal_lengths_and_refuse_a_short_v():
    """``_check_shapes`` takes Sq != Sk; it still wants batch and head dim
    equal, whole groups of query heads, and v as long as k."""
    _, (q, k, v) = _inputs(12, 1, 8, 4, 2, 16, sk=24)
    fa._check_shapes(q, k, v)
    with pytest.raises(ValueError, match="want q"):
        fa._check_shapes(q, k, v[:, :20])
    with pytest.raises(ValueError, match="do not match"):
        fa._check_shapes(q, k[..., :8], v)
    with pytest.raises(ValueError, match="do not match"):
        fa._check_shapes(q, torch.cat([k, k]), torch.cat([v, v]))
    with pytest.raises(ValueError, match="multiple"):
        fa._check_shapes(q[:, :, :3], k, v)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 4),
                                           (True, 4)])
def test_card_operands_refuse_causal_or_window_at_unequal_lengths(causal,
                                                                  window):
    """The kernel takes Sq != Sk only without causal and window: neither
    package has such a call, and the wrapper says so (the check reads
    only shapes here); the plain version computes them."""
    _, (q, k, v) = _inputs(13, 1, 8, 4, 2, 16, sk=24)
    fa._check_card_operands(q, k, v)
    with pytest.raises(ValueError, match="unequal lengths only without"):
        fa._check_card_operands(q, k, v, window=window, causal=causal)
    fa._check_card_operands(q, k[:, :8], v[:, :8], window=window,
                            causal=causal)
    assert fa.flash_attention(q, k, v, causal=causal,
                              window=window).shape == q.shape


def test_census_declares_products_at_both_lengths():
    """The op census takes the kernel's two products at (Sq, D) x (D, Sk)
    and (Sq, Sk) x (Sk, Dv)."""
    _, (q, k, v) = _inputs(14, 2, 8, 4, 2, 16, "bfloat16", sk=24)
    dots = fa._attention_dots(q, k, v, causal=False)
    assert [(d.lhs, d.rhs) for d in dots] == [((2, 4, 8, 16), (16, 24)),
                                              ((2, 4, 8, 24), (24, 16))]
    res = census.op_census(lambda: fa.flash_attention(q, k, v,
                                                      causal=False))
    assert res["ops"]["kernel_calls"] == 1
    assert res["flops"]["dot_flops"] == 2 * 2 * 4 * 8 * 24 * (16 + 16)


def test_kernel_tiles_do_not_change_the_function():
    """The plain version at the kernel's kv tile equals it at the JAX
    layer's chunk (and the oracle) up to summation order."""
    _, (q, k, v) = _inputs(6, 1, 200, 4, 2, 32)
    a = fa.flash_attention_plain(q, k, v, kv_chunk=fa.BLOCK_KV)
    b = fa.flash_attention_plain(q, k, v, kv_chunk=200)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_cpu_tensors_never_launch_flash():
    cuda_lib.reset_launch_counts()
    _, (q, k, v) = _inputs(7, 1, 32, 2, 1, 16)
    tops.flash_attention(q, k, v)
    tblocks.flash_attention(q, k, v, causal=True)
    assert cuda_lib.launch_counts()["flash_attention"] == 0
    assert fa.flash_attention.launches == 0


def test_wrapper_refuses_mismatched_operands():
    _, (q, k, v) = _inputs(8, 1, 32, 4, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-1}   # chip_smoke.py's FLASH_ROW_TOL


def _row_rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs().amax(dim=-1)
                  / ref.square().mean(dim=-1).sqrt()).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_error_limit_passes_tile_order_and_fails_a_dropped_tile(dtype):
    """The card check's second limit, error over each output row's RMS:
    another kv tile order stays under it, and one kv tile dropped from the
    last rows only (where |out| is small) lies far above it."""
    _, (q, k, v) = _inputs(9, 1, 1024, 2, 1, 128, dtype)
    ref = fa.flash_attention_plain(q, k, v, kv_chunk=fa.BLOCK_KV)
    for chunk in (32, 128, 1024):
        alt = fa.flash_attention_plain(q, k, v, kv_chunk=chunk)
        assert _row_rel_err(alt, ref) <= ROW_TOL[dtype]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    scores = qf @ kf.transpose(-1, -2) * 128 ** -0.5
    keep = torch.ones(1024, 1024, dtype=torch.bool).tril()
    keep[768:, 256:256 + fa.BLOCK_KV] = False
    dropped = (scores.masked_fill(~keep, float("-inf")).softmax(-1) @ vf)
    dropped = dropped.transpose(1, 2).to(q.dtype)
    assert _row_rel_err(dropped, ref) > 10 * ROW_TOL[dtype]


# the configs the LM path serves (the dense GQA ones, the hybrid, the MoE
# ones, xLSTM, the encoder-decoder)
SERVED = {"granite-8b", "yi-34b", "stablelm-3b", "glm4-9b", "chameleon-34b",
          "recurrentgemma-2b", "deepseek-v2-236b", "kimi-k2-1t-a32b",
          "xlstm-350m", "whisper-base"}


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_card_wrapper_takes_every_served_head_dim(name):
    """Every config the LM path serves with attention has a head dim the
    card kernels take: ``_check_card_operands`` passes bf16 operands of its
    widths, an MLA config's at its prefill's qk and v dims, an
    encoder-decoder's cross-attention at its encoder's length too (CPU
    tensors here: the check reads only dtype, shape, strides and
    alignment). A served config without attention (xlstm-350m) calls no
    flash kernel. The configs it does not serve are refused before any
    attention runs."""
    cfg = tconfigs.get_arch(name)
    try:
        tlm.check_supported(cfg)
    except NotImplementedError:
        assert name not in SERVED
        return
    assert name in SERVED
    if not {"attn", "local_attn", "mla"} & set(cfg.block_pattern):
        return
    d = dv = cfg.resolved_head_dim
    if "mla" in cfg.block_pattern:     # nope + rope columns over v's width
        d = dv + cfg.rope_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    q = torch.zeros((1, 8, h, d), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, hkv, d), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, hkv, dv), dtype=torch.bfloat16)
    fa._check_shapes(q, k, v)
    fa._check_card_operands(q, k, v)
    if cfg.is_encdec:   # the cross block: 8 queries over every frame
        k = torch.zeros((1, cfg.encoder_seq, hkv, d), dtype=torch.bfloat16)
        fa._check_shapes(q, k, k)
        fa._check_card_operands(q, k, k)

