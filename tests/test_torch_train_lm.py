"""The port's LM training path held against the JAX package on the CPU.

* ``lm_loss`` and every leaf's gradient against ``jax.value_and_grad`` of
  ``repro.models.lm.lm_loss`` (jitted) on reduced stablelm-3b, granite-8b
  (remat "full" too: the same numbers), recurrentgemma-2b, deepseek-v2
  (2 layers) and xlstm-350m (one mLSTM and one sLSTM layer) in float32,
  through the plain versions: the loss within
  2e-6 and each gradient leaf within 1e-5 of its largest entry (float32
  summation order; the worst seen is 4e-6, recurrentgemma-2b's scan);
* ``flash_attention_bwd_plain`` against ``jax.grad`` of the reference's
  ``blocks.flash_attention`` (causal and not, GQA, ragged): 2e-5;
* ``apply_updates`` per leaf for AdamW, factored, bf16 momentum, no
  momentum (Adafactor) and SGD, two steps: within 4 float32 ulps of each
  value's magnitude (XLA contracts some multiply-adds that PyTorch rounds
  twice), bf16 momentum within one bf16 ulp;
* compression: int8 codes and scales bit for bit, residuals within one
  ulp of the gradient's scale;
* ``TokenStream`` batches and pipeline state bit for bit;
* three ``make_train_step`` steps at microbatches 1 and 2 (and one with
  residuals and compression), parameters within 1e-6 of the reference's
  jitted step's; the NaN guard keeps every leaf bit for bit and counts
  the skip;
* ``Trainer``: a run stopped and resumed from its checkpoint equals the
  uninterrupted run bit for bit;
* the train launcher on the CPU against the reference's launcher: the
  logged losses within 1e-5;
* the guard: ``cuda_lib.needs_backward`` and ``lm.check_trainable``.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.configs.reduced import reduced as jreduced
from repro.data import synthetic as jsyn
from repro.launch import train as jlaunch
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.configs import base as tbase
from repro_torch.configs.reduced import reduced as treduced
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizer as topt
from repro_torch.train import loop as tloop


def _np(t):
    return t.detach().float().numpy()


def _leaves_close(port, ref, rel, atol=0.0):
    """Each leaf of two trees (port's nested dicts, the reference's pytree)
    within ``rel`` of that leaf's largest entry (plus ``atol``)."""
    ref_leaves = jax.tree.leaves(ref)
    # a factored second moment is a (row, col) pair, two pytree leaves
    port_leaves = [t for x in topt.leaves(port)
                   for t in (x if isinstance(x, tuple) else (x,))]
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r, np.float32)
        assert tuple(p.shape) == r.shape
        tol = rel * max(float(np.abs(r).max()), 1e-30) + atol
        np.testing.assert_allclose(_np(p), r, rtol=0, atol=tol)


def _cfgs(arch, **over):
    return (dataclasses.replace(treduced(tconfigs.get_arch(arch)), **over),
            dataclasses.replace(jreduced(jconfigs.get_arch(arch)), **over))


def _weights(cfg):
    """The same seeded weights for both packages: the port's draw (the
    reference's eager ``init_params`` takes seconds a config)."""
    tp = tlm.init_params(0, cfg)
    return tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _batch(vocab, b=2, s=32, seed=5):
    jb = jsyn.make_lm_batch(jax.random.PRNGKey(seed), b, s, vocab)
    return jb, {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}


def test_run_and_optimizer_configs_match_reference():
    assert dataclasses.asdict(tbase.OptimizerConfig()) == dataclasses.asdict(
        jbase.OptimizerConfig())
    arch = "stablelm-3b"
    port = dataclasses.asdict(tbase.RunConfig(tconfigs.get_arch(arch)))
    ref = dataclasses.asdict(jbase.RunConfig(jconfigs.get_arch(arch)))
    # the port's default directory lies under TMPDIR, not a fixed /tmp path
    assert port.pop("checkpoint_dir").endswith("repro_ckpt")
    ref.pop("checkpoint_dir")
    assert port == ref


# --- lm_loss and its gradient ------------------------------------------------

# deepseek-v2 at 2 layers (its dense first layer and one MLA + MoE layer)
# and xlstm-350m as one mLSTM and one sLSTM layer: the reference's compile
# of their gradient takes 16 s at the reduced configs' depth, 7 s so
LOSS_CASES = [("stablelm-3b", {"remat": "none"}),
              ("granite-8b", {"remat": "full"}),
              ("recurrentgemma-2b", {}),
              ("deepseek-v2-236b", {"num_layers": 2}),
              ("xlstm-350m", {"num_layers": 2,
                              "block_pattern": ("mlstm", "slstm")})]


@pytest.mark.parametrize("arch,over", LOSS_CASES,
                         ids=[a for a, _ in LOSS_CASES])
def test_lm_loss_and_gradients_match_reference(arch, over):
    cfg, jcfg = _cfgs(arch, **over)
    tp, jp = _weights(cfg)
    jb, tb = _batch(cfg.vocab_size)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg), has_aux=True))(jp, jb)
    live = topt.leafwise(lambda t: t.detach().requires_grad_(True), tp)
    flat = topt.leaves(live)
    loss, metrics = tlm.lm_loss(live, tb, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(grads)
    tg = topt.leafwise(lambda p: next(it), tp)
    assert abs(float(loss) - float(jloss)) <= 2e-6
    assert abs(float(metrics["ppl"]) - float(jm["ppl"])) <= 2e-6 * float(
        jm["ppl"])
    _leaves_close(tg, jg, rel=1e-5)


def test_remat_changes_no_number():
    """``cfg.remat`` recomputes each stacked layer in the backward
    (torch.utils.checkpoint); the loss and the gradients are the same
    bits."""
    out = []
    for remat in ("none", "full"):
        cfg, _ = _cfgs("granite-8b", remat=remat)
        tp = tlm.init_params(0, cfg)
        _, tb = _batch(cfg.vocab_size)
        live = topt.leafwise(lambda t: t.detach().requires_grad_(True), tp)
        loss, _ = tlm.lm_loss(live, tb, cfg)
        out.append([loss] + list(torch.autograd.grad(loss,
                                                     topt.leaves(live))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("causal,h,hkv,s", [(True, 4, 2, 37),
                                            (False, 4, 4, 24)])
def test_flash_backward_plain_matches_jax_gradient(causal, h, hkv, s):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (2, s, h, 16), (2, s, hkv, 16), (2, s, hkv, 16), (2, s, h, 16)))

    def f(q_, k_, v_):
        return jnp.sum(jblocks.flash_attention(q_, k_, v_, causal=causal,
                                               q_chunk=16, kv_chunk=16)
                       * jnp.asarray(do))

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                      (q, k, v)))
    port = fa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, do)), causal=causal)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(_np(p), np.asarray(r), rtol=0, atol=2e-5)
    # the wrapper on CPU tensors runs the plain version
    wrapped = fa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, do)),
                                     causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, port))


# --- the optimizer and compression -------------------------------------------

OPT_VARIANTS = {
    "adamw": {},
    "factored": {"factored_second_moment": True},
    "bf16_momentum": {"momentum_dtype": "bfloat16"},
    "no_momentum": {"factored_second_moment": True, "use_momentum": False},
    "sgd": {"name": "sgd", "weight_decay": 0.01},
}


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (6, 5), "b": (5,)}, "stack": {"w": (3, 4, 7)},
              "n": {"scale": (1, 9)}}
    return {g: {k: (rng.normal(size=s) * 0.5).astype(np.float32)
                for k, s in leaves.items()} for g, leaves in shapes.items()}


@pytest.mark.parametrize("variant", sorted(OPT_VARIANTS))
def test_apply_updates_matches_reference(variant):
    over = dict(warmup_steps=1, total_steps=4, lr=1e-2, **OPT_VARIANTS[
        variant])
    jcfg, tcfg = jbase.OptimizerConfig(**over), tbase.OptimizerConfig(**over)
    params = _param_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tparams.from_numpy(params)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    for i in range(2):
        grads = _param_tree(10 + i)
        jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, grads),
                                        js, jcfg)
        tp, ts, tm = topt.apply_updates(tp, tparams.from_numpy(grads), ts,
                                        tcfg)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=4e-7)
    assert int(ts.step) == int(js.step) == 2
    _leaves_close(tp, jp, rel=5e-7)
    bf16_ulp = 2 ** -7 if tcfg.momentum_dtype == "bfloat16" else 0.0
    _leaves_close(ts.mu, js.mu, rel=5e-7 + bf16_ulp)
    _leaves_close(ts.nu, js.nu, rel=5e-7)


def test_apply_updates_donates_and_guards_in_place():
    """The step writes into the tensors it was given (the reference donates
    them); a step that is not finite leaves every one as it was."""
    cfg = tbase.OptimizerConfig(warmup_steps=1, total_steps=4)
    tp = tparams.from_numpy(_param_tree(0))
    grads = tparams.from_numpy(_param_tree(1))
    ref_p, ref_s, _ = topt.apply_updates(
        topt.leafwise(torch.clone, tp), grads,
        topt.init_opt_state(tp, cfg), cfg)
    state = topt.init_opt_state(tp, cfg)
    before = topt.leafwise(torch.clone, tp)
    kept, _, _ = topt.apply_updates(tp, grads, state, cfg,
                                    finite=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(topt.leaves(kept),
                                                 topt.leaves(before)))
    assert int(state.step) == 0
    new_p, new_s, _ = topt.apply_updates(tp, grads, state, cfg,
                                         finite=torch.tensor(True))
    assert all(a is b for a, b in zip(topt.leaves(new_p), topt.leaves(tp)))
    assert all(a is b for a, b in zip(topt.leaves(new_s.nu),
                                      topt.leaves(state.nu)))
    assert all(torch.equal(a, b) for a, b in zip(topt.leaves(new_p),
                                                 topt.leaves(ref_p)))
    assert all(torch.equal(a, b) for a, b in zip(topt.leaves(new_s.nu),
                                                 topt.leaves(ref_s.nu)))


def test_compression_matches_reference_bit_for_bit():
    grads, res = _param_tree(3), _param_tree(4)
    res = jax.tree.map(lambda r: r * 1e-3, res)
    jq, js, jr = jcomp.tree_compress(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, res))
    tq, ts, tr = tcomp.tree_compress(tparams.from_numpy(grads),
                                     tparams.from_numpy(res))
    for p, r in zip(topt.leaves(tq), jax.tree.leaves(jq)):
        assert p.dtype == torch.int8
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for p, r in zip(topt.leaves(ts), jax.tree.leaves(js)):
        assert p.numpy().tobytes() == np.asarray(r).tobytes()
    for p, r, s in zip(topt.leaves(tr), jax.tree.leaves(jr),
                       jax.tree.leaves(js)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                   atol=float(s) * 2 ** -23 * 127)
    dec_t = tcomp.tree_decompress(tq, ts)
    dec_j = jcomp.tree_decompress(jq, js)
    _leaves_close(dec_t, dec_j, rel=0.0)
    tp = tparams.from_numpy(grads)
    assert tcomp.compressed_psum_bytes(tp) == jcomp.compressed_psum_bytes(
        jax.tree.map(jnp.asarray, grads))
    assert all(float(r.abs().sum()) == 0.0 and r.dtype == torch.float32
               for r in topt.leaves(tcomp.init_residuals(tp)))


# --- data ----------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq", [(256, 4, 64), (50304, 2, 300)])
def test_token_stream_matches_reference_bit_for_bit(vocab, batch, seq):
    jst = jsyn.TokenStream(vocab, seq, batch, seed=3)
    tst = tsyn.TokenStream(vocab, seq, batch, seed=3, device="cpu")
    for _ in range(3):
        jb, tb = jst.next_batch(), tst.next_batch()
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert tst.state_dict() == jst.state_dict() == {"step": 3, "seed": 3}
    resumed = tsyn.TokenStream(vocab, seq, batch, device="cpu")
    resumed.load_state_dict(tst.state_dict())
    assert torch.equal(resumed.next_batch()["tokens"],
                       tst.next_batch()["tokens"])


def test_xla_exp_is_the_reference_exponential():
    x = np.concatenate([np.linspace(-3.0, 0.0, 100_001),
                        np.random.default_rng(0).uniform(-87, 88, 100_000)]
                       ).astype(np.float32)
    ref = np.asarray(jnp.exp(jnp.asarray(x)))
    assert tsyn.xla_exp(torch.from_numpy(x)).numpy().tobytes() == \
        ref.tobytes()


# --- the train step and the Trainer -------------------------------------------

STEP_OPT = dict(warmup_steps=2, total_steps=6, lr=1e-2)


@pytest.fixture(scope="module")
def stablelm():
    """Reduced stablelm-3b, the reference's weights and its jitted train
    steps at microbatches 1 and 2 (shared: one compile each)."""
    cfg, jcfg = _cfgs("stablelm-3b")
    _, jp = _weights(cfg)
    jocfg = jbase.OptimizerConfig(**STEP_OPT)
    jsteps = {m: jax.jit(jloop.make_train_step(jcfg, jocfg, microbatches=m))
              for m in (1, 2)}
    return cfg, jcfg, jp, jsteps


def _step_batches(vocab, n):
    """``n`` batches of 4 x 32 tokens from the reference's TokenStream."""
    jst = jsyn.TokenStream(vocab, 32, 4, seed=1)
    for _ in range(n):
        jb = jst.next_batch()
        yield jb, {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(stablelm, microbatches):
    cfg, jcfg, jp, jsteps = stablelm
    jocfg = jbase.OptimizerConfig(**STEP_OPT)
    tocfg = tbase.OptimizerConfig(**STEP_OPT)
    jstep = jsteps[microbatches]
    tstep = tloop.make_train_step(cfg, tocfg, microbatches=microbatches)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    js, ts = jopt.init_opt_state(jp, jocfg), topt.init_opt_state(tp, tocfg)
    jparams_ = jp
    for jb, tb in _step_batches(cfg.vocab_size, 3):
        jparams_, js, jm = jstep(jparams_, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-6
        assert int(tm["skipped"]) == int(jm["skipped"]) == 0
    # Adam divides by sqrt(v): where a gradient entry is small its float32
    # ulps move the update by up to ~1e-4 of its size (lr), each step
    _leaves_close(tp, jparams_, rel=0.0, atol=3 * STEP_OPT["lr"] * 1e-4)
    _leaves_close(ts.mu, js.mu, rel=1e-5)


def test_train_step_compresses_with_residuals(stablelm):
    cfg, jcfg, jp, _ = stablelm
    over = dict(STEP_OPT, grad_compression=True)
    jocfg, tocfg = jbase.OptimizerConfig(**over), tbase.OptimizerConfig(**over)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    jb, tb = _batch(cfg.vocab_size, b=2, s=16)
    jout = jax.jit(jloop.make_train_step(jcfg, jocfg))(
        jp, jopt.init_opt_state(jp, jocfg), jb, jcomp.init_residuals(jp))
    tout = tloop.make_train_step(cfg, tocfg)(
        tp, topt.init_opt_state(tp, tocfg), tb, tcomp.init_residuals(tp))
    assert len(tout) == len(jout) == 4
    # an int8 code may flip where g / scale lies within the gradients'
    # float32 ulps of a rounding boundary: that entry's first Adam update
    # (of size lr) moves; at most 0.1% of the entries, each by at most lr
    flips = 0
    for p, r in zip(topt.leaves(tout[0]), jax.tree.leaves(jout[0])):
        diff = np.abs(_np(p) - np.asarray(r))
        assert float(diff.max()) <= STEP_OPT["lr"]
        flips += int((diff > 1e-6 * max(1.0, float(np.abs(r).max()))).sum())
    assert flips <= 1e-3 * sum(p.numel() for p in topt.leaves(tout[0]))
    # the new residuals: the reference's shapes, float32, finite
    for p, r in zip(topt.leaves(tout[3]), jax.tree.leaves(jout[3])):
        assert tuple(p.shape) == np.shape(r) and p.dtype == torch.float32
        assert bool(torch.isfinite(p).all())


def test_nan_guard_keeps_the_state_and_counts_the_skip(stablelm):
    cfg, jcfg, jp, jsteps = stablelm
    jp = dict(jp, final_norm={"scale": jnp.full_like(
        jp["final_norm"]["scale"], jnp.inf)})
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp))
    before = topt.leafwise(torch.clone, tp)
    jb, tb = next(_step_batches(cfg.vocab_size, 1))
    ocfg = tbase.OptimizerConfig(**STEP_OPT)
    state = topt.init_opt_state(tp, ocfg)
    new_p, new_s, m = tloop.make_train_step(cfg, ocfg)(
        tp, state, tb)
    _, _, jm = jsteps[1](
        jp, jopt.init_opt_state(jp, jbase.OptimizerConfig(**STEP_OPT)), jb)
    assert int(m["skipped"]) == int(jm["skipped"]) == 1
    assert not np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(topt.leaves(new_p),
                                                 topt.leaves(before)))
    assert int(new_s.step) == 0
    assert all(float(t.abs().sum()) == 0 for t in topt.leaves(new_s.mu))


class _StoppingStream(tsyn.TokenStream):
    """A TokenStream that asks its trainer to stop once it has served
    ``stop_at`` batches (a SIGTERM at that step boundary)."""
    trainer = None
    stop_at = None

    def next_batch(self):
        batch = super().next_batch()
        if self.step == self.stop_at:
            self.trainer.request_stop()
        return batch


def _trainer(directory, stop_at=None):
    cfg, _ = _cfgs("stablelm-3b")
    run = tbase.RunConfig(arch=cfg, optimizer=tbase.OptimizerConfig(
        **STEP_OPT), checkpoint_dir=str(directory), checkpoint_every=2,
        log_every=1)
    stream = _StoppingStream(cfg.vocab_size, 16, 2, device="cpu")
    trainer = tloop.Trainer(run, stream, device="cpu")
    stream.trainer, stream.stop_at = trainer, stop_at
    return trainer, lambda: tlm.init_params_from_key(prng.PRNGKey(0), cfg)


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    whole, init = _trainer(tmp_path / "whole")
    p, o, start = whole.restore_or_init(init)
    assert start == 0
    p_whole, o_whole, step = whole.fit(p, o, 0, 4)
    assert step == 4 and len(whole.history) == 4

    # stopped after step 3 (not a checkpoint step): the stop checkpoints
    first, init = _trainer(tmp_path / "cut", stop_at=3)
    p, o, _ = first.restore_or_init(init)
    assert first.fit(p, o, 0, 4)[2] == 3
    assert first.ckpt.all_steps() == [2, 3]
    resumed, init = _trainer(tmp_path / "cut")
    p, o, start = resumed.restore_or_init(init)
    assert start == 3 and resumed.stream.step == 3
    p_res, o_res, step = resumed.fit(p, o, start, 4)
    assert step == 4
    for a, b in zip(topt.leaves(p_res), topt.leaves(p_whole)):
        assert torch.equal(a, b)
    assert int(o_res.step) == int(o_whole.step) == 4
    assert resumed.history[-1] == whole.history[-1]


def test_launcher_trains_an_lm_like_the_reference(tmp_path, monkeypatch,
                                                  capsys):
    argv = ["--arch", "stablelm-3b", "--scale", "tiny", "--steps", "3",
            "--batch", "4", "--seq", "32"]
    trainer = tlaunch.main(argv + ["--device", "cpu", "--ckpt-dir",
                                   str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "3 steps in" in out and "final loss" in out
    ref_history = []
    real = jloop.Trainer.fit

    def fit(self, *args, **kwargs):
        result = real(self, *args, **kwargs)
        ref_history.extend(self.history)
        return result

    monkeypatch.setattr(jloop.Trainer, "fit", fit)
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "ref")])
    jlaunch.main()
    assert len(trainer.history) == len(ref_history) == 3
    for port, ref in zip(trainer.history, ref_history):
        assert port.keys() == ref.keys()
        for key in ("loss", "grad_norm", "lr"):
            assert abs(port[key] - ref[key]) <= 1e-5 * max(1, abs(ref[key]))
    # a second run resumes from the last checkpoint and trains no step
    again = tlaunch.main(argv + ["--device", "cpu", "--ckpt-dir",
                                 str(tmp_path / "port")])
    assert "resumed from checkpoint at step 3" in capsys.readouterr().out
    assert again.history == []


# --- the guard -----------------------------------------------------------------

def test_needs_backward_predicate():
    x = torch.ones(3)
    w = torch.ones(3, requires_grad=True)
    assert not cuda_lib.needs_backward(x, [x, x])
    assert cuda_lib.needs_backward(x, w)
    assert cuda_lib.needs_backward(x, [x, w])             # one level down
    with torch.no_grad():
        assert not cuda_lib.needs_backward(x, w)
    # CPU operands run the plain version, which autograd differentiates
    cuda_lib.refuse_detached("flash_attention", (x, w), {})
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach())
    assert out.requires_grad


@pytest.mark.parametrize("arch,kernel", [
    ("recurrentgemma-2b", "rglru_scan_gated"),
    ("deepseek-v2-236b", "MLA"), ("xlstm-350m", "slstm_scan"),
    ("whisper-base", "cross-attention"), ("kimi-k2-1t-a32b", "head dim 112"),
    ("stablelm-3b", None), ("granite-8b", None)])
def test_check_trainable_names_the_kernel_without_a_backward(arch, kernel):
    cfg = tconfigs.get_arch(arch)
    tlm.check_trainable(cfg, "cpu")                # the plain versions train
    if kernel is None:
        tlm.check_trainable(cfg, "cuda")
        tlm.check_trainable(treduced(cfg), "cuda")   # float32 at D 16
        return
    with pytest.raises(NotImplementedError, match="ROADMAP item 16") as exc:
        tlm.check_trainable(cfg, "cuda")
    assert kernel in str(exc.value)
