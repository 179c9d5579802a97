"""Causal LM / encoder-decoder model: port of ``repro.models.lm``.

The per-layer kinds come from ``ArchConfig.layer_kinds()`` and the layers
are grouped by ``segment_plan`` as in the reference, so the parameter and
cache trees are the reference's (a run of identical layers is one
``body`` segment whose leaves carry a leading layer-stack axis); a tree made
by ``repro.models.lm.init_params`` crosses over with
``params.from_numpy``. Where the reference scans over the stacked layers,
the port loops in Python over per-layer views of the stacked tensors (no
copies).

Modes: "train" (logits), "prefill" (logits + cache), "decode" (one token).
Prefill attention runs through the flash-attention kernel on the card, a
``local_attn`` layer's with the config's sliding window, an ``mla`` layer's
at its (qk, v) widths (192, 128), an ``rglru`` layer's recurrence through
the RG-LRU scan kernel, and an ``slstm`` layer's through the sLSTM kernel
(in decode too); an ``mlstm`` layer's chunkwise form is plain PyTorch ops,
as the reference's is plain einsums. A ``moe`` layer's MLP is the
reference's single-shard mixture of experts (``blocks.moe_apply``); the
leading dense layers of an MoE config take ``dense_d_ff``; an xLSTM layer
(MLP kind ``none``) has no MLP.

An encoder-decoder config (whisper-base) adds the reference's encoder: a
stack of ``encoder_layers`` non-causal attention layers (``enc_attn``,
RoPE at the frame positions) with dense MLPs over the given frame
embeddings (the audio frontend is a stub in both packages: the caller
passes ``encoder_embeddings`` of shape (B, encoder_seq, d_model), not
scaled by sqrt(d)), then the final rmsnorm; each decoder layer has a
cross-attention block (``ln_x``, ``cross``) after its mixer, over K/V
projected from the encoder's output in train and prefill and read from
the cache's ``enc_k`` / ``enc_v`` in decode. The prefill's attention,
the encoder's and the cross block's included, runs through the flash
kernel on the card (the cross block's at Sq != Sk); decode's cross block
attends in plain ops, as the reference's does.

The cache: the reference updates it functionally. Here a decode step
writes the new K/V row IN PLACE into the cache it is given (at slot
``pos``, or ``pos % window`` in a local layer's ring; an MLA layer's
latent row at ``pos``), and a recurrent layer's state (RG-LRU, mLSTM,
sLSTM) too, and returns a cache whose leaves are those same tensors (the
encoder's ``enc_k`` / ``enc_v`` unchanged), so a cache must not be reused
after a decode step.

Training: ``lm_loss`` is the reference's next-token cross-entropy (float32
log-softmax, mean NLL, and its exp as ``ppl``). A train forward under
autograd recomputes each layer of a stacked ``body`` segment in the
backward (``torch.utils.checkpoint``, non-reentrant, one layer a segment)
where ``cfg.remat`` is not ``"none"``, as the reference's
``jax.checkpoint`` of its scan body: the reference's memory policy, which
stablelm-3b at full depth needs to fit one card; the numbers do not
change. On the card an attention layer's gradient runs through the flash
backward kernel; ``check_trainable`` names the layers of a config whose
train forward would reach a kernel without one (windowed, MLA or cross
attention, the RG-LRU and sLSTM scans) and raises before a first step. On
the CPU every config trains through the plain versions.

Ported: configs whose mixers are ``attn``, ``local_attn``, ``mla``,
``rglru``, ``mlstm`` and ``slstm``, with dense, MoE or no MLPs, with or
without an encoder (the dense GQA models, recurrentgemma-2b, deepseek-v2,
kimi-k2, xlstm-350m and whisper-base). A ``mesh`` and ``rules`` raise
``NotImplementedError``: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import blocks, recurrent
from repro_torch.models.params import (ParamSpec, init_tree,
                                       init_tree_from_key, stack_specs)

# the mixers this port runs
MIXERS = ("attn", "local_attn", "mla", "rglru", "mlstm", "slstm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config this slice does not run."""
    mixers = sorted({mx for mx, _ in cfg.layer_kinds()} - set(MIXERS))
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: mixers {mixers} are not ported")


# a mixer whose train forward on the card reaches a kernel without a
# backward, and that kernel
_NO_BACKWARD = {"local_attn": "flash_attention with a sliding window",
                "mla": "flash_attention at MLA's (192, 128) widths",
                "rglru": "rglru_scan_gated",
                "slstm": "slstm_scan"}


def check_trainable(cfg: ArchConfig, device) -> None:
    """Raise NotImplementedError where a train step of ``cfg`` on
    ``device`` would reach a kernel that has no backward (on the card: a
    windowed, MLA or cross attention layer, an RG-LRU or sLSTM layer, an
    attention head dim the flash backward is not built for), naming the
    kernel. On the CPU every config trains through the plain versions."""
    check_supported(cfg)
    if torch.device(device).type != "cuda":
        return
    why = sorted({f"{mx} ({_NO_BACKWARD[mx]})" for mx, _ in cfg.layer_kinds()
                  if mx in _NO_BACKWARD})
    if cfg.is_encdec:
        why.append("the cross-attention (flash_attention at Sq != Sk)")
    if not why and any(mx == "attn" for mx, _ in cfg.layer_kinds()):
        try:
            fa.check_backward(cfg.dtype, cfg.resolved_head_dim)
        except NotImplementedError as exc:
            why.append(str(exc))
    if why:
        raise NotImplementedError(
            f"{cfg.name} does not train on the card: its train forward "
            f"reaches kernels without a backward: {'; '.join(why)}; they "
            f"are ROADMAP item 16 (on the CPU it trains through the plain "
            f"versions)")


# ----------------------------------------------------------------------------
# segmentation: group layers into unrolled prefix + stacked periodic body
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kinds: Tuple[Tuple[str, str], ...]   # (mixer, mlp) per layer in the unit
    repeats: int                          # >1 => stacked params
    layer_ids: Tuple[int, ...]            # absolute layer indices covered


def segment_plan(cfg: ArchConfig) -> Tuple[Segment, ...]:
    kinds = cfg.layer_kinds()
    segs: List[Segment] = []
    i = cfg.first_dense_layers
    for j in range(cfg.first_dense_layers):
        segs.append(Segment(f"prefix{j}", (kinds[j],), 1, (j,)))
    period = len(cfg.block_pattern)
    rest = cfg.num_layers - i
    reps = rest // period
    if reps > 0:
        unit = kinds[i:i + period]
        ids = tuple(range(i, i + reps * period))
        segs.append(Segment("body", unit, reps, ids))
        i += reps * period
    for j in range(i, cfg.num_layers):
        segs.append(Segment(f"tail{j}", (kinds[j],), 1, (j,)))
    return tuple(segs)


# ----------------------------------------------------------------------------
# specs, init, cache
# ----------------------------------------------------------------------------

def _mixer_spec(cfg: ArchConfig, mixer: str) -> Dict[str, Any]:
    if mixer in ("attn", "local_attn", "enc_attn"):
        return blocks.attn_spec(cfg)
    if mixer == "mla":
        return blocks.mla_spec(cfg)
    if mixer == "rglru":
        return recurrent.rglru_spec(cfg)
    if mixer == "mlstm":
        return recurrent.mlstm_spec(cfg)
    if mixer == "slstm":
        return recurrent.slstm_spec(cfg)
    raise ValueError(mixer)


def _layer_spec(cfg: ArchConfig, mixer: str, mlp: str,
                cross: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": blocks.rmsnorm_spec(d),
                            "mixer": _mixer_spec(cfg, mixer)}
    if cross:   # an encoder-decoder's decoder layer: the cross block
        spec["ln_x"] = blocks.rmsnorm_spec(d)
        spec["cross"] = blocks.attn_spec(cfg)
    if mlp == "dense":
        spec["ln2"] = blocks.rmsnorm_spec(d)
        # an MoE config's leading dense layers are dense_d_ff wide
        ff = (cfg.dense_d_ff or cfg.d_ff) if cfg.num_experts > 0 else cfg.d_ff
        spec["mlp"] = blocks.mlp_spec(cfg, d_ff=ff)
    elif mlp == "moe":
        spec["ln2"] = blocks.rmsnorm_spec(d)
        spec["mlp"] = blocks.moe_spec(cfg)
    return spec


def model_spec(cfg: ArchConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    spec: Dict[str, Any] = {
        "embed": {"w": ParamSpec((v, d), scale=1.0)},
        "final_norm": blocks.rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ParamSpec((d, v))}
    spec["decoder"] = {}
    for seg in segment_plan(cfg):
        unit = {f"l{j}": _layer_spec(cfg, mx, mlp, cfg.is_encdec)
                for j, (mx, mlp) in enumerate(seg.kinds)}
        spec["decoder"][seg.name] = (stack_specs(unit, seg.repeats)
                                     if seg.repeats > 1 else unit)
    if cfg.is_encdec:   # stacked over the encoder's layers, even one
        spec["encoder"] = {
            "body": stack_specs({"l0": _layer_spec(cfg, "enc_attn",
                                                   "dense")},
                                cfg.encoder_layers),
            "norm": blocks.rmsnorm_spec(d)}
    return spec


def init_params(seed: int, cfg: ArchConfig, device=None) -> Dict:
    """Seeded random weights in ``cfg.param_dtype``, drawn on ``device``
    (one leaf, and one layer of a stacked leaf, at a time), so a
    billions-parameter model never passes through host memory."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(gen, model_spec(cfg), device=dev, dtype=cfg.pdtype)


def init_params_from_key(key, cfg: ArchConfig, device=None) -> Dict:
    """The reference's ``init_params(key, cfg)`` draw: one key a leaf from
    ``prng.split(key, n)`` in the reference's leaf order, each leaf
    ``prng.normal`` (within 3 float32 ulps of ``jax.random.normal``) times
    its init scale, in ``cfg.param_dtype`` on ``device`` (the launchers'
    weights, so that their runs can be held against the reference's)."""
    return init_tree_from_key(key, model_spec(cfg), device=device,
                              dtype=cfg.pdtype)


def _mixer_cache_spec(cfg: ArchConfig, mixer: str, batch: int,
                      max_len: int) -> Dict[str, Any]:
    if mixer == "attn":
        return blocks.attn_cache_spec(cfg, batch, max_len)
    if mixer == "local_attn":   # a ring of min(window, max_len) slots
        return blocks.attn_cache_spec(cfg, batch, max_len, window=cfg.window)
    if mixer == "mla":          # the latent: c_kv and the shared rope key
        return blocks.mla_cache_spec(cfg, batch, max_len)
    if mixer == "rglru":
        return recurrent.rglru_cache_spec(cfg, batch)
    if mixer == "mlstm":
        return recurrent.mlstm_cache_spec(cfg, batch)
    if mixer == "slstm":
        return recurrent.slstm_cache_spec(cfg, batch)
    raise ValueError(mixer)


def cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    check_supported(cfg)
    spec: Dict[str, Any] = {"decoder": {}}
    for seg in segment_plan(cfg):
        unit = {}
        for j, (mx, _) in enumerate(seg.kinds):
            c = {"mixer": _mixer_cache_spec(cfg, mx, batch, max_len)}
            if cfg.is_encdec:   # the cross block's K/V of the encoder
                c["enc_k"] = c["enc_v"] = ParamSpec(
                    (batch, cfg.encoder_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim), init="zeros")
            unit[f"l{j}"] = c
        spec["decoder"][seg.name] = (stack_specs(unit, seg.repeats)
                                     if seg.repeats > 1 else unit)
    spec["pos"] = ParamSpec((), init="zeros", dtype="int32")
    return spec


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """A zero cache in ``cfg.dtype`` (positions int32)."""
    return init_tree(torch.Generator(), cache_spec(cfg, batch, max_len),
                     device=device, dtype=cfg.dtype)


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------

def _apply_layer(lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, mixer: str, mlp: str, *, mode: str,
                 cache: Optional[Dict], enc_out: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    new_cache: Dict[str, Any] = {}
    h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    mc = cache["mixer"] if cache else None
    if mixer in ("attn", "local_attn", "enc_attn"):
        out, nm = blocks.attn_apply(
            lp["mixer"], h, positions, cfg, causal=mixer != "enc_attn",
            window=cfg.window if mixer == "local_attn" else 0, mode=mode,
            cache=mc)
    elif mixer == "mla":
        out, nm = blocks.mla_apply(lp["mixer"], h, positions, cfg, mode=mode,
                                   cache=mc)
    elif mixer == "rglru":
        out, nm = recurrent.rglru_apply(lp["mixer"], h, cfg, mode=mode,
                                        cache=mc)
    elif mixer == "mlstm":
        out, nm = recurrent.mlstm_apply(lp["mixer"], h, cfg, mode=mode,
                                        cache=mc)
    elif mixer == "slstm":
        out, nm = recurrent.slstm_apply(lp["mixer"], h, cfg, mode=mode,
                                        cache=mc)
    else:
        raise ValueError(mixer)
    if nm is not None:
        new_cache["mixer"] = nm
    x = x + out
    # the cross block: over K/V projected from the encoder's output (train,
    # prefill) or the cache's (decode); without either (a train forward with
    # no embeddings) the reference skips it
    if "cross" in lp and (enc_out is not None or
                          (cache and "enc_k" in cache)):
        hx = blocks.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
        if enc_out is not None:
            ek = blocks._project(enc_out, lp["cross"]["wk"])
            ev = blocks._project(enc_out, lp["cross"]["wv"])
        else:
            ek, ev = cache["enc_k"], cache["enc_v"]
        cout, _ = blocks.attn_apply(
            lp["cross"], hx, positions, cfg, causal=False,
            mode="decode" if mode == "decode" else "train",
            kv_override=(ek, ev))
        x = x + cout
        if mode in ("prefill", "decode"):
            new_cache["enc_k"], new_cache["enc_v"] = ek, ev
    if "mlp" in lp:
        h2 = blocks.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if mlp == "moe":
            x = x + blocks.moe_apply(lp["mlp"], h2, cfg)
        else:
            x = x + blocks.mlp_apply(lp["mlp"], h2, cfg)
    return x, (new_cache if new_cache else None)


def _apply_unit(up: Dict, x, positions, cfg, seg: Segment, *, mode, cache,
                enc_out=None):
    """Apply one period (len(seg.kinds) layers)."""
    new_cache = {}
    for j, (mx, mlp) in enumerate(seg.kinds):
        lc = cache.get(f"l{j}") if cache else None
        x, nc = _apply_layer(up[f"l{j}"], x, positions, cfg, mx, mlp,
                             mode=mode, cache=lc, enc_out=enc_out)
        if nc is not None:
            new_cache[f"l{j}"] = nc
    return x, (new_cache if new_cache else None)


def _layer_view(tree, j: int):
    """Layer j of a stacked tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, j) for k, v in tree.items()}
    return tree[j]


def _layers_of(tree, n: int) -> List:
    """The n per-layer trees of a stacked tree, as views: one
    ``torch.unbind`` a leaf, whose backward stacks the layers' gradients
    once (indexing layer by layer would add a whole stacked leaf's
    gradient for every layer)."""
    if isinstance(tree, dict):
        per = {k: _layers_of(v, n) for k, v in tree.items()}
        return [{k: per[k][j] for k in per} for j in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(leaves: List, stacked=None):
    """Stack per-layer cache trees. A leaf that is already layer j of
    ``stacked`` (a decode cache written in place) is not copied."""
    if isinstance(leaves[0], dict):
        return {k: _stack([x[k] for x in leaves],
                          stacked[k] if stacked is not None else None)
                for k in leaves[0]}
    if stacked is not None and all(
            x.data_ptr() == stacked[j].data_ptr() for j, x in enumerate(leaves)):
        return stacked
    return torch.stack(leaves)


def _run_decoder(params, x, positions, cfg: ArchConfig, *, mode, cache,
                 enc_out=None):
    new_cache: Dict[str, Any] = {}
    for seg in segment_plan(cfg):
        sp = params["decoder"][seg.name]
        sc = cache["decoder"].get(seg.name) if cache else None
        if seg.repeats == 1:
            x, nc = _apply_unit(sp, x, positions, cfg, seg, mode=mode,
                                cache=sc, enc_out=enc_out)
        elif _remat(cfg, mode):
            # recompute each layer in the backward, as the reference's
            # jax.checkpoint of its scan body; a train unit returns no cache
            def unit(up, x_):
                return _apply_unit(up, x_, positions, cfg, seg, mode=mode,
                                   cache=None, enc_out=enc_out)[0]

            for up in _layers_of(sp, seg.repeats):
                x = checkpoint(unit, up, x, use_reentrant=False)
            nc = None
        else:
            ncs = []
            for j, up in enumerate(_layers_of(sp, seg.repeats)):
                x, nc_j = _apply_unit(
                    up, x, positions, cfg, seg, mode=mode,
                    cache=_layer_view(sc, j) if sc is not None else None,
                    enc_out=enc_out)
                ncs.append(nc_j)
            nc = None if mode == "train" else _stack(ncs, sc)
        if nc is not None:
            new_cache[seg.name] = nc
    return x, new_cache


def _remat(cfg: ArchConfig, mode: str) -> bool:
    """Whether a stacked segment's layers recompute in the backward: a
    train forward that autograd records, under a remat policy."""
    return (cfg.remat != "none" and mode == "train"
            and torch.is_grad_enabled())


def _run_encoder(params, emb: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The encoder over frame embeddings (B, S_enc, d) in the compute
    dtype: ``encoder_layers`` non-causal attention layers (RoPE at
    positions 0 .. S_enc - 1) with dense MLPs, each a view of the stacked
    ``encoder.body``, then the final rmsnorm. The input is not scaled."""
    positions = torch.arange(emb.shape[1], device=emb.device)[None, :]
    seg = Segment("enc", (("enc_attn", "dense"),), cfg.encoder_layers,
                  tuple(range(cfg.encoder_layers)))
    x = emb
    for up in _layers_of(params["encoder"]["body"], cfg.encoder_layers):
        x, _ = _apply_unit(up, x, positions, cfg, seg, mode="train",
                           cache=None)
    return blocks.rmsnorm(params["encoder"]["norm"], x, cfg.norm_eps)


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
            mesh=None, rules=None, *, mode: str = "train",
            cache: Optional[Dict] = None,
            encoder_embeddings: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens: (B, S) integer ids; ``encoder_embeddings`` (B, S_enc, d) of
    an encoder-decoder config (ignored by a decoder-only one, as the
    reference ignores them), run through the encoder in the compute dtype
    for the decoder's cross blocks. Returns (logits, new_cache | None)."""
    check_supported(cfg)
    if mesh is not None or rules is not None:
        raise NotImplementedError("one card has no mesh: sharding comes "
                                  "with the multi-card slice")
    emb = params["embed"]["w"]
    ids = torch.clamp(tokens.to(torch.long), 0, emb.shape[0] - 1)
    x = emb[ids].to(cfg.dtype)
    x = x * (cfg.d_model ** 0.5)

    if positions is None:
        if mode == "decode":
            positions = cache["pos"].expand(tokens.shape[0], 1)
        else:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]

    enc_out = None
    if cfg.is_encdec and encoder_embeddings is not None:
        enc_out = _run_encoder(params, encoder_embeddings.to(cfg.dtype), cfg)

    x, new_cache = _run_decoder(params, x, positions, cfg, mode=mode,
                                cache=cache, enc_out=enc_out)
    x = blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ emb.to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    if mode in ("prefill", "decode"):
        prev = cache["pos"] if (cache is not None and "pos" in cache) \
            else torch.tensor(0, dtype=torch.int32, device=tokens.device)
        return logits, {"decoder": new_cache, "pos": prev + tokens.shape[1]}
    return logits, None


def lm_loss(params: Dict, batch: Dict, cfg: ArchConfig, mesh=None,
            rules=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy. batch: {tokens, labels[,
    encoder_embeddings]}. Returns (loss, {"loss", "ppl"}), 0-d float32."""
    logits, _ = forward(params, batch["tokens"], cfg, mesh, rules,
                        mode="train",
                        encoder_embeddings=batch.get("encoder_embeddings"))
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].to(torch.long)[..., None])
    loss = torch.mean(nll)
    return loss, {"loss": loss, "ppl": torch.exp(loss)}
