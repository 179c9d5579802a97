"""Causal decoder-only LM: port of ``repro.models.lm``.

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

The cache: the reference updates it functionally. Here a decode step
writes the new K/V row IN PLACE into the cache it is given (at slot
``pos``, or ``pos % window`` in a local layer's ring; an MLA layer's
latent row at ``pos``), and a recurrent layer's state (RG-LRU, mLSTM,
sLSTM) too, and returns a cache whose leaves are those same tensors, so a
cache must not be reused after a decode step.

Ported: configs whose mixers are ``attn``, ``local_attn``, ``mla``,
``rglru``, ``mlstm`` and ``slstm``, with dense, MoE or no MLPs (the dense
GQA models, recurrentgemma-2b, deepseek-v2, kimi-k2 and xlstm-350m).
Encoder-decoder configs raise ``NotImplementedError``, and so do a
``mesh`` and ``rules``: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, recurrent
from repro_torch.models.params import ParamSpec, init_tree, stack_specs

# the mixers this port runs
MIXERS = ("attn", "local_attn", "mla", "rglru", "mlstm", "slstm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config this slice does not run."""
    mixers = sorted({mx for mx, _ in cfg.layer_kinds()} - set(MIXERS))
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: mixers {mixers} are not ported")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet")


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
    if mixer in ("attn", "local_attn"):
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


def _layer_spec(cfg: ArchConfig, mixer: str, mlp: str) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": blocks.rmsnorm_spec(d),
                            "mixer": _mixer_spec(cfg, mixer)}
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
        unit = {f"l{j}": _layer_spec(cfg, mx, mlp)
                for j, (mx, mlp) in enumerate(seg.kinds)}
        spec["decoder"][seg.name] = (stack_specs(unit, seg.repeats)
                                     if seg.repeats > 1 else unit)
    return spec


def init_params(seed: int, cfg: ArchConfig, device=None) -> Dict:
    """Seeded random weights in ``cfg.param_dtype``, drawn on ``device``
    (one leaf, and one layer of a stacked leaf, at a time), so a
    billions-parameter model never passes through host memory."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(gen, model_spec(cfg), device=dev, dtype=cfg.pdtype)


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
        unit = {f"l{j}": {"mixer": _mixer_cache_spec(cfg, mx, batch,
                                                     max_len)}
                for j, (mx, _) in enumerate(seg.kinds)}
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
                 cache: Optional[Dict]
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = blocks.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    mc = cache["mixer"] if cache else None
    if mixer in ("attn", "local_attn"):
        out, nm = blocks.attn_apply(
            lp["mixer"], h, positions, cfg, causal=True,
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
    x = x + out
    if "mlp" in lp:
        h2 = blocks.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if mlp == "moe":
            x = x + blocks.moe_apply(lp["mlp"], h2, cfg)
        else:
            x = x + blocks.mlp_apply(lp["mlp"], h2, cfg)
    return x, ({"mixer": nm} if nm is not None else None)


def _apply_unit(up: Dict, x, positions, cfg, seg: Segment, *, mode, cache):
    """Apply one period (len(seg.kinds) layers)."""
    new_cache = {}
    for j, (mx, mlp) in enumerate(seg.kinds):
        lc = cache.get(f"l{j}") if cache else None
        x, nc = _apply_layer(up[f"l{j}"], x, positions, cfg, mx, mlp,
                             mode=mode, cache=lc)
        if nc is not None:
            new_cache[f"l{j}"] = nc
    return x, (new_cache if new_cache else None)


def _layer_view(tree, j: int):
    """Layer j of a stacked tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, j) for k, v in tree.items()}
    return tree[j]


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


def _run_decoder(params, x, positions, cfg: ArchConfig, *, mode, cache):
    new_cache: Dict[str, Any] = {}
    for seg in segment_plan(cfg):
        sp = params["decoder"][seg.name]
        sc = cache["decoder"].get(seg.name) if cache else None
        if seg.repeats == 1:
            x, nc = _apply_unit(sp, x, positions, cfg, seg, mode=mode,
                                cache=sc)
        else:
            ncs = []
            for j in range(seg.repeats):
                x, nc_j = _apply_unit(
                    _layer_view(sp, j), x, positions, cfg, seg, mode=mode,
                    cache=_layer_view(sc, j) if sc is not None else None)
                ncs.append(nc_j)
            nc = None if mode == "train" else _stack(ncs, sc)
        if nc is not None:
            new_cache[seg.name] = nc
    return x, new_cache


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
            mesh=None, rules=None, *, mode: str = "train",
            cache: Optional[Dict] = None,
            encoder_embeddings: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens: (B, S) integer ids. Returns (logits, new_cache | None)."""
    check_supported(cfg)
    if mesh is not None or rules is not None:
        raise NotImplementedError("one card has no mesh: sharding comes "
                                  "with the multi-card slice")
    if encoder_embeddings is not None:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet")
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

    x, new_cache = _run_decoder(params, x, positions, cfg, mode=mode,
                                cache=cache)
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
