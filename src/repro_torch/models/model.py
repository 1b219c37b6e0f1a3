"""Top-level model API: ``init_params``, ``forward`` (cache-less, paged or
contiguous), the whisper ``encode``, and ``prefill`` / ``decode_step`` on
the contiguous cache (counterpart of ``repro.models.model``).

Parameters are nested dicts in the JAX layout: block leaves are stacked
over layer groups (``[G, ...]`` tensors, or per-group lists of
:class:`~repro_torch.core.qtensor.QTensor` after ``quantize_for_serving``;
MoE experts ``[G, E, ...]`` or ``[G][E]`` lists), and the forward pass
loops over groups where JAX scans. The encoder-decoder (whisper) adds
``encoder`` (its layers, ``pos_emb``, ``final_norm``) and ``xattn`` (one
cross-attention per decoder layer); the VLM takes a prefix of vision
embeddings before the text.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as torch_ckpt
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import kvcache as KV
from repro_torch.models.attention import (attend, attn_block,
                                          cross_attn_block, head_input,
                                          head_proj, out_proj,
                                          precompute_cross_kv)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy_loss, embed_tokens,
                                       glu_mlp, linear, rms_norm, softcap,
                                       tp_input)

MOE_AUX_WEIGHT = 0.01
TAP_ROWS = 512          # calibration rows a tap keeps per call


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX package's layout and scales (not its values: the two
    frameworks draw different numbers from one seed). ``device="meta"``
    gives the tree's shapes and dtypes without storage (the training
    mesh's specs)."""
    if str(device) == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": {"tok": B._normal(gen, (cfg.vocab, d), 0.02, dev, dtype)},
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B._normal(gen, (d, cfg.vocab), d ** -0.5, dev,
                                      dtype)
    params["blocks"] = {
        f"b{i}": B.init_block(gen, kind, cfg.moe_slots[i], cfg,
                              cfg.n_groups, dev, dtype)
        for i, kind in enumerate(cfg.pattern)}
    if cfg.is_encdec:
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
        params["encoder"] = {
            "blocks": {"norm1": torch.zeros((n_enc, d), device=dev),
                       "attn": B.init_attn_params(gen, cfg, n_enc, dev,
                                                  dtype),
                       "norm2": torch.zeros((n_enc, d), device=dev),
                       "ffn": B.init_mlp_params(gen, cfg, n_enc, dev,
                                                dtype)},
            "pos_emb": B._normal(gen, (cfg.enc_seq, d), 0.02, dev, dtype),
            "final_norm": torch.zeros((d,), device=dev)}
        params["xattn"] = {
            "norm_x": torch.zeros((n_dec, d), device=dev),
            "xattn": B.init_attn_params(gen, cfg, n_dec, dev, dtype)}
    return params


def group_slice(tree, g: int):
    """Group ``g``'s view of a group-stacked tree ([G, ...] tensors and
    per-group lists alike)."""
    if isinstance(tree, dict):
        return {k: group_slice(v, g) for k, v in tree.items()}
    return tree[g]


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           use_kernels: bool = True, *, remat: bool = False,
           gather=None) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings ``[B, T,
    d]``: ``pos_emb``, then non-causal layers (no rotary, no q/k/v bias,
    as the reference's), then the final norm. On a training mesh each
    layer's leaves come through ``gather`` (``encoder/blocks``), its
    attention runs the rank's heads (or all of them, where they do not
    divide ``model``) and its FFN the rank's hidden units, and ``remat``
    recomputes each layer in the backward pass, as the decoder's
    groups."""
    gather = gather if gather is not None else _whole
    enc = params["encoder"]
    x = frames + enc["pos_emb"][None, :frames.shape[1]].to(frames.dtype)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    hd = cfg.head_dim

    def layer(lp, x):
        lp = gather(lp, "encoder/blocks")
        h = head_input(rms_norm(x, lp["norm1"], cfg.norm_eps), cfg)
        q, k, v = (head_proj(h, lp["attn"][w], None, cfg, use_kernels, n
                             ).reshape(b, t, -1, hd)
                   for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                ("wv", cfg.n_kv_heads)))
        o = attend(q, k, v, q_positions=positions, kv_positions=positions,
                   causal=False, window=None)
        x = x + out_proj({"wo": lp["attn"]["wo"]}, o, None, use_kernels,
                          cfg)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + glu_mlp(h2, lp["ffn"], cfg.act, cfg.gated_mlp,
                           use_kernels=use_kernels, d_ff=cfg.d_ff)
    if remat:
        layer = functools.partial(torch_ckpt.checkpoint, layer,
                                  use_reentrant=False,
                                  **_remat_kw(cfg.remat_policy))
    for i in range(cfg.n_enc_layers):
        x = layer(group_slice(enc["blocks"], i), x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _decoder_layer(cfg, bp, xp, x, cache, enc_out, positions, pos,
                   use_kernels, gather):
    """One encoder-decoder decoder layer: self-attention, cross-attention
    after ``norm_x`` (its K/V from ``enc_out``, or the cache's
    ``cross``), then the FFN; its leaves through ``gather`` (``blocks/b0``
    and ``xattn``). Returns ``(x, the cross K/V)``."""
    bp, xp = gather(bp, "blocks/b0"), gather(xp, "xattn")
    kv = (precompute_cross_kv(xp["xattn"], enc_out, cfg, use_kernels)
          if enc_out is not None else cache["cross"])
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    x = x + attn_block(bp["attn"], h, cfg, positions=positions, window=None,
                       cache=cache["self"] if cache is not None else None,
                       pos=pos, use_kernels=use_kernels)
    hx = rms_norm(x, xp["norm_x"], cfg.norm_eps)
    x = x + cross_attn_block(xp["xattn"], hx, kv, cfg,
                             use_kernels=use_kernels)
    h2 = rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + glu_mlp(h2, bp["ffn"], cfg.act, cfg.gated_mlp,
                       use_kernels=use_kernels, d_ff=cfg.d_ff), kv


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, pos=None,
            valid_len: Optional[torch.Tensor] = None,
            vis_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            use_kernels: bool = True,
            paged_attention: bool = False,
            taps: Optional[dict] = None,
            remat: bool = False) -> torch.Tensor:
    """Logits ``[B, S, V]``. A MoE block's load-balancing loss is dropped,
    as serving drops it (``moe.moe_block`` returns it; ``train_loss``
    sums it).

    Without ``cache`` every sequence attends over its own tokens, at
    ``positions`` (default ``arange(S)`` in every row) — the forward the
    PTQ path evaluates with. With the paged arena it is one paged step:
    K/V of ``tokens`` are written into the arena in place, and
    ``valid_len [B]`` bounds each lane's KV (writes at or past it land on
    the null page); mamba and hybrid blocks update their lanes' SSM and
    conv rows in place, a lane with no valid token leaving them as they
    were. With a contiguous cache (``KV.init_cache``, or the
    ``{"b0": init_encdec_cache(...)}`` of an encoder-decoder) a
    multi-token call writes from position 0 and a one-token call at
    ``pos`` (a scalar; ``positions`` default to it), in place.

    ``vis_embeds [B, n_vis, d]`` (a VLM) go before the text embeddings and
    their rows are cut from the logits. An encoder-decoder runs
    ``encode(frames)`` (or takes ``enc_out``) and each decoder layer's
    cross K/V from it, stored into the cache's ``cross`` when one is
    given; without either, the cache's ``cross`` is read.
    ``use_kernels=False`` runs the plain version of every kernel (the
    counterpart of JAX's ``use_pallas=False``); ``paged_attention``
    selects the ragged paged-attention route over the full-width
    gather.

    Under a mesh (``runtime_context.use_mesh``, the mesh step set) the
    projections are tensor-parallel (``layers.column_linear`` /
    ``row_linear``), MoE layers expert-parallel (``models.moe``), the
    Mamba2 mixer replicated after its gathered ``in_proj``
    (``models.ssm``), an attention block whose heads do not divide the
    model axis whole on every rank, and a vocab-sharded head gives this
    rank's slice of the vocab's logits (a whole head, all of them, its
    input outside ``tp_input``). An encoder-decoder's encoder and
    cross-attention run the same way, their leaves through ``gather``.

    ``remat`` recomputes each layer group's activations in the backward
    pass (``torch.utils.checkpoint``, non-reentrant; an encoder-decoder's
    encoder and decoder layers each), as the reference's
    ``jax.checkpoint`` per group: all of them for ``cfg.remat_policy ==
    "full"``, all but the matmul outputs for ``"dots"`` (JAX's
    ``dots_with_no_batch_dims_saveable``: ``aten.mm`` outputs are saved,
    the attention's batched products are not). Cache-less only.

    ``taps`` (a dict, filled in place) collects calibration inputs for
    GPTQ and AWQ: the input rows of every tapped matmul of group ``g``
    under ``blocks/{g}/b{i}/<mixer>/<weight>``, at most ``TAP_ROWS`` rows
    a call, detached, on the forward's device. As in the reference, an
    encoder-decoder's layers are not tapped."""
    return _forward(cfg, params, tokens, positions=positions, cache=cache,
                    pos=pos, valid_len=valid_len, vis_embeds=vis_embeds,
                    frames=frames, enc_out=enc_out, use_kernels=use_kernels,
                    paged_attention=paged_attention, taps=taps, remat=remat)


def _make_tap(taps: Optional[dict], g: int):
    """The tap of group ``g``: keys ``blocks/{g}/<name>``, rows subsampled
    to ``TAP_ROWS`` with a stride, later calls concatenated
    (``repro.models.model._make_tap``)."""
    if taps is None:
        return None

    def inner(name, value):
        key = f"blocks/{g}/{name}"
        v = value.detach().reshape(-1, value.shape[-1])
        if v.shape[0] > TAP_ROWS:
            v = v[::v.shape[0] // TAP_ROWS][:TAP_ROWS]
        v = v.clone()
        prev = taps.get(key)
        taps[key] = v if prev is None else torch.cat([prev, v])
    return inner


def _forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
             positions=None, cache=None, pos=None, valid_len=None,
             vis_embeds=None, frames=None, enc_out=None,
             use_kernels: bool = True, paged_attention: bool = False,
             taps: Optional[dict] = None, aux: Optional[list] = None,
             skip_head: bool = False, remat: bool = False,
             gather=None) -> torch.Tensor:
    """``forward``; with ``aux`` (a list) every MoE block's load-balancing
    loss is appended to it, and with ``skip_head`` the final-normed hidden
    states ``[B, S, d]`` come back in place of the logits (the training
    loss reads both). ``gather(tree, prefix)`` (the training mesh's
    ``launch.sharding.fsdp_gather``) makes the leaves under ``prefix``
    whole along their FSDP dim just before each use: the embedding, each
    group's blocks inside the group (so a rematerialised group gathers
    again in the backward pass), the head."""
    if remat and (cache is not None or taps is not None):
        raise ValueError("remat recomputes a cache-less forward only")
    if gather is None:
        gather = _whole
    b = tokens.shape[0]
    x = embed_tokens(tokens, gather(params["embed"]["tok"], "embed/tok"),
                     cfg.scale_embed, vocab=cfg.vocab)
    n_vis = 0
    if cfg.n_vis_tokens and vis_embeds is not None:
        n_vis = vis_embeds.shape[1]
        x = torch.cat([vis_embeds.to(x.dtype), x], dim=1)
    total = x.shape[1]
    if positions is None:
        if pos is not None:                           # decode step
            p = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
            positions = (p.expand(b, total) if p.ndim == 0
                         else p[:, None])
        else:
            positions = torch.arange(total, device=x.device)[None, :
                                                             ].expand(
                b, total)

    if cfg.is_encdec:
        if enc_out is None and frames is not None:
            enc_out = encode(cfg, params, frames, use_kernels, remat=remat,
                             gather=gather)
        dec_cache = cache["b0"] if cache is not None else None
        layer = functools.partial(
            _decoder_layer, cfg, positions=positions, pos=pos,
            use_kernels=use_kernels, gather=gather)
        if remat:
            layer = functools.partial(torch_ckpt.checkpoint, layer,
                                      use_reentrant=False,
                                      **_remat_kw(cfg.remat_policy))
        cross = []
        for g in range(cfg.n_groups):
            lc = (group_slice(dec_cache, g) if dec_cache is not None
                  else None)
            x, kv = layer(group_slice(params["blocks"]["b0"], g),
                          group_slice(params["xattn"], g), x, lc, enc_out)
            cross.append(kv)
        if dec_cache is not None and enc_out is not None:
            # the cross K/V stay in the dtype they were computed in, as in
            # the reference's returned cache
            dec_cache["cross"] = {
                n: torch.stack([kv[n] for kv in cross])
                for n in ("xk", "xv")}
    else:
        run = functools.partial(
            _apply_group, cfg, positions=positions, pos=pos,
            valid_len=valid_len, use_kernels=use_kernels,
            paged_attention=paged_attention, gather=gather)
        if remat:
            run = functools.partial(torch_ckpt.checkpoint, run,
                                    use_reentrant=False,
                                    **_remat_kw(cfg.remat_policy))
        keys = [f"b{i}" for i in range(len(cfg.pattern))]
        for g in range(cfg.n_groups):
            gp = {k: group_slice(params["blocks"][k], g) for k in keys}
            gc = ({k: group_slice(cache[k], g) for k in keys}
                  if cache is not None else None)
            x, terms = run(gp, x, gc, _make_tap(taps, g))
            if aux is not None:
                aux.extend(terms)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_vis:
        x = x[:, n_vis:]
    if skip_head:
        return x
    w = head_weight(cfg, params, gather)
    if isinstance(w, torch.Tensor) and w.shape[-1] != cfg.vocab:
        x = tp_input(x)                       # a vocab-parallel head
    logits = linear(x, w, use_kernels=use_kernels)
    logits = softcap(logits, cfg.logit_softcap)
    return logits


def _whole(tree, prefix: str):
    """The ``gather`` off a training mesh: every leaf as it is."""
    return tree


def _apply_group(cfg: ModelConfig, gp: dict, x: torch.Tensor, gc, tap, *,
                 positions, pos, valid_len, use_kernels: bool,
                 paged_attention: bool, gather):
    """Group ``g``'s blocks in pattern order over ``gp`` (its slice of
    ``params["blocks"]``) and ``gc`` (its slice of the cache, or None):
    ``(x, [the MoE blocks' aux losses])``."""
    terms: list = []
    for i, kind in enumerate(cfg.pattern):
        key = f"b{i}"
        x = B.apply_block(
            gather(gp[key], f"blocks/{key}"), x, kind, cfg.moe_slots[i],
            cfg, positions=positions,
            cache=gc[key] if gc is not None else None, pos=pos,
            valid_len=valid_len, use_kernels=use_kernels,
            paged_attention=paged_attention,
            tap=B.tap_prefix(tap, key), aux=terms)
    return x, terms


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kw(policy: str) -> dict:
    """``torch.utils.checkpoint`` keywords of a remat policy."""
    if policy == "full":
        return {}
    if policy == "dots":
        return {"context_fn": functools.partial(
            torch_ckpt.create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"unknown remat_policy {policy!r}")


def head_weight(cfg: ModelConfig, params: dict, gather=None):
    """The head's ``[d, V]`` weight (this rank's vocab slice under TP):
    ``lm_head``, or the embedding table's transpose for a tied head;
    through ``gather`` on a training mesh."""
    gather = gather if gather is not None else _whole
    if cfg.tie_embeddings:
        return gather(params["embed"]["tok"], "embed/tok").T
    return gather(params["lm_head"], "lm_head")


def train_loss(cfg: ModelConfig, params: dict, batch: dict, *,
               use_kernels: bool = False, remat: bool = True,
               gather=None):
    """The training objective (``repro.models.model.train_loss``): mean
    token NLL of ``batch["labels"]`` plus ``MOE_AUX_WEIGHT`` times the sum
    of the MoE blocks' load-balancing losses. Returns ``(total, {"loss",
    "aux"})``. With ``cfg.chunked_ce`` and no ``loss_mask`` the head and
    the loss run through ``sharded_ce_loss`` on the hidden states, else
    ``cross_entropy_loss`` over the logits. The hand kernels have no
    backward, so training runs the plain path (``use_kernels=False``) on
    dense parameters. ``remat`` (default on, as the reference's) as in
    ``forward``; the single-device step passes ``remat=False``, as the
    reference's does.

    On a training mesh (``runtime_context.use_mesh`` and ``gather``, the
    FSDP gather) the parameters are this rank's slices, the batch its dp
    rows, and the loss the mean over them: under TP both losses reduce
    over the vocab shards (``vocab_parallel_nll``) and come out equal on
    every model rank. Each MoE block's aux is already the global one
    (its statistics summed over the dp ranks, ``models.moe``), so the
    aux and its sum are equal on every rank; ``gather`` reaches every
    leaf of a group, the ``mamba/`` and ``ffn/`` experts and router
    too."""
    aux_terms: list = []
    kw = dict(vis_embeds=batch.get("vis_embeds"), frames=batch.get("frames"),
              use_kernels=use_kernels, aux=aux_terms, remat=remat,
              gather=gather)
    if cfg.chunked_ce and batch.get("loss_mask") is None:
        from repro_torch.models.chunked_ce import sharded_ce_loss
        hidden = _forward(cfg, params, batch["tokens"], skip_head=True,
                          **kw)
        loss = sharded_ce_loss(hidden, head_weight(cfg, params, gather),
                               batch["labels"],
                               logit_softcap=cfg.logit_softcap,
                               vocab=cfg.vocab)
    else:
        logits = _forward(cfg, params, batch["tokens"], **kw)
        loss = cross_entropy_loss(logits, batch["labels"],
                                  batch.get("loss_mask"), vocab=cfg.vocab)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    for a in aux_terms:
        aux = aux + a
    total = loss + MOE_AUX_WEIGHT * aux
    return total, {"loss": loss, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: int, cache_dtype=torch.bfloat16,
            vis_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            use_kernels: bool = True):
    """Full forward over the prompt into a fresh contiguous cache of
    ``max_len`` positions; returns ``(last_logits [B, V], cache)``. An
    encoder-decoder encodes ``frames`` and keeps each decoder layer's
    cross K/V in the cache, under ``b0``."""
    b = tokens.shape[0]
    dev = tokens.device
    if cfg.is_encdec:
        cache = {"b0": KV.init_encdec_cache(cfg, b, max_len, cache_dtype,
                                            dev)}
        enc_out = encode(cfg, params, frames, use_kernels)
        logits = forward(cfg, params, tokens, cache=cache, enc_out=enc_out,
                         use_kernels=use_kernels)
    else:
        cache = KV.init_cache(cfg, b, max_len, cache_dtype, dev)
        logits = forward(cfg, params, tokens, cache=cache,
                         vis_embeds=vis_embeds, use_kernels=use_kernels)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, use_kernels: bool = True):
    """One token step on a contiguous cache (updated in place): ``token
    [B, 1]`` at position ``pos`` (a scalar); returns ``(logits [B, V],
    cache)``."""
    logits = forward(cfg, params, token, cache=cache, pos=pos,
                     use_kernels=use_kernels)
    return logits[:, -1], cache
