"""The contiguous prefill and decode on a rank mesh, the rank function
``tests/test_torch_mesh_contig.py`` spawns (no JAX here, so spawned
ranks import this module quickly).

On each rank, for each case: ``serve.steps.build_prefill`` over the
rank's rows of the batch (``sharding.batch_rows``) into its cache
(``sharding.local_cache``), then ``STEPS`` greedy ``build_decode`` steps,
each call's logits made whole with ``gather_logits``; once on the
bridged dense weights and once on QMC streams quantized after the shard
(``launch.dryrun.decode_params``: the rank's shard alone, a replicated
attention block whole), with the collectives of the dense run by kind
and the shapes of the rank's cache.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun import decode_params
from repro_torch.serve import steps as S

B, SEQ, STEPS = 4, 6, 4
# fp32 caches: a bf16 cache rounds an entry the two frameworks compute
# ulps apart to neighbouring bf16 values (2 of whisper's 5120 V entries),
# which moves a decode logit by ~1e-3
CACHE_DTYPE = torch.float32
# (name, arch, overrides of reduced_config): whisper-medium and
# internvl2-2b with an odd vocab (509, as their published 51865 and 92553
# divide no model axis: the embedding and the head replicate), and a
# dense stack whose single KV head divides no model axis (its attention
# replicates) with a vocab-parallel head
CASES = [("whisper", "whisper-medium", dict(vocab=509)),
         ("internvl", "internvl2-2b", dict(vocab=509)),
         ("dense-kv1", "stablelm-1.6b", dict(n_kv_heads=1))]


def case_cfg(name: str):
    _, arch, repl = next(c for c in CASES if c[0] == name)
    return dataclasses.replace(reduced_config(arch), **repl)


def make_inputs(cfg, seed: int = 11) -> dict:
    """``B`` prompts of ``SEQ`` tokens and the stack's ``frames`` or
    ``vis_embeds``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = 0.1 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = 0.1 * rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return out


def cache_len(cfg) -> int:
    return SEQ + cfg.n_vis_tokens + STEPS


def greedy(mesh, cfg, params, inputs) -> dict:
    """Prefill and ``STEPS`` greedy decode steps on this rank; the whole
    logits of every call ``[B, 1 + STEPS, V]``, the tokens fed and the
    rank's cache."""
    rows = shd.batch_rows(mesh, B)
    toks = torch.from_numpy(inputs["tokens"]).long()
    extras = {k: torch.from_numpy(v)[rows] for k, v in inputs.items()
              if k != "tokens"}
    n = cache_len(cfg)
    prefill = S.build_prefill(cfg, mesh, batch=B, seq=SEQ, cache_len=n,
                              cache_dtype=CACHE_DTYPE)
    decode = S.build_decode(cfg, mesh, batch=B, cache_len=n)
    lg, cache = prefill(params, toks[rows], extras)
    logits = [S.gather_logits(lg, mesh, B, cfg)]
    fed = []
    for i in range(STEPS):
        nxt = torch.argmax(logits[-1], dim=-1)
        fed.append(nxt)
        lg, cache = decode(params, nxt[rows].reshape(-1, 1), cache,
                           SEQ + cfg.n_vis_tokens + i)
        logits.append(S.gather_logits(lg, mesh, B, cfg))
    return dict(logits=torch.stack(logits, 1), tokens=torch.stack(fed, 1),
                cache=cache)


def contig_job(mesh, job):
    """Each case on this rank, dense then on streams quantized after the
    shard."""
    out = {"rank": mesh.rank, "cases": {}}
    for name in job["cases"]:
        cfg = case_cfg(name)
        whole = job["params"][name]
        inputs = job["inputs"][name]
        mesh.reset_counts()
        with torch.no_grad():
            dense = greedy(mesh, cfg, shd.shard_params(whole, mesh, cfg),
                           inputs)
            kinds = {k: v[0] for k, v in mesh.by_kind.items()}
            quant = greedy(mesh, cfg, shd.shard_params(
                decode_params(cfg, whole, mesh, "qtensor"), mesh, cfg),
                inputs)
        cache = dense.pop("cache")
        self_kv = cache["b0"]["self"] if cfg.is_encdec else \
            cache["b0"]["attn"]
        quant.pop("cache")
        out["cases"][name] = dict(
            dense=dense, quant=quant, by_kind=kinds,
            k_shape=tuple(self_kv["k"].shape),
            xk_shape=(tuple(cache["b0"]["cross"]["xk"].shape)
                      if cfg.is_encdec else None))
    return out
