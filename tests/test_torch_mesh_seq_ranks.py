"""The sequence-parallel contiguous cache, the rank function
``tests/test_torch_mesh_seq.py`` spawns (no JAX here, so spawned ranks
import this module quickly).

On each rank, for each case (an arch and a batch that does not divide
the data axis): ``serve.steps.build_prefill`` of ``SEQ`` tokens (every
row) into the rank's cut of a ``cache_len`` cache
(``sharding.local_cache``: ``T / D`` positions), then ``STEPS`` greedy
``build_decode`` steps at tensor positions (the dry run's form), each
call's logits made whole with ``gather_logits``; the rank's cache shape
and its collectives by kind.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import sharding as shd
from repro_torch.serve import steps as S

SEQ, STEPS = 6, 4
ARCHS = ("hymba-1.5b", "whisper-medium", "internvl2-2b", "stablelm-1.6b")
BATCHES = (1, 3)


def case_cfg(arch: str):
    """The reduced config, its vocab cut to 509 where the head would be
    vocab-parallel at M = 2 (an odd vocab replicates it, as the
    published whisper, internvl and hymba vocabs do)."""
    cfg = reduced_config(arch)
    return dataclasses.replace(cfg, vocab=509) if arch != "stablelm-1.6b" \
        else cfg


def cache_len(cfg) -> int:
    """Twice one past the prompt: the prompt sits in data rank 0's half,
    and the decode steps cross into rank 1's at their second step."""
    return 2 * (SEQ + cfg.n_vis_tokens + 1)


def make_inputs(cfg, batch: int, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed + batch)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, SEQ)).astype(
        np.int32)}
    if cfg.is_encdec:
        out["frames"] = 0.1 * rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = 0.1 * rng.standard_normal(
            (batch, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return out


def greedy(mesh, cfg, params, inputs) -> dict:
    b = inputs["tokens"].shape[0]
    n = cache_len(cfg)
    toks = torch.from_numpy(inputs["tokens"]).long()
    extras = {k: torch.from_numpy(v) for k, v in inputs.items()
              if k != "tokens"}
    prefill = S.build_prefill(cfg, mesh, batch=b, seq=SEQ, cache_len=n,
                              cache_dtype=torch.float32)
    decode = S.build_decode(cfg, mesh, batch=b, cache_len=n)
    lg, cache = prefill(params, toks, extras)
    logits, fed = [S.gather_logits(lg, mesh, b, cfg)], []
    for i in range(STEPS):
        nxt = torch.argmax(logits[-1], dim=-1)
        fed.append(nxt)
        lg, cache = decode(params, nxt.reshape(-1, 1), cache,
                           torch.tensor(SEQ + cfg.n_vis_tokens + i))
        logits.append(S.gather_logits(lg, mesh, b, cfg))
    self_kv = cache["b0"]["self"] if cfg.is_encdec else next(
        g["attn"] for g in cache.values() if "attn" in g)
    return dict(logits=torch.stack(logits, 1), tokens=torch.stack(fed, 1),
                k_shape=tuple(self_kv["k"].shape))


def seq_job(mesh, job):
    """Each (arch, batch) case on this rank, on the bridged dense
    weights."""
    out = {"rank": mesh.rank, "seq": shd.seq_slice(mesh, 1, 8),
           "cases": {}}
    for arch, batch in job["cases"]:
        cfg = case_cfg(arch)
        mesh.reset_counts()
        with torch.no_grad():
            got = greedy(mesh, cfg, shd.shard_params(job["params"][arch],
                                                     mesh, cfg),
                         job["inputs"][(arch, batch)])
        got["by_kind"] = {k: v[0] for k, v in mesh.by_kind.items()}
        out["cases"][(arch, batch)] = got
    return out
