"""The replicated-dim route and encoder-decoder and VLM stacks on the rank
mesh, the port held to itself, and the rank function
``tests/test_torch_mesh_heads.py`` spawns (no JAX here, so spawned ranks
import this module quickly):

  * the rules on stand-in ranks: hymba-1.5b (25 heads, 5 KV heads) at
    ``M`` = 2 and 4 and qwen2.5-1.5b (12 heads, 2 KV heads) at ``M`` = 4
    replicate every attention leaf over ``model`` and keep its FSDP cut
    on ``data``; the paged arena keeps every KV head on a model rank; the
    attention biases' gradients take no SUM over ``model`` there; qwen
    at ``M`` = 2, whose heads divide, stays tensor-parallel;
  * ``check_train_mesh`` accepts every registry config at ``M`` = 2 and
    4 and refuses a ``d_ff`` that does not divide ``model``;
  * ``obs.costs.train_step_work`` counts a replicated attention block
    and a replicated head in full on every model rank;
  * ``shard_params`` keeps a replicated block's streams whole and refuses
    a sharded conversion of them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import _REGISTRY, get_config, reduced_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.core.qtensor import quantize_qtensor
from repro_torch.core.qtensor_sharded import quantize_qtensor_sharded
from repro_torch.kernels import paged_attention as kpa
from repro_torch.launch import sharding as shd
from repro_torch.models.model import init_params
from repro_torch.obs.costs import train_step_work
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as S
from test_torch_mesh_families_ranks import StandInMesh
from test_torch_train_ranks import (BATCH, LR, SEQ, STEPS, WARMUP,
                                    elastic_first, elastic_resume)

# 15 usable pages + the null page: 8 a data rank at D = 2
ENGINE = dict(slots=4, max_len=32, page_size=8, n_pages=15)
# (name, arch, overrides of reduced_config, microbatches). Each vocab is
# odd (509), so the embedding and the head replicate over model; the
# hymba-structured stack (a global and a local hybrid block) keeps
# hymba's G = 5 with 5 heads over 1 KV head, which do not divide 2, so its
# attention replicates too
CASES = [("whisper-mb2", "whisper-medium", dict(vocab=509), 2),
         ("internvl-mb1", "internvl2-2b", dict(vocab=509), 1),
         ("hymba5-mb1", "hymba-1.5b",
          dict(vocab=509, n_heads=5, n_kv_heads=1, head_dim=16,
               n_layers=2, pattern=("hybrid", "hybrid_local"), window=8),
          1)]
HYMBA5 = "hymba5-mb1"
_ATTN = ("wq", "wk", "wv", "wo")


def case_cfg(name: str):
    _, arch, repl, _ = next(c for c in CASES if c[0] == name)
    return dataclasses.replace(reduced_config(arch), **repl)


def make_batch(cfg, seed: int = 3) -> dict:
    """Tokens and labels of ``BATCH`` rows of ``SEQ``, with the stack's
    ``frames`` or ``vis_embeds`` drawn from the same numpy generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(
        np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vis_tokens:
        out["vis_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: (torch.from_numpy(v).long() if k in ("tokens", "labels")
                else torch.from_numpy(v)) for k, v in batch.items()}


def serve_requests(vocab: int, n: int = 6):
    """``n`` requests on 4 slots (slots reseated, states reset)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(5)
    return [Request(uid=i, prompt=rng.integers(2, vocab, size=int(L)
                                               ).astype(np.int32),
                    max_new_tokens=4)
            for i, L in enumerate(rng.integers(4, 14, size=n))]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------
def train_cases(mesh, names, params_by_case, batches):
    """Each case on this rank: the step-0 loss and gradients (made whole
    with ``unshard``) and ``STEPS`` steps of ``build_train_step``."""
    out = {}
    for name in names:
        cfg, mb = case_cfg(name), next(c[3] for c in CASES if c[0] == name)
        params = params_by_case[name]
        specs = shd.train_specs(params, mesh, cfg)
        local = shd.train_slices(params, mesh, specs)
        rows = shd.batch_rows(mesh, BATCH, mb)
        batch = {k: v[rows] for k, v in torch_batch(batches[name]).items()}
        loss, _, grads = S.mesh_grads_fn(cfg, mesh, mb)(local, batch)
        step = S.build_train_step(cfg, AdamWConfig(lr=LR), mesh,
                                  microbatches=mb, warmup=WARMUP,
                                  total_steps=10)
        opt = adamw.init(local, AdamWConfig(lr=LR))
        hist = []
        for _ in range(STEPS):
            local, opt, m = step(local, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
        out[name] = dict(loss0=float(loss), history=hist,
                         grads=shd.unshard(grads, mesh, specs),
                         params=shd.unshard(local, mesh, specs))
    return out


def serve_run(mesh, cfg, params):
    """The stack through ``ServeEngine(mesh=)`` on B1's route: this rank's
    tokens, its collectives a run by kind, the fused KV width of its
    arena, and its calls into the ragged paged-attention entries."""
    calls = {"whole": 0, "slice": 0}
    plain = (kpa.ragged_paged_attention, kpa.ragged_paged_attention_call)

    def whole(*a, **k):
        calls["whole"] += 1
        return plain[0](*a, **k)

    def sliced(*a, **k):
        calls["slice"] += 1
        return plain[1](*a, **k)
    kpa.ragged_paged_attention, kpa.ragged_paged_attention_call = \
        whole, sliced
    try:
        eng = ServeEngine(cfg, params, mesh=mesh, cuda_graphs=False,
                          device="cpu", paged_attention=True, **ENGINE)
        k0 = {k: v[0] for k, v in mesh.by_kind.items()}
        reqs = serve_requests(cfg.vocab)
        eng.run(reqs)
    finally:
        kpa.ragged_paged_attention, kpa.ragged_paged_attention_call = plain
    return dict(tokens=[r.out_tokens for r in reqs],
                by_kind={k: v[0] - k0.get(k, 0)
                         for k, v in mesh.by_kind.items()
                         if v[0] - k0.get(k, 0)},
                kv_width=eng._arena["b0"]["attn"]["k_pages"].shape[-1],
                attention_calls=calls, rounds=eng.stats.rounds)


def heads_job(mesh, job):
    """Every part of a mesh shape's work in one spawn."""
    out = {}
    if "cases" in job:
        out["cases"] = train_cases(mesh, job["cases"], job["params"],
                                   job["batches"])
    if "serve" in job:
        out["serve"] = serve_run(mesh, *job["serve"])
    if "elastic_first" in job:
        out["elastic_first"] = elastic_first(mesh, *job["elastic_first"])
    if "elastic_resume" in job:
        out["elastic_resume"] = elastic_resume(mesh, *job["elastic_resume"])
    return out


# ---------------------------------------------------------------------------
# the rules on stand-in ranks
# ---------------------------------------------------------------------------
def _attn_paths(specs):
    return [p for p in specs if p.split("/")[-1] in _ATTN + ("bq", "bk",
                                                             "bv")
            and "attn/" in p]


@pytest.mark.parametrize("arch,m", [("hymba-1.5b", 2), ("hymba-1.5b", 4),
                                    ("qwen2.5-1.5b", 4)])
def test_attention_replicates_where_heads_do_not_divide(arch, m):
    """Every attention leaf loses its ``model`` cut and keeps ``data``;
    the FFN stays tensor-parallel; the arena's fused KV dim is whole; the
    biases' gradients are summed over ``data`` only."""
    cfg = get_config(arch)
    mesh = StandInMesh((2, m), (1, m - 1))
    meta = init_params(cfg, device="meta")
    specs = shd.train_specs(meta, mesh, cfg)
    paths = _attn_paths(specs)
    assert paths
    for p in paths:
        assert "model" not in specs[p], p
        name = p.split("/")[-1]
        if name in ("wq", "wk", "wv"):
            assert specs[p] == (None, "data", None), p
        elif name == "wo":
            assert specs[p] == (None, None, "data"), p
        else:
            assert shd.grad_axes(p, specs[p], mesh, cfg) == ("data",), p
            # the dim rule alone sums a bias over model
            assert shd.grad_axes(p, specs[p], mesh) == ("data", "model"), p
        assert shd.serving_spec(p, meta_leaf(meta, p), mesh, cfg) == \
            (None,) * len(specs[p]), p
    assert specs["blocks/b0/ffn/w_up"] == (None, "data", "model")
    assert specs["blocks/b0/ffn/w_down"] == (None, "model", "data")
    if arch == "hymba-1.5b":
        # the dim rule alone would cut 1600 columns into 12.5 heads a rank
        assert shd.param_spec("blocks/b0/attn/wq",
                              meta["blocks"]["b0"]["attn"]["wq"], mesh) \
            == (None, "data", "model")
    pages = torch.empty(cfg.n_groups, 8, 16, cfg.kv_dim, device="meta")
    assert shd.paged_cache_spec("b0/attn/k_pages", pages, mesh, cfg)[-1] \
        is None
    arena = shd.local_arena(cfg, 8, 16, 2, 4, torch.float32, "meta", mesh)
    assert arena["b0"]["attn"]["k_pages"].shape[-1] == cfg.kv_dim


def meta_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_heads_that_divide_stay_tensor_parallel():
    """qwen2.5-1.5b at ``M`` = 2 (12 and 2 heads divide): the q/k/v
    columns, ``wo``'s rows and the arena's KV dim are cut over ``model``,
    and the biases' gradients summed there."""
    cfg = get_config("qwen2.5-1.5b")
    mesh = StandInMesh((1, 2), (0, 1))
    specs = shd.train_specs(init_params(cfg, device="meta"), mesh, cfg)
    assert specs["blocks/b0/attn/wq"] == (None, "data", "model")
    assert specs["blocks/b0/attn/wo"] == (None, "model", "data")
    assert shd.grad_axes("blocks/b0/attn/bq", specs["blocks/b0/attn/bq"],
                         mesh, cfg) == ("model",)
    arena = shd.local_arena(cfg, 8, 16, 2, 4, torch.float32, "meta", mesh)
    assert arena["b0"]["attn"]["k_pages"].shape[-1] == cfg.kv_dim // 2


def test_check_train_mesh_accepts_the_registry_and_refuses_an_odd_d_ff():
    for arch in _REGISTRY:
        for m in (2, 4):
            shd.check_train_mesh(get_config(arch), StandInMesh((1, m)))
    odd = dataclasses.replace(reduced_config("stablelm-1.6b"), d_ff=255)
    with pytest.raises(ValueError, match="d_ff = 255 does not divide"):
        shd.check_train_mesh(odd, StandInMesh((1, 2)))


def test_train_step_work_counts_replicated_blocks_in_full():
    """hymba5 (5 heads of 16, 1 KV head; vocab 509) over 64 tokens: a
    (2, 2) rank counts the attention block and the head whole, the
    Mamba2 ``in_proj`` / ``out_proj`` and the FFN at half; whisper's
    encoder layers and cross K/V run at the frames' rows."""
    cfg, t = case_cfg(HYMBA5), 64
    d = cfg.d_model
    mesh = StandInMesh((2, 2), (1, 1))
    one = train_step_work(cfg, tokens=t, remat=False)["forward_flops"]
    rank = train_step_work(cfg, mesh, tokens=t, remat=False)[
        "forward_flops"]
    attn = cfg.n_layers * 2 * t * d * (80 + 16 + 16 + 80)
    head = 2 * t * d * cfg.vocab
    assert rank == pytest.approx((one - attn - head) / 2 + attn + head)
    w = case_cfg("whisper-mb2")
    d, a, kv = w.d_model, w.attn_dim, w.kv_dim
    enc_rows = 2 * w.enc_seq
    got = train_step_work(w, tokens=t, enc_tokens=enc_rows, remat=False)
    layer = 2 * (2 * d * a + 2 * d * kv + 2 * d * w.d_ff)  # a row's
    xattn = 2 * t * 2 * d * a + 2 * enc_rows * 2 * d * kv
    want = (w.n_enc_layers * enc_rows * layer + w.n_layers * t * layer
            + w.n_layers * xattn + 2 * t * d * w.vocab)
    assert got["forward_flops"] == want


def test_a_replicated_block_keeps_its_streams_whole():
    """``shard_params`` leaves a replicated attention block's QTensor
    streams whole on every model rank (the dim rule alone would cut the
    1600-wide ``wo`` of hymba-1.5b by its rows), and refuses a
    ``tp_shards=2`` conversion of one, whose shards only a row-parallel
    product could join."""
    cfg = get_config("hymba-1.5b")
    mesh = StandInMesh((1, 2), (0, 1))
    qmc = QMCConfig(rho=0.3, granularity="subtile")
    wo = quantize_qtensor(torch.randn(1600, 1536), qmc)
    tree = {"blocks": {"b0": {"attn": {"wo": [wo]}}}}
    assert shd.shard_params(tree, mesh, cfg)["blocks"]["b0"]["attn"][
        "wo"][0] is wo
    cut = shd.shard_params(tree, mesh)["blocks"]["b0"]["attn"]["wo"][0]
    assert cut is not wo
    sharded = quantize_qtensor_sharded(torch.randn(1600, 1536), qmc, 2, 0)
    with pytest.raises(ValueError, match="tp_shards=1"):
        shd.shard_params({"blocks": {"b0": {"attn": {"wo": [sharded]}}}},
                         mesh, cfg)
