"""The mesh layer itself, on gloo ranks spawned on the CPU, the port held
to itself (no JAX, so the spawned ranks import this module quickly):

  * a rank that raises makes the run raise, promptly (its peer, blocked
    in a collective, is ended);
  * token selection over vocab shards (``select_tokens_tp``) equals one
    rank's ``select_tokens`` on the whole logits: greedy tokens exactly,
    ties to the lowest index as ``argmax`` has them, logprobs to 1e-6;
    sampled lanes exactly (their rows are gathered whole);
  * the cross-rank merge of attention partials (``merge_over``) equals
    the plain ``merge_slices`` exactly at D = 2 (two-term sums);
  * page copies whose source and destination sit on different data
    ranks (``apply_page_ops`` with a page slice) equal the copies made on
    the whole arena, for fp32 pages and int8 pages with bf16 scales.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import merge_over, merge_slices
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.serve.sampling import (lane_inputs, select_tokens,
                                        select_tokens_tp)
from repro_torch.serve.steps import apply_page_ops

TIMEOUT_S = 120.0


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.ones(1)
    mesh.all_reduce(t, "model")          # its peer never joins
    return "unreachable"


def test_a_failing_rank_fails_the_mesh():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(_fail_on_rank_1, (1, 2), backend="gloo", timeout_s=TIMEOUT_S)


def _samp(temp):
    samp = lane_inputs(len(temp))
    samp["temp"][:] = temp
    samp["top_k"][:] = 5
    samp["top_p"][:] = 0.9
    samp["key"][:] = np.arange(2 * len(temp)).reshape(-1, 2) + 7
    return {"temp": torch.tensor(samp["temp"]),
            "top_k": torch.tensor(samp["top_k"]),
            "top_p": torch.tensor(samp["top_p"]),
            "key": torch.tensor(samp["key"].view(np.int32))}


def _logits():
    """[4, 3, 96]: ties across the two vocab shards (row 0: ids 3 and 70),
    inside the second (row 1: 50 and 51) and inside the first (row 2: 10
    and 20); row 3 random."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 3, 96), generator=g)
    for b, ids in ((0, (3, 70)), (1, (50, 51)), (2, (10, 20))):
        x[b, :, list(ids)] = 9.0
    return x


def _select_rank(mesh, logits, temp, sampled):
    v = logits.shape[-1]
    n = v // mesh.shape[1]
    m = mesh.index("model")
    positions = torch.arange(3)[None].expand(4, 3) + 5
    n_new = torch.tensor([3, 2, 3, 0])
    return select_tokens_tp(logits[..., m * n:(m + 1) * n], v,
                            *_samp(temp).values(), positions, n_new, mesh,
                            sampled=sampled)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy",
                                                        "sampled"])
def test_vocab_shards_select_like_one_rank(sampled):
    logits = _logits()
    temp = [0.0, 0.8, 0.0, 1.2] if sampled else [0.0] * 4
    want_tok, want_logp = select_tokens(
        logits, *_samp(temp).values(),
        torch.arange(3)[None].expand(4, 3) + 5, torch.tensor([3, 2, 3, 0]),
        sampled=sampled)
    if not sampled:
        assert want_tok[0, 0] == 3 and want_tok[1, 0] == 50 \
            and want_tok[2, 0] == 10
    for tok, logp in spawn(_select_rank, (1, 2), backend="gloo",
                           args=(logits, temp, sampled),
                           timeout_s=TIMEOUT_S):
        assert torch.equal(tok, want_tok)
        torch.testing.assert_close(logp, want_logp, rtol=0, atol=1e-6)


def _partials():
    g = torch.Generator().manual_seed(1)
    parts = []
    for _ in range(2):
        o = torch.randn((2, 3, 4, 8), generator=g)
        m = torch.randn((2, 3, 4), generator=g)
        l = torch.rand((2, 3, 4), generator=g) + 0.5
        parts.append((o, m, l))
    # a row with nothing in slice 1, one with nothing in either
    o, m, l = parts[1]
    o[0, 0, 0], m[0, 0, 0], l[0, 0, 0] = 0.0, -1e30, 0.0
    for o, m, l in parts:
        o[1, 2, 3], m[1, 2, 3], l[1, 2, 3] = 0.0, -1e30, 0.0
    return parts


def _merge_rank(mesh, parts):
    return merge_over(*parts[mesh.index("data")], mesh)


def test_cross_rank_merge_equals_the_plain_merge():
    parts = _partials()
    want = merge_slices(parts)
    assert (want[1, 2, 3] == 0).all()
    for got in spawn(_merge_rank, (2, 1), backend="gloo", args=(parts,),
                     timeout_s=TIMEOUT_S):
        assert torch.equal(got, want)


def _arena(quantized):
    g = torch.Generator().manual_seed(2)
    shape = (2, 16, 8, 32)                 # [G, pages, page, KV * hd]
    if quantized:
        attn = {"k_pages": torch.randint(-127, 128, shape, generator=g,
                                         dtype=torch.int8),
                "v_pages": torch.randint(-127, 128, shape, generator=g,
                                         dtype=torch.int8),
                "k_scale_pages": torch.rand((2, 16, 8, 2), generator=g
                                            ).to(torch.bfloat16),
                "v_scale_pages": torch.rand((2, 16, 8, 2), generator=g
                                            ).to(torch.bfloat16)}
    else:
        attn = {"k_pages": torch.randn(shape, generator=g),
                "v_pages": torch.randn(shape, generator=g)}
    attn["block_tbl"] = torch.zeros((2, 4, 4), dtype=torch.int32)
    return {"b0": {"attn": attn}}


COPIES = [(2, 9), (12, 3), (5, 6), (0, 0)]   # across, across, within, pad


def _copy_rank(mesh, arena):
    local = shd.shard_arena(arena, mesh)
    first, n = shd.page_slice(16, mesh)
    src = torch.tensor([s for s, _ in COPIES], dtype=torch.int32)
    dst = torch.tensor([d for _, d in COPIES], dtype=torch.int32)
    tables = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    apply_page_ops(local, tables, src, dst, None, mesh, (first, n))
    return {k: v[:, :n] for k, v in local["b0"]["attn"].items()
            if k.endswith("_pages")}, local["b0"]["attn"]["block_tbl"]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_page_copies_across_data_ranks(quantized):
    arena = _arena(quantized)
    whole = {k: v.clone() for k, v in arena["b0"]["attn"].items()}
    src = torch.tensor([s for s, _ in COPIES])
    dst = torch.tensor([d for _, d in COPIES])
    for name, leaf in whole.items():
        if name.endswith("_pages"):
            leaf.index_copy_(1, dst, leaf.index_select(1, src))
    for rank, (pages, tbl) in enumerate(spawn(
            _copy_rank, (2, 1), backend="gloo", args=(arena,),
            timeout_s=TIMEOUT_S)):
        assert torch.equal(tbl[0], torch.arange(16, dtype=torch.int32
                                                ).reshape(4, 4))
        for name, got in pages.items():
            want = whole[name][:, rank * 8:(rank + 1) * 8]
            assert torch.equal(got, want), (rank, name)
