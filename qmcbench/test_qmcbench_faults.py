"""A run with its timed path broken underneath must come out not
correct. Each test drives the whole of a run (set-up, window, the
comparison) on the CPU at a small size, past the look for a card, with
one fault planted in the program: a token altered where the head
produces it, attention state never written (a step that leaves its KV
state unchanged), and on the hybrid stack the SSM state left as it was.
Faults of training (half a batch, a state left unchanged by the
optimizer) and of exchanges between chips have no place in one-chip
serving cells."""
import pytest
import torch

from qmcbench import harness
from qmcbench.smallcell import small_cell

SEED = 2 ** 31 + 77


def _run(name):
    return harness.run_cell(small_cell(name), SEED, 1.0, False,
                            device="cpu")


def _altered_head(monkeypatch):
    from repro_torch.serve import steps
    real = steps.select_tokens

    def altered(*a, **kw):
        tok, logp = real(*a, **kw)
        return torch.where(tok >= 0, (tok + 1) % a[0].shape[-1], tok), logp
    monkeypatch.setattr(steps, "select_tokens", altered)


def _kv_unwritten(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "paged_cache_write",
                        lambda *a, **kw: None)


def _ssm_state_kept(monkeypatch):
    from repro_torch.models import blocks
    real = blocks.mamba_block

    def kept(p, x, cfg, *, cache=None, **kw):
        before = None if cache is None else cache["ssm"].clone()
        out = real(p, x, cfg, cache=cache, **kw)
        if before is not None:
            cache["ssm"].copy_(before)
        return out
    monkeypatch.setattr(blocks, "mamba_block", kept)


@pytest.mark.parametrize("name,fault", [
    ("stablelm-1.6b.chat", _altered_head),
    ("stablelm-1.6b.chat", _kv_unwritten),
    ("hymba-1.5b.chat-long", _altered_head),
    ("hymba-1.5b.chat-long", _kv_unwritten),
    ("hymba-1.5b.chat-long", _ssm_state_kept),
])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert r["correct"] is False
    failed = [k for k, v in r["checks"].items() if v["value"] > v["limit"]]
    assert "logprob_err" in failed or "logit_gap" in failed
