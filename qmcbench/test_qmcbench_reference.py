"""The plain reference against the port, on the CPU at a small size: its
own copy of QMC gives the port's format matrices bit for bit, and a run
of the harness compares clean."""
import pytest
import torch

from qmcbench import harness, refquant, weights
from qmcbench.smallcell import small_cell


@pytest.mark.parametrize("name", ["stablelm-1.6b.chat",
                                  "hymba-1.5b.chat-long"])
def test_reference_quantizes_as_the_port_does(name):
    from repro_torch.core.qtensor import dequantize_qtensor
    from repro_torch.core.serving_quant import quantize_for_serving
    c = small_cell(name).config
    q = quantize_for_serving(weights.dense_params(c["model"], 3, "cpu"),
                             harness.qmc_config(c["quant"]),
                             min_dim=c["quant"]["min_dim"])
    ref = refquant.format_params(weights.dense_params(c["model"], 3, "cpu"),
                                 c["quant"])
    seen = 0
    for path, leaf in weights.iter_leaves(q):
        node = ref
        for k in path.split("/"):
            node = node[k]
        qts = leaf if isinstance(leaf, list) else [leaf]
        if not hasattr(qts[0], "in_codes"):
            assert torch.equal(leaf, node)
            continue
        dense = node if isinstance(leaf, list) else node[None]
        for i, qt in enumerate(qts):
            assert torch.equal(dequantize_qtensor(qt, torch.float32),
                               dense[i]), path
            seen += 1
    assert seen > 0


def test_reference_copy_keeps_ties_and_zero_columns():
    w = torch.zeros(16, 256)
    w[:8, :128] = 1.0                      # two subtiles tie at the top
    w[8:, 128:] = 1.0
    w[:, 5] = 0.0                          # an all-zero column
    q = {"rho": 0.25, "bits_in": 3, "bits_out": 5, "cell_bits": 3,
         "subtile": [8, 128], "scale_grid": [0.3, 1.05, 48]}
    from repro_torch.core.qconfig import QMCConfig
    from repro_torch.core.qtensor import dequantize_qtensor, quantize_qtensor
    qt = quantize_qtensor(w, QMCConfig(rho=0.25, granularity="subtile"))
    assert torch.equal(refquant.qmc_matrix(w, q),
                       dequantize_qtensor(qt, torch.float32))


@pytest.mark.parametrize("name", ["stablelm-1.6b.chat",
                                  "hymba-1.5b.chat-long"])
def test_a_run_compares_clean(name):
    r = harness.run_cell(small_cell(name), 2 ** 31 + 5, 1.0, False,
                         device="cpu")
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["logit_gap"]["value"] == 0.0
    assert r["checks"]["logprob_err"]["value"] < 1e-4
    assert list(r["checks"]) == ["logit_gap", "logprob_err",
                                 "window_graph_captures",
                                 "unfinished_requests"]
