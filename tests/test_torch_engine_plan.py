"""Engine parity, continued: the dense weight plan switched on (JAX's
default plan against the port's), and a pool small enough to force
preemption. Helpers and weights come from ``test_torch_engine``."""
import pytest

from test_torch_engine import qmc_weights, run_both  # noqa: F401


@pytest.mark.parametrize("quant", [False, True], ids=["fp32kv", "int8kv"])
def test_tokens_match_jax_engine_weight_plan(qmc_weights, quant):  # noqa: F811
    """weight_plan=True on both sides: streams dequantized once at setup,
    the step multiplies dense weights."""
    run_both(qmc_weights, quant=quant, weight_plan=True)


def test_port_defaults_match_jax_defaults(qmc_weights):  # noqa: F811
    """Each engine at its defaults: JAX's dense weight plan and XLA
    gather against the port's qmm streams and paged attention."""
    run_both(qmc_weights, quant=False, weight_plan=True,
             jax_paged_attention=False, port_weight_plan=False)


def test_preemption_matches_jax(qmc_weights):  # noqa: F811
    """2 usable pages for 2 slots: the 13-token prompt outgrows its page
    while the 9-token one holds the other, so the younger lane preempts
    itself and is recomputed — identically on both sides."""
    js, ps = run_both(qmc_weights, quant=False, weight_plan=False,
                      n_pages=2)
    assert ps.preemptions > 0
