"""The port's copy of the memory co-design simulator
(``repro_torch.memsys``) against the JAX package's: every traffic model,
evaluator and the design-space sweep give equal floats for hymba-1.5b and
stablelm-1.6b (pure Python on both sides, so equal, not close)."""
import dataclasses

import pytest

from repro import memsys as jax_memsys
from repro.configs import get_config as jax_get_config
from repro.core.qconfig import QMCConfig as JaxQMCConfig
from repro.memsys import workload as jax_workload
from repro_torch import memsys
from repro_torch.configs import get_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.memsys import workload

ARCHS = ["hymba-1.5b", "stablelm-1.6b"]
METHODS = ["fp32", "fp16", "rtn4", "awq", "gptq", "mx4", "emems_mram",
           "emems_reram"]


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_and_evaluators_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sys_cfg, jsys_cfg = memsys.MemSystemConfig(), \
        jax_memsys.MemSystemConfig()
    for method in METHODS:
        for legacy in (False, True):
            t = memsys.make_traffic(cfg, method, seq_len=1024,
                                    legacy_flash=legacy)
            jt = jax_memsys.make_traffic(jcfg, method, seq_len=1024,
                                         legacy_flash=legacy)
            _same(t, jt)
            _same(memsys.evaluate_conventional(t, sys_cfg, legacy),
                  jax_memsys.evaluate_conventional(jt, jsys_cfg, legacy))
            _same(memsys.evaluate_hetero(t, sys_cfg),
                  jax_memsys.evaluate_hetero(jt, jsys_cfg))
    for cell_bits in (2, 3):
        t = memsys.make_traffic(cfg, "qmc", seq_len=1024,
                                qmc=QMCConfig(rho=0.3, cell_bits=cell_bits))
        jt = jax_memsys.make_traffic(
            jcfg, "qmc", seq_len=1024,
            qmc=JaxQMCConfig(rho=0.3, cell_bits=cell_bits))
        _same(t, jt)
        best = memsys.dse(t, cell_bits=cell_bits)
        jbest = jax_memsys.dse(jt, cell_bits=cell_bits)
        _same(best, jbest)
        _same(memsys.evaluate_hetero(t, best),
              jax_memsys.evaluate_hetero(jt, jbest))
    with pytest.raises(ValueError):
        memsys.make_traffic(cfg, "int3")


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_traffic_models_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    lens = [17, 64, 100, 1]
    _same(workload.kv_traffic_paged(cfg, lens, page=16),
          jax_workload.kv_traffic_paged(jcfg, lens, page=16))
    _same(workload.kv_traffic_paged(cfg, lens, live_only=False,
                                    max_pages_per_seq=8),
          jax_workload.kv_traffic_paged(jcfg, lens, live_only=False,
                                        max_pages_per_seq=8))
    for chunk, cached in ((32, 0), (48, 32)):
        _same(workload.kv_traffic_chunked(cfg, 200, chunk=chunk,
                                          cached_len=cached),
              jax_workload.kv_traffic_chunked(jcfg, 200, chunk=chunk,
                                              cached_len=cached))
    _same(workload.kv_traffic_prefix(cfg, [64, 80, 40], [32, 64, 0]),
          jax_workload.kv_traffic_prefix(jcfg, [64, 80, 40], [32, 64, 0]))
    base = memsys.make_traffic(cfg, "qmc", seq_len=512)
    jbase = jax_memsys.make_traffic(jcfg, "qmc", seq_len=512)
    _same(workload.shard_serve_traffic(base, data_shards=2, model_shards=2),
          jax_workload.shard_serve_traffic(jbase, data_shards=2,
                                           model_shards=2))
    for q_start, n_new in ((0, 40), (33, 1), (100, 17)):
        assert workload.chunk_pages_streamed(q_start, n_new) == \
            jax_workload.chunk_pages_streamed(q_start, n_new)
