"""Analytic heterogeneous-memory co-design simulator (paper §3.3, §4.2.3);
port counterpart of ``repro.memsys``, pure Python."""
from repro_torch.memsys.devices import (FLASH, LPDDR5, MRAM, RERAM_2B,
                                        RERAM_3B, MemDevice)
from repro_torch.memsys.system import (EvalResult, MemSystemConfig, dse,
                                       evaluate_conventional,
                                       evaluate_hetero)
from repro_torch.memsys.workload import Traffic, make_traffic

__all__ = ["FLASH", "LPDDR5", "MRAM", "RERAM_2B", "RERAM_3B", "MemDevice",
           "EvalResult", "MemSystemConfig", "dse", "evaluate_conventional",
           "evaluate_hetero", "Traffic", "make_traffic"]
