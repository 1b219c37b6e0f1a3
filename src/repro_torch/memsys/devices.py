"""Memory device models — paper Table 1 (+ Flash for the legacy baseline).

All constants are the paper's cited measurements:
  MRAM   [43,44]: 3.5 ns read, 36.57 GiB/s per channel, 1 pJ/bit, 66 Mb/mm2
  ReRAM  [40,45]: <5 ns read, 1.8 GiB/s per 256x256 array, 1.56 pJ/bit
                  (3-bit mode), 30.1 Mb/mm2 (3-bit mode)
  LPDDR5 [46]   : 1.7 ns, 186.26 GiB/s, 3.5 pJ/bit, 209.9 Mb/mm2
UCIe 3.0 chiplet link: 64 GT/s per IO x 64 IOs for on-chip MRAM access.

A copy of ``repro.memsys.devices``.
"""
from __future__ import annotations

import dataclasses

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class MemDevice:
    name: str
    read_latency_ns: float          # intrinsic access latency t_access
    bandwidth_gibs: float           # per channel/array unit
    read_energy_pj_per_bit: float
    density_mb_per_mm2: float
    cell_bits: int = 1              # logical bits per cell (MLC)

    def bandwidth_bytes(self, units: int = 1) -> float:
        return self.bandwidth_gibs * GiB * units


MRAM = MemDevice("MRAM", read_latency_ns=3.5, bandwidth_gibs=36.57,
                 read_energy_pj_per_bit=1.0, density_mb_per_mm2=66.0)

RERAM_3B = MemDevice("MLC-ReRAM-3b", read_latency_ns=5.0, bandwidth_gibs=1.8,
                     read_energy_pj_per_bit=1.56,
                     density_mb_per_mm2=30.1, cell_bits=3)

# 2-bit mode: fewer levels -> lower BER; density and per-bit energy scale
# with cells/bit (2/3 of the 3-bit-mode density; same current per access).
RERAM_2B = MemDevice("MLC-ReRAM-2b", read_latency_ns=5.0, bandwidth_gibs=1.8,
                     read_energy_pj_per_bit=1.56 * 3.0 / 2.0,
                     density_mb_per_mm2=30.1 * 2.0 / 3.0, cell_bits=2)

LPDDR5 = MemDevice("LPDDR5", read_latency_ns=1.7, bandwidth_gibs=186.26,
                   read_energy_pj_per_bit=3.5, density_mb_per_mm2=209.9)

# NAND Flash: dense cold storage, used only for weight initialization in the
# conventional hierarchy (paper §1); read bandwidth is the PCIe-class limit.
FLASH = MemDevice("Flash", read_latency_ns=25_000.0, bandwidth_gibs=4.0,
                  read_energy_pj_per_bit=2.5, density_mb_per_mm2=1300.0)

# Interconnect energy per bit crossing the package network (Eq. 4 E_network)
E_NETWORK_PJ_PER_BIT = 0.25
# UCIe 3.0 link to the MRAM chiplet: 64 GT/s x 64 IOs = 512 GiB/s ceiling
UCIE_BW_GIBS = 64 * 64 / 8
# Dual-clock FIFO synchronization between memory clock domains [39]
T_SYNC_NS = 3 * 0.303               # 2-4 cycles at 3.3 GHz -> ~1 ns
RERAM_BUS_GHZ = 3.3                 # ReRAM module bus: 3.3 GHz, 64-byte IO
RERAM_BUS_BYTES = 64
