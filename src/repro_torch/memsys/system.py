"""Heterogeneous memory-system evaluation — paper Eq. (3) latency model,

Eq. (4) power constraint, and the capacity/area accounting of §4.2.3.

A `MemSystem` assigns the traffic streams to devices:

  * conventional (Jetson-class): weights + KV + activations all on LPDDR5
    (bandwidth contention: one shared bus), optional Flash residency.
  * QMC heterogeneous: outliers -> on-chip MRAM (UCIe-capped), inliers ->
    off-chip MLC ReRAM (bus-capped), KV/activations -> LPDDR5, all fetched
    concurrently and merged: T_final = max(T_i) + T_sync.
  * eMEMs homogeneous: all weights in a single NVM + KV on LPDDR5.

A copy of ``repro.memsys.system``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.memsys import devices as dv
from repro_torch.memsys.workload import Traffic

NS = 1e-9
PJ = 1e-12


@dataclasses.dataclass(frozen=True)
class MemSystemConfig:
    """A point in the design space: bandwidth allocation per device."""
    mram_channels: int = 8           # x 36.57 GiB/s, capped by UCIe
    reram_banks: int = 4             # x 32 arrays x 1.8 GiB/s each
    reram_cell_bits: int = 3
    lpddr_channels: int = 1          # x 186.26 GiB/s (Jetson-class: 1)
    t_queue_ns: float = 10.0
    power_budget_w: float = 8.0

    @property
    def mram_bw(self) -> float:      # bytes/s
        raw = dv.MRAM.bandwidth_bytes(self.mram_channels)
        return min(raw, dv.UCIE_BW_GIBS * dv.GiB)

    @property
    def reram_bw(self) -> float:
        per_bank = dv.RERAM_3B.bandwidth_bytes(32)
        bus = dv.RERAM_BUS_GHZ * 1e9 * dv.RERAM_BUS_BYTES
        return min(per_bank * self.reram_banks, 2 * bus)

    @property
    def lpddr_bw(self) -> float:
        return dv.LPDDR5.bandwidth_bytes(self.lpddr_channels)

    @property
    def reram_dev(self) -> dv.MemDevice:
        return dv.RERAM_3B if self.reram_cell_bits == 3 else dv.RERAM_2B


@dataclasses.dataclass
class EvalResult:
    name: str
    latency_s: float                 # per decode step
    energy_j: float                  # per decode step
    capacity_cells: float            # memory cells for weight residency
    external_bits: float             # off-chip transferred bits per step
    area_mm2: float
    power_w: float                   # sustained memory read power
    feasible: bool

    def row(self):
        return (f"{self.name:14s} lat={self.latency_s*1e3:8.3f}ms "
                f"energy={self.energy_j*1e3:8.3f}mJ "
                f"cells={self.capacity_cells/8/1024**2:9.1f}MB-eq "
                f"ext={self.external_bits/8/1024**2:8.1f}MB "
                f"area={self.area_mm2:7.1f}mm2 "
                f"power={self.power_w:5.2f}W")


def _stream_time(bits: float, bw_bytes: float, t_access_ns: float,
                 t_queue_ns: float) -> float:
    """Eq. (3): T = t_access + s/b + t_queue."""
    if bits <= 0:
        return 0.0
    return t_access_ns * NS + (bits / 8.0) / bw_bytes + t_queue_ns * NS


def evaluate_conventional(traffic: Traffic, sys_cfg: MemSystemConfig,
                          legacy_flash: bool = True) -> EvalResult:
    """Jetson-class baseline: one LPDDR5 bus serves weights + KV + acts."""
    total_bits = (traffic.weight_bits + traffic.kv_bits + traffic.act_bits)
    lat = _stream_time(total_bits, sys_cfg.lpddr_bw,
                       dv.LPDDR5.read_latency_ns, sys_cfg.t_queue_ns)
    energy = total_bits * (dv.LPDDR5.read_energy_pj_per_bit
                           + dv.E_NETWORK_PJ_PER_BIT) * PJ
    cells = traffic.weight_cells_inlier + traffic.weight_cells_outlier
    if legacy_flash and traffic.flash_resident_bits:
        cells += traffic.flash_resident_bits      # Flash copy of the weights
    area = (traffic.dram_resident_bits / 1e6 / 8 * 8
            / dv.LPDDR5.density_mb_per_mm2 / 8) \
        + (traffic.flash_resident_bits / 8e6 / dv.FLASH.density_mb_per_mm2
           if legacy_flash else 0.0)
    power = total_bits / lat * (dv.LPDDR5.read_energy_pj_per_bit
                                + dv.E_NETWORK_PJ_PER_BIT) * PJ \
        if lat > 0 else 0.0
    return EvalResult(traffic.name, lat, energy, cells,
                      external_bits=total_bits, area_mm2=area, power_w=power,
                      feasible=True)


def evaluate_hetero(traffic: Traffic, sys_cfg: MemSystemConfig
                    ) -> EvalResult:
    """QMC / eMEMs: NVM weight streams in parallel with the LPDDR5 KV path.

    T_final = max(T_mram, T_reram, T_lpddr) + T_sync  (Eq. 3)
    P = BW_m (E_m + E_net) + BW_r (E_r + E_net)       (Eq. 4)
    """
    rdev = sys_cfg.reram_dev
    t_m = _stream_time(traffic.weight_bits_outlier, sys_cfg.mram_bw,
                       dv.MRAM.read_latency_ns, sys_cfg.t_queue_ns)
    t_r = _stream_time(traffic.weight_bits_inlier, sys_cfg.reram_bw,
                       rdev.read_latency_ns, sys_cfg.t_queue_ns)
    t_d = _stream_time(traffic.kv_bits + traffic.act_bits, sys_cfg.lpddr_bw,
                       dv.LPDDR5.read_latency_ns, sys_cfg.t_queue_ns)
    lat = max(t_m, t_r, t_d) + dv.T_SYNC_NS * NS

    e_m = traffic.weight_bits_outlier * (dv.MRAM.read_energy_pj_per_bit
                                         + dv.E_NETWORK_PJ_PER_BIT)
    e_r = traffic.weight_bits_inlier * (rdev.read_energy_pj_per_bit
                                        + dv.E_NETWORK_PJ_PER_BIT)
    e_d = (traffic.kv_bits + traffic.act_bits) \
        * (dv.LPDDR5.read_energy_pj_per_bit + dv.E_NETWORK_PJ_PER_BIT)
    energy = (e_m + e_r + e_d) * PJ

    # Eq. (4): sustained power of the two weight streams
    power = (sys_cfg.mram_bw * 8 * (dv.MRAM.read_energy_pj_per_bit
                                    + dv.E_NETWORK_PJ_PER_BIT)
             + sys_cfg.reram_bw * 8 * (rdev.read_energy_pj_per_bit
                                       + dv.E_NETWORK_PJ_PER_BIT)) * PJ
    feasible = power <= sys_cfg.power_budget_w

    cells = traffic.weight_cells_inlier + traffic.weight_cells_outlier
    # area: MRAM cells are 1 bit each; ReRAM density is quoted in logical
    # Mb/mm2 for the given MLC mode (cells * cell_bits = logical bits)
    mram_mb = traffic.weight_cells_outlier / 1e6
    reram_mb = traffic.weight_cells_inlier * rdev.cell_bits / 1e6
    area = mram_mb / dv.MRAM.density_mb_per_mm2 \
        + reram_mb / rdev.density_mb_per_mm2
    external = traffic.weight_bits_inlier + traffic.kv_bits \
        + traffic.act_bits            # MRAM is on-chip -> not external
    return EvalResult(traffic.name, lat, energy, cells, external, area,
                      power, feasible)


def dse(traffic: Traffic, *, cell_bits: int = 3, power_budget_w: float = 8.0,
        t_queue_ns: float = 10.0) -> Optional[MemSystemConfig]:
    """§3.3.3: sweep discrete MRAM/ReRAM bandwidth configs, drop the ones

    violating the power budget, pick the latency-minimal survivor."""
    best, best_lat = None, float("inf")
    for ch, banks in itertools.product(range(1, 15), range(1, 13)):
        cfgp = MemSystemConfig(mram_channels=ch, reram_banks=banks,
                               reram_cell_bits=cell_bits,
                               t_queue_ns=t_queue_ns,
                               power_budget_w=power_budget_w)
        r = evaluate_hetero(traffic, cfgp)
        if not r.feasible:
            continue
        if r.latency_s < best_lat:
            best, best_lat = cfgp, r.latency_s
    return best
