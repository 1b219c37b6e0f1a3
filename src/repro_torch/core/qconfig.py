"""Quantization configuration dataclasses (a copy of the QMC parts of
``repro.core.qconfig``; the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Discrete MLC-ReRAM perturbation model (paper §3.4).

    A stored code flips by ±1 step with probabilities (p_minus, p_plus)
    determined by the device BER of the chosen MLC mode: 3-bit cells have
    tighter level spacing and therefore a higher adjacent-state error rate
    than 2-bit cells.
    """

    cell_bits: int = 3            # MLC mode: 3-bit or 2-bit cells
    p_minus: float = 0.015        # P(code -> code-1)
    p_plus: float = 0.015         # P(code -> code+1)

    @property
    def p_flip(self) -> float:
        return self.p_minus + self.p_plus

    @staticmethod
    def for_mode(cell_bits: int) -> "NoiseModel":
        if cell_bits == 3:
            return NoiseModel(cell_bits=3, p_minus=0.015, p_plus=0.015)
        if cell_bits == 2:
            return NoiseModel(cell_bits=2, p_minus=0.002, p_plus=0.002)
        raise ValueError(f"unsupported MLC mode: {cell_bits}-bit cells")


@dataclasses.dataclass(frozen=True)
class QMCConfig:
    """Configuration for Algorithm 1 (Outlier-Aware Robust Quantization)."""

    rho: float = 0.3              # outlier ratio (fraction of |W| kept high-prec)
    bits_in: int = 3              # logical bits for ReRAM-resident inliers
    bits_out: int = 5             # logical bits for MRAM-resident outliers
    cell_bits: int = 3            # MLC mode (noise model + capacity accounting)
    granularity: str = "scalar"   # "scalar" (paper-faithful) | "subtile"
    subtile: tuple = (8, 128)     # subtile granule of the structured variant
    # Scale search: candidates are alpha * s_minmax for alpha on this grid.
    scale_grid_lo: float = 0.30
    scale_grid_hi: float = 1.05
    scale_grid_n: int = 48
    channel_axis: int = -1        # per-channel axis (output channels)

    @property
    def noise(self) -> NoiseModel:
        return NoiseModel.for_mode(self.cell_bits)

    @property
    def avg_bits(self) -> float:
        """Logical bits/weight (memory-cell accounting, paper's 4.44x)."""
        return (1.0 - self.rho) * self.bits_in + self.rho * self.bits_out

    @property
    def compression_vs_fp16(self) -> float:
        return 16.0 / self.avg_bits
