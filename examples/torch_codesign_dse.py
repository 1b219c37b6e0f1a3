"""Memory-system co-design exploration on the PyTorch port's copy of the
configs and ``memsys`` (paper §3.3.3, Eq. 3-4; counterpart of
``examples/codesign_dse.py``): sweep the MRAM-channel x ReRAM-bank
design space for a full-size SLM, print the feasible frontier and the
chosen configuration, and compare the deployment against the
Jetson-class LPDDR5 baseline and eMEMs. The model is analytic: nothing
runs on a device, so ``--device`` only names where the model's weights
would be served.

  PYTHONPATH=src python examples/torch_codesign_dse.py --arch hymba-1.5b
"""
import argparse
import itertools

from repro_torch.configs import get_config
from repro_torch.core.qconfig import QMCConfig
from repro_torch.memsys import (MemSystemConfig, dse, evaluate_conventional,
                                evaluate_hetero, make_traffic)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--budget", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    qc = QMCConfig(rho=0.3, cell_bits=3)
    traffic = make_traffic(cfg, "qmc", seq_len=args.seq, qmc=qc)

    print(f"== DSE for {args.arch} ({cfg.param_count() / 1e9:.2f}B params, "
          f"seq={args.seq}, budget={args.budget}W) ==")
    print(f"{'mram_ch':>8s} {'reram_bk':>9s} {'power_W':>8s} "
          f"{'lat_ms':>8s} feasible")
    for ch, banks in itertools.product((1, 2, 4, 8, 14), (1, 2, 4, 8, 12)):
        sc = MemSystemConfig(mram_channels=ch, reram_banks=banks,
                             power_budget_w=args.budget)
        r = evaluate_hetero(traffic, sc)
        print(f"{ch:8d} {banks:9d} {r.power_w:8.2f} "
              f"{r.latency_s * 1e3:8.3f} {'yes' if r.feasible else 'NO'}")

    best = dse(traffic, power_budget_w=args.budget)
    r_best = evaluate_hetero(traffic, best)
    print(f"\nchosen: mram_channels={best.mram_channels}, "
          f"reram_banks={best.reram_banks} -> "
          f"{r_best.latency_s * 1e3:.3f} ms/token, "
          f"{r_best.energy_j * 1e3:.2f} mJ/token")

    base = evaluate_conventional(
        make_traffic(cfg, "fp16", seq_len=args.seq, legacy_flash=True),
        MemSystemConfig())
    em = evaluate_hetero(make_traffic(cfg, "emems_mram", seq_len=args.seq),
                         dse(make_traffic(cfg, "emems_mram",
                                          seq_len=args.seq)))
    print(f"\nvs FP16/LPDDR5 : {base.latency_s / r_best.latency_s:6.2f}x "
          f"latency, {base.energy_j / r_best.energy_j:6.2f}x energy, "
          f"{base.capacity_cells / r_best.capacity_cells:6.2f}x memory "
          f"cells")
    print(f"vs eMEMs-MRAM  : {em.latency_s / r_best.latency_s:6.2f}x "
          f"latency, {em.energy_j / r_best.energy_j:6.2f}x energy, "
          f"{em.capacity_cells / r_best.capacity_cells:6.2f}x memory cells")
    assert r_best.feasible, "the chosen configuration must fit the budget"


if __name__ == "__main__":
    main()
