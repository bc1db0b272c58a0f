"""Quickstart: the paper's experiment end-to-end in 30 seconds — one
declarative Cluster, two views of it.

Port of ``examples/quickstart.py``.  A ``Cluster`` described by a single
``FleetSpec`` (the paper's 9-machine heterogeneous testbed profile)
multiplies two matrices for real — each grain through kernel K3 (the CUDA
matmul; on the CPU its plain version) — through the TDA triangle,
verifying the distributed product against the single-machine one.  We then
sweep worker counts in both allotment modes (equal-split vs homogenized,
both through the same facade) and print the Fig-3 style speedup table.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np

from ..cluster import Cluster, FleetSpec, MatmulJob, SimJob
from ..core import PAPER_MACHINES
from ..kernels.matmul.ops import matmul


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs K3's "
                         "plain version)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n = 192
    a = rng.standard_normal((n, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)

    fleet = FleetSpec.from_perfs(PAPER_MACHINES, prefix="sp")
    cluster = Cluster(fleet, device=args.device)

    print("== TDA distributed matmul (homogenized, K3 kernel) ==")
    print(f"fleet: {fleet}")
    for job in range(3):
        rep = cluster.simulate(MatmulJob(a, b, matmul_fn=matmul))
        # Rows actually executed per provider (the runtime's assignment, which
        # drifts from the one-shot plan as grains migrate).
        rows_done = {w: 2 * c for w, c in sorted(rep.shares().items())}
        print(f"job {job}: sim_time={rep.sim_time_s:7.2f}s  "
              f"max|err|={rep.metrics['max_abs_err']:.2e}  "
              f"rows_executed={rows_done}")
        if not rep.metrics["max_abs_err"] < 1e-3:
            raise SystemExit(f"distributed product off by "
                             f"{rep.metrics['max_abs_err']}")

    print("\n== Fig-3 style sweep (size 800, simulated timing) ==")
    # Same facade, static one-shot plans, oracle perfs: homogenized
    # scope-lengths vs the paper's equal-split baseline per worker count.
    def speedup(k: int, homogenize: bool) -> float:
        c = Cluster(fleet.take(k), homogenize=homogenize, adaptive=False,
                    priors="spec", device=args.device)
        return c.simulate(SimJob(size=800)).measured_speedup

    het = [speedup(k, False) for k in range(1, len(fleet) + 1)]
    hom = [speedup(k, True) for k in range(1, len(fleet) + 1)]
    print("workers | equal-split speedup | homogenized speedup")
    for k, (e, h) in enumerate(zip(het, hom, strict=True), start=1):
        bar_e = "#" * int(e * 10)
        bar_h = "*" * int(h * 10)
        print(f"{k:7d} | {e:6.2f} {bar_e:<40s} | {h:6.2f} {bar_h}")
    print(
        f"\nmax equal-split={max(het):.2f} (paper: 2.8) | "
        f"max homogenized={max(hom):.2f} (paper: 3.6) | "
        f"gain={max(hom)/max(het)-1:+.0%}"
    )


if __name__ == "__main__":
    main()
