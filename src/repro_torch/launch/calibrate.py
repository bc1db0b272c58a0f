"""Calibration CLI: measured (load, overhead) samples -> BackendProfile refit.

Port of ``repro/launch/calibrate.py`` with the same flags, plus ``--device``
(default ``cuda``; ``--device cpu`` measures host copies, for the tests).
Where the reference times ``jax.device_put`` of the load split across N
host-platform devices, this times host-to-device copies of the load split
across the CUDA devices the port can see (``--devices`` of them, all
visible by default).  One card gives one chunk: the whole (L, width) block
crosses to ``cuda:0``.  The reference's description follows.

The profile registry ships with *synthesized* calibration sweeps (slopes
picked per backend class, ripple added so the fit is a real regression).
This CLI replaces them with measurements from the machine it runs on:

  PYTHONPATH=src python -m repro_torch.launch.calibrate --backend wallclock \
      --out calibration.json

For ``--backend wallclock`` each load L is distributed for real: an
(L, width) float32 block is split across the devices and the wall time of
the scatter (copy to each device + wait for it) is one
(load, overhead_seconds) sample — the experiment the paper runs once for its
Ethernet, § "calibrating M".  The samples are refit through the same
least-squares slope as every built-in profile, and the profile's
``perf_band`` is set from the measured unit-op throughput so
``select_profile`` prefers this narrow *measured* band over the synthesized
class bands.  ``--backend sim`` re-records a registered profile's modeled
sweep instead (a provenance-tagged copy of the synthesized default, useful
as the comparison row next to a wallclock run).

``--out`` saves the refit profile(s) with ``cluster.profiles.save_profiles``;
a later run restores them with ``load_profiles`` — no magic constants
cross runs, only measurements.
"""

from __future__ import annotations

import argparse
from time import perf_counter

from ..cluster.profiles import get_profile, refit_profile, save_profiles

__all__ = ["measure_wallclock_overhead", "main"]


def measure_wallclock_overhead(
    loads, repeats: int = 3, width: int = 64, devices: list | None = None,
) -> tuple[list[tuple[float, float]], tuple[float, float], int]:
    """Measure distribution overhead per load on ``devices`` (default:
    every visible CUDA device — one on a one-card machine, which then takes
    the whole load).

    Returns ``(samples, perf_band, n_devices)``: samples are measured
    (load, overhead_seconds) pairs (best of ``repeats``, jitter-robust);
    ``perf_band`` brackets the measured per-device reference-grain
    throughput (work-units/sec in *wall* time) at a factor of two each way.
    """
    import numpy as np
    import torch

    from ..core.wallclock import WallclockBackend, wallclock_devices

    devs = list(devices) if devices is not None else wallclock_devices()
    n = len(devs)

    def scatter(chunks):
        parts = [torch.from_numpy(c).to(d, copy=True)
                 for c, d in zip(chunks, devs)]
        for p in parts:
            if p.device.type == "cuda":
                torch.cuda.current_stream(p.device).synchronize()
        return parts

    samples: list[tuple[float, float]] = []
    for load in loads:
        host = np.ones((max(int(load), n), width), dtype=np.float32)
        chunks = np.array_split(host, n)
        scatter(chunks)                         # warm the transfer path
        best = float("inf")
        for _ in range(max(repeats, 1)):
            t0 = perf_counter()
            scatter(chunks)
            best = min(best, perf_counter() - t0)
        samples.append((float(load), best))
    # The band: measured reference-grain throughput on one device.  A
    # factor-of-two bracket keeps the band narrow, so select_profile
    # prefers it over the synthesized class bands (narrowest-covering rule).
    wb = WallclockBackend(devices=devs)
    thr = 1.0 / max(wb.base_repeats * wb.unit_s, 1e-12)
    return samples, (thr / 2.0, thr * 2.0), n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="refit BackendProfile bands from measured samples")
    ap.add_argument("--backend", choices=("sim", "wallclock"),
                    default="wallclock",
                    help="wallclock: measure real host-to-device scatter "
                         "per load; sim: re-record a registered profile's "
                         "modeled sweep")
    ap.add_argument("--loads", default="200,400,600,800,1000",
                    help="comma-separated load sweep (work units)")
    ap.add_argument("--name", default=None,
                    help="profile name to register (default: "
                         "'wallclock-host' / 'sim-<profile>')")
    ap.add_argument("--profile", default=None,
                    help="sim backend: source profile to re-record "
                         "(default: the registry default)")
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices to scatter across (wallclock; "
                         "default: every visible device)")
    ap.add_argument("--device", default=None,
                    help="torch device to measure on (default: cuda; "
                         "'cpu' measures host copies)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="measurements per load; best (min) is recorded")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="save the refit profile as JSON "
                         "(cluster.profiles.load_profiles restores it)")
    args = ap.parse_args(argv)

    loads = [float(s) for s in args.loads.split(",") if s.strip()]
    if len(loads) < 2:
        raise SystemExit("--loads needs >= 2 samples for a slope fit")

    if args.backend == "wallclock":
        from ..core.wallclock import wallclock_devices

        devs = wallclock_devices(args.device, args.devices)
        samples, band, n = measure_wallclock_overhead(
            loads, repeats=args.repeats, devices=devs)
        name = args.name or "wallclock-host"
        desc = (f"measured host-to-device scatter across {n} "
                f"{devs[0].type} device(s)")
    else:
        src = get_profile(args.profile)
        samples = [(load, src.overhead(load)) for load in loads]
        band = src.perf_band
        name = args.name or f"sim-{src.name}"
        desc = f"re-recorded modeled sweep of profile {src.name!r}"

    prof = refit_profile(name, samples, perf_band=band, description=desc)
    band_s = (f"({prof.perf_band[0]:.3g}, {prof.perf_band[1]:.3g})"
              if prof.perf_band else "none (opted out of auto-selection)")
    print(f"profile {prof.name!r}: slope M={prof.overhead_slope:.4g} "
          f"fit from {len(samples)} measured samples, perf_band={band_s}")
    for load, ovh in samples:
        print(f"  load {load:8.0f} -> overhead {ovh * 1e3:9.4f} ms")
    if args.out:
        save_profiles(args.out, [name])
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
