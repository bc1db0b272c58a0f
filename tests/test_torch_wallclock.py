"""The port's wall-clock backend behind the ExecutionBackend seam, on the CPU.

Mirrors the tier-1 cases of ``tests/test_wallclock.py`` with the
reference's bands (training waits for the port's training slice), runs
them on ``device="cpu"`` and holds what is deterministic to the JAX
package: the sim reports, the repeats and time-scale arithmetic, the
calibrate CLI's sim mode.  Measured runs use one intra-op thread: a host
timer around multithreaded CPU products jitters with the machine's other
load, and the agreement band is the reference's.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from repro.cluster import Cluster as JaxCluster
from repro.cluster import SimJob as JaxSimJob
from repro.cluster import profiles as JaxP
from repro.core import WallclockBackend as JaxWallclockBackend
from repro_torch.cluster import Cluster, MatmulJob, ServeJob, SimJob
from repro_torch.cluster import profiles as P
from repro_torch.core import (
    AsyncRuntime,
    ExecutionBackend,
    SimBackend,
    SimWorker,
    WallclockBackend,
    wallclock,
)
from repro_torch.serve import Request

FLEET = "4:3:2:1"
CPU = [torch.device("cpu")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _report_fields(rep):
    return (
        rep.sim_time_s, rep.work_done, rep.predicted_speedup,
        rep.measured_speedup, rep.backend,
        tuple((p.sim_time_s, p.work, p.quality, p.n_migrated)
              for p in rep.phases),
    )


# ---------------------------------------------------------------- seam: sim
def test_sim_backend_is_default_and_identical():
    job = SimJob(size=64, n_jobs=2)
    sc = "halve:w0@50%"
    rep_default = Cluster(FLEET, priors="spec", device="cpu").simulate(
        job, scenario=sc)
    rep_explicit = Cluster(FLEET, priors="spec", backend="sim",
                           device="cpu").simulate(job, scenario=sc)
    ref = JaxCluster(FLEET, priors="spec").simulate(
        JaxSimJob(size=64, n_jobs=2), scenario=sc)
    assert rep_default.backend == "sim"
    assert _report_fields(rep_default) == _report_fields(rep_explicit) == \
        _report_fields(ref)


def test_raw_runtime_explicit_sim_backend_identical():
    def run(backend):
        workers = [SimWorker(f"w{i}", p) for i, p in enumerate((4, 3, 2, 1))]
        return AsyncRuntime(workers, backend=backend).run(40, grain_cost=1.0)

    t0, t1, t2 = (run(b).makespan
                  for b in (None, SimBackend(), ExecutionBackend()))
    assert t0 == t1 == t2


def test_eta_mode_recompute_matches_incremental():
    job = SimJob(size=64)
    inc = Cluster(FLEET, eta_mode="incremental", device="cpu").simulate(job)
    rec = Cluster(FLEET, eta_mode="recompute", device="cpu").simulate(job)
    assert inc.sim_time_s == rec.sim_time_s


# ------------------------------------------------------------- validation
def test_unknown_backend_actionable():
    with pytest.raises(ValueError, match="wallclock"):
        Cluster(FLEET, backend="warp", device="cpu")
    with pytest.raises(TypeError, match="ExecutionBackend"):
        Cluster(FLEET, backend=42, device="cpu")


def test_unknown_eta_mode_actionable():
    with pytest.raises(ValueError, match="incremental"):
        Cluster(FLEET, eta_mode="exact", device="cpu")
    assert Cluster(FLEET, eta_mode=None, device="cpu").eta_mode is None


def test_serve_scenario_rejected_under_wallclock():
    cluster = Cluster("2x2:1x2", backend="wallclock", device="cpu")
    reqs = [Request(i, [1, 2, 3], 2) for i in range(4)]
    with pytest.raises(ValueError, match="scenario"):
        cluster.serve(ServeJob(reqs), scenario="halve:w0@50%")


# --------------------------------------------------------- wallclock smoke
def test_wallclock_repeats_emulate_heterogeneity():
    wb = WallclockBackend(calibration_reps=4, devices=CPU)
    assert [wb.repeats(1.0, p, 1.0) for p in (4, 3, 2, 1)] == [3, 4, 6, 12]
    assert wb.time_scale(2.0) == pytest.approx(12 * wb.unit_s / 2.0)
    assert wb.grain_seconds(1.0, 1.0, 1.0) == pytest.approx(12 * wb.unit_s)
    # The arithmetic is the reference's, at any cost, perf and reference:
    # the reference's methods, run on the port backend's own state (a JAX
    # backend would calibrate JAX devices, tens of seconds under load).
    ref = JaxWallclockBackend
    grid = [(c, p, r) for c in (0.5, 1.0, 2.0, 7.0) for p in (0.3, 1.0, 2.5, 4.0)
            for r in (None, 1.0, 3.0)]
    assert [wb.repeats(*g) for g in grid] == [ref.repeats(wb, *g) for g in grid]
    for c in (0.5, 2.0, 96.0):
        assert wb.time_scale(c) == ref.time_scale(wb, c)
        assert wb.grain_seconds(c, 2.5) == ref.grain_seconds(wb, c, 2.5)


def test_wallclock_simulate_smoke():
    rep = Cluster(FLEET, priors="spec", backend="wallclock",
                  device="cpu").simulate(SimJob(size=48))
    assert rep.backend == "wallclock[1d]"
    assert rep.measured_speedup > 0
    assert "wallclock/cpu" in rep.metrics["wallclock"]
    assert rep.work_done == 48


def test_wallclock_shared_across_jobs():
    cluster = Cluster("2:1", backend="wallclock", device="cpu")
    r1 = cluster.simulate(SimJob(size=12))
    r2 = cluster.simulate(SimJob(size=12))
    assert r1.backend == r2.backend
    assert cluster._wallclock is not None
    assert cluster._wallclock.device_index("w0") == \
        cluster._wallclock.device_index("w0")


def test_wallclock_matmul_values_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 8)).astype(np.float32)
    b = rng.standard_normal((8, 6)).astype(np.float32)
    rep = Cluster("2:1", backend="wallclock", device="cpu").simulate(
        MatmulJob(a, b))
    assert rep.backend == "wallclock[1d]"
    assert rep.metrics["max_abs_err"] == 0.0
    assert torch.equal(rep.artifact, torch.from_numpy(a) @ torch.from_numpy(b))


def test_wallclock_kill_scenario_conserves_work():
    rep = Cluster(FLEET, priors="spec", backend="wallclock",
                  device="cpu").simulate(SimJob(size=48),
                                         scenario="kill:w0@50%")
    assert rep.work_done == 48
    assert rep.measured_speedup > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_wallclock_overlap_modes_measure(overlap):
    wb = WallclockBackend(calibration_reps=4, devices=CPU, overlap=overlap)
    rep = Cluster("2:1", backend=wb, device="cpu").simulate(SimJob(size=12))
    stats = wb.stats()
    assert rep.work_done == 12 and stats.n_launched == 12
    assert stats.overlap is overlap and stats.platform == "cpu"
    assert rep.measured_speedup > 0


# ------------------------------------------- the unit op's compiled route
def _eager_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    h = x
    for _ in range(k):
        h = torch.tanh(h @ x)
    return h


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 12])
def test_unit_chain_gives_the_eager_chain(k):
    """The compiled route's chain (three graphs over two buffers; on the
    CPU each graph's step runs eagerly) gives the eager chain's values bit
    for bit, one graph call a unit op, and a chain after a longer one
    still starts from ``x``."""
    x = torch.randn((16, 16), generator=torch.Generator().manual_seed(k))
    chain = wallclock._UnitChain(x / 4.0)
    for n in (k + 3, k):
        got = chain.run(n)
        assert torch.equal(got, _eager_chain(x / 4.0, n))
    calls = chain.first.calls + chain.ab.calls + chain.ba.calls
    assert calls == 2 * k + 3 and chain.first.calls == 2
    assert chain.ab.calls - chain.ba.calls in (0, 1, 2)


@pytest.mark.parametrize("compile_op", [True, False])
def test_wallclock_cpu_unit_op_stays_eager(compile_op):
    """On the CPU either setting keeps today's eager route (no chain is
    captured), and a grain's chain ends where the compiled route's chain
    over the same operand ends."""
    wb = WallclockBackend(calibration_reps=4, devices=CPU,
                          compile_op=compile_op)
    assert wb.compile_op is compile_op and wb._chains == [None]
    worker = SimWorker("w0", 2.0)
    handle = wb.launch(None, worker, 0, 1.0, 0.0)
    assert handle.k == wb.repeats(1.0, 2.0) and handle.measured > 0
    want = wallclock._UnitChain(wb._x[0]).run(handle.k)
    assert torch.equal(handle.value, want)
    assert wb._streams == {}


def test_wallclock_compiled_route_runs_through_the_chain():
    """A backend whose chain is the compiled route's (forced on the CPU,
    where it is captured nowhere) runs each grain as that many graph
    calls, with the eager backend's values and repeats."""
    fast = WallclockBackend(calibration_reps=4, devices=CPU)
    slow = WallclockBackend(calibration_reps=4, devices=CPU,
                            compile_op=False)
    chain = fast._chains[0] = wallclock._UnitChain(fast._x[0])
    done = 0
    for grain, perf in enumerate((4.0, 3.0, 2.0, 1.0)):
        worker = SimWorker(f"w{grain}", perf)
        a = fast.launch(None, worker, grain, 1.0, 0.0)
        b = slow.launch(None, worker, grain, 1.0, 0.0)
        done += a.k
        assert a.k == b.k and torch.equal(a.value, b.value)
        assert chain.first.calls + chain.ab.calls + chain.ba.calls == done


# ----------------------------------------------- sim-vs-wallclock agreement
def test_tiny_fleet_sim_wallclock_agreement():
    # The reference's band and assertions, held by the median of three
    # measured runs, each at ten times the reference's grains after a
    # calibration chain of ~0.1 s.  A single run compares the host's load
    # during its calibration chain with the load during its job; under
    # ``pytest -n 6`` that load shifts between the two, and one run in a few
    # dozen strays outside the band.
    job = SimJob(size=480)
    sim = Cluster("2:1", priors="spec", default_profile="local",
                  device="cpu").simulate(job)
    runs = []
    for _ in range(3):
        wb = WallclockBackend(calibration_reps=1000, devices=CPU)
        runs.append(Cluster("2:1", priors="spec", backend=wb,
                            device="cpu").simulate(job).measured_speedup)
    measured = sorted(runs)[1]
    pred = sim.predicted_speedup
    assert pred == pytest.approx(1.5, rel=1e-3)  # N_H of a 2:1 fleet
    assert abs(measured - pred) / pred < 0.5, runs
    assert measured > 1.0, runs                # beats the best solo worker


# ------------------------------------------------------------- calibration
def test_calibrate_cli_sim_mode(tmp_path, capsys):
    from repro.launch.calibrate import main as jax_main
    from repro_torch.launch.calibrate import main

    argv = ["--backend", "sim", "--name", "test-cal", "--loads", "100,200,400"]
    try:
        jax_main(argv + ["--out", str(tmp_path / "ref.json")])
        want = capsys.readouterr().out
        main(argv + ["--out", str(tmp_path / "cal.json")])
        got = capsys.readouterr().out
        prof = P.get_profile("test-cal")
        assert prof.overhead_slope == pytest.approx(
            P.get_profile(None).overhead_slope)
        assert got.replace("cal.json", "ref.json") == want
        assert "slope" in got
        data = json.loads((tmp_path / "cal.json").read_text())
        assert data == json.loads((tmp_path / "ref.json").read_text())
        assert data["profiles"][0]["name"] == "test-cal"
    finally:
        P.PROFILES.pop("test-cal", None)
        JaxP.PROFILES.pop("test-cal", None)


def test_calibrate_cli_needs_two_loads():
    from repro_torch.launch.calibrate import main

    with pytest.raises(SystemExit, match="loads"):
        main(["--backend", "sim", "--loads", "100"])


def test_calibrate_wallclock_on_cpu():
    from repro_torch.launch.calibrate import measure_wallclock_overhead

    samples, band, n = measure_wallclock_overhead(
        [64, 256], repeats=2, devices=CPU)
    assert n == 1 and [s[0] for s in samples] == [64.0, 256.0]
    assert all(s[1] > 0 for s in samples)
    assert 0 < band[0] < band[1] == pytest.approx(4 * band[0])


# -------------------------------------------------------- launcher plumbing
def test_backend_args_make_backend():
    from repro_torch.launch.common import add_backend_args, make_backend

    ap = argparse.ArgumentParser()
    add_backend_args(ap)
    ap.add_argument("--device", default=None)
    assert make_backend(ap.parse_args([])) == "sim"
    wb = make_backend(ap.parse_args(["--backend", "wallclock",
                                     "--device", "cpu"]))
    assert isinstance(wb, WallclockBackend) and wb.devices == CPU
    assert Cluster("2:1", backend=wb, device="cpu")._backend_label() == \
        "wallclock[1d]"
    with pytest.raises(ValueError, match="one device"):
        make_backend(ap.parse_args(["--backend", "wallclock", "--device",
                                    "cpu", "--devices", "2"]))
