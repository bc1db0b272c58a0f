"""Port parity: the TDA triangle and ``Cluster.simulate(MatmulJob)`` of
``repro_torch`` against the JAX package, on the same numpy inputs, on the
CPU.

The setups are the reference's own (``tests/test_runtime.py``,
``tests/test_cluster.py``, ``tests/test_coord.py``, ``examples/
quickstart.py``): a provider killed mid-job, a perf drop, per-provider link
profiles, the facade with two jobs, a coordinator killed under ``/c2``, and
the paper's fleet with the matmul op.  The copied control plane must make
the same decisions, so shares, ``executed_by``, the sim clock, the phase
overheads and the coordinator stats are equal, not close.  The product
equals the port's own single ``a @ b`` bit for bit (torch's CPU product is
row-slice invariant at these shapes, and the plain matmul op is so at any
shape) and the JAX (numpy) product within f32 tolerance: the two libraries
sum in different orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.cluster import Cluster as JaxCluster
from repro.cluster import FleetSpec as JaxFleetSpec
from repro.cluster import MatmulJob as JaxMatmulJob
from repro.cluster import SimJob as JaxSimJob
from repro.core import PAPER_MACHINES as JAX_PAPER_MACHINES
from repro.core import ServiceProvider as JaxServiceProvider
from repro.core import TDAServer as JaxTDAServer
from repro.core import ThinClient as JaxThinClient
from repro.core import TimelineEvent as JaxTimelineEvent
from repro_torch.cluster import Cluster, FleetSpec, MatmulJob, SimJob
from repro_torch.cluster.profiles import PROFILES
from repro_torch.core import (
    PAPER_MACHINES,
    ServiceProvider,
    TDAServer,
    ThinClient,
    TimelineEvent,
)
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul.ops import matmul as port_matmul

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)   # two libraries' f32 summation orders


def _ab(seed, n, k, m):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((k, m)).astype(np.float32))


def _check_product(out, a, b):
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(out, ta @ tb)
    np.testing.assert_allclose(out.numpy(), a @ b, **F32)


def _run_pair(perfs, a, b, timeline=(), warm=False, profile=None):
    """The same ThinClient job through both packages."""
    runs = []
    for SP, Server, Client, Ev, kw in (
        (JaxServiceProvider, JaxTDAServer, JaxThinClient, JaxTimelineEvent, {}),
        (ServiceProvider, TDAServer, ThinClient, TimelineEvent,
         {"device": "cpu"}),
    ):
        providers = [SP(f"sp{i}", p, profile=profile)
                     for i, p in enumerate(perfs)]
        client = Client(Server(providers), **kw)
        if warm:
            client.matmul(a, b)
        events = tuple(Ev(*e[:3], **e[3]) for e in timeline)
        out, t = client.matmul(a, b, timeline=events)
        runs.append((out, t, client.last_result))
    return runs


def _same_schedule(jres, tres):
    assert tres.shares() == jres.shares()
    assert tres.executed_by == jres.executed_by
    assert (tres.makespan, tres.end_s, tres.n_migrated) == \
        (jres.makespan, jres.end_s, jres.n_migrated)


def test_worker_death_midjob_matches_reference():
    a, b = _ab(7, 120, 48, 36)
    (jout, jt, jres), (out, t, res) = _run_pair(
        [1.0, 1.0, 1.0], a, b, timeline=((2.0, "kill", "sp1", {}),))
    assert sorted(res.executed_by) == list(range(60))      # 2-row grains
    _same_schedule(jres, res)
    assert t == jt > 0
    _check_product(out, a, b)


def test_perf_drop_midjob_matches_reference():
    a, b = _ab(8, 200, 32, 32)
    (jout, jt, jres), (out, t, res) = _run_pair(
        [2.0] * 4, a, b, warm=True,
        timeline=((0.5, "perf", "sp0", {"perf": 0.2}),))
    _same_schedule(jres, res)
    assert t == jt
    shares = res.shares()
    assert shares["sp0"] < min(shares[f"sp{i}"] for i in (1, 2, 3))
    assert res.homogenization_quality() == jres.homogenization_quality()
    _check_product(out, a, b)


@pytest.mark.parametrize("profile", [None, "paper-ethernet", "dcn"])
def test_profile_distribution_overhead_matches_reference(profile):
    a, b = _ab(0, 32, 8, 8)
    (jout, jt, jres), (out, t, res) = _run_pair([2.0, 2.0], a, b,
                                                 profile=profile)
    _same_schedule(jres, res)
    assert t - res.makespan == jt - jres.makespan
    if profile is not None:
        assert t - res.makespan == pytest.approx(
            32 / PROFILES[profile].overhead_slope, rel=1e-6)
    _check_product(out, a, b)


def _phase_view(rep):
    return [(p.label, p.index, p.work, p.sim_time_s, dict(p.shares),
             p.n_migrated, p.quality, p.metrics.get("overhead_s"),
             p.metrics.get("compute_s")) for p in rep.phases]


def _same_report(jrep, trep):
    assert _phase_view(trep) == _phase_view(jrep)
    assert (trep.sim_time_s, trep.work_done, trep.predicted_speedup,
            trep.measured_speedup, trep.backend) == \
        (jrep.sim_time_s, jrep.work_done, jrep.predicted_speedup,
         jrep.measured_speedup, jrep.backend)
    assert trep.shares() == jrep.shares()


def test_facade_matmul_job_matches_reference():
    a, b = _ab(1, 24, 8, 8)
    fleet = "2@dcn,2@dcn,1@dcn"
    jc = JaxCluster(fleet)
    tc = Cluster(fleet, device="cpu")
    jrep = jc.simulate(JaxMatmulJob(a, b, n_jobs=2))
    trep = tc.simulate(MatmulJob(a, b, n_jobs=2))
    _same_report(jrep, trep)
    assert tc._tda_client.last_result.executed_by == \
        jc._tda_client.last_result.executed_by
    assert sum(trep.shares().values()) == 2 * 12
    assert trep.metrics["max_abs_err"] == 0.0
    assert trep.metrics["n"] == jrep.metrics["n"] == 24
    _check_product(trep.artifact, a, b)


def test_matmul_job_accepts_tensors():
    a, b = _ab(2, 24, 8, 8)
    rep = Cluster("2:1", device="cpu").simulate(
        MatmulJob(torch.from_numpy(a), torch.from_numpy(b)))
    _check_product(rep.artifact, a, b)


@pytest.mark.parametrize("scenario", [None, "ckill:0@25%"])
def test_ckill_c2_matches_reference(scenario):
    a, b = _ab(3, 80, 24, 24)
    fleet = "1*8/c2"
    jrep = JaxCluster(fleet, priors="spec").simulate(
        JaxMatmulJob(a, b), scenario=scenario)
    trep = Cluster(fleet, priors="spec", device="cpu").simulate(
        MatmulJob(a, b), scenario=scenario)
    _same_report(jrep, trep)
    assert dataclasses.asdict(trep.coord) == dataclasses.asdict(jrep.coord)
    assert trep.coord.takeovers == (1 if scenario else 0)
    assert trep.metrics["max_abs_err"] == 0.0
    _check_product(trep.artifact, a, b)


def test_quickstart_paper_fleet_with_matmul_op_matches_reference():
    """The quickstart: the paper's 9 machines, three jobs, the matmul op as
    ``matmul_fn`` (its plain version on the CPU: no kernel launch)."""
    assert PAPER_MACHINES == JAX_PAPER_MACHINES
    a, b = _ab(0, 192, 64, 64)
    jc = JaxCluster(JaxFleetSpec.from_perfs(JAX_PAPER_MACHINES, prefix="sp"))
    tc = Cluster(FleetSpec.from_perfs(PAPER_MACHINES, prefix="sp"),
                 device="cpu")
    before = dict(mm.LAUNCHES)
    for _ in range(3):
        jrep = jc.simulate(JaxMatmulJob(a, b))
        trep = tc.simulate(MatmulJob(a, b, matmul_fn=port_matmul))
        _same_report(jrep, trep)
        assert tc._tda_client.last_result.executed_by == \
            jc._tda_client.last_result.executed_by
        np.testing.assert_allclose(trep.artifact.numpy(), jrep.artifact, **F32)
    assert mm.LAUNCHES == before
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(trep.artifact, port_matmul(ta, tb))


def test_fig3_sweep_matches_reference():
    """The quickstart's Fig-3 sweep: equal-split and homogenized speedups per
    worker count over the paper's fleet, equal to the reference's."""
    jfleet = JaxFleetSpec.from_perfs(JAX_PAPER_MACHINES, prefix="sp")
    tfleet = FleetSpec.from_perfs(PAPER_MACHINES, prefix="sp")

    def sweep(C, fleet, Job, **kw):
        return [C(fleet.take(k), homogenize=h, adaptive=False, priors="spec",
                  **kw).simulate(Job(size=800)).measured_speedup
                for h in (False, True) for k in range(1, len(fleet) + 1)]

    want = sweep(JaxCluster, jfleet, JaxSimJob)
    got = sweep(Cluster, tfleet, SimJob, device="cpu")
    assert got == want
    assert max(got[9:]) > max(got[:9])        # homogenized beats equal-split
