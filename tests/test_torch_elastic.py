"""Port parity: ``repro_torch.launch.elastic`` against ``repro.launch.elastic``.

Each case of ``tests/test_elastic.py`` runs the same steps on both packages
(``PodSpec``, ``ElasticFleet`` and ``PerformanceTracker`` of each, the same
heartbeats at the same clock times) and compares what comes out field for
field: every ``RemeshPlan`` (survivors, lost pods, resume step, capacity
fraction, and its ``GrainPlan``'s workers, shares and grain count), the
rehearsals' makespan, shares, grain owners and homogenization quality, the
trackers' workers and perfs, and the errors raised.  The checkpoint cases
write one checkpoint with the port's ``checkpoint.save`` and restore both
fleets from it.  Each case's own assertions then hold on the port.
"""

import types

import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
import repro.core as jax_core
import repro.launch.elastic as jax_elastic
import repro_torch.checkpoint as ckpt
import repro_torch.core as core
import repro_torch.launch.elastic as elastic

torch.set_num_threads(1)

PORT = types.SimpleNamespace(PerformanceTracker=core.PerformanceTracker,
                             PerfReport=core.PerfReport,
                             ElasticFleet=elastic.ElasticFleet,
                             PodSpec=elastic.PodSpec,
                             RemeshPlan=elastic.RemeshPlan)
REF = types.SimpleNamespace(PerformanceTracker=jax_core.PerformanceTracker,
                            PerfReport=jax_core.PerfReport,
                            ElasticFleet=jax_elastic.ElasticFleet,
                            PodSpec=jax_elastic.PodSpec,
                            RemeshPlan=jax_elastic.RemeshPlan)


def _fleet(pkg, n=4, grains=64, dead_after=50.0):
    tracker = pkg.PerformanceTracker(alpha=1.0, dead_after_s=dead_after)
    pods = [pkg.PodSpec(f"pod{i}", 256, (16, 16)) for i in range(n)]
    for p in pods:
        tracker.observe(pkg.PerfReport(p.name, 4.0, 1.0, 0.0))
    return pkg.ElasticFleet(pods, tracker, grains), tracker


def _beat(pkg, tracker, t, perfs=(4.0, 4.0, 4.0)):
    for i, perf in enumerate(perfs):
        tracker.observe(pkg.PerfReport(f"pod{i}", perf, 1.0, t))


def fields(plan):
    """A plan (or None) as plain data, field for field."""
    if plan is None:
        return None
    g = plan.grain_plan
    return (plan.survivors, plan.lost, plan.resume_step,
            plan.capacity_fraction, g.workers, g.shares, g.total_grains)


def rehearsal(res):
    return (res.makespan, res.shares(), dict(res.executed_by),
            res.homogenization_quality())


def both(run):
    """``run(pkg)`` on the port and on the reference; returns the port's
    result after checking the two are equal."""
    got, want = run(PORT), run(REF)
    assert got == want
    return got


def test_podspec_validates_mesh():
    def run(pkg):
        with pytest.raises(ValueError) as err:
            pkg.PodSpec("bad", 256, (8, 16))
        return str(err.value)

    both(run)


def test_no_failures_no_plan():
    def run(pkg):
        fleet, tracker = _fleet(pkg)
        for name in fleet.pods:
            tracker.observe(pkg.PerfReport(name, 4.0, 1.0, 40.0))
        return fields(fleet.handle_failures(now_s=45.0, last_ckpt_step=100))

    assert both(run) is None


def test_failure_produces_remesh_plan():
    def run(pkg):
        fleet, tracker = _fleet(pkg)
        _beat(pkg, tracker, 100.0)          # pod3 goes silent
        plan = fleet.handle_failures(now_s=100.0, last_ckpt_step=80)
        assert isinstance(plan, pkg.RemeshPlan)
        _beat(pkg, tracker, 101.0)
        again = fleet.handle_failures(now_s=101.0, last_ckpt_step=80)
        return fields(plan), fields(again)

    plan, again = both(run)
    survivors, lost, resume, frac, _, shares, _ = plan
    assert lost == ("pod3",)
    assert set(survivors) == {"pod0", "pod1", "pod2"}
    assert sum(shares) == 64
    assert resume == 80
    assert frac == pytest.approx(0.75)
    assert again is None


def _lose_pod3(pkg):
    fleet, tracker = _fleet(pkg)
    _beat(pkg, tracker, 100.0)
    fleet.handle_failures(now_s=100.0, last_ckpt_step=80)
    return fleet, tracker


def test_rejoin_restores_capacity():
    def run(pkg):
        fleet, _ = _lose_pod3(pkg)
        return fields(fleet.handle_join(
            pkg.PodSpec("pod3", 256, (16, 16)), perf_prior=4.0, now_s=120.0,
            last_ckpt_step=110))

    survivors, lost, _, _, _, shares, _ = both(run)
    assert set(survivors) == {f"pod{i}" for i in range(4)}
    assert lost == ()
    assert sum(shares) == 64


def test_degraded_pod_rejoins_smaller():
    def run(pkg):
        fleet, _ = _lose_pod3(pkg)
        return fields(fleet.handle_join(
            pkg.PodSpec("pod3", 128, (8, 16)), perf_prior=2.0, now_s=120.0,
            last_ckpt_step=110))

    plan = both(run)
    shares = dict(zip(plan[4], plan[5], strict=True))
    assert shares["pod3"] < shares["pod0"]
    assert shares["pod3"] >= 1


def test_rehearse_predicts_recovery_makespan():
    def run(pkg):
        fleet, tracker = _fleet(pkg)
        _beat(pkg, tracker, 100.0)
        plan = fleet.handle_failures(now_s=100.0, last_ckpt_step=80)
        res = fleet.rehearse(plan)
        return (fields(plan), rehearsal(res), tracker.workers(),
                tracker.perf("pod0"))

    _, (makespan, shares, executed_by, quality), workers, perf = both(run)
    assert sorted(executed_by) == list(range(64))
    assert set(shares) == {"pod0", "pod1", "pod2"}
    assert makespan == pytest.approx(64 / 12.0, rel=0.1)
    assert quality <= 1.1
    assert workers == ["pod0", "pod1", "pod2"]
    assert perf == pytest.approx(4.0)


def test_rehearse_degraded_survivor_gets_less_work():
    def run(pkg):
        fleet, tracker = _fleet(pkg)
        _beat(pkg, tracker, 100.0, perfs=(4.0, 4.0, 1.0))
        plan = fleet.handle_failures(now_s=100.0, last_ckpt_step=80)
        return fields(plan), rehearsal(fleet.rehearse(plan))

    _, (_, shares, _, quality) = both(run)
    assert shares["pod2"] < shares["pod0"]
    assert quality <= 1.25


def test_swept_pod_cannot_heartbeat_back_without_join():
    def run(pkg):
        fleet, tracker = _lose_pod3(pkg)
        tracker.observe(pkg.PerfReport("pod3", 4.0, 1.0, 101.0))  # late
        late = ("pod3" in tracker.workers(), tracker.n_rejected)
        plan = fleet.handle_join(pkg.PodSpec("pod3", 256, (16, 16)),
                                 perf_prior=4.0, now_s=120.0,
                                 last_ckpt_step=110)
        return late, fields(plan)

    (present, rejected), plan = both(run)
    assert not present and rejected == 1
    assert "pod3" in plan[0]


def _save_tracker(tmp_path, step, perfs, t, **tracker_kw) -> str:
    """One checkpoint, written by the port, whose extras hold a tracker
    that heard ``perfs`` at time ``t``."""
    d = str(tmp_path / "ck")
    live = core.PerformanceTracker(**tracker_kw)
    for name, p in perfs.items():
        live.observe(core.PerfReport(name, p, 1.0, t))
    ckpt.save(d, step, {"x": torch.zeros((2,), dtype=torch.float32)},
              extras={"tracker": live.state_dict(), "clock": t})
    return d


def test_from_checkpoint_restores_learned_perfs(tmp_path):
    d = _save_tracker(tmp_path, 7, {"pod0": 8.0, "pod1": 2.0, "gone": 4.0},
                      50.0, alpha=1.0)
    # The round trip the restore rests on: both packages read the port's
    # checkpoint, its extras and its tree, alike.
    assert ckpt.read_extras(d) == jax_ckpt.read_extras(d)
    (tree, step), (jtree, jstep) = (
        ckpt.restore(d, {"x": torch.ones(2)}),
        jax_ckpt.restore(d, {"x": np.ones(2, np.float32)}))
    assert step == jstep == 7
    np.testing.assert_array_equal(tree["x"].numpy(), np.asarray(jtree["x"]))

    def run(pkg):
        pods = [pkg.PodSpec(n, 256, (16, 16)) for n in ("pod0", "pod1",
                                                        "fresh")]
        fleet = pkg.ElasticFleet.from_checkpoint(pods, d, total_grains=64,
                                                 alpha=1.0)
        return (fleet.tracker.perf_vector(50.0), fleet.tracker.workers(),
                fields(fleet._plan(resume_step=7)))

    pv, workers, plan = both(run)
    assert pv["pod0"] == pytest.approx(8.0)
    assert pv["pod1"] == pytest.approx(2.0)
    assert pv["fresh"] == pytest.approx(1.0)
    assert "gone" not in workers
    shares = dict(zip(plan[4], plan[5], strict=True))
    assert shares["pod0"] > shares["pod1"] > 0


def test_from_checkpoint_explicit_kwargs_win_over_saved_config(tmp_path):
    d = _save_tracker(tmp_path, 3, {"pod0": 6.0}, 10.0, alpha=1.0,
                      dead_after_s=300.0)

    def run(pkg):
        fleet = pkg.ElasticFleet.from_checkpoint(
            [pkg.PodSpec("pod0", 256, (16, 16))], d, total_grains=16,
            alpha=0.9, dead_after_s=30.0)
        t = fleet.tracker
        return t.alpha, t.dead_after_s, t.perf_vector(10.0)

    alpha, dead_after, pv = both(run)
    assert (alpha, dead_after) == (0.9, 30.0)
    assert pv["pod0"] == pytest.approx(6.0)


def test_from_checkpoint_without_checkpoint_is_neutral(tmp_path):
    def run(pkg):
        pods = [pkg.PodSpec("pod0", 256, (16, 16)),
                pkg.PodSpec("pod1", 256, (16, 16))]
        fleet = pkg.ElasticFleet.from_checkpoint(
            pods, str(tmp_path / "none"), total_grains=16)
        return fleet.tracker.perf_vector(), fields(fleet._plan(0))

    pv, _ = both(run)
    assert pv == {"pod0": 1.0, "pod1": 1.0}


def test_all_pods_lost_raises():
    def run(pkg):
        fleet, _ = _fleet(pkg, n=1)
        with pytest.raises(RuntimeError) as err:
            fleet.handle_failures(now_s=1000.0, last_ckpt_step=0)
        return str(err.value), fleet.alive()

    msg, alive = both(run)
    assert msg == "all pods lost" and alive == []
