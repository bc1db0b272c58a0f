"""The reference's last public names in the port: the serve launcher's
deprecated shims (``parse_replicas``, ``build_fleet``,
``scenario_timeline``), ``configs.registry.all_configs`` and
``kernels.autotune.save_registry``, each against the reference or, where
it builds port objects, against the port's own ``Cluster.serve``."""

import dataclasses

import pytest
import torch

from repro.configs.registry import all_configs as jax_all_configs
from repro.core import TimelineEvent as JaxTimelineEvent
from repro.launch.serve import parse_replicas as jax_parse_replicas
from repro.launch.serve import scenario_timeline as jax_scenario_timeline
from repro.serve import Request as JaxRequest
from repro_torch.cluster import Cluster, ServeJob
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCH_IDS, all_configs
from repro_torch.core import TimelineEvent
from repro_torch.kernels import autotune
from repro_torch.launch.serve import (
    build_fleet,
    make_requests,
    parse_replicas,
    scenario_timeline,
)
from repro_torch.models import Model
from repro_torch.serve import Request

torch.set_num_threads(1)

SPECS = ["8x4:4x2:2x1", "8:4:2", "2.5x3,1", "a=4x2:b=2x1", " 3 : 1x2 ,"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_replicas_is_the_reference(spec):
    """Bare-perf items mean 4 slots; names and both separators pass."""
    assert parse_replicas(spec) == jax_parse_replicas(spec)


def test_parse_replicas_keeps_the_legacy_contract():
    assert parse_replicas("8x4:4x2:2x1") == [(8.0, 4), (4.0, 2), (2.0, 1)]
    assert parse_replicas("8:4:2") == [(8.0, 4), (4.0, 4), (2.0, 4)]


def _events(timeline) -> list[tuple]:
    return [dataclasses.astuple(e) for e in timeline]


@pytest.mark.parametrize("scenario", ["none", "halving", "kill",
                                      "halve:r1@40%", "kill:r0@10%;"
                                      "halve:r1@60%"])
@pytest.mark.parametrize("specs", [[(8.0, 4), (4.0, 2)],
                                   [(2.0, 1), (1.0, 3), (0.5, 2)]])
def test_scenario_timeline_is_the_reference(scenario, specs):
    """The same events at the same times as the reference's on the same
    requests (``tests/test_cluster.py``'s inputs and more)."""
    lengths = [(2, 6), (2, 6), (2, 6), (2, 6), (5, 3)]
    reqs = [Request(i, [1] * p, n) for i, (p, n) in enumerate(lengths)]
    jreqs = [JaxRequest(i, [1] * p, n) for i, (p, n) in enumerate(lengths)]
    got = scenario_timeline(scenario, specs, reqs)
    assert _events(got) == _events(jax_scenario_timeline(scenario, specs,
                                                         jreqs))
    assert all(isinstance(e, TimelineEvent) for e in got)


def test_scenario_timeline_keeps_the_legacy_event():
    reqs = [Request(i, [1, 1], 6) for i in range(4)]   # cost 4 * 8 = 32
    rate = 8 * 4 + 4 * 2
    got = scenario_timeline("halving", [(8.0, 4), (4.0, 2)], reqs)
    want = JaxTimelineEvent(0.25 * 32 / rate, "perf", "r0", perf=4.0)
    assert _events(got) == [dataclasses.astuple(want)]


def test_build_fleet_serves_the_tokens_of_cluster_serve():
    """The deprecated ``FleetServer`` over ``DecodeEngine``s of the reduced
    Qwen2 gives each request the tokens ``Cluster.serve`` gives it on the
    same weights (greedy decoding)."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    specs = parse_replicas("2x2:1x2")
    reqs = make_requests(6, cfg.vocab_size, 4, seed=1)
    fleet = build_fleet(model, params, specs, max_seq=32, queue_depth=8)
    assert sorted(fleet.engines) == ["r0", "r1"]
    assert {e.device.type for e in fleet.engines.values()} == {"cpu"}
    rep = fleet.serve(reqs)
    again = make_requests(6, cfg.vocab_size, 4, seed=1)
    Cluster("r0=2x2,r1=1x2", device="cpu").serve(
        ServeJob(again, model=model, params=params, max_seq=32))
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in again]
    assert rep.n_requests == len(reqs)


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_is_the_reference_field_for_field(reduced):
    got, want = all_configs(reduced), jax_all_configs(reduced)
    assert list(got) == list(want) == list(ARCH_IDS)
    for arch in ARCH_IDS:
        a, b = dataclasses.asdict(got[arch]), dataclasses.asdict(want[arch])
        assert a.keys() == b.keys(), arch
        for key in a:
            assert a[key] == b[key], (arch, key)


def test_save_registry_round_trips(tmp_path):
    """``save_registry`` writes what ``load_registry`` and ``lookup`` read
    back; a second save replaces the cached read; the port's own registry
    file is not touched."""
    with open(autotune.REGISTRY_PATH, "rb") as f:
        own = f.read()
    path = str(tmp_path / "registry.json")
    dims = {"m": 1000, "k": 512}
    key = autotune.registry_key("matmul", dims, "cpu")
    reg = {key: {"blocks": {"bm": 64, "bn": 64}, "ms": 0.5}}
    autotune.save_registry(reg, path)
    assert autotune.load_registry(path) == reg
    assert autotune.lookup("matmul", dims, "cpu", path=path) == \
        {"bm": 64, "bn": 64}
    assert autotune.lookup("matmul", {"m": 3000, "k": 512}, "cpu",
                           path=path) == {}
    reg[key]["blocks"] = {"bm": 128}
    autotune.save_registry(reg, path)
    assert autotune.lookup("matmul", {"m": 900, "k": 300}, "cpu",
                           path=path) == {"bm": 128}
    with open(path) as f:
        assert f.read().endswith("}\n")
    with open(autotune.REGISTRY_PATH, "rb") as f:
        assert f.read() == own
