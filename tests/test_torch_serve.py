"""Slice-wide parity: the port's ``Cluster.serve`` with port engines against
the reference ``Cluster.serve`` with JAX engines, on the same bridged
weights and the same requests, on the CPU.

Fleets: the disaggregated ``fast=2.0^prefill,slow=1.0x4^decode`` (prefill
kernel path, KV handoffs, TTFT split) and one mixed fleet (admission
waves).  Per-request tokens, shares, handoffs, the sim clock and the TTFT
split are equal — the copied control plane makes the same scheduling
decisions as the original.  ``simulate(SimJob)`` is compared the same way.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cluster import Cluster as JaxCluster
from repro.cluster import ServeJob as JaxServeJob
from repro.cluster import SimJob as JaxSimJob
from repro.models import LayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro.serve import Request as JaxRequest
from repro_torch.cluster import Cluster, MatmulJob, ServeJob, SimJob, TrainJob
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.serve import Request

FLEETS = ["fast=2.0^prefill,slow=1.0x4^decode", "a=2x2,b=1x2"]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig(
        name="tiny-disagg", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=True,
        rope_theta=1e4,
    )
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s)) for s in jcfg.layer_pattern)
    tm = Model(ModelConfig(**fields), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _prompts(n: int = 6):
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(0, 64, int(rng.integers(3, 30)))]
            for _ in range(n)]


def _phase_view(rep):
    return [(p.label, p.index, p.work, p.sim_time_s, dict(p.shares),
             p.n_migrated) for p in rep.phases]


@pytest.mark.parametrize("fleet", FLEETS)
def test_serve_matches_reference(models, fleet):
    jm, jparams, tm, tparams = models
    prompts = _prompts()
    jreqs = [JaxRequest(i, list(p), 5) for i, p in enumerate(prompts)]
    treqs = [Request(i, list(p), 5) for i, p in enumerate(prompts)]
    jrep = JaxCluster(fleet).serve(
        JaxServeJob(jreqs, model=jm, params=jparams, max_seq=64))
    trep = Cluster(fleet, device="cpu").serve(
        ServeJob(treqs, model=tm, params=tparams, max_seq=64))

    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 5 for r in treqs)
    assert trep.sim_time_s == jrep.sim_time_s
    assert trep.work_done == jrep.work_done
    assert _phase_view(trep) == _phase_view(jrep)
    for key in ("mode", "n_handoffs", "ttft_split", "role_shares",
                "role_quality", "n_requests"):
        assert trep.metrics.get(key) == jrep.metrics.get(key), key
    if "^" in fleet:
        assert trep.metrics["mode"] == "disaggregated"
        assert trep.metrics["n_handoffs"] == len(prompts)


@pytest.mark.parametrize("scenario", [None, "halve:w1@30%", "kill:w2@40%"])
def test_simulate_matches_reference(scenario):
    fleet = "8x1,4x1,2x1"
    jrep = JaxCluster(fleet).simulate(JaxSimJob(size=96, n_jobs=2),
                                      scenario=scenario)
    trep = Cluster(fleet, device="cpu").simulate(SimJob(size=96, n_jobs=2),
                                                 scenario=scenario)
    assert _phase_view(trep) == _phase_view(jrep)
    assert (trep.sim_time_s, trep.predicted_speedup, trep.measured_speedup) \
        == (jrep.sim_time_s, jrep.predicted_speedup, jrep.measured_speedup)


def test_later_slices_raise_and_device_policy():
    with pytest.raises(NotImplementedError, match="matmul slice"):
        Cluster("2x1", backend="wallclock", device="cpu")
    c = Cluster("2x1,1x1", device="cpu")
    with pytest.raises(NotImplementedError, match="matmul slice"):
        c.simulate(MatmulJob(np.ones((4, 4)), np.ones((4, 4))))
    with pytest.raises(NotImplementedError, match="training slice"):
        c.train(TrainJob(model=None, steps=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Cluster("2x1")
