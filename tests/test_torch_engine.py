"""Port parity: ``repro_torch.serve.DecodeEngine`` against the JAX engine on
bridged weights (the ``tiny-disagg`` model of ``test_disagg.py``), f32 on
the CPU.

Greedy tokens are equal on the teacher-forced (submit) path and on the
bucketed prefill + insert path; within the port, prefill + insert
reproduces the submit path, and re-inserting a retained handoff after
``cancel`` completes bitwise-identically (mirroring ``test_disagg.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import LayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.kernels.prefill.ops import length_bucket
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.serve import DecodeEngine, Request


def tiny_cfg(use_pallas: bool = False) -> JaxModelConfig:
    return JaxModelConfig(
        name="tiny-disagg", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(LayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32", use_pallas=use_pallas,
        rope_theta=1e4,
    )


def port_cfg(jcfg: JaxModelConfig) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s)) for s in jcfg.layer_pattern)
    return ModelConfig(**fields)


def models(use_pallas: bool = False):
    jm = JaxModel(tiny_cfg(use_pallas))
    jparams = jm.init(jax.random.key(0))
    tm = Model(port_cfg(jm.cfg), device="cpu")
    return jm, jparams, tm, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def engine(tm, tparams, **kw):
    return DecodeEngine(tm, tparams, device="cpu", **kw)


PROMPTS = [list(np.random.default_rng(s).integers(0, 64, n))
           for s, n in ((1, 5), (2, 20), (3, 9))]


def test_teacher_forced_tokens_equal_jax():
    jm, jparams, tm, tparams = models()
    jeng = JaxEngine(jm, jparams, max_batch=2, max_seq=64)
    teng = engine(tm, tparams, max_batch=2, max_seq=64)
    jreqs = [JaxRequest(i, list(p), 6) for i, p in enumerate(PROMPTS)]
    treqs = [Request(i, list(p), 6) for i, p in enumerate(PROMPTS)]
    for r in jreqs:
        jeng.submit(r)
    for r in treqs:
        teng.submit(r)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert (teng.steps, teng.tokens_out, teng.prompt_fed) == \
        (jeng.steps, jeng.tokens_out, jeng.prompt_fed)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_insert_tokens_equal_jax_and_submit_path(use_pallas):
    jm, jparams, tm, tparams = models(use_pallas)
    prompt = PROMPTS[1]
    jpf = JaxEngine(jm, jparams, max_batch=1, max_seq=64, name="pf")
    jdc = JaxEngine(jm, jparams, max_batch=2, max_seq=64, name="dc")
    jreq = JaxRequest(0, list(prompt), 6)
    jdc.insert(jpf.prefill(jreq))
    jdc.run_until_drained()

    ref = Request(0, list(prompt), 6)
    sub = engine(tm, tparams, max_batch=2, max_seq=64)
    sub.submit(ref)
    sub.run_until_drained()

    pf = engine(tm, tparams, max_batch=1, max_seq=64, name="pf")
    dc = engine(tm, tparams, max_batch=2, max_seq=64, name="dc")
    req = Request(1, list(prompt), 6)
    handoff = pf.prefill(req)
    assert handoff.pos == len(prompt)
    assert handoff.bucket == length_bucket(len(prompt), 64)
    assert dc.insert(handoff) >= 0
    dc.run_until_drained()
    assert req.out_tokens == jreq.out_tokens == ref.out_tokens


def test_reinsert_after_cancel_is_bitwise():
    _, _, tm, tparams = models()
    prompt = PROMPTS[1][:18]
    ref = Request(0, list(prompt), 8)
    ref_eng = engine(tm, tparams, max_batch=1, max_seq=64)
    ref_eng.submit(ref)
    ref_eng.run_until_drained()

    pf = engine(tm, tparams, max_batch=1, max_seq=64, name="pf")
    dc0 = engine(tm, tparams, max_batch=1, max_seq=64, name="dc0")
    dc1 = engine(tm, tparams, max_batch=1, max_seq=64, name="dc1")
    req = Request(1, list(prompt), 8)
    handoff = pf.prefill(req)
    dc0.insert(handoff)
    for _ in range(3):
        dc0.step()
    assert not req.done
    dc0.cancel(req.rid)
    assert dc0.active == 0
    dc1.insert(handoff)
    dc1.run_until_drained()
    assert req.done and req.out_tokens == ref.out_tokens


def test_insert_into_wider_engine_lane():
    """A handoff lands in lane ``idx`` of the batch axis of every stacked
    period cache, cast to the engine's cache dtype."""
    _, _, tm, tparams = models()
    pf = engine(tm, tparams, max_batch=1, max_seq=64)
    dc = engine(tm, tparams, max_batch=3, max_seq=64)
    dc.insert(pf.prefill(Request(0, [1, 2, 3], 4)))
    h = pf.prefill(Request(1, list(range(1, 21)), 4))
    assert dc.insert(h) == 1
    full = dc.caches["periods"]["pos0"]["self"]
    part = h.caches["periods"]["pos0"]["self"]
    assert torch.equal(full.k[:, 1:2, :h.bucket], part.k.to(full.k.dtype))
    assert torch.equal(full.v[:, 1:2, :h.bucket], part.v.to(full.v.dtype))
    assert not full.k[:, 2].any()


def test_finished_at_prefill_slot_exhaustion_and_validation():
    _, _, tm, tparams = models()
    pf = engine(tm, tparams, max_batch=1, max_seq=32)
    dc = engine(tm, tparams, max_batch=1, max_seq=32)
    req = Request(0, [3, 5, 7], 1)
    h = pf.prefill(req)
    assert dc.insert(h) == -1 and req.done and dc.active == 0
    assert dc.insert(pf.prefill(Request(1, [1, 2], 4))) == 0
    with pytest.raises(RuntimeError, match="no free slot"):
        dc.insert(pf.prefill(Request(2, [3, 4], 4)))
    with pytest.raises(ValueError, match="non-empty"):
        pf.prefill(Request(3, [], 4))
    with pytest.raises(ValueError, match="max_seq"):
        pf.prefill(Request(4, list(range(30)), 8))


def test_engine_device_must_match_model():
    _, _, tm, tparams = models()
    with pytest.raises(ValueError, match="engine on meta"):
        DecodeEngine(tm, tparams, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(tm, tparams)
