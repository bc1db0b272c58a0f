"""The engine's compiled steps (``serve/compiled.py``, the counterpart of the
reference's ``jax.jit`` on ``DecodeEngine``'s decode step and bucketed
prefill) on the reduced configs of the 8 archs ``DecodeEngine`` serves,
f32 on the CPU.

On the CPU the compiled route runs each step eagerly over the static
buffers a CUDA graph would read and write, so these tests hold it to the
graph's rules:

  (a) capture safety: the steps the engine captures make none of the calls
      that, on CUDA, sync the host or copy from host memory while a graph
      is being captured (``CaptureGuard``);
  (b) the compiled route's tokens and logits equal the eager route's
      (``compile_steps=False``) bit for bit, and its tokens the reference
      engine's, on ``submit`` and on prefill + insert;
  (c) aliasing: handoffs of one bucket, prefilled one after the other and
      inserted after, keep their own caches (the reference's tokens);
  (d) new parameters drop the compiled steps (a fresh engine's tokens).

The card's side (graph bits, launch counts over replays, a failed capture
raising) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.models.layers import rope_freqs
from repro_torch.serve import DecodeEngine, Request
from repro_torch.serve import compiled
from repro_torch.tree import tree_leaves

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

#: The archs ``DecodeEngine`` serves (token input, no encoder).
ARCHS = ("qwen2-1.5b", "codeqwen1.5-7b", "granite-34b", "qwen3-8b",
         "qwen2-moe-a2.7b", "mamba2-2.7b", "jamba-v0.1-52b",
         "deepseek-v2-236b")

aten = torch.ops.aten


class CaptureGuard(TorchDispatchMode):
    """Raises on the ops that, on CUDA, sync the host or copy from host
    memory, which a CUDA graph capture forbids: reading a tensor on the
    host (``int(t)``, ``.item()``), a tensor made from host data
    (``torch.tensor``), ``nonzero``, a boolean-mask index, and a copy
    between devices."""

    BANNED = (aten._local_scalar_dense.default, aten.lift_fresh.default,
              aten.nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise AssertionError(f"{func} in a captured step")
        if func is aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError("a boolean-mask index in a captured step")
        if func is aten._to_copy.default and "device" in kwargs and \
                torch.device(kwargs["device"]) != args[0].device:
            raise AssertionError("a copy between devices in a captured step")
        if func is aten.copy_.default and args[0].device != args[1].device:
            raise AssertionError("a copy between devices in a captured step")
        return func(*args, **kwargs)


_SUB_CONFIGS = {"moe": port_config.MoEConfig, "ssm": port_config.SSMConfig,
                "mla": port_config.MLAConfig,
                "encoder": port_config.EncoderConfig}


def _port_cfg(jcfg) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for key in ("layer_pattern", "prefix_pattern"):
        fields[key] = tuple(port_config.LayerSpec(**dataclasses.asdict(s))
                            for s in getattr(jcfg, key))
    for key, cls in _SUB_CONFIGS.items():
        if fields[key] is not None:
            fields[key] = cls(**dataclasses.asdict(fields[key]))
    return ModelConfig(**fields)


@functools.lru_cache(maxsize=None)
def _build(arch: str):
    """The reduced config in both packages on the reference's weights."""
    jm = JaxModel(jax_get_config(arch, reduced=True))
    jparams = jm.init(jax.random.key(0))
    tm = Model(_port_cfg(jm.cfg), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _prompts(vocab: int, lengths) -> list[list[int]]:
    rng = np.random.default_rng(1)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


#: Three prompts in bucket 16 (each bucket's first call warms up, its
#: second captures, its third replays on the card) and one in bucket 32.
LENGTHS = (5, 11, 7, 20)
NEW = 5


def _engine(tm, tparams, **kw) -> DecodeEngine:
    return DecodeEngine(tm, tparams, max_batch=2, max_seq=64, device="cpu",
                        **kw)


def _record(engine: DecodeEngine) -> list:
    """Wrap the engine's two steps; return the list their host logits go
    to, in call order."""
    seen = []
    decode, prefill = engine._decode_logits, engine._prefill_logits

    def dec(toks, pos):
        lg = decode(toks, pos)
        seen.append(("decode", lg.copy()))
        return lg

    def pre(toks, last_pos):
        lg, caches = prefill(toks, last_pos)
        seen.append(("prefill", lg.copy()))
        return lg, caches

    engine._decode_logits, engine._prefill_logits = dec, pre
    return seen


def _serve(engine, prompts, route: str, cls=Request):
    """Tokens of ``prompts`` through ``submit`` or prefill + insert (all
    prefilled first, then inserted: handoffs wait in a queue, as in a
    disaggregated fleet)."""
    reqs = [cls(i, list(p), NEW) for i, p in enumerate(prompts)]
    if route == "submit":
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
    else:
        for i in range(0, len(reqs), engine.max_batch):
            handoffs = [engine.prefill(r) for r in reqs[i:i + engine.max_batch]]
            for h in handoffs:
                engine.insert(h)
            engine.run_until_drained()
    return [list(map(int, r.out_tokens)) for r in reqs]


def test_rope_freqs_keep_the_old_expressions_bits():
    """With theta filled on the device instead of copied from the host, the
    frequencies are the bits of the old expression (thetas that f32 rounds
    included)."""
    for d in (16, 64, 128, 192):
        for theta in (1e4, 5e5, 1e6, 1234.5, 10000.1, 1e6 / 3):
            exps = torch.arange(0, d, 2, dtype=torch.float32) / d
            old = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                                  exps)
            assert torch.equal(rope_freqs(d, theta, "cpu"), old)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_are_capture_safe(arch):
    """(a) The decode step and the prefills of two buckets, as the engine
    runs them, under ``CaptureGuard`` after an unguarded first call (the
    warm-up a capture follows); then the engine's compiled steps
    themselves, each guarded from its second call on."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    caches = model.init_cache(2, 64)
    toks = torch.tensor([[3], [7]])
    pos = torch.tensor([4, 9])
    prompts = []
    for bucket, n in ((16, 5), (32, 20)):
        tb = torch.zeros((1, bucket), dtype=torch.int64)
        tb[0, :n] = 2
        prompts.append((tb, torch.tensor(n - 1)))
    with torch.no_grad():
        for guard in (False, True):
            with CaptureGuard() if guard else torch.no_grad():
                model.decode_step(params, caches, toks, pos)
                for tb, last in prompts:
                    model.prefill(params, {"tokens": tb}, last_pos=last)

    guarded = []
    run = compiled.CompiledStep._run

    def checked(step):
        if step.calls == 1:
            return run(step)
        guarded.append(step.name)
        with CaptureGuard():
            return run(step)

    engine = _engine(model, params)
    saved, compiled.CompiledStep._run = compiled.CompiledStep._run, checked
    try:
        _serve(engine, _prompts(cfg.vocab_size, LENGTHS), "prefill")
    finally:
        compiled.CompiledStep._run = saved
    assert "engine0.decode" in guarded and "engine0.prefill[16]" in guarded


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_tokens_and_logits_equal_eager_and_reference(arch):
    """(b) On ``submit`` and on prefill + insert: the compiled route's
    tokens and every step's logits equal the eager route's bit for bit,
    and its tokens the reference engine's."""
    jm, jparams, tm, tparams = _build(arch)
    prompts = _prompts(tm.cfg.vocab_size, LENGTHS)
    jeng = JaxEngine(jm, jparams, max_batch=2, max_seq=64)
    fast, slow = _engine(tm, tparams), _engine(tm, tparams,
                                               compile_steps=False)
    seen_fast, seen_slow = _record(fast), _record(slow)
    for route in ("submit", "prefill"):
        want = _serve(jeng, prompts, route, JaxRequest)
        got = _serve(fast, prompts, route)
        assert got == _serve(slow, prompts, route), route
        assert got == want, route
    assert fast._decode is not None and sorted(fast._prefills) == [16, 32]
    assert slow._decode is None and slow._prefills == {}
    assert [k for k, _ in seen_fast] == [k for k, _ in seen_slow]
    assert len(seen_fast) > 20
    for (kind, a), (_, b) in zip(seen_fast, seen_slow, strict=True):
        assert np.array_equal(a, b), kind


@pytest.mark.parametrize("arch", ARCHS)
def test_handoffs_of_one_bucket_keep_their_own_caches(arch):
    """(c) Three prompts of bucket 16 prefilled one after the other (the
    step's static outputs overwritten each time), then inserted and
    decoded: the reference engine's tokens, and caches that differ."""
    jm, jparams, tm, tparams = _build(arch)
    prompts = _prompts(tm.cfg.vocab_size, LENGTHS[:3])
    jeng = JaxEngine(jm, jparams, max_batch=3, max_seq=64)
    jreqs = [JaxRequest(i, list(p), NEW) for i, p in enumerate(prompts)]
    for h in [jeng.prefill(r) for r in jreqs]:
        jeng.insert(h)
    jeng.run_until_drained()
    want = [list(map(int, r.out_tokens)) for r in jreqs]

    engine = DecodeEngine(tm, tparams, max_batch=3, max_seq=64,
                          device="cpu")
    reqs = [Request(i, list(p), NEW) for i, p in enumerate(prompts)]
    handoffs = [engine.prefill(r) for r in reqs]
    assert [h.bucket for h in handoffs] == [16, 16, 16]
    first = tree_leaves(handoffs[0].caches)
    for h in handoffs[1:]:
        leaves = tree_leaves(h.caches)
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(first, leaves) if a.numel())
    for h in handoffs:
        engine.insert(h)
    engine.run_until_drained()
    assert [list(map(int, r.out_tokens)) for r in reqs] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_new_params_drop_the_compiled_steps(arch):
    """(d) After serving, ``engine.params`` reassigned: the compiled steps
    are dropped, and the engine gives the tokens of a fresh engine under
    the new parameters that serves the same routes in the same order (a
    reused slot keeps its Mamba state on ``submit``, as in the
    reference)."""
    _, _, tm, tparams = _build(arch)
    prompts = _prompts(tm.cfg.vocab_size, LENGTHS)
    engine = _engine(tm, tparams)
    old = _serve(engine, prompts, "prefill")
    assert engine._decode is not None and engine._prefills
    new_params = tm.init(1)
    engine.params = new_params
    assert engine._decode is None and engine._prefills == {}
    fresh = _engine(tm, new_params)
    for route in ("prefill", "submit"):
        got = _serve(engine, prompts, route)
        assert got == _serve(fresh, prompts, route), route
        if route == "prefill":
            assert got != old


def test_compiled_step_keeps_static_buffers_on_the_cpu():
    """On the CPU a step runs over its static input buffers and returns its
    static outputs, overwritten by the next call, as a replay overwrites a
    graph's; inputs of another shape raise."""
    calls = []

    def fn(x, y):
        calls.append((x, y))
        return {"sum": x + y, "prod": (x * y,)}

    step = compiled.CompiledStep("demo", fn, "cpu")
    a = step(torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]))
    b = step(torch.tensor([5.0, 6.0]), torch.tensor([7.0, 8.0]))
    assert calls[0][0] is calls[1][0] and calls[0][1] is calls[1][1]
    assert b is a and torch.equal(a["sum"], torch.tensor([12.0, 14.0]))
    assert torch.equal(a["prod"][0], torch.tensor([35.0, 48.0]))
    assert step.graph is None and step.calls == 2
    with pytest.raises(ValueError, match="demo"):
        step(torch.zeros(3), torch.zeros(3))


def test_engine_routes_default_and_eager():
    """``compile_steps`` is on by default; ``False`` is the eager route,
    which compiles nothing; both return the same handoff values, and a
    compiled handoff owns its caches."""
    _, _, tm, tparams = _build("qwen2-1.5b")
    r = Request(0, [1, 2, 3], 4)
    fast = _engine(tm, tparams)
    slow = _engine(tm, tparams, compile_steps=False)
    assert fast.compile_steps and not slow.compile_steps
    a, b = fast.prefill(r), slow.prefill(Request(0, [1, 2, 3], 4))
    assert a.first_token == b.first_token and slow._prefills == {}
    outs = tree_leaves(fast._prefills[16].outputs[1])
    for x, y, o in zip(tree_leaves(a.caches), tree_leaves(b.caches), outs):
        assert torch.equal(x, y) and x.data_ptr() != o.data_ptr()
