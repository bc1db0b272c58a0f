"""Continuous-batching decode engine (single replica).

Port of ``repro/serve/engine.py``.  The reference's per-engine ``jax.jit``
(one compiled decode step, the cache donated; one compiled prefill per
length bucket) becomes ``serve/compiled.py``'s ``CompiledStep``: on CUDA
each step is captured as a CUDA graph on its second call and replayed from
then on, the hand-written kernels inside it (``self._decode``, and
``self._prefills[bucket]``, sharing one graph memory pool).  The caches are
written in place, the port's donation, so a decode returns the very cache
objects it was given.  ``compile_steps=False`` keeps the eager route,
which dispatches every op from Python; the tests and ``chip_smoke.py``
hold the two routes' tokens and logits equal, bit for bit.  On the CPU the
compiled route runs its steps eagerly over the same static buffers.

A fixed pool of ``max_batch`` slots shares one batched decode_step
with a *per-slot position vector* — slots advance independently, so finished
sequences are replaced by queued requests immediately (continuous batching)
with no head-of-line blocking.  Prompts are teacher-forced through the decode
path token-by-token, which keeps a single decode shape per engine.

The *bucketed prefill fast path* (``prefill``/``insert``) consumes a whole
prompt in one call instead: prompts are right-padded to a power-of-two
length bucket (one shape per bucket; on CUDA every attention layer runs the
hand-written prefill kernel of ``kernels/prefill``, every mamba layer the
SSD-scan kernel of ``kernels/mamba_scan``), the true last-token logits
sample the first output token, and the resulting ``KVHandoff`` — request +
first token + batch-1 cache slice — can be ``insert()``-ed into a free slot
of *any* engine, including a different replica (prefill/decode
disaggregation).

The engine reports throughput heartbeats which the homogenized dispatcher
(dispatch.py) consumes for cross-replica scope-length allotment.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.performance import PerfReport
from ..device import resolve_device
from ..kernels.prefill.ops import length_bucket
from ..models.attention import KVCache
from ..models.mla import MLACache
from ..models.model import Model
from ..tree import tree_map
from .compiled import CompiledStep, new_pool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_step: int = 0
    finish_step: int = 0


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0             # next cache index to write
    fed: int = 0             # prompt tokens already consumed


@dataclasses.dataclass
class KVHandoff:
    """A completed prefill: everything a decode replica needs to continue.

    ``caches`` is the batch-1 cache pytree covering positions [0, bucket);
    ``insert`` writes it into one slot lane of the target engine's full-size
    cache (positions beyond ``pos`` are never attended — decode masks
    ``arange(S) <= pos``).  ``first_token`` was sampled from the true
    last-prompt-position logits, so a handoff + decode reproduces the
    teacher-forced token sequence."""

    req: Request
    pos: int                 # cache positions filled (= len(prompt))
    first_token: int
    caches: object           # batch-1 cache pytree, seq dim = bucket
    source: str              # producing engine (provenance / debugging)
    bucket: int


#: Caches whose fields are laid out (batch, sequence, ...): a handoff's
#: fields cover positions [0, bucket) of the lane.
_SEQ_CACHES = (KVCache, MLACache)


def _put(full, part, batch_axis: int, idx: int) -> None:
    """Write the batch-1 ``part`` cache into lane ``idx`` of ``full``, in
    place, cast to the engine's cache dtype.  A ``KVCache``'s k and v and
    an ``MLACache``'s latent and rope key cover positions [0, bucket) of
    the lane (seq = max_seq); a ``MambaCache``'s conv window and state have
    no sequence axis and are written whole.  The reference finds the same
    axes by shape (``insert`` of ``repro/serve/engine.py``)."""
    seq = isinstance(full, _SEQ_CACHES)
    for field in dataclasses.fields(full):
        f, p = getattr(full, field.name), getattr(part, field.name)
        sl = [slice(None)] * f.ndim
        sl[batch_axis] = slice(idx, idx + 1)
        if seq:
            sl[batch_axis + 1] = slice(0, p.shape[batch_axis + 1])
        f[tuple(sl)] = p.to(f.dtype)


def _decode_step(model: Model, params, caches: dict, toks: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """The engine's decode step: (B, 1, V) logits; the caches written in
    place, never replaced (the port's donation)."""
    with torch.no_grad():
        logits, out = model.decode_step(params, caches, toks, pos)
    if out is not caches:
        raise RuntimeError("the decode step returned other caches than it "
                           "was given")
    return logits


def _prefill_step(model: Model, params, toks: torch.Tensor, last_pos):
    """The engine's bucketed prefill: (last-token logits, caches)."""
    with torch.no_grad():
        return model.prefill(params, {"tokens": toks}, last_pos=last_pos)


class DecodeEngine:
    def __init__(
        self, model: Model, params, max_batch: int = 4, max_seq: int = 128,
        eos_id: int | None = None, greedy: bool = True, seed: int = 0,
        name: str = "engine0", device: str | torch.device | None = None,
        compile_steps: bool = True,
    ):
        if model.cfg.input_mode == "embeds" and not model.cfg.is_enc_dec:
            raise ValueError("DecodeEngine drives token-input models")
        if model.cfg.is_enc_dec:
            raise ValueError("use the enc-dec serving path (examples) instead")
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine on {self.device}, model on {model.device}")
        self.model = model
        self.compile_steps = compile_steps
        self._pool = None        # the compiled steps' graph memory pool
        self._stream = None      # and their side stream (CUDA)
        self.params = params
        self.name = name
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: list[Request] = []
        self.caches = model.init_cache(max_batch, max_seq)
        self.steps = 0
        self.tokens_out = 0
        self.prompt_fed = 0      # prompt tokens consumed (feed or prefill)
        self.handoffs_in = 0     # KVHandoffs inserted into this engine
        self._hb_steps = 0
        self._hb_tokens = 0
        self._hb_fed = 0

    # -------------------------------------------------------- compiled steps
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        """New parameters drop the compiled steps: a graph keeps the
        addresses of the parameters it was captured with, where the
        reference's jitted steps take ``params`` on every call."""
        self._params = params
        self._decode: CompiledStep | None = None
        self._prefills: dict[int, CompiledStep] = {}

    @property
    def caches(self) -> dict:
        return self._caches

    @caches.setter
    def caches(self, caches: dict) -> None:
        """New caches drop the compiled decode step, which keeps the
        addresses of the caches it was captured with."""
        self._caches = caches
        self._decode = None

    def _compiled(self, name: str, fn, *bound) -> CompiledStep:
        """``fn(self.model, *bound, *inputs)`` compiled: ``bound`` (the
        parameters, the caches) is fixed at compile time, as a graph fixes
        addresses, on the CPU too.  The step holds no reference to the
        engine, so dropping the engine frees its graphs at once."""
        if self._pool is None:
            self._pool = new_pool(self.device)
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
        return CompiledStep(f"{self.name}.{name}",
                            functools.partial(fn, self.model, *bound),
                            self.device, pool=self._pool, stream=self._stream)

    def _decode_logits(self, toks: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step over (B, 1) tokens at (B,) positions: the
        (B, V) logits on the host."""
        toks, pos = torch.from_numpy(toks), torch.from_numpy(pos)
        if not self.compile_steps:
            logits = _decode_step(self.model, self._params, self._caches,
                                  toks.to(self.device), pos.to(self.device))
        else:
            if self._decode is None:
                self._decode = self._compiled("decode", _decode_step,
                                              self._params, self._caches)
            logits = self._decode(toks, pos)
        return logits[:, 0].float().cpu().numpy()

    def _prefill_logits(self, toks: np.ndarray, last_pos: int):
        """One bucket's prefill of (1, bucket) tokens: the logits at
        ``last_pos`` (V,) on the host, and the batch-1 caches.  A compiled
        prefill's caches are its graph's outputs, which the bucket's next
        replay overwrites: the handoff gets a copy of its own (a
        disaggregated fleet queues handoffs before it inserts them)."""
        if not self.compile_steps:
            logits, caches = _prefill_step(
                self.model, self._params,
                torch.from_numpy(toks).to(self.device), last_pos)
        else:
            bucket = toks.shape[1]
            step = self._prefills.get(bucket)
            if step is None:
                step = self._prefills[bucket] = self._compiled(
                    f"prefill[{bucket}]", _prefill_step, self._params)
            logits, caches = step(torch.from_numpy(toks),
                                  torch.tensor(last_pos))
            caches = tree_map(torch.clone, caches)
        lg = logits[0, 0, : self.model.cfg.vocab_size].float().cpu().numpy()
        return lg, caches

    # ----------------------------------------------------------------- admin
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError("request exceeds engine max_seq")
        req.submit_step = self.steps
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.req is None and self.queue:
                slot.req = self.queue.pop(0)
                slot.pos = 0
                slot.fed = 0

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def cancel(self, rid: int) -> Request | None:
        """Withdraw an unfinished request (queued or mid-decode in a slot)
        and reset its decode state, so re-submitting it to another engine
        decodes it from scratch — the exactly-once guarantee when a request
        migrates off a killed engine mid-bundle.  Partial tokens this engine
        already produced are discarded (the request never *completed* here).
        Returns the request, or None if ``rid`` is unknown/already done."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                return r
        for slot in self.slots:
            r = slot.req
            if r is not None and r.rid == rid:
                slot.req = None
                slot.pos = 0
                slot.fed = 0
                r.out_tokens = []
                r.done = False
                r.finish_step = 0
                return r
        return None

    # --------------------------------------------------------------- prefill
    def prefill(self, req: Request) -> KVHandoff:
        """Consume the whole prompt in one bucketed call.

        One shape per power-of-two length bucket: the prompt is
        right-padded to the bucket and the true last-token logits are read at
        ``last_pos = L - 1`` (causality keeps valid positions exact under end
        padding).  Stateless w.r.t. the slot pool — the produced ``KVHandoff``
        is decoded wherever it gets ``insert``-ed.

        A mamba layer's conv window and state carry no position mask: the
        handed-off ones have also consumed the pad tokens, so the decode
        that follows differs from the teacher-forced one.  The reference
        does the same, and the port keeps its behaviour (ROADMAP.md,
        section 3)."""
        L = len(req.prompt)
        if L == 0:
            raise ValueError("prefill needs a non-empty prompt")
        if L + req.max_new_tokens > self.max_seq:
            raise ValueError("request exceeds engine max_seq")
        bucket = length_bucket(L, self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = req.prompt
        lg, caches = self._prefill_logits(toks, L - 1)
        first = (
            int(lg.argmax()) if self.greedy
            else int(self.rng.choice(self.model.cfg.vocab_size))
        )
        self.prompt_fed += L
        self.tokens_out += 1
        return KVHandoff(req=req, pos=L, first_token=first, caches=caches,
                         source=self.name, bucket=bucket)

    def insert(self, handoff: KVHandoff) -> int:
        """Continue a prefilled request on this engine.  Returns the slot
        index, or -1 when the request finished *at* prefill (max_new_tokens
        == 1 or first token is EOS) and no slot is needed.

        Exactly-once contract: ``insert`` (re)sets ``out_tokens`` to the
        handoff's first token, so a decode cancelled mid-stream on a killed
        replica can re-insert the *same* handoff on the heir and decode a
        bitwise-identical continuation — the prefill is never recomputed and
        never double-counted."""
        r = handoff.req
        if len(r.prompt) + r.max_new_tokens > self.max_seq:
            raise ValueError("request exceeds engine max_seq")
        r.submit_step = self.steps
        r.out_tokens = [handoff.first_token]
        r.done = False
        self.handoffs_in += 1
        if r.max_new_tokens <= 1 or (
            self.eos_id is not None and handoff.first_token == self.eos_id
        ):
            r.done = True
            r.finish_step = self.steps
            return -1
        idx = next(
            (i for i, s in enumerate(self.slots) if s.req is None), None
        )
        if idx is None:
            raise RuntimeError(
                f"engine {self.name!r}: no free slot for handoff insert"
            )

        # The handoff's batch-1 slice goes to lane ``idx`` of the batch axis,
        # named explicitly: axis 1 under the stacked periods axis, axis 0 for
        # prefix layers.  The (shorter) bucket seq axis starts at 0; garbage
        # beyond ``pos`` is never attended.  Written in place (the reference
        # builds a new cache; the values are the same).
        for key, full in self.caches["periods"].items():
            _put(full["self"], handoff.caches["periods"][key]["self"], 1, idx)
        for full, part in zip(self.caches.get("prefix", ()),
                              handoff.caches.get("prefix", ())):
            _put(full["self"], part["self"], 0, idx)
        slot = self.slots[idx]
        slot.req = r
        slot.pos = handoff.pos
        slot.fed = len(r.prompt)
        return idx

    # ------------------------------------------------------------------ step
    def step(self) -> list[Request]:
        """Advance every active slot one token; returns finished requests.

        Idle slots re-write position 0 of their own cache lane with a pad
        token — harmless (the lane is reinitialized on admission by writing
        from pos 0 upward, and validity masks bound attention at pos)."""
        self._admit()
        if self.active == 0:
            return []
        toks = np.zeros((self.max_batch, 1), np.int64)
        pos = np.zeros((self.max_batch,), np.int64)
        for i, slot in enumerate(self.slots):
            r = slot.req
            if r is None:
                continue
            pos[i] = slot.pos
            if slot.fed < len(r.prompt):
                toks[i, 0] = r.prompt[slot.fed]
            else:
                toks[i, 0] = r.out_tokens[-1]
        lg = self._decode_logits(toks, pos)
        self.steps += 1
        finished = []
        for i, slot in enumerate(self.slots):
            r = slot.req
            if r is None:
                continue
            slot.pos += 1
            if slot.fed < len(r.prompt):
                slot.fed += 1
                self.prompt_fed += 1
                if slot.fed < len(r.prompt):
                    continue  # still feeding prompt; no sample yet
            nxt = (
                int(lg[i, : self.model.cfg.vocab_size].argmax())
                if self.greedy
                else int(self.rng.choice(self.model.cfg.vocab_size))
            )
            r.out_tokens.append(nxt)
            self.tokens_out += 1
            if (
                len(r.out_tokens) >= r.max_new_tokens
                or (self.eos_id is not None and nxt == self.eos_id)
                or slot.pos >= self.max_seq
            ):
                r.done = True
                r.finish_step = self.steps
                finished.append(r)
                slot.req = None
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self.active == 0 and not self.queue:
                break
        return done

    @property
    def throughput(self) -> float:
        return self.tokens_out / max(self.steps, 1)

    def heartbeat(self, now_s: float, seconds_per_step: float = 1.0) -> PerfReport | None:
        """Work/sec since the last heartbeat, as a PerfReport for the
        homogenized dispatcher's tracker (the paper's background process).

        Work counts *prompt tokens consumed* as well as output tokens: a
        step spent teacher-forcing a prompt is real engine work, so a
        mid-prompt-feed window reports the engine's true speed instead of
        going silent (silence froze the tracker's perf estimate exactly when
        a new bundle landed — the early-estimate distortion).  Returns None
        when no engine steps ran since the last call."""
        steps = self.steps - self._hb_steps
        work = (self.tokens_out - self._hb_tokens) + (
            self.prompt_fed - self._hb_fed
        )
        if steps <= 0 or work <= 0:
            return None
        self._hb_steps, self._hb_tokens = self.steps, self.tokens_out
        self._hb_fed = self.prompt_fed
        return PerfReport(
            worker=self.name,
            work_done=float(work),
            elapsed_s=steps * seconds_per_step,
            time_s=now_s,
        )
