"""Tensor-parallel compute over the ``model`` axis (``sharding/tp.py``,
``sharding/apply.py``, the split-head routes of ``models/attention.py``)
against the unsharded port steps and the reference.

The multi-rank cases run the reduced ``qwen2-1.5b`` (4 q heads over 2 KV
heads: K/V split at model 2, replicated at model 4) on ``gloo`` ranks in
subprocesses, each rank a CPU process, as ``tests/test_torch_sharding.py``
runs them.  Each case takes one train step (loss, parameters and both
moments against the unsharded port step, the loss against the reference's
on the same weights), a prefill and four decode steps (logits and caches
against the unsharded ones, tokens equal), and counts the collectives of
one decode step (``CommDebugMode``): none may be the size of a cache.  At
model 4 each rank's attention must get its own q heads and the KV head
they read; under ``seq_parallel`` each checkpointed period must keep 1/m
of the unsharded step's saved bytes (``saved_tensors_hooks``).  Four
cases run in the default tier, ``1x2-fsdp_tp-shared`` among them (the
same steps over ``launch/shared_pg.py``'s backend, on its CPU route: host
mailboxes, the device route's protocol and rank order); the rest under
``-m slow``.

The in-process cases hold the head maps and the cache assembly of the
split-head routes against the global head map, rank by rank.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import train_batch_specs as jax_train_batch
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models.parallel import SINGLE, SOLO, Group

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = (5e-4, 5e-5)                     # f32 (rtol, atol), the reference's

_WORKER = textwrap.dedent(
    """
    import dataclasses, json, pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, nd, nm, pkl, case = sys.argv[1:8]
    rank, world, nd, nm = int(rank), int(world), int(nd), int(nm)
    case = json.loads(case)
    backend = case.get("backend", "gloo")
    if backend == "shared":
        from repro_torch.launch.shared_pg import register
        register()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import train_batch_specs
    from repro_torch.launch.dryrun import _collective_mode
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, attention, params_from_numpy
    from repro_torch.models import transformer
    from repro_torch.sharding import Policy
    from repro_torch.sharding.apply import (distribute_tree, full_tree,
        local_tree, make_sharded_decode_step, make_sharded_prefill_step,
        make_sharded_train_step)
    from repro_torch.train import (TrainState, init_train_state,
        make_decode_step, make_prefill_step, make_train_step)
    from repro_torch.tree import tree_leaves, tree_paths

    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              **case["cfg"])
    model = Model(cfg, device="cpu")
    mesh = make_debug_mesh(nd, nm, device_type="cpu")
    pol = Policy(cfg, mesh)
    with open(pkl, "rb") as f:
        ref = pickle.load(f)
    init = lambda: params_from_numpy(ref, "cpu")
    b, s = 2 * nd * nm, 16
    batch = train_batch_specs(cfg, b, s, device="cpu")
    out = {}

    TOL = (5e-4, 5e-5)

    def margins(got, want):
        # Each leaf's largest |got - want| - rtol |want|: within the f32
        # tolerance where it is at most atol.
        return [float(((a - c).abs() - TOL[0] * c.abs()).max())
                for a, c in zip(tree_leaves(got), tree_leaves(want),
                                strict=True)]

    def saved_per_period(fn):
        # The bytes each period's checkpoint saves (its inputs), read by
        # saved_tensors_hooks around each call of the checkpoint.
        per, real = [], transformer.checkpoint

        def wrapped(body, *args, **kw):
            got = []

            def pack(t):
                got.append(t.numel() * t.element_size())
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                res = real(body, *args, **kw)
            per.append(sum(got))
            return res

        transformer.checkpoint = wrapped
        try:
            res = fn()
        finally:
            transformer.checkpoint = real
        return res, per

    # ---- one train step, sharded against unsharded
    state = init_train_state(init())
    sstate = TrainState(
        params=distribute_tree(state.params, pol.param_specs(state.params),
                               mesh),
        opt=distribute_tree(state.opt, pol.opt_specs(state.params), mesh))
    sbatch = distribute_tree(batch, pol.batch_specs(batch), mesh)
    (sstate, met), sp_saved = saved_per_period(
        lambda: make_sharded_train_step(model, mesh)(sstate, sbatch))
    (ustate, umet), u_saved = saved_per_period(
        lambda: make_train_step(model)(init_train_state(init()), batch))
    out["loss"], out["loss_unsharded"] = float(met["loss"]), float(
        umet["loss"])
    out["saved"], out["saved_unsharded"] = sp_saved, u_saved
    for key, sv, uv in (("params", sstate.params, ustate.params),
                        ("m", sstate.opt["m"], ustate.opt["m"]),
                        ("v", sstate.opt["v"], ustate.opt["v"])):
        out[key] = margins(full_tree(sv), uv)

    # ---- prefill: the first layer's q and k as each rank's attention
    # gets them, logits and caches against the unsharded prefill
    params = init()
    sparams = distribute_tree(params, pol.param_specs(params), mesh)
    pb = {"tokens": batch["tokens"][:, :8]}
    seen, real_sdpa = [], attention._sdpa_full

    def keep(q, k, v, **kw):
        seen.append((q.clone(), k.clone()))
        return real_sdpa(q, k, v, **kw)

    attention._sdpa_full = keep
    try:
        lg, caches = make_prefill_step(model)(params, pb)
        slg, scaches = make_sharded_prefill_step(model, mesh)(
            sparams, distribute_tree(pb, pol.batch_specs(pb), mesh))
    finally:
        attention._sdpa_full = real_sdpa
    (uq, uk), (q, k) = seen[0], seen[len(seen) // 2]
    out["heads"] = {"q": list(q.shape), "k": list(k.shape),
                    "q_full": list(uq.shape), "k_full": list(uk.shape)}
    # This rank's rows of the batch, its q heads and the KV heads they read.
    dr = mesh.get_coordinate()[0]
    bl = uq.shape[0] // nd
    hq = q.shape[2]
    mr = mesh.get_coordinate()[1]
    group = uq.shape[2] // uk.shape[2]
    kv = sorted({(mr * hq + i) // group for i in range(hq)})
    uq_r = uq[dr * bl:(dr + 1) * bl, :, mr * hq:(mr + 1) * hq]
    uk_r = uk[dr * bl:(dr + 1) * bl, :, kv[0]:kv[-1] + 1]
    out["heads"]["kv"] = kv
    out["heads"]["q_err"] = float((q - uq_r).abs().max())
    out["heads"]["k_err"] = float((k - uk_r).abs().max())
    out["prefill_logits"] = margins(slg.full_tensor(), lg)
    out["prefill_caches"] = margins(full_tree(scaches), caches)
    out["cache_placements"] = [str(d.placements) for d in
                               tree_leaves(scaches)]

    # ---- four decode steps from the prefill's caches, in a cache of 64
    def longer(c):
        big = model.init_cache(b, 64)
        for x, y in zip(tree_leaves(big), tree_leaves(c), strict=True):
            x.narrow(2, 0, 8).copy_(y)
        return big

    ucaches = longer(caches)
    dcaches = distribute_tree(longer(full_tree(scaches)),
                              pol.cache_specs(ucaches), mesh)
    inputs = batch["tokens"][:, 7:8].contiguous()
    sinputs = inputs
    dstep, sdstep = make_decode_step(model), make_sharded_decode_step(
        model, mesh)
    toks, stoks, logit_m = [], [], []
    for i in range(4):
        pos = torch.tensor(8 + i, dtype=torch.int32)
        ulg, ucaches = dstep(params, ucaches, inputs, pos)
        sin = distribute_tree(sinputs, pol.batch_specs(sinputs), mesh)
        if i == 0:
            comm = _collective_mode()
            with comm:
                slg, dcaches = sdstep(sparams, dcaches, sin, pos)
            # A parameter's gather over the data axes (fsdp) has the shape
            # of the parameter, whole or with one dimension over ``model``.
            shapes = set()
            for path, d in zip(tree_paths(sparams), tree_leaves(sparams),
                               strict=True):
                shp = list(d.shape[1:] if ("key", "periods") in path
                           else d.shape)
                shapes.add(str(tuple(shp)))
                for i, n in enumerate(shp):
                    if n % nm == 0:
                        shapes.add(str(tuple(shp[:i] + [n // nm]
                                             + shp[i + 1:])))
            out["decode_collectives"] = [
                c for c in comm.records if not (
                    c["op"] == "all-gather" and any(
                        f" {sh} " in c["what"] for sh in shapes))]
            out["decode_param_gathers"] = len(comm.records) - len(
                out["decode_collectives"])
        else:
            slg, dcaches = sdstep(sparams, dcaches, sin, pos)
        slg = slg.full_tensor()
        logit_m += margins(slg, ulg)
        inputs = torch.argmax(ulg[:, 0], -1, keepdim=True).to(torch.int32)
        sinputs = torch.argmax(slg[:, 0], -1, keepdim=True).to(torch.int32)
        toks.append(inputs[:, 0].tolist())
        stoks.append(sinputs[:, 0].tolist())
    out["decode_logits"] = logit_m
    out.update(tokens=toks, sharded_tokens=stoks)
    out["decode_caches"] = margins(full_tree(dcaches), ucaches)
    k = next(d for d in tree_leaves(dcaches))
    out["cache_shard_bytes"] = (k.to_local()[0].numel()
                                * k.to_local().element_size())
    out["rank"] = rank
    print(json.dumps(out))
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(nd: int, nm: int, pkl: str, case: dict,
               timeout: int = 300, worker: str = _WORKER) -> list[dict]:
    """``worker`` on ``nd * nm`` gloo ranks in subprocesses (argv: rank,
    world, port, nd, nm, pkl, the case as JSON); each rank's last stdout
    line as JSON."""
    world = nd * nm
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(world), str(port),
         str(nd), str(nm), pkl, json.dumps(case)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL[1] + TOL[0] * abs(b)


_SLOW = pytest.mark.slow
_CASES = [
    pytest.param((1, 2), {"sharding_policy": "fsdp_tp"}, "gloo",
                 id="1x2-fsdp_tp"),
    pytest.param((1, 4), {"sharding_policy": "tp"}, "gloo", id="1x4-tp"),
    pytest.param((1, 2), {"sharding_policy": "fsdp_tp",
                          "seq_parallel": True}, "gloo", id="1x2-fsdp_tp-sp"),
    pytest.param((2, 2), {"sharding_policy": "tp", "vocab_size": 250,
                          "ce_chunk": 8}, "gloo",
                 id="2x2-tp-padded-vocab-ce_chunk", marks=_SLOW),
    pytest.param((2, 2), {"sharding_policy": "fsdp_tp"}, "gloo",
                 id="2x2-fsdp_tp", marks=_SLOW),
    pytest.param((1, 4), {"sharding_policy": "fsdp_tp"}, "gloo",
                 id="1x4-fsdp_tp", marks=_SLOW),
    pytest.param((1, 4), {"sharding_policy": "fsdp_tp",
                          "seq_parallel": True}, "gloo", id="1x4-fsdp_tp-sp",
                 marks=_SLOW),
    pytest.param((2, 2), {"sharding_policy": "fsdp_tp",
                          "seq_parallel": True}, "gloo", id="2x2-fsdp_tp-sp",
                 marks=_SLOW),
    pytest.param((1, 2), {"sharding_policy": "tp"}, "gloo", id="1x2-tp",
                 marks=_SLOW),
    pytest.param((2, 2), {"sharding_policy": "fsdp_tp"}, "shared",
                 id="2x2-fsdp_tp-shared", marks=_SLOW),
    pytest.param((1, 2), {"sharding_policy": "fsdp_tp"}, "shared",
                 id="1x2-fsdp_tp-shared"),
]


@pytest.mark.parametrize("mesh,over,backend", _CASES)
def test_tp_steps_match_unsharded_and_reference(mesh, over, backend,
                                                tmp_path):
    """Train, prefill and decode, tensor-parallel on gloo ranks (or on
    ``launch/shared_pg.py``'s backend, as ranks that share one card run,
    here on its CPU route), against the unsharded port steps and the
    reference's loss."""
    nd, nm = mesh
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b", reduced=True),
                               **over)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jparams), f)
    ranks = _run_ranks(nd, nm, str(pkl), {"cfg": over, "backend": backend})
    batch = jax_train_batch(jcfg, 2 * nd * nm, 16, concrete=True)
    ref_loss = float(jm.loss(jparams, batch)[0])
    for res in ranks:
        # One train step: the loss against the unsharded step and the
        # reference, every parameter leaf and both moments within 5e-5.
        assert _close(res["loss"], res["loss_unsharded"]), res["loss"]
        assert _close(res["loss"], ref_loss), (res["loss"], ref_loss)
        for key in ("params", "m", "v"):
            assert max(res[key]) <= TOL[1], (key, max(res[key]))
        # Prefill and decode within the f32 tolerance; tokens equal.
        for key in ("prefill_logits", "prefill_caches", "decode_logits",
                    "decode_caches"):
            assert max(res[key]) <= TOL[1], (key, max(res[key]))
        assert res["sharded_tokens"] == res["tokens"]
        # Each rank's attention: its H/m q heads and the KV heads they
        # read, equal to the unsharded projections of those heads.
        h = res["heads"]
        hq = jcfg.n_q_heads // nm
        assert h["q"][2] == hq and h["q_full"][2] == jcfg.n_q_heads
        group = jcfg.n_q_heads // jcfg.n_kv_heads
        mr = res["rank"] % nm
        assert h["kv"] == sorted({(mr * hq + i) // group
                                  for i in range(hq)})
        assert h["k"][2] == len(h["kv"])
        assert h["q_err"] <= TOL[1] and h["k_err"] <= TOL[1]
        # The prefill's caches come back at the decode's placements: the
        # sequence over ``model``.
        assert all("Shard(dim=2)" in p for p in res["cache_placements"])
        # No collective of a decode step is the size of a cache: past the
        # fsdp parameter gathers, the largest is under one layer's own
        # shard of it.
        if over["sharding_policy"] == "tp" or nd == 1:
            assert res["decode_param_gathers"] == 0
        coll = res["decode_collectives"]
        assert coll and max(c["bytes"] for c in coll) < \
            res["cache_shard_bytes"], coll
        # Each checkpointed period keeps its input: this rank's rows, and
        # under ``seq_parallel`` 1/m of their positions.
        share = nd * (nm if over.get("seq_parallel") else 1)
        assert len(res["saved"]) == len(res["saved_unsharded"]) == \
            jcfg.n_layers
        for sp, un in zip(res["saved"], res["saved_unsharded"],
                          strict=True):
            assert sp * share == un, (sp, un)


# ------------------------------------------------ head maps, in process
class _Rank(Group):
    """One rank of a group whose gathers read the other ranks' tensors
    from ``every`` (the rank's own input is ignored)."""

    def __init__(self, rank: int, size: int, every: list):
        self.rank, self.size, self.every = rank, size, every

    def gather(self, t, dim):
        return torch.cat(self.every, dim=dim)


_HEADS = [(4, 2, 2), (4, 2, 4), (16, 2, 2), (16, 2, 4), (16, 2, 8),
          (16, 2, 16), (12, 3, 2), (12, 3, 4), (8, 1, 4), (48, 1, 16),
          (32, 8, 4), (32, 4, 16), (12, 4, 6)]


def _cfg(h: int, kv: int):
    return dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                               n_heads=h, n_kv_heads=kv, head_dim=4,
                               d_model=8)


def _attn_params(h: int, kv: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"wq": torch.randn(8, h, 4, generator=g),
            "wk": torch.randn(8, kv, 4, generator=g),
            "wv": torch.randn(8, kv, 4, generator=g),
            "bk": torch.randn(kv, 4, generator=g),
            "bv": torch.randn(kv, 4, generator=g)}


def _rank_params(p: dict, h: int, kv: int, r: int, m: int) -> dict:
    """Rank r's shards at the policy's specs: q heads split, K/V split
    where they divide, else whole."""
    hq = h // m
    out = {"wq": p["wq"][:, r * hq:(r + 1) * hq]}
    for name in ("wk", "wv", "bk", "bv"):
        t = p[name]
        dim = 1 if name.startswith("w") else 0
        if kv % m == 0:
            t = t.narrow(dim, r * kv // m, kv // m)
        out[name] = t
    return out


def _heads_of(lp: dict, p: dict) -> list[int]:
    """The global KV heads whose columns a rank's ``wk`` holds."""
    return [next(u for u in range(p["wk"].shape[1])
                 if torch.equal(lp["wk"][:, j], p["wk"][:, u]))
            for j in range(lp["wk"].shape[1])]


@pytest.mark.parametrize("h,kv,m", _HEADS)
def test_local_kv_maps_each_q_head_to_its_kv_head(h, kv, m):
    """Rank by rank, the K/V column each local q head reads (by the
    kernels' map, i // (local q heads / KV columns), or the index that
    repeats K/V per q head) holds the KV head that the global map gives it
    (q head j reads KV head j // (h / kv)), whether K/V split with the q
    heads, are cut to a rank's range, or repeat per q head."""
    cfg = _cfg(h, kv)
    p = _attn_params(h, kv)
    hq = h // m
    for r in range(m):
        lp, expand = A._local_kv(_rank_params(p, h, kv, r, m), cfg,
                                 _Rank(r, m, []))
        heads = _heads_of(lp, p)
        for name in ("wv", "bk", "bv"):
            dim = 1 if name.startswith("w") else 0
            assert torch.equal(lp[name], p[name].index_select(
                dim, torch.tensor(heads)))
        cols = heads if expand is None else [heads[j] for j in
                                             expand.tolist()]
        per = hq // len(cols)
        assert per * len(cols) == hq
        assert [cols[i // per] for i in range(hq)] == \
            [(r * hq + i) // (h // kv) for i in range(hq)]


@pytest.mark.parametrize("h,kv,m", _HEADS)
def test_cache_shard_holds_every_kv_head_on_the_ranks_positions(h, kv, m):
    """``_cache_shard``: from each rank's own KV columns, every rank
    assembles all KV heads on its share of the sequence."""
    cfg = _cfg(h, kv)
    p = _attn_params(h, kv)
    s = 2 * m
    k_full = torch.randn(2, s, kv, 4,
                         generator=torch.Generator().manual_seed(2))
    hq = h // m
    own = []
    for r in range(m):
        lp, _ = A._local_kv(_rank_params(p, h, kv, r, m), cfg,
                            _Rank(r, m, []))
        own.append(k_full[:, :, _heads_of(lp, p)])
    width = max(t.shape[2] for t in own)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, width - t.shape[2]))
              for t in own]
    for r in range(m):
        got = A._cache_shard(own[r], cfg, _Rank(r, m, padded), hq)
        assert torch.equal(got, k_full[:, r * (s // m):(r + 1) * (s // m)])


def test_single_is_the_identity():
    """Without a sharded step every hook is the identity on its input."""
    x = torch.randn(2, 3, 4)
    for fn in (SOLO.col_in, SOLO.row_out, SOLO.sum, SOLO.max,
               SINGLE.seq_split, SINGLE.seq_gather, SINGLE.moe_tokens,
               SINGLE.moe_rows, SOLO.kv_in):
        assert fn(x) is x
    assert SINGLE.split(4, 4) is SOLO and SINGLE.in_periods() is SINGLE
    p = {"wq": x}
    got, expand = A._local_kv(p, None, SOLO)
    assert got is p and expand is None
