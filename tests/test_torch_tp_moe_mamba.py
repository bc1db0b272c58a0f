"""Tensor-parallel compute of the MoE and Mamba layers over the ``model``
axis (``models/moe.py``'s expert-parallel and expert-TP routes,
``models/mamba.py``'s split heads, ``sharding/apply.py``'s plan and decode
caches) against the unsharded port steps and the reference.

The multi-rank cases run reduced configs on ``gloo`` ranks in
subprocesses (``tests/test_torch_tp.py``'s ``_run_ranks``): ``qwen2-moe-
a2.7b`` (8 experts: expert-parallel at model 2 and 4; with 6 experts at
model 4, expert-TP on the experts' width), ``mamba2-2.7b`` (8 heads) and
``jamba-v0.1-52b`` (8 Mamba heads, 4 experts, attention), at (1, 2) and
(1, 4) and under ``seq_parallel``.  The Mamba layers' ``norm``,
``dt_bias``, ``d_skip`` and ``conv_b`` are drawn non-uniform, so a norm
taken over one rank's channels, or a vector cut to the wrong heads, shows.
Each case takes one train step (loss, parameters and both moments against
the unsharded port step within 5e-5, the loss against the reference's on
the same weights), the loss gradient (every leaf, the router's by its
relative error too: the aux loss counted once), a prefill and four decode
steps (logits and caches against the unsharded ones, tokens equal), and
counts the collectives of one decode step (``CommDebugMode``): past the
conv window's gathers, none is the size of a cache.  Each rank must run
its own experts (or every expert at its width) and its own heads.  A case
at world size 1 holds the sharded steps to the unsharded steps' bits.

The in-process cases hold the split MoE routes (the ranks' partial sums
added up) against the whole layer, and the split gated norm against the
whole one, rank by rank.
"""

import dataclasses
import json
import pickle
import textwrap

import jax
import numpy as np
import pytest
import torch
from test_torch_tp import _run_ranks

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import train_batch_specs as jax_train_batch
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.layers import gated_rms_norm
from repro_torch.models.parallel import Group
from repro_torch.sharding.tp import TPGroup

torch.set_num_threads(1)

TOL = (5e-4, 5e-5)                     # f32 (rtol, atol), the reference's
BATCH = 4

_WORKER = textwrap.dedent(
    """
    import dataclasses, json, pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, nd, nm, pkl, case = sys.argv[1:8]
    rank, world, nd, nm = int(rank), int(world), int(nd), int(nm)
    case = json.loads(case)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import train_batch_specs
    from repro_torch.launch.dryrun import _collective_mode
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, mamba, moe, params_from_numpy
    from repro_torch.sharding import Policy
    from repro_torch.sharding.policy import is_spec, to_placements
    from repro_torch.sharding import apply
    from repro_torch.sharding.apply import (distribute_tree, full_tree,
        make_sharded_decode_step, make_sharded_prefill_step,
        make_sharded_train_step)
    from repro_torch.train import (TrainState, init_train_state,
        make_decode_step, make_prefill_step, make_train_step, step)
    from repro_torch.tree import tree_flatten, tree_leaves, tree_paths

    base = get_config(case["arch"], reduced=True)
    over = dict(case["cfg"])
    if case.get("moe"):
        over["moe"] = dataclasses.replace(base.moe, **case["moe"])
    cfg = dataclasses.replace(base, **over)
    model = Model(cfg, device="cpu")
    mesh = make_debug_mesh(nd, nm, device_type="cpu")
    pol = Policy(cfg, mesh)
    with open(pkl, "rb") as f:
        ref = pickle.load(f)
    init = lambda: params_from_numpy(ref, "cpu")
    b, s = case["batch"], 16
    batch = train_batch_specs(cfg, b, s, device="cpu")
    out = {"rank": rank}
    TOL = (5e-4, 5e-5)

    def margins(got, want):
        # Each leaf's largest |got - want| - rtol |want|: within the f32
        # tolerance where it is at most atol.
        return [float(((a - c).abs() - TOL[0] * c.abs()).max())
                for a, c in zip(tree_leaves(got), tree_leaves(want),
                                strict=True)]

    def equal(got, want):
        return all(torch.equal(a, c) for a, c in zip(
            tree_leaves(got), tree_leaves(want), strict=True))

    # What each rank's split layers get: the experts' weights (E, d, ff)
    # and the heads K5's op scans, while a sharded step runs.
    seen = {"on": False, "experts": set(), "heads": set()}
    real_mlp, real_ssd = moe._expert_mlp, mamba.ssd

    def rec_mlp(x, w_gate, *a, **k):
        if seen["on"] and w_gate.ndim == 3:
            seen["experts"].add(tuple(w_gate.shape))
        return real_mlp(x, w_gate, *a, **k)

    def rec_ssd(x, *a, **k):
        if seen["on"]:
            seen["heads"].add(x.shape[2])
        return real_ssd(x, *a, **k)

    moe._expert_mlp, mamba.ssd = rec_mlp, rec_ssd

    def sharded(fn, *args):
        seen["on"] = True
        try:
            return fn(*args)
        finally:
            seen["on"] = False

    # ---- one train step, sharded against unsharded; the gradients as
    # each step hands them to AdamW
    grads = {}

    def keep_grads(mod, key):
        real = mod.adamw_update

        def update(g, *a, **k):
            grads[key] = g
            return real(g, *a, **k)

        mod.adamw_update = update

    keep_grads(apply, "sharded")
    keep_grads(step, "unsharded")
    state = init_train_state(init())
    sstate = TrainState(
        params=distribute_tree(state.params, pol.param_specs(state.params),
                               mesh),
        opt=distribute_tree(state.opt, pol.opt_specs(state.params), mesh))
    sbatch = distribute_tree(batch, pol.batch_specs(batch), mesh)
    sparams = sstate.params
    sstate, met = sharded(make_sharded_train_step(model, mesh), sstate,
                          sbatch)
    ustate, umet = make_train_step(model)(init_train_state(init()), batch)
    sgrads, ugrads = full_tree(grads["sharded"]), grads["unsharded"]
    out["grads"] = margins(sgrads, ugrads)
    out["grads_equal"] = equal(sgrads, ugrads)
    router = [(g, u) for p, g, u in zip(tree_paths(ugrads),
                                        tree_leaves(sgrads),
                                        tree_leaves(ugrads), strict=True)
              if ("key", "router") in p]
    out["router_rel"] = [float(torch.linalg.vector_norm(g - u)
                               / torch.linalg.vector_norm(u))
                         for g, u in router]
    out["aux"], out["aux_unsharded"] = float(met["aux"]), float(umet["aux"])
    out["loss"], out["loss_unsharded"] = float(met["loss"]), float(
        umet["loss"])
    out["train_equal"] = True
    for key, sv, uv in (("params", sstate.params, ustate.params),
                        ("m", sstate.opt["m"], ustate.opt["m"]),
                        ("v", sstate.opt["v"], ustate.opt["v"])):
        full = full_tree(sv)
        out[key] = margins(full, uv)
        out["train_equal"] &= equal(full, uv)

    # ---- prefill, logits and caches against the unsharded prefill
    params = init()
    pb = {"tokens": batch["tokens"][:, :8]}
    lg, caches = make_prefill_step(model)(params, pb)
    slg, scaches = sharded(make_sharded_prefill_step(model, mesh), sparams,
                           distribute_tree(pb, pol.batch_specs(pb), mesh))
    slg = slg.full_tensor()
    out["prefill_logits"] = margins(slg, lg)
    out["prefill_caches"] = margins(full_tree(scaches), caches)
    out["prefill_equal"] = equal(slg, lg) and equal(full_tree(scaches),
                                                    caches)
    # The prefill's caches at the decode's placements (``cache_specs``).
    want_pl = [to_placements(sp, mesh) for sp in tree_flatten(
        pol.cache_specs(caches), is_leaf=is_spec)[0]]
    out["cache_placements"] = {
        "/".join(str(k) for _, k in p): [str(d.placements), str(tuple(w))]
        for p, d, w in zip(tree_paths(scaches), tree_leaves(scaches),
                           want_pl, strict=True)}

    # ---- four decode steps from the prefill's caches, in a cache of 64
    def longer(c):
        big = model.init_cache(b, 64)
        for x, y in zip(tree_leaves(big), tree_leaves(c), strict=True):
            (x if x.shape == y.shape else x.narrow(2, 0, 8)).copy_(y)
        return big

    ucaches = longer(caches)
    dcaches = distribute_tree(longer(full_tree(scaches)),
                              pol.cache_specs(ucaches), mesh)
    # The smallest cache a decode keeps as this rank's shard, one layer's
    # (an attention layer's K shard), one layer's whole Mamba state, and
    # the bytes of a conv window's gather.
    limits, conv_bytes = [], 0
    for p, d in zip(tree_paths(dcaches), tree_leaves(dcaches), strict=True):
        name = p[-1][1]
        per = d.to_local()[0].numel() * d.to_local().element_size()
        whole = d[0].numel() * d.element_size()
        if name == "k":
            limits.append(per)
        elif name == "state":
            limits.append(whole)
        elif name == "conv":
            # This rank's rows of one layer's window, whole over ``model``.
            rows = d.to_local().shape[1]
            conv_bytes = whole * rows // d.shape[1]
            out["conv_split"] = "Shard" in str(d.placements[1])
    out["cache_limit"], out["conv_bytes"] = min(limits), conv_bytes
    inputs = batch["tokens"][:, 7:8].contiguous()
    sinputs = inputs
    dstep, sdstep = make_decode_step(model), make_sharded_decode_step(
        model, mesh)
    toks, stoks, logit_m, dec_equal = [], [], [], True
    for i in range(4):
        pos = torch.tensor(8 + i, dtype=torch.int32)
        ulg, ucaches = dstep(params, ucaches, inputs, pos)
        sin = distribute_tree(sinputs, pol.batch_specs(sinputs), mesh)
        if i == 0:
            comm = _collective_mode()
            with comm:
                slg, dcaches = sharded(sdstep, sparams, dcaches, sin, pos)
            # The collectives over the data axis are the fsdp parameter
            # gathers; the rest run over ``model``.
            assert nd == 1 or nd != nm
            rest = [c for c in comm.records if nd == 1 or c["group"] != nd]
            out["decode_param_gathers"] = len(comm.records) - len(rest)
            conv = [c for c in rest if c["op"] == "all-gather"
                    and c["bytes"] == conv_bytes]
            out["decode_conv_gathers"] = len(conv)
            out["decode_collectives"] = [c for c in rest if c not in conv]
        else:
            slg, dcaches = sharded(sdstep, sparams, dcaches, sin, pos)
        slg = slg.full_tensor()
        logit_m += margins(slg, ulg)
        dec_equal &= equal(slg, ulg)
        inputs = torch.argmax(ulg[:, 0], -1, keepdim=True).to(torch.int32)
        sinputs = torch.argmax(slg[:, 0], -1, keepdim=True).to(torch.int32)
        toks.append(inputs[:, 0].tolist())
        stoks.append(sinputs[:, 0].tolist())
    out["decode_logits"] = logit_m
    out.update(tokens=toks, sharded_tokens=stoks)
    out["decode_caches"] = margins(full_tree(dcaches), ucaches)
    out["decode_equal"] = dec_equal and equal(full_tree(dcaches), ucaches)
    out["experts"] = sorted(seen["experts"])
    out["heads"] = sorted(seen["heads"])
    print(json.dumps(out))
    dist.destroy_process_group()
    """
)

#: Mamba leaves drawn non-uniform in every case (the reference inits them
#: to zeros, ones or a ramp).
_DRAWN = ("norm", "dt_bias", "d_skip", "conv_b")


def _jax_cfg(arch: str, moe_over: dict):
    cfg = jax_get_config(arch, reduced=True)
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_over))
    return cfg


_REFS: dict = {}


def _reference(arch: str, moe_over: dict, tmp_path_factory):
    """The weights (pickled numpy, the Mamba leaves redrawn) and the
    reference's loss on them, once per config."""
    key = (arch, json.dumps(moe_over, sort_keys=True))
    if key not in _REFS:
        jcfg = _jax_cfg(arch, moe_over)
        jm = JaxModel(jcfg)
        jparams = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        rng = np.random.default_rng(1)

        def redraw(path, leaf):
            names = [getattr(k, "key", None) for k in path]
            if "mamba" in names and names[-1] in _DRAWN:
                return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
            return leaf

        jparams = jax.tree_util.tree_map_with_path(redraw, jparams)
        pkl = tmp_path_factory.mktemp("tp_moe_mamba") / "params.pkl"
        with open(pkl, "wb") as f:
            pickle.dump(jparams, f)
        batch = jax_train_batch(jcfg, BATCH, 16, concrete=True)
        _REFS[key] = (str(pkl), float(jm.loss(jparams, batch)[0]))
    return _REFS[key]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL[1] + TOL[0] * abs(b)


_CASES = [
    pytest.param("qwen2-moe-a2.7b", (1, 2), {"sharding_policy": "fsdp_tp"},
                 {}, id="qwen2-moe-ep-1x2-fsdp_tp"),
    pytest.param("qwen2-moe-a2.7b", (1, 4), {"sharding_policy": "tp"}, {},
                 id="qwen2-moe-ep-1x4-tp"),
    pytest.param("qwen2-moe-a2.7b", (1, 4), {"sharding_policy": "fsdp_tp"},
                 {"n_routed": 6}, id="qwen2-moe-etp-1x4-fsdp_tp"),
    pytest.param("mamba2-2.7b", (1, 2), {"sharding_policy": "fsdp_tp"}, {},
                 id="mamba2-1x2-fsdp_tp"),
    pytest.param("mamba2-2.7b", (1, 4), {"sharding_policy": "tp"}, {},
                 id="mamba2-1x4-tp"),
    pytest.param("mamba2-2.7b", (1, 2), {"sharding_policy": "fsdp_tp",
                                         "seq_parallel": True}, {},
                 id="mamba2-1x2-fsdp_tp-sp"),
    pytest.param("jamba-v0.1-52b", (1, 2), {"sharding_policy": "fsdp_tp"},
                 {}, id="jamba-1x2-fsdp_tp"),
    pytest.param("jamba-v0.1-52b", (1, 4), {"sharding_policy": "tp"}, {},
                 id="jamba-1x4-tp"),
    pytest.param("jamba-v0.1-52b", (1, 2), {"sharding_policy": "fsdp_tp",
                                            "seq_parallel": True}, {},
                 id="jamba-1x2-fsdp_tp-sp"),
    pytest.param("jamba-v0.1-52b", (1, 1), {"sharding_policy": "fsdp_tp"},
                 {}, id="jamba-1x1-bitwise"),
    pytest.param("jamba-v0.1-52b", (2, 4), {"sharding_policy": "fsdp_tp"},
                 {}, id="jamba-2x4-fsdp_tp", marks=pytest.mark.slow),
    pytest.param("qwen2-moe-a2.7b", (2, 4), {"sharding_policy": "fsdp_tp"},
                 {"n_routed": 6}, id="qwen2-moe-etp-2x4-fsdp_tp",
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("arch,mesh,over,moe_over", _CASES)
def test_tp_moe_mamba_match_unsharded_and_reference(arch, mesh, over,
                                                    moe_over,
                                                    tmp_path_factory):
    """Train, the loss gradient, prefill and decode of MoE and Mamba
    layers split over ``model`` on gloo ranks, against the unsharded port
    steps and the reference's loss."""
    nd, nm = mesh
    pkl, ref_loss = _reference(arch, moe_over, tmp_path_factory)
    ranks = _run_ranks(nd, nm, pkl, {"arch": arch, "cfg": over,
                                     "moe": moe_over, "batch": BATCH},
                       worker=_WORKER)
    cfg = get_config(arch, reduced=True)
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_over))
    for res in ranks:
        if nd * nm == 1:
            # At world size 1 the sharded steps are the unsharded steps.
            assert res["grads_equal"] and res["train_equal"]
            assert res["prefill_equal"] and res["decode_equal"]
        # One train step: the loss against the unsharded step and the
        # reference, every parameter leaf and both moments within 5e-5.
        assert _close(res["loss"], res["loss_unsharded"]), res["loss"]
        assert _close(res["loss"], ref_loss), (res["loss"], ref_loss)
        for key in ("grads", "params", "m", "v"):
            assert max(res[key]) <= TOL[1], (key, max(res[key]))
        # The router's gradient: the aux loss's counted once, though every
        # rank computes it.
        if cfg.moe is not None:
            assert res["router_rel"] and max(res["router_rel"]) <= 1e-5, \
                res["router_rel"]
            assert _close(res["aux"], res["aux_unsharded"])
        # Prefill and decode within the f32 tolerance; tokens equal.
        for key in ("prefill_logits", "prefill_caches", "decode_logits",
                    "decode_caches"):
            assert max(res[key]) <= TOL[1], (key, max(res[key]))
        assert res["sharded_tokens"] == res["tokens"]
        # Each rank runs its own experts (or every expert at its width)
        # and its own Mamba heads.
        if cfg.moe is not None:
            e, f = cfg.moe.n_routed, cfg.moe.d_expert
            want = (e // nm, cfg.d_model, f) if e % nm == 0 \
                else (e, cfg.d_model, f // nm)
            assert res["experts"] == [list(want)], res["experts"]
        if cfg.ssm is not None:
            assert res["heads"] == [cfg.ssm.n_heads(cfg.d_model) // nm]
            # The state split by heads over ``model``.
            for path, (pl, _) in res["cache_placements"].items():
                if path.endswith("state"):
                    assert nm == 1 or pl.endswith("Shard(dim=2))"), pl
        # The prefill's caches come back at the decode's placements.
        for path, (pl, want) in res["cache_placements"].items():
            assert pl == want, (path, pl, want)
        # No collective of a decode step is the size of a cache: past the
        # fsdp parameter gathers and one gather of each Mamba layer's conv
        # window (its channels are split evenly, not by heads), the
        # largest is under one layer's own K shard and under one layer's
        # Mamba state.
        if over["sharding_policy"] == "tp" or nd == 1:
            assert res["decode_param_gathers"] == 0
        n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_pattern) \
            * cfg.n_periods
        assert res["decode_conv_gathers"] == (
            n_mamba if res.get("conv_split") else 0)
        coll = res["decode_collectives"]
        assert (not coll and nm == 1) or max(
            c["bytes"] for c in coll) < res["cache_limit"], coll


# ------------------------------------------- split MoE routes, in process
def _moe_cfg(e: int, shared: bool):
    return dataclasses.replace(
        get_config("qwen2-moe-a2.7b", reduced=True),
        moe=dataclasses.replace(get_config("qwen2-moe-a2.7b",
                                           reduced=True).moe, n_routed=e,
                                n_shared=int(shared),
                                d_shared=128 if shared else 0,
                                capacity_factor=1.0))


def _moe_share(p: dict, cfg, r: int, m: int) -> dict:
    """Rank r's shards at the policy's specs: experts split where they
    divide, else their width; the shared expert's width; the router
    whole."""
    e = cfg.moe.n_routed
    out = {"router": p["router"]}
    for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        t = p[name]
        out[name] = t.chunk(m, dim=0)[r] if e % m == 0 \
            else t.chunk(m, dim=dim)[r]
    if "shared" in p:
        sp = p["shared"]
        out["shared"] = {"w_gate": sp["w_gate"].chunk(m, 1)[r],
                         "w_up": sp["w_up"].chunk(m, 1)[r],
                         "w_down": sp["w_down"].chunk(m, 0)[r]}
    return out


@pytest.mark.parametrize("e,m,shared", [(8, 2, True), (8, 4, False),
                                        (6, 4, True), (6, 2, False)])
def test_split_moe_partials_sum_to_the_whole_layer(e, m, shared):
    """Expert-parallel (E % m == 0) and expert-TP (otherwise): the ranks'
    partial sums of ``apply_moe`` (capacities that drop tokens) and of
    ``apply_moe_dense`` add up to the whole layer's output, and every
    rank's aux loss is the whole layer's."""
    cfg = _moe_cfg(e, shared)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    caps = torch.tensor([8, 0, 16, 8, 8, 8, 16, 8][:e])
    want, want_aux = moe.apply_moe(p, cfg, x, caps)
    want_d, _ = moe.apply_moe_dense(p, cfg, x)
    got = got_d = 0
    for r in range(m):
        g = TPGroup(None, r, m)
        part, aux = moe.apply_moe(_moe_share(p, cfg, r, m), cfg, x, caps,
                                  group=g)
        assert part.dtype == torch.float32
        assert torch.equal(aux, want_aux)
        got = got + part
        got_d = got_d + moe.apply_moe_dense(_moe_share(p, cfg, r, m), cfg, x,
                                            group=g)[0]
    torch.testing.assert_close(got, want, rtol=TOL[0], atol=TOL[1])
    torch.testing.assert_close(got_d, want_d, rtol=TOL[0], atol=TOL[1])


# -------------------------------------------- the split gated norm, in process
class _Ranks(Group):
    """One rank of ``size`` whose ``total`` returns the sum over every
    rank, given (after checking its own input is its share of it)."""

    def __init__(self, rank: int, size: int, parts: list):
        self.rank, self.size, self.parts = rank, size, parts

    def total(self, t):
        torch.testing.assert_close(t, self.parts[self.rank])
        return sum(self.parts)


@pytest.mark.parametrize("m", [2, 4])
def test_split_gated_norm_takes_the_whole_width(m):
    """The gated norm of a rank's channels, its mean square over every
    rank's (``Group.total``), under a non-uniform weight, equals the whole
    norm's channels; normalizing the rank's channels alone does not."""
    gen = torch.Generator().manual_seed(0)
    y, z = torch.randn(2, 5, 32, generator=gen), torch.randn(2, 5, 32,
                                                             generator=gen)
    w = torch.rand(32, generator=gen) + 0.5
    want = gated_rms_norm(y, z, w, 1e-5)
    n = 32 // m
    gated = y * torch.nn.functional.silu(z)
    parts = [torch.sum(gated[..., r * n:(r + 1) * n] ** 2, -1, keepdim=True)
             for r in range(m)]
    for r in range(m):
        cols = slice(r * n, (r + 1) * n)
        got = gated_rms_norm(y[..., cols], z[..., cols], w[cols], 1e-5,
                             _Ranks(r, m, parts), 32)
        torch.testing.assert_close(got, want[..., cols], rtol=TOL[0],
                                   atol=TOL[1])
        alone = gated_rms_norm(y[..., cols], z[..., cols], w[cols], 1e-5)
        assert not torch.allclose(alone, want[..., cols], rtol=TOL[0],
                                  atol=TOL[1])


# ---------------------------------------- split Mamba heads, one B/C group
@pytest.mark.parametrize("m", [2, 4])
def test_split_mamba_heads_need_one_group(m):
    """Every config's Mamba layers read one group of B and C, which each
    rank's heads take whole; a layer of more groups refuses to split."""
    from repro_torch.models import mamba

    base = get_config("mamba2-2.7b", reduced=True)
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm,
                                                            n_groups=2))
    p = mamba.init_mamba(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 4, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="n_groups"):
        mamba.mamba_train(p, cfg, x, group=TPGroup(None, 0, m))
