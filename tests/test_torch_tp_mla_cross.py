"""Tensor-parallel compute of MLA (``models/mla.py``) and cross-attention
(``models/attention.py``) over the ``model`` axis, ``sharding/apply.py``'s
plan and decode caches for them, against the unsharded port steps and the
reference.

The multi-rank cases run the reduced ``deepseek-v2-236b`` (4 MLA heads:
its dense prefix layer and two MLA + MoE periods) and
``seamless-m4t-medium`` (4 heads: encoder self-attention, decoder self-
and cross-attention) on ``gloo`` ranks in subprocesses
(``tests/test_torch_tp.py``'s ``_run_ranks``), at (1, 2) and (1, 4), under
``seq_parallel``, at (1, 1), with 3 heads, which do not divide over
``model`` and fall back to whole layers, and DeepSeek-V2 cut to its dense
prefix layer (no periods).  Each case takes one train step
(loss, every gradient leaf, parameters and both moments against the
unsharded port step within 5e-5, the loss against the reference's on the
same weights), a prefill (logits, and caches at ``Policy.cache_specs``)
and 8 decode steps (logits and caches against the unsharded, tokens
equal).  The enc-dec model decodes from a cross cache twice the memory's
length, its second half zero rows, which the decode attends on the split
route as the reference does on the whole one.  One decode step's
collectives (``CommDebugMode``) hold no cache, whole or split; the decode's
plan splits the MLA and cross-attention groups.  Each rank must compute its
own heads.  The seamless case at (1, 2) also takes the gradient with the
encoder memory's sum over ``model`` left out (``Group.kv_in`` the
identity), which must miss the encoder's gradients.
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
    from repro_torch.models import Model, attention, mla, params_from_numpy
    from repro_torch.models import transformer
    from repro_torch.sharding import Policy, apply, tp
    from repro_torch.sharding.policy import is_spec, to_placements
    from repro_torch.sharding.apply import (distribute_tree, full_tree,
        make_sharded_decode_step, make_sharded_prefill_step,
        make_sharded_train_step)
    from repro_torch.train import (TrainState, init_train_state,
        make_decode_step, make_prefill_step, make_train_step, step)
    from repro_torch.tree import tree_flatten, tree_leaves, tree_paths

    cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                              **case["cfg"])
    model = Model(cfg, device="cpu")
    mesh = make_debug_mesh(nd, nm, device_type="cpu")
    pol = Policy(cfg, mesh)
    with open(pkl, "rb") as f:
        ref = pickle.load(f)
    init = lambda: params_from_numpy(ref, "cpu")
    b, s = case["batch"], 16
    batch = train_batch_specs(cfg, b, s, device="cpu")
    enc = cfg.is_enc_dec
    out = {"rank": rank}
    TOL = (5e-4, 5e-5)

    def margins(got, want):
        # Each leaf's largest |got - want| - rtol |want|: within the f32
        # tolerance where it is at most atol (an empty leaf, of zero
        # periods, at -1).
        return [float(((a - c).abs() - TOL[0] * c.abs()).max())
                if c.numel() else -1.0
                for a, c in zip(tree_leaves(got), tree_leaves(want),
                                strict=True)]

    def equal(got, want):
        return all(torch.equal(a, c) for a, c in zip(
            tree_leaves(got), tree_leaves(want), strict=True))

    # The heads each rank's MLA and cross-attention compute (``wuq``'s and
    # the cross ``wq``'s local head counts), while a sharded step runs.
    seen = {"on": False, "mla": set(), "cross": set()}
    real_latents, real_train = mla._latents, transformer.attention_train
    real_cross_q = attention._cross_q

    def rec_latents(p, *a, **k):
        if seen["on"]:
            seen["mla"].add(p["wuq"].shape[1])
        return real_latents(p, *a, **k)

    def rec_train(p, *a, **k):
        if seen["on"] and k.get("xkv") is not None:
            seen["cross"].add(p["wq"].shape[1])
        return real_train(p, *a, **k)

    def rec_cross_q(p, *a, **k):
        if seen["on"]:
            seen["cross"].add(p["wq"].shape[1])
        return real_cross_q(p, *a, **k)

    mla._latents, transformer.attention_train = rec_latents, rec_train
    attention._cross_q = rec_cross_q

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

    def sharded_state():
        state = init_train_state(init())
        return TrainState(
            params=distribute_tree(state.params,
                                   pol.param_specs(state.params), mesh),
            opt=distribute_tree(state.opt, pol.opt_specs(state.params),
                                mesh))

    sstate = sharded_state()
    sbatch = distribute_tree(batch, pol.batch_specs(batch), mesh)
    sparams = sstate.params
    sstate, met = sharded(make_sharded_train_step(model, mesh), sstate,
                          sbatch)
    ustate, umet = make_train_step(model)(init_train_state(init()), batch)
    sgrads, ugrads = full_tree(grads["sharded"]), grads["unsharded"]
    out["grads"] = margins(sgrads, ugrads)
    out["grads_equal"] = equal(sgrads, ugrads)
    out["loss"], out["loss_unsharded"] = float(met["loss"]), float(
        umet["loss"])
    out["train_equal"] = True
    for key, sv, uv in (("params", sstate.params, ustate.params),
                        ("m", sstate.opt["m"], ustate.opt["m"]),
                        ("v", sstate.opt["v"], ustate.opt["v"])):
        full = full_tree(sv)
        out[key] = margins(full, uv)
        out["train_equal"] &= equal(full, uv)
    if case.get("no_kv_sum"):
        # The encoder memory's gradient left as each rank's own heads'
        # share: the encoder's leaves must then miss.
        real_kv_in = tp.TPGroup.kv_in
        tp.TPGroup.kv_in = lambda self, x: x
        try:
            make_sharded_train_step(model, mesh)(sharded_state(), sbatch)
        finally:
            tp.TPGroup.kv_in = real_kv_in
        miss = full_tree(grads["sharded"])
        out["enc_grads_no_sum"] = [
            m for p, m in zip(tree_paths(ugrads), margins(miss, ugrads),
                              strict=True) if ("key", "enc_stack") in p]
        out["enc_grads"] = [
            m for p, m in zip(tree_paths(ugrads), out["grads"], strict=True)
            if ("key", "enc_stack") in p]

    # ---- prefill, logits and caches against the unsharded prefill
    params = init()
    if enc:
        pb = {"src_embeds": batch["src_embeds"],
              "tgt_tokens": batch["tgt_tokens"]}
        prompt = pb["tgt_tokens"]
    else:
        pb = {"tokens": batch["tokens"][:, :8]}
        prompt = pb["tokens"]
    L = prompt.shape[1]
    lg, caches = make_prefill_step(model)(params, pb)
    slg, scaches = sharded(make_sharded_prefill_step(model, mesh), sparams,
                           distribute_tree(pb, pol.batch_specs(pb), mesh))
    slg = slg.full_tensor()
    out["prefill_logits"] = margins(slg, lg)
    out["prefill_caches"] = margins(full_tree(scaches), caches)
    out["prefill_equal"] = equal(slg, lg) and equal(full_tree(scaches),
                                                    caches)
    want_pl = [to_placements(sp, mesh) for sp in tree_flatten(
        pol.cache_specs(caches), is_leaf=is_spec)[0]]
    out["cache_placements"] = {
        "/".join(str(k) for _, k in p): [str(d.placements), str(tuple(w))]
        for p, d, w in zip(tree_paths(scaches), tree_leaves(scaches),
                           want_pl, strict=True)}

    # ---- 8 decode steps from the prefill's caches, in a cache of 64 (and
    # for the enc-dec model a cross cache twice the memory's length: its
    # second half zero rows, which the decode attends)
    mem = pb["src_embeds"].shape[1] if enc else None

    def longer(c):
        big = model.init_cache(b, 64, cross_seq=2 * mem if enc else None)
        for x, y in zip(tree_leaves(big), tree_leaves(c), strict=True):
            dim = next(i for i, (n, m) in enumerate(zip(x.shape, y.shape))
                       if n != m)
            x.narrow(dim, 0, y.shape[dim]).copy_(y)
        return big

    ucaches = longer(caches)
    dcaches = distribute_tree(longer(full_tree(scaches)),
                              pol.cache_specs(ucaches), mesh)
    # Every cache leaf's shape, whole and as a rank's share: no collective
    # of a decode step may have one.
    cache_shapes = set()
    for d in tree_leaves(dcaches):
        for shp in (tuple(d.shape), tuple(d.shape[1:]),
                    tuple(d.to_local().shape),
                    tuple(d.to_local().shape[1:])):
            cache_shapes.add(str(shp))
    inputs = prompt[:, L - 1:L].contiguous()
    sinputs = inputs
    dstep, sdstep = make_decode_step(model), make_sharded_decode_step(
        model, mesh)
    real_plan, plans = apply._Plan, []

    def rec_plan(*a, **k):
        plans.append(real_plan(*a, **k))
        return plans[-1]

    toks, stoks, logit_m, dec_equal = [], [], [], True
    for i in range(8):
        pos = torch.tensor(L + i, dtype=torch.int32)
        ulg, ucaches = dstep(params, ucaches, inputs, pos)
        sin = distribute_tree(sinputs, pol.batch_specs(sinputs), mesh)
        if i == 0:
            comm = _collective_mode()
            apply._Plan = rec_plan
            try:
                with comm:
                    slg, dcaches = sharded(sdstep, sparams, dcaches, sin,
                                           pos)
            finally:
                apply._Plan = real_plan
            out["decode_groups"] = sorted(
                "/".join(n) for n in plans[-1].tp_groups)
            out["decode_cache_collectives"] = [
                c for c in comm.records
                if any(f" {sh} " in c["what"] for sh in cache_shapes)]
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
    if enc:
        # The whole decode from a cross cache of the memory's own length:
        # the zero rows move its logits.
        exact = model.init_cache(b, 64, cross_seq=mem)
        for x, y in zip(tree_leaves(exact), tree_leaves(caches),
                        strict=True):
            dim = next((i for i, (n, m) in enumerate(zip(x.shape, y.shape))
                        if n != m), 0)
            x.narrow(dim, 0, y.shape[dim]).copy_(y)
        elg, _ = dstep(params, exact, prompt[:, L - 1:L].contiguous(),
                       torch.tensor(L, dtype=torch.int32))
        first = make_decode_step(model)(params, longer(caches),
                                        prompt[:, L - 1:L].contiguous(),
                                        torch.tensor(L, dtype=torch.int32))[0]
        out["zero_rows_shift"] = float((elg - first).abs().max())
    out["mla_heads"] = sorted(seen["mla"])
    out["cross_heads"] = sorted(seen["cross"])
    print(json.dumps(out))
    dist.destroy_process_group()
    """
)

_REFS: dict = {}


def _cfg_over(over: dict) -> dict:
    """The overrides of a case that both packages take (heads, depth)."""
    return {k: v for k, v in over.items()
            if k in ("n_heads", "n_kv_heads", "n_layers")}


def _reference(arch: str, heads: dict, tmp_path_factory):
    """The weights (pickled numpy) and the reference's loss on them, once
    per config."""
    key = (arch, json.dumps(heads, sort_keys=True))
    if key not in _REFS:
        jcfg = jax_get_config(arch, reduced=True, **heads)
        jm = JaxModel(jcfg)
        # Jitted: the reduced DeepSeek-V2's eager init takes 15 s.
        jparams = jax.tree.map(np.asarray,
                               jax.jit(jm.init)(jax.random.key(0)))
        pkl = tmp_path_factory.mktemp("tp_mla_cross") / "params.pkl"
        with open(pkl, "wb") as f:
            pickle.dump(jparams, f)
        batch = jax_train_batch(jcfg, BATCH, 16, concrete=True)
        _REFS[key] = (str(pkl), float(jax.jit(jm.loss)(jparams, batch)[0]))
    return _REFS[key]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL[1] + TOL[0] * abs(b)


_DS, _SM = "deepseek-v2-236b", "seamless-m4t-medium"
_CASES = [
    pytest.param(_DS, (1, 2), {"sharding_policy": "fsdp_tp"},
                 id="deepseek-1x2-fsdp_tp"),
    pytest.param(_DS, (1, 4), {"sharding_policy": "tp"}, id="deepseek-1x4-tp"),
    pytest.param(_DS, (1, 1), {"sharding_policy": "fsdp_tp"},
                 id="deepseek-1x1-bitwise"),
    pytest.param(_DS, (1, 2), {"sharding_policy": "tp", "n_heads": 3,
                               "n_kv_heads": 3}, id="deepseek-1x2-3-heads"),
    pytest.param(_DS, (1, 2), {"sharding_policy": "fsdp_tp", "n_layers": 1},
                 id="deepseek-1x2-no-periods"),
    pytest.param(_SM, (1, 2), {"sharding_policy": "fsdp_tp",
                               "no_kv_sum": True}, id="seamless-1x2-fsdp_tp"),
    pytest.param(_SM, (1, 4), {"sharding_policy": "tp"}, id="seamless-1x4-tp"),
    pytest.param(_SM, (1, 2), {"sharding_policy": "tp",
                               "seq_parallel": True}, id="seamless-1x2-tp-sp"),
    pytest.param(_SM, (1, 1), {"sharding_policy": "tp"},
                 id="seamless-1x1-bitwise"),
    pytest.param(_SM, (1, 2), {"sharding_policy": "tp", "n_heads": 3,
                               "n_kv_heads": 3}, id="seamless-1x2-3-heads"),
]


@pytest.mark.parametrize("arch,mesh,over", _CASES)
def test_tp_mla_cross_match_unsharded_and_reference(arch, mesh, over,
                                                   tmp_path_factory):
    """Train, the loss gradient, prefill and decode of MLA and cross-
    attention split over ``model`` on gloo ranks, against the unsharded
    port steps and the reference's loss."""
    nd, nm = mesh
    heads = _cfg_over(over)
    pkl, ref_loss = _reference(arch, heads, tmp_path_factory)
    case = {"arch": arch, "batch": BATCH,
            "cfg": {k: v for k, v in over.items() if k != "no_kv_sum"},
            "no_kv_sum": over.get("no_kv_sum", False)}
    ranks = _run_ranks(nd, nm, pkl, case, worker=_WORKER)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **heads)
    h = cfg.n_q_heads
    split = nm > 1 and h % nm == 0
    for res in ranks:
        if nd * nm == 1:
            # At world size 1 the sharded steps are the unsharded steps.
            assert res["grads_equal"] and res["train_equal"]
            assert res["prefill_equal"] and res["decode_equal"]
        # One train step: the loss against the unsharded step and the
        # reference, every gradient, parameter leaf and both moments
        # within 5e-5.
        assert _close(res["loss"], res["loss_unsharded"]), res["loss"]
        assert _close(res["loss"], ref_loss), (res["loss"], ref_loss)
        for key in ("grads", "params", "m", "v", "prefill_logits",
                    "prefill_caches", "decode_logits", "decode_caches"):
            assert max(res[key]) <= TOL[1], (key, max(res[key]))
        assert res["sharded_tokens"] == res["tokens"]
        # The prefill's caches come back at the decode's placements.
        for path, (pl, want) in res["cache_placements"].items():
            assert pl == want, (path, pl, want)
        # Each rank computes its own heads where they divide, else all.
        want = [h // nm] if split else [h]
        if cfg.mla is not None:
            assert res["mla_heads"] == want, res["mla_heads"]
        else:
            assert res["cross_heads"] == want, res["cross_heads"]
        # The decode splits MLA and cross-attention over ``model`` and no
        # collective moves a cache, whole or a rank's share.
        kind = "mla" if cfg.mla is not None else "cross"
        groups = [g for g in res["decode_groups"] if g.endswith(kind)]
        # One group a layer of the prefix and of the period pattern.
        n = len(cfg.layer_pattern) + (len(cfg.prefix_pattern) if kind == "mla"
                                      else 0)
        assert len(groups) == (n if split else 0), groups
        assert not res["decode_cache_collectives"], \
            res["decode_cache_collectives"]
        if cfg.is_enc_dec:
            # The zero rows of the long cross cache move the logits.
            assert res["zero_rows_shift"] > 1e-3
        if case["no_kv_sum"]:
            # The encoder's gradients need the memory's gradient summed
            # over the ranks.
            assert max(res["enc_grads"]) <= TOL[1]
            assert max(res["enc_grads_no_sum"]) > 100 * TOL[1], \
                res["enc_grads_no_sum"]
