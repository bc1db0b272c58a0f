"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe``.

Each case of ``tests/test_moe.py`` runs on both packages with the same
numpy inputs and the same weights (the reference's ``init_moe`` through
``params_from_numpy``), in f32 on the CPU: the port's outputs, aux losses
and gradients match the reference's at its f32 tolerance (rtol 5e-4 / atol
5e-5, ``tests/test_kernels.py:20-23``), its capacities are the reference's
integers, and each case's own assertion holds on the port.  Two cases the
reference lacks: tied router probabilities (top-k takes the lowest expert
index first, as ``jax.lax.top_k`` does, so routing and the rank scatter
match token for token) and the sentinel bucket of dropped assignments (no
index error, the reference's values, dropped assignments contributing
nothing).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LayerSpec as JaxLayerSpec
from repro.models import ModelConfig as JaxModelConfig
from repro.models import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.models import moe
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5


def mk_cfg(e=8, k=2, cap=4.0, shared=0) -> JaxModelConfig:
    return JaxModelConfig(
        name="moe-test", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=64, head_dim=16,
        layer_pattern=(JaxLayerSpec("attn", "moe"),),
        moe=JaxMoEConfig(n_routed=e, top_k=k, d_expert=32,
                         capacity_factor=cap, n_shared=shared,
                         d_shared=64 if shared else 0),
        param_dtype="float32", compute_dtype="float32", use_pallas=False,
    )


def port_cfg(jcfg: JaxModelConfig) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["moe"] = port_config.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ModelConfig(**fields)


def _x(b=2, s=16, d=32, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, s, d))
            * 0.5).astype(np.float32)


def _params(jcfg, seed=0):
    """The reference's MoE params for ``seed``, and the same as tensors."""
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def _both(jcfg, jp, tp, x, capacities=None, dense=False):
    """(port, reference) (out, aux) of ``apply_moe`` (or
    ``apply_moe_dense``) on the same input, as numpy."""
    if dense:
        j = jax_moe.apply_moe_dense(jp, jcfg, jnp.asarray(x))
        t = moe.apply_moe_dense(tp, port_cfg(jcfg), torch.from_numpy(x))
    else:
        jcaps = None if capacities is None else jnp.asarray(capacities,
                                                            jnp.int32)
        j = jax_moe.apply_moe(jp, jcfg, jnp.asarray(x), jcaps)
        t = moe.apply_moe(tp, port_cfg(jcfg), torch.from_numpy(x),
                          capacities)
    return ([np.asarray(v.detach()) for v in t], [np.asarray(v) for v in j])


def _close(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_capacity_vs_dense_parity_no_drops():
    """With generous capacity, the capacity-routed path equals the dense
    sweep, and each equals the reference's."""
    jcfg = mk_cfg(cap=8.0)
    jp, tp = _params(jcfg)
    x = _x()
    cap, jcap = _both(jcfg, jp, tp, x)
    dense, jdense = _both(jcfg, jp, tp, x, dense=True)
    _close(cap, jcap)
    _close(dense, jdense)
    np.testing.assert_allclose(cap[0], dense[0], rtol=2e-4, atol=2e-5)
    assert dense[1] == 0.0


def test_drops_under_tight_capacity():
    jcfg = mk_cfg(cap=0.25)
    jp, tp = _params(jcfg)
    x = _x()
    tight, jtight = _both(jcfg, jp, tp, x)
    dense, _ = _both(jcfg, jp, tp, x, dense=True)
    _close(tight, jtight)
    assert float(np.max(np.abs(tight[0] - dense[0]))) > 1e-4


def test_aux_loss_positive_and_bounded():
    jcfg = mk_cfg()
    jp, tp = _params(jcfg)
    (out, aux), want = _both(jcfg, jp, tp, _x())
    _close([out, aux], want)
    assert 0 <= float(aux) < 1.0


def test_shared_expert_contributes():
    jcfg = mk_cfg(shared=1)
    jp, tp = _params(jcfg)
    x = _x()
    got, want = _both(jcfg, jp, tp, x)
    _close(got, want)
    jp0 = dict(jp, shared={k: np.zeros_like(v)
                           for k, v in jp["shared"].items()})
    got0, want0 = _both(jcfg, jp0, params_from_numpy(jp0, "cpu"), x)
    _close(got0, want0)
    assert float(np.max(np.abs(got[0] - got0[0]))) > 1e-5


# ------------------------------------------------- homogenized capacities
def test_capacity_per_expert_uniform():
    m = port_cfg(mk_cfg(e=8, k=2, cap=1.0)).moe
    caps = moe.capacity_per_expert(256, m)
    np.testing.assert_array_equal(
        caps, jax_moe.capacity_per_expert(256, mk_cfg(e=8, k=2, cap=1.0).moe))
    assert (caps == caps[0]).all()
    assert caps.sum() >= 256 * 2


def _rand_capacity_case(seed: int) -> tuple[list[float], int]:
    rng = np.random.default_rng(seed)
    size = int(rng.integers(4, 17))
    perfs = rng.uniform(0.2, 4.0, size).tolist()
    tokens = int(rng.integers(64, 4097))
    return perfs, tokens


@pytest.mark.parametrize(
    "perfs,tokens",
    [_rand_capacity_case(s) for s in range(12)]
    + [
        ([0.2] * 4, 64),              # smallest envelope corner
        ([4.0] * 16, 4096),           # largest
        ([0.2, 4.0, 0.2, 4.0], 64),   # 20:1 spread, few tokens
        ([0.2] * 15 + [4.0], 4096),   # one fast expert among crawlers
    ],
)
def test_capacity_proportional_to_perf(perfs, tokens):
    jcfg = mk_cfg(e=len(perfs), k=2, cap=1.0)
    m = port_cfg(jcfg).moe
    caps = moe.capacity_per_expert(tokens, m, expert_perfs=perfs, round_to=1)
    np.testing.assert_array_equal(caps, jax_moe.capacity_per_expert(
        tokens, jcfg.moe, expert_perfs=perfs, round_to=1))
    budget = int(m.capacity_factor * tokens * m.top_k)
    exact = np.asarray(perfs) / np.sum(perfs) * budget
    assert np.all(np.abs(caps - np.maximum(exact, 1))
                  <= np.maximum(exact, 1) + 1)


def test_homogenized_capacity_equalizes_finish_time():
    jcfg = mk_cfg(e=4, k=2, cap=1.0)
    perfs = [4.0, 2.0, 1.0, 0.5]
    caps = moe.capacity_per_expert(512, port_cfg(jcfg).moe,
                                   expert_perfs=perfs, round_to=1)
    np.testing.assert_array_equal(caps, jax_moe.capacity_per_expert(
        512, jcfg.moe, expert_perfs=perfs, round_to=1))
    ft = [c / p for c, p in zip(caps, perfs, strict=True)]
    assert max(ft) / min(ft) < 1.15, (caps, ft)


def test_homogenized_capacities_run_through_layer():
    jcfg = mk_cfg(e=4, k=2, cap=1.0)
    jp, tp = _params(jcfg, seed=1)
    caps = moe.capacity_per_expert(32, port_cfg(jcfg).moe,
                                   expert_perfs=[4.0, 2.0, 1.0, 0.5])
    got, want = _both(jcfg, jp, tp, _x(b=2, s=16), caps)
    _close(got, want)
    assert np.isfinite(got[0]).all()
    # The same capacities as a tensor give the same output.
    out, _ = moe.apply_moe(tp, port_cfg(jcfg), torch.from_numpy(_x()),
                           torch.as_tensor(caps, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), got[0])


def test_router_gradient_flows():
    """Every leaf's gradient (the router's through the gates and the aux
    loss) against ``jax.grad``."""
    jcfg = mk_cfg()
    jp, tp = _params(jcfg)
    x = _x()

    def jloss(params):
        out, aux = jax_moe.apply_moe(params, jcfg, jnp.asarray(x))
        return jnp.sum(out**2) + aux

    jg = jax.grad(jloss)(jp)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, aux = moe.apply_moe(tp, port_cfg(jcfg), torch.from_numpy(x))
    tg = torch.autograd.grad(torch.sum(out**2) + aux, leaves)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for t, j in zip(tg, jleaves, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    assert float(tg[0].abs().sum()) > 0          # router (sorted first)
    assert float(tg[1].abs().sum()) > 0          # w_down


# ------------------------------------------------------- port-only cases
def test_tied_router_probabilities_route_lowest_index_first():
    """A router whose columns 0-5 are zero ties those experts' logits
    exactly (and all eight on tokens where the other two lose): the port
    picks the tied experts lowest index first, as ``jax.lax.top_k`` does,
    token for token, and under a capacity that drops, the rank scatter
    keeps and drops the same assignments (equal outputs)."""
    jcfg = mk_cfg(e=8, k=2, cap=0.5)
    jp, _ = _params(jcfg)
    router = np.zeros_like(jp["router"])
    router[:, 6:] = jp["router"][:, 6:]
    jp = dict(jp, router=router)
    tp = params_from_numpy(jp, "cpu")
    x = _x(b=2, s=24)
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(router), axis=-1)
    _, jexp = jax.lax.top_k(probs, 2)
    _, _, texp = moe._route(tp, port_cfg(jcfg).moe, torch.from_numpy(xt))
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    assert (np.asarray(jexp) < 6).any()           # ties were decided
    got, want = _both(jcfg, jp, tp, x)
    _close(got, want)
    zero = dict(jp, router=np.zeros_like(router))
    got, want = _both(jcfg, zero, params_from_numpy(zero, "cpu"), x)
    _close(got, want)
    _, _, texp = moe._route(params_from_numpy(zero, "cpu"),
                            port_cfg(jcfg).moe, torch.from_numpy(xt))
    assert (texp.numpy() == [0, 1]).all()         # all eight tied


@pytest.mark.parametrize("caps", [[0] * 8, [8] * 8, [0, 64, 0, 64, 3, 5, 1, 2],
                                  [1000] * 8])
def test_dropped_assignments_take_the_sentinel(caps):
    """Every token's first choice is expert 7 (a constant feature that the
    router weighs heavily), so its 64 assignments overflow any capacity.
    Capacities of 0 (every assignment dropped: the output is the shared
    expert's alone), a tight 8, uneven ones, and ones above ``cap_max``
    (32 here, which then bounds the buckets: expert 7 fills its last
    slot, the last row of the buckets, so the clamped sentinel reads a real
    row that ``keep`` must mask): no index error, and the reference's
    values."""
    jcfg = mk_cfg(e=8, k=2, cap=1.0, shared=1)
    jp, _ = _params(jcfg)
    router = jp["router"].copy()
    router[0, 7] = 5.0
    jp = dict(jp, router=router)
    tp = params_from_numpy(jp, "cpu")
    x = _x(b=2, s=32)
    x[..., 0] = 2.0
    _, _, texp = moe._route(tp, port_cfg(jcfg).moe,
                            torch.from_numpy(x.reshape(64, -1)))
    assert (texp[:, 0] == 7).all()
    got, want = _both(jcfg, jp, tp, x, np.asarray(caps))
    _close(got, want)
    shared_only, _ = moe.apply_moe(
        dict(tp, w_down=torch.zeros_like(tp["w_down"])), port_cfg(jcfg),
        torch.from_numpy(x))
    if caps == [0] * 8:
        np.testing.assert_array_equal(got[0], shared_only.numpy())
    else:
        assert float(np.abs(got[0] - shared_only.numpy()).max()) > 1e-4


def test_expert_load_matches_reference():
    m = port_cfg(mk_cfg()).moe
    logits = np.random.default_rng(5).standard_normal((64, 8)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        moe.expert_load(m, torch.from_numpy(logits)).numpy(),
        np.asarray(jax_moe.expert_load(mk_cfg().moe, jnp.asarray(logits))),
        rtol=1e-6)


def test_router_stays_f32_under_bf16_params():
    """The router is f32 whatever ``param_dtype`` is, as the reference's
    ``dense_init(..., jnp.float32)`` makes it: the port's init draws it in
    f32 and the bridge leaves it uncast; the experts follow the dtype."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("qwen2-moe-a2.7b", reduced=True,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    layer = Model(cfg, device="cpu").init(0)["stack"]["periods"]["pos0"]
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["moe"]["w_gate"].dtype == torch.bfloat16
    jp, _ = _params(mk_cfg(shared=1))
    bridged = params_from_numpy(jp, "cpu", torch.bfloat16)
    assert bridged["router"].dtype == torch.float32
    assert bridged["shared"]["w_up"].dtype == torch.bfloat16
