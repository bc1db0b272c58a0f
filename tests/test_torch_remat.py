"""``remat_policy="dots"`` against the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

The counterpart of ``tests/test_perf_knobs.py::test_remat_policies_same_loss``
on both packages (same weights through the params bridge, same numpy
batch): the losses of the two policies agree to 1e-6 in each package, the
port's ``dots`` gradients are within the f32 tolerance of ``jax.grad`` under
``dots``, and the port's backward recomputes fewer ``aten.mm`` calls under
``dots`` than under ``nothing`` (the saved products are not run again).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import LayerSpec as JaxLayerSpec
from repro.models import Model as JaxModel
from repro.models import ModelConfig as JaxModelConfig
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.tree import tree_flatten, tree_unflatten

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def base_cfg(**kw) -> JaxModelConfig:
    """``tests/test_perf_knobs.py``'s config."""
    d = dict(
        name="knobs", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=60, head_dim=8, vocab_pad_to=64,
        layer_pattern=(JaxLayerSpec("attn", "dense"),),
        param_dtype="float32", compute_dtype="float32",
        rope_theta=1e4, use_pallas=False,
    )
    d.update(kw)
    return JaxModelConfig(**d)


def port_cfg(jcfg: JaxModelConfig, **kw) -> ModelConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["layer_pattern"] = tuple(
        port_config.LayerSpec(**dataclasses.asdict(s))
        for s in jcfg.layer_pattern)
    fields["prefix_pattern"] = ()
    fields.update(kw)
    return ModelConfig(**fields)


def lm_batch(b=2, s=13, v=60, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, v, (b, s))
    return {"tokens": t, "targets": np.roll(t, -1, 1),
            "loss_mask": np.ones((b, s), np.float32)}


@pytest.fixture(scope="module")
def setup():
    jcfg = base_cfg()
    jparams = JaxModel(jcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = lm_batch()
    return jcfg, jparams, params, batch


def _jax_loss(jcfg, jparams, batch, policy):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    m = JaxModel(dataclasses.replace(jcfg, remat_policy=policy))
    loss = float(m.loss(jparams, jb)[0])
    grads = jax.grad(lambda p: m.loss(p, jb)[0])(jparams)
    return loss, [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss(jcfg, params, batch, policy, mode=None):
    m = Model(port_cfg(jcfg, remat_policy=policy), device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss, _ = m.loss(tree_unflatten(treedef, leaves), tb)
    if mode is None:
        grads = torch.autograd.grad(loss, leaves)
    else:
        with mode:
            grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_remat_policies_same_loss_on_both_packages(setup):
    jcfg, jparams, params, batch = setup
    j_n, _ = _jax_loss(jcfg, jparams, batch, "nothing")
    j_d, j_grads = _jax_loss(jcfg, jparams, batch, "dots")
    assert abs(j_n - j_d) < 1e-6
    p_n, p_grads_n = _port_loss(jcfg, params, batch, "nothing")
    p_d, p_grads = _port_loss(jcfg, params, batch, "dots")
    assert abs(p_n - p_d) < 1e-6
    assert abs(p_d - j_d) <= 5e-5 + 5e-4 * abs(j_d)
    assert len(p_grads) == len(j_grads)
    for g, w in zip(p_grads, j_grads, strict=True):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    for g, w in zip(p_grads, p_grads_n, strict=True):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


class _MMCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_fewer_matrix_products(setup):
    jcfg, _, params, batch = setup
    counts = {}
    for policy in ("nothing", "dots"):
        mode = _MMCount()
        _port_loss(jcfg, params, batch, policy, mode)
        counts[policy] = mode.n
    # Each period's forward runs again in the backward under "nothing";
    # under "dots" its matrix products come from the saved outputs.
    assert counts["dots"] < counts["nothing"], counts
