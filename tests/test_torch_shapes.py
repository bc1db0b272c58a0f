"""The port's batch functions (``configs/shapes.py``) against the
reference's concrete ones, bit for bit, and the training launcher's
``--mode single`` on the three input modes those functions feed.

Both packages draw from numpy's ``default_rng(0)`` anew on every array, so
``tgt_tokens`` equals ``targets``, and the M-RoPE positions are three equal
streams: the reference's ``_arr``, copied as it is.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes
from repro_torch.tree import tree_leaves

# One intra-op thread: a torch file on one test worker must not take every
# core from the timing tests that run beside it.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert np.array_equal(t.numpy(), j)


def test_the_port_runs_every_arch_of_the_reference():
    assert ARCH_IDS == JAX_ARCH_IDS


def test_shapes_and_cell_status_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.CROSS_SEQ_DECODE == jshapes.CROSS_SEQ_DECODE
    for arch in ARCH_IDS:
        for name, shape in shapes.SHAPES.items():
            assert shapes.cell_status(get_config(arch), shape) == \
                jshapes.cell_status(jax_get_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_and_prefill_batches_are_bitwise_the_reference(arch):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                              reduced=True)
    for port_fn, ref_fn in ((shapes.train_batch_specs,
                             jshapes.train_batch_specs),
                            (shapes.prefill_batch_specs,
                             jshapes.prefill_batch_specs)):
        got = port_fn(cfg, 2, 12, device="cpu")
        want = ref_fn(jcfg, 2, 12, concrete=True)
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])
    if cfg.is_enc_dec:
        assert torch.equal(got["tgt_tokens"], shapes.train_batch_specs(
            cfg, 2, 12, device="cpu")["targets"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_inputs_are_bitwise_the_reference(arch):
    """Inputs, zeroed caches (enc-dec: a cross cache of CROSS_SEQ_DECODE
    rows) and ``pos = seq - 1``."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                              reduced=True)
    inputs, caches, pos = shapes.decode_input_specs(cfg, 2, 16, device="cpu")
    jinputs, jcaches, jpos = jshapes.decode_input_specs(jcfg, 2, 16,
                                                        concrete=True)
    if isinstance(jinputs, dict):
        assert sorted(inputs) == sorted(jinputs)
        for key in jinputs:
            _same(inputs[key], jinputs[key])
    else:
        _same(inputs, jinputs)
    _same(pos, jpos)
    jleaves = jax.tree_util.tree_leaves(jcaches)
    leaves = tree_leaves(caches)
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves, strict=True):
        _same(t, j)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-vl-7b",
                                  "seamless-m4t-medium"])
def test_train_launcher_single_mode_on_the_new_archs(arch):
    """``launch/train.py --mode single`` on the CPU: the embeds and enc-dec
    batches come from ``train_batch_specs``; two steps, finite losses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: loss "), out.stdout
    losses = [float(w) for w in last.split() if w[0].isdigit()]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_trains_a_step_and_decodes(arch):
    """The reference's per-arch smoke (``tests/test_archs_smoke.py``) on the
    port: the reduced config builds on the CPU, has finite gradients that
    are not all zero on ``train_batch_specs``' batch, takes one AdamW step,
    and decodes one step of ``decode_input_specs`` to finite logits, the
    caches' shapes kept."""
    from repro_torch.models import Model
    from repro_torch.train import (
        init_train_state,
        make_grain_grad_fn,
        make_train_step,
    )

    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    batch = shapes.train_batch_specs(cfg, 2, 16, device="cpu")
    (loss, _), grads = make_grain_grad_fn(model)(params, batch)
    grads = tree_leaves(grads)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    state, metrics = make_train_step(model)(init_train_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    inputs, caches, pos = shapes.decode_input_specs(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        logits, new = model.decode_step(state.params, caches, inputs, pos)
    assert tuple(logits.shape) == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert [tuple(t.shape) for t in tree_leaves(new)] == \
        [tuple(t.shape) for t in tree_leaves(caches)]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-vl-7b",
                                  "seamless-m4t-medium"])
def test_bridge_carries_the_new_leaves_as_they_are(arch):
    """The params bridge maps the reference's MLA, encoder and
    cross-attention leaves one to one: the same paths, shapes, dtypes and
    bits."""
    from repro.models import Model as JaxModel
    from repro_torch.models import params_from_numpy

    jparams = JaxModel(jax_get_config(arch, reduced=True)).init(
        jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(tree_leaves(tparams)) == len(flat)
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        _same(node, leaf)
