"""The port's dry run (``launch/dryrun.py``) and its abstract inputs
against the reference's: ``Model.abstract_params``, ``input_specs``,
``cell_status`` and ``model_flops`` for every arch and shape, the ring
model of ``collective_stats`` on the numbers of ``tests/test_dryrun_utils.
py``, and one cell under the fake process group in a subprocess."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_status as jax_cell_status
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.launch.dryrun import model_flops as jax_model_flops
from repro.models import Model as JaxModel
from repro_torch.configs import ARCH_IDS, SHAPES, cell_status, get_config, \
    input_specs
from repro_torch.launch.dryrun import collective_stats, model_flops
from repro_torch.models import Model
from repro_torch.tree import tree_flatten, tree_paths

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_leaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                t.device.type)
            for p, t in zip(tree_paths(tree), tree_flatten(tree)[0],
                            strict=True)}


def _jax_path(path) -> tuple:
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(("key", k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(("index", k.idx))
        else:
            out.append(("attr", k.name))
    return tuple(out)


def _ref_leaves(tree) -> dict:
    return {_jax_path(p): (tuple(leaf.shape), str(np.dtype(leaf.dtype)),
                           "meta")
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch):
    got = Model(get_config(arch), device="meta").abstract_params()
    want = JaxModel(jax_get_config(arch)).abstract_params()
    assert _port_leaves(got) == _ref_leaves(want)


@pytest.mark.parametrize("shape", tuple(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_cell_status_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cell_status(cfg, SHAPES[shape]) == jax_cell_status(
        jcfg, JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    want = jax_input_specs(jcfg, JAX_SHAPES[shape], concrete=False)
    assert sorted(got) == sorted(want)
    for key in got:
        assert _port_leaves(got[key]) == _ref_leaves(want[key]), key


@pytest.mark.parametrize("shape", tuple(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    s = SHAPES[shape]
    n_tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
    got = model_flops(cfg, Model(cfg, device="meta"), s, n_tokens, s.kind)
    want = jax_model_flops(jcfg, JaxModel(jcfg), JAX_SHAPES[shape], n_tokens,
                           s.kind)
    assert got == want


def test_collective_stats_ring_model():
    recs = [
        {"op": "all-reduce", "bytes": 1024 * 4, "group": 4, "what": "ar"},
        {"op": "all-gather", "bytes": 64 * 64 * 2, "group": 8, "what": "ag"},
        {"op": "collective-permute", "bytes": 16 * 4, "group": 2,
         "what": "cp"},
    ]
    st = collective_stats(recs)
    assert abs(st["per_op_bytes"]["all-reduce"] - 6144) < 1  # 2 r 3/4
    assert abs(st["per_op_bytes"]["all-gather"] - 7168) < 1  # r 7/8
    assert st["per_op_bytes"]["collective-permute"] == 64
    assert st["per_op_counts"]["all-reduce"] == 1
    assert len(st["top_ops"]) == 3
    assert st["top_ops"][0]["bytes"] >= st["top_ops"][1]["bytes"]
    rs = collective_stats([{"op": "reduce-scatter", "bytes": 100,
                            "group": 4}])
    assert rs["bytes_per_device"] == 300                     # r (g-1)
    assert collective_stats([{"op": "all-reduce", "bytes": 4096,
                              "group": 1}])["bytes_per_device"] == 0


_CELL = textwrap.dedent(
    """
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    from repro_torch.launch.dryrun import run_cell
    r = run_cell("qwen2-1.5b", "decode_32k", "single", sys.argv[1])
    print(json.dumps(r))
    """
)


def test_run_cell_under_fake_process_group(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _CELL, str(tmp_path)], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "run" and res["n_devices"] == 256
    assert [p.name for p in tmp_path.iterdir()] == [
        "qwen2-1.5b__decode_32k__single.json"]
    assert res["cost_flops_per_device"] > 0
    assert res["collectives"]["per_op_counts"]["all-gather"] > 0
    assert res["memory"]["peak_bytes"] >= res["memory"]["argument_bytes"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
