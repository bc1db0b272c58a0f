"""The port stands alone: running it loads neither JAX nor the JAX package,
and it never calls a library attention kernel or matrix product in place of
its own kernels.

Run-time checks happen in fresh subprocesses (this test process has JAX
loaded for the parity tests); the source scan covers every module of
``src/repro_torch`` and ``chip_smoke.py``.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import tokenize

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_REPORT = """
import json, sys
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps(bad))
"""

_SERVE = """
import numpy as np
from repro_torch.cluster import Cluster, ServeJob
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serve import Request

cfg = get_config("qwen2-1.5b", reduced=True, use_pallas=True)
model = Model(cfg, device="cpu")
params = model.init(0)
rng = np.random.default_rng(0)
reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab_size, 5 + 3 * i)], 3)
        for i in range(3)]
rep = Cluster("fast=2.0^prefill,slow=1.0x2^decode", device="cpu").serve(
    ServeJob(reqs, model=model, params=params, max_seq=32))
assert rep.metrics["n_handoffs"] == 3, rep.metrics
assert all(len(r.out_tokens) == 3 for r in reqs)
"""


_MATMUL = """
import numpy as np
from repro_torch.cluster import Cluster, MatmulJob
from repro_torch.kernels.matmul.ops import matmul

rng = np.random.default_rng(0)
a = rng.standard_normal((24, 8)).astype(np.float32)
b = rng.standard_normal((8, 8)).astype(np.float32)
rep = Cluster("2:1", backend="wallclock", device="cpu").simulate(
    MatmulJob(a, b, matmul_fn=matmul))
assert rep.backend == "wallclock[1d]", rep.backend
assert rep.metrics["max_abs_err"] < 1e-5, rep.metrics
"""


_TRAIN = """
from repro_torch.cluster import Cluster, TrainJob
from repro_torch.configs import get_config
from repro_torch.models import Model

cfg = get_config("qwen2-1.5b", reduced=True, use_pallas=True)
rep = Cluster("2:1", device="cpu").train(
    TrainJob(Model(cfg, device="cpu"), steps=2, grains=4, seq_len=8),
    scenario="halve:w0@1:25%")
assert rep.kind == "train" and len(rep.phases) == 2, rep.summary()
"""


_MAMBA = """
import numpy as np
from repro_torch.cluster import Cluster, ServeJob
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import mamba_scan, ops, ref
from repro_torch.models import Model, mamba
from repro_torch.serve import Request

cfg = get_config("mamba2-2.7b", reduced=True, use_pallas=True)
model = Model(cfg, device="cpu")
params = model.init(0)
rng = np.random.default_rng(0)
reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab_size, 5 + 3 * i)], 3)
        for i in range(3)]
rep = Cluster("fast=2.0^prefill,slow=1.0x2^decode", device="cpu").serve(
    ServeJob(reqs, model=model, params=params, max_seq=32))
assert rep.metrics["n_handoffs"] == 3, rep.metrics
assert all(len(r.out_tokens) == 3 for r in reqs)
"""


_REMAINING = """
import numpy as np
import torch
from repro_torch.cluster import Cluster, ServeJob
from repro_torch.configs import get_config
from repro_torch.configs.shapes import prefill_batch_specs, train_batch_specs
from repro_torch.models import Model
from repro_torch.serve import Request

cfg = get_config("deepseek-v2-236b", reduced=True)
model = Model(cfg, device="cpu")
params = model.init(0)
rng = np.random.default_rng(0)
reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab_size, 5 + 3 * i)], 3)
        for i in range(3)]
rep = Cluster("fast=2.0^prefill,slow=1.0x2^decode", device="cpu").serve(
    ServeJob(reqs, model=model, params=params, max_seq=32))
assert rep.metrics["n_handoffs"] == 3, rep.metrics
for arch in ("qwen2-vl-7b", "seamless-m4t-medium"):
    cfg = get_config(arch, reduced=True, use_pallas=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    loss, _ = model.loss(params, train_batch_specs(cfg, 2, 8, device="cpu"))
    logits, caches = model.prefill(params, prefill_batch_specs(cfg, 1, 8))
    assert torch.isfinite(loss) and torch.isfinite(logits).all()
"""


_DISTRIBUTION = """
import argparse, dataclasses, os, tempfile
import torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.shapes import train_batch_specs
from repro_torch.examples import moe_homogenized
from repro_torch.launch import dryrun, env
from repro_torch.launch.common import apply_env
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import Model
from repro_torch.sharding import Policy
from repro_torch.sharding.apply import distribute_tree, make_sharded_train_step
from repro_torch.train import TrainState, init_train_state

assert apply_env(argparse.Namespace(tuned=True)) is not None
fd, path = tempfile.mkstemp()
os.close(fd)
dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                        world_size=1)
cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                          sharding_policy="fsdp_tp", remat_policy="dots")
model = Model(cfg, device="cpu")
mesh = make_debug_mesh(1, 1, device_type="cpu")
pol = Policy(cfg, mesh)
state = init_train_state(model.init(0))
batch = train_batch_specs(cfg, 2, 8, device="cpu")
sstate = TrainState(
    params=distribute_tree(state.params, pol.param_specs(state.params), mesh),
    opt=distribute_tree(state.opt, pol.opt_specs(state.params), mesh))
_, met = make_sharded_train_step(model, mesh)(
    sstate, distribute_tree(batch, pol.batch_specs(batch), mesh))
assert torch.isfinite(met["loss"])
dist.destroy_process_group()
os.remove(path)
moe_homogenized.main(["--device", "cpu"])
"""


def _run(code: str) -> list[str]:
    # One intra-op thread, as the in-process port tests pin it.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code + _REPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_serve_loads_no_jax_or_repro():
    assert _run(_SERVE) == []


def test_port_wallclock_matmul_loads_no_jax_or_repro():
    assert _run(_MATMUL) == []


def test_port_train_loads_no_jax_or_repro():
    assert _run(_TRAIN) == []


def test_port_mamba_serve_loads_no_jax_or_repro():
    assert _run(_MAMBA) == []


def test_port_remaining_configs_load_no_jax_or_repro():
    """MLA served through the disaggregated fleet, M-RoPE with embeds
    input and enc-dec trained and prefilled on K1/K4's wrappers."""
    assert _run(_REMAINING) == []


def test_port_distribution_loads_no_jax_or_repro():
    """The sharded train step (remat_policy="dots") on a one-rank mesh,
    the tuned env profile applied, the dry-run module and an example."""
    assert _run(_DISTRIBUTION) == []


def test_source_scan_covers_the_distribution_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"sharding/policy.py", "sharding/apply.py", "launch/mesh.py",
            "launch/env.py", "launch/dryrun.py", "examples/quickstart.py",
            "examples/serve_hetero.py", "examples/train_hetero.py",
            "examples/moe_homogenized.py"} <= scanned


def test_source_scan_covers_the_remaining_configs_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"models/mla.py", "configs/shapes.py",
            "configs/deepseek_v2_236b.py", "configs/qwen2_vl_7b.py",
            "configs/seamless_m4t_medium.py"} <= scanned


_SHARED = """
import os, tempfile
import torch, torch.distributed as dist
from repro_torch.configs.registry import all_configs
from repro_torch.kernels.autotune import save_registry
from repro_torch.launch import shared_pg
from repro_torch.launch.serve import (build_fleet, parse_replicas,
                                      scenario_timeline)

shared_pg.register(slot_bytes=1024)
fd, path = tempfile.mkstemp()
os.close(fd)
dist.init_process_group("shared", init_method=f"file://{path}", rank=0,
                        world_size=1)
x = torch.arange(1000.0)
dist.all_reduce(x)
assert torch.equal(x, torch.arange(1000.0))
dist.destroy_process_group()
if os.path.exists(path):
    os.remove(path)
assert shared_pg.MEMORY == {"cuda": 0, "cpu": 0}
assert parse_replicas("8:4") == [(8.0, 4), (4.0, 4)]
assert len(all_configs(reduced=True)) == 10
"""


def test_port_shared_backend_and_launch_shims_load_no_jax_or_repro():
    """A collective over the ``"shared"`` backend (its CPU route), and the
    launcher shims, ``all_configs`` and ``save_registry`` imported."""
    assert _run(_SHARED) == []


def test_source_scan_covers_the_shared_backend():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert "launch/shared_pg.py" in scanned
    assert "launch/staged_pg.py" not in scanned
    assert (PORT / "launch" / "csrc" / "shared_pg.cu").exists()


def test_import_chip_smoke_loads_no_jax_or_repro():
    assert _run("import chip_smoke\n") == []


_FORBIDDEN = [
    (r"^\s*(import|from)\s+jax\b", "imports jax"),
    (r"^\s*(import|from)\s+repro(\.|\s|$)", "imports the JAX package"),
    (r"torch\.compile\b", "calls torch.compile"),
    (r"cudnn_attention|_scaled_dot_product_\w+attention", "calls a library "
     "attention kernel"),
]


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"])
def test_source_imports_and_calls(path):
    text = (ROOT / path).read_text()
    for pattern, what in _FORBIDDEN:
        assert not re.search(pattern, text, re.M), f"{path} {what}"
    if path != "chip_smoke.py":   # the smoke run times SDPA as a yardstick
        assert "scaled_dot_product_attention" not in text, path



def _code_only(path: pathlib.Path) -> str:
    """The source without its comments and string literals."""
    if path.suffix == ".cu":
        text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
        return re.sub(r"//[^\n]*", " ", text)
    with open(path, "rb") as f:
        toks = tokenize.tokenize(f.readline)
        skip = {tokenize.COMMENT, tokenize.STRING,
                getattr(tokenize, "FSTRING_MIDDLE", tokenize.STRING)}
        return " ".join(t.string for t in toks if t.type not in skip)


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT))
                   for p in (PORT / "kernels" / "matmul").rglob("*")
                   if p.suffix in (".py", ".cu")))
def test_matmul_kernel_route_has_no_library_product(path):
    """K3's wrapper, op, plain version and CUDA source compute the product
    themselves: no torch product, cuBLAS or CUTLASS GEMM stands in."""
    code = _code_only(ROOT / path)
    for pattern in (r"torch \. (matmul|mm|bmm|einsum|addmm)\b", r"[\w)\]] @",
                    r"\. (matmul|mm) \(", r"(?i)cublas|cutlass"):
        assert not re.search(pattern, code), f"{path}: {pattern}"


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT))
                   for p in (PORT / "kernels" / "flash_attention").rglob("*")
                   if p.suffix in (".py", ".cu") and p.name != "ref.py"))
def test_flash_attention_kernel_route_has_no_library_attention(path):
    """K4's wrapper, op and CUDA source compute attention themselves: no
    torch product, SDPA, cuDNN or cuBLAS call stands in.  (``ref.py`` is the
    plain version, which the CUDA route never calls.)"""
    code = _code_only(ROOT / path)
    for pattern in (r"torch \. (matmul|mm|bmm|einsum|addmm|softmax)\b",
                    r"[\w)\]] @", r"\. (matmul|mm|bmm) \(",
                    r"(?i)cublas|cudnn|cutlass|scaled_dot_product"):
        assert not re.search(pattern, code), f"{path}: {pattern}"


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT))
                   for p in (PORT / "kernels" / "mamba_scan").rglob("*")
                   if p.suffix == ".cu" or p.name == "mamba_scan.py"))
def test_mamba_scan_kernel_route_has_no_library_product(path):
    """K5's wrapper and CUDA source compute the scan themselves: no torch
    product, cuBLAS or CUTLASS call stands in.  (``ref.py`` holds the plain
    version and ``ops.py`` the plain grouped path, which the CUDA route
    never calls.)"""
    code = _code_only(ROOT / path)
    for pattern in (r"torch \. (matmul|mm|bmm|einsum|addmm|cumsum)\b",
                    r"[\w)\]] @", r"\. (matmul|mm|bmm) \(",
                    r"(?i)cublas|cudnn|cutlass"):
        assert not re.search(pattern, code), f"{path}: {pattern}"
