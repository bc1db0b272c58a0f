"""The port stands alone: running it loads neither JAX nor the JAX package,
and it never calls a library attention kernel in place of its own.

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


def _run(code: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code + _REPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_serve_loads_no_jax_or_repro():
    assert _run(_SERVE) == []


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
