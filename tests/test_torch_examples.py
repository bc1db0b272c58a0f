"""The port's four examples (``python -m repro_torch.examples.<name>``) on
the CPU against the reference's (``examples/<name>.py``): each exits 0 and
prints the reference's report lines.  Every number of those lines that is
the sim clock's (times, quality, shares, migrations, plans) or a capacity
is equal; the tokens, losses and products come from each package's own
weights and kernels, so those fields are left out of the comparison."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args: list[str], timeout: int = 300) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def _both(name: str, *extra: str):
    port = _run(["-m", f"repro_torch.examples.{name}", "--device", "cpu",
                 *extra])
    ref = _run([f"examples/{name}.py", *extra])
    return port, ref


def _drop(lines, pattern):
    return [re.sub(pattern, "", ln) for ln in lines]


def test_quickstart_matches_reference():
    port, ref = _both("quickstart")
    # The product's error is each kernel's own rounding (K3 vs Pallas).
    port = _drop(port, r"max\|err\|=\S+|K3 kernel|Pallas kernel")
    ref = _drop(ref, r"max\|err\|=\S+|K3 kernel|Pallas kernel")
    assert port == ref
    assert any(ln.startswith("job 2: sim_time=") for ln in port)
    assert any("max homogenized=" in ln for ln in port)


def test_serve_hetero_matches_reference():
    port, ref = _both("serve_hetero")
    # Part 1's tokens come from each package's random weights.
    part2 = next(i for i, ln in enumerate(ref) if "batched fleet" in ln)
    assert port[part2:] == ref[part2:]
    assert port[0] == ref[0]
    assert any("re-homogenization holds the line" in ln for ln in port)


def test_train_hetero_matches_reference(tmp_path):
    args = ["--steps", "6", "--grains", "8", "--seq", "32"]
    port = _run(["-m", "repro_torch.examples.train_hetero", "--device", "cpu",
                 *args])
    ref = _run(["examples/train_hetero.py", *args, "--ckpt",
                str(tmp_path / "ckpt")])
    # Losses come from each package's random weights.
    pat = r"loss=\S+|loss \S+ -> \S+ \(.*\)"
    assert _drop(port, pat) == _drop(ref, pat)
    assert any(ln.startswith("resumed at step 6") for ln in port)


def test_moe_homogenized_matches_reference():
    port, ref = _both("moe_homogenized")
    # The capacities from the perfs are the reference's; the routing (and
    # so the load and the output delta) the port's own weights'.
    n = next(i for i, ln in enumerate(ref) if ln.startswith("output delta"))
    assert port[:n] == ref[:n]
    for a, b in zip(port[n:], ref[n:], strict=True):
        assert a.split(":")[0] == b.split(":")[0]
    assert port[n + 4] == ref[n + 4]           # the uniform capacities
