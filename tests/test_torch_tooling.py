"""The port's tuned env profile (``launch/env.py``) against the
reference's on the keys that carry over, and ``--tuned`` /
``REPRO_TUNED=1`` on the port's train and serve CLIs (they apply the
profile; before this slice they raised)."""

import argparse
import os
import pathlib
import subprocess
import sys

import pytest

from repro.launch import env as jax_env
from repro_torch.launch import env
from repro_torch.launch.common import apply_env

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The reference's keys with a counterpart in a PyTorch process.
CARRIED = ("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "LD_PRELOAD")


def test_tuned_env_equals_reference_on_carried_keys():
    for base in ({}, {"LD_PRELOAD": "x"},
                 {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1"}):
        ref = {k: v for k, v in jax_env.tuned_env(None, base=base).items()
               if k in CARRIED}
        assert env.tuned_env(base=base) == ref
    assert set(env.TUNED_ENV) <= set(jax_env.TUNED_ENV)
    assert env.TUNED_ENV == {k: jax_env.TUNED_ENV[k] for k in env.TUNED_ENV}
    assert env.tcmalloc_path() == jax_env.tcmalloc_path()


def _run(args, **extra_env):
    run_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra_env)
    for key in CARRIED + ("REPRO_TUNED",):
        if key not in extra_env:
            run_env.pop(key, None)
    out = subprocess.run([sys.executable] + args, cwd=ROOT, env=run_env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_env_export_prints_the_reference_lines():
    port = _run(["-m", "repro_torch.launch.env", "--export"])
    ref = _run(["-m", "repro.launch.env", "--export"])
    carried = [ln for ln in ref if ln.split("=")[0].removeprefix("export ")
               in CARRIED]
    assert port == carried
    assert port and all(ln.startswith("export ") for ln in port)


def test_apply_env_applies_the_profile(monkeypatch):
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                       raising=False)
    monkeypatch.delenv("REPRO_TUNED", raising=False)
    assert apply_env(argparse.Namespace(tuned=False)) == {}
    assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in os.environ
    applied = apply_env(argparse.Namespace(tuned=True))
    assert applied == {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
    assert os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == \
        "60000000000"
    # Existing values win: a second apply sets nothing.
    assert apply_env(argparse.Namespace(tuned=True)) == {}


@pytest.mark.parametrize("cli,args", [
    ("train", ["--mode", "hdp", "--steps", "1", "--seq", "16", "--grains",
               "4"]),
    ("serve", ["--requests", "2", "--max-new", "2", "--max-seq", "32"]),
])
@pytest.mark.parametrize("how", ["flag", "env"])
def test_tuned_runs_on_port_clis(cli, args, how):
    extra = ["--tuned"] if how == "flag" else []
    kw = {"REPRO_TUNED": "1"} if how == "env" else {}
    out = _run(["-m", f"repro_torch.launch.{cli}", "--device", "cpu",
                *args, *extra], **kw)
    assert out[0] == ('tuned env profile applied: '
                      '{"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": '
                      '"60000000000"}'), out[:3]
