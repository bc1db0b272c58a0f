"""Tuned-substrate launcher profile: the env recipe as checked-in code.

Port of ``repro/launch/env.py`` for the keys that carry over to a PyTorch
process: tcmalloc preloaded ahead of glibc malloc, and its large-alloc
warning threshold pushed out of numpy's way.  Existing environment values
always win, so a wrapper and ``apply()`` compose.

  - ``python -m repro_torch.launch.env --export`` prints eval-able
    ``export K=V`` lines for a shell wrapper, the only way ``LD_PRELOAD``
    can take effect (the dynamic linker reads it before Python starts).
  - ``apply()`` (the train and serve CLIs' ``--tuned`` / ``REPRO_TUNED=1``)
    sets what still works after the process is up.

The reference's other keys have no counterpart here: ``TF_CPP_MIN_LOG_LEVEL``
(no TensorFlow runtime is loaded), the persistent JAX compilation cache
(``REPRO_JAX_CACHE``: PyTorch runs eagerly, and the kernels' build
directory, ``kernels/_build``, already persists between runs) and
``--devices`` (XLA's host-platform device count).
"""

from __future__ import annotations

import argparse
import os
import shlex

__all__ = ["TUNED_ENV", "tcmalloc_path", "tuned_env", "apply", "main"]

#: The static half of the recipe (values are strings: this is environ).
TUNED_ENV = {
    # tcmalloc reports every allocation past this as a potential leak;
    # numpy's buffer pools trip it constantly. 60 GB ~= never.
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

#: Where distros put tcmalloc (first hit wins; absent -> no preload).
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def tcmalloc_path() -> str | None:
    for p in _TCMALLOC_CANDIDATES:
        if os.path.exists(p):
            return p
    return None


def tuned_env(base: dict | None = None) -> dict[str, str]:
    """The full profile as a dict of env additions.  Values already present
    in ``base`` (default: the current environment) are left alone."""
    if base is None:
        base = os.environ
    out = {k: v for k, v in TUNED_ENV.items() if k not in base}
    tc = tcmalloc_path()
    if tc is not None and "LD_PRELOAD" not in base:
        out["LD_PRELOAD"] = tc
    return out


def apply() -> dict[str, str]:
    """In-process opt-in: merge the profile into ``os.environ`` (existing
    values win).  Returns what was applied.  ``LD_PRELOAD`` is skipped here:
    the dynamic linker already ran; export it from a wrapper for the malloc
    half."""
    applied = tuned_env()
    applied.pop("LD_PRELOAD", None)
    os.environ.update(applied)
    return applied


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="print the tuned-substrate env profile")
    ap.add_argument("--export", action="store_true",
                    help="emit eval-able 'export K=V' lines (shell wrapper)")
    args = ap.parse_args(argv)
    for k, v in sorted(tuned_env().items()):
        if args.export:
            print(f"export {k}={shlex.quote(v)}")
        else:
            print(f"{k}={v}")


if __name__ == "__main__":
    main()
