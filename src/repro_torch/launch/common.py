"""Shared launcher plumbing: fleet-flag grammar, backend choice, env profile.

Port of ``repro/launch/common.py`` with the same flags.  ``--devices`` is
the number of CUDA devices the wall-clock backend round-robins over
(``make_backend``); the XLA host-device pinning it drives in the reference
has no counterpart under PyTorch, so nothing is written to the environment.
The tuned env profile (``launch/env.py``) comes with a later port slice:
asking for it raises ``NotImplementedError``.  The reference's description
follows.

The train and serve CLIs grew the same three fragments independently — a
``--fleet`` flag whose legacy alias (``--pods`` / ``--replicas``) predates
the FleetSpec grammar, a ``--tuned``/``REPRO_TUNED`` env-profile apply, and
(with the wall-clock backend) host-platform device pinning that must land in
``XLA_FLAGS`` before the first JAX computation.  They live here once.
"""

from __future__ import annotations

import argparse
import os
import warnings

__all__ = ["add_fleet_arg", "add_backend_args", "make_backend",
           "add_trace_args", "make_tracer", "export_trace", "apply_env"]

_warned_aliases: set[str] = set()


def add_fleet_arg(ap: argparse.ArgumentParser, *, legacy: str,
                  default: str, help: str) -> None:
    """``--fleet`` plus its deprecated pre-FleetSpec alias (``--pods`` on
    the train CLI, ``--replicas`` on serve).  Both write ``args.fleet``; the
    alias additionally emits one DeprecationWarning per process."""

    class _FleetAction(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            if option_string == legacy and legacy not in _warned_aliases:
                _warned_aliases.add(legacy)
                # CLI users must actually see this: DeprecationWarning is
                # filtered out by default outside __main__, so force it
                # through for this one emission (filters restored on exit).
                with warnings.catch_warnings():
                    warnings.simplefilter("always", DeprecationWarning)
                    warnings.warn(
                        f"{legacy} is deprecated; use --fleet (same "
                        f"FleetSpec grammar — the old {legacy} strings "
                        f"parse unchanged)",
                        DeprecationWarning,
                        stacklevel=2,
                    )
            setattr(namespace, self.dest, values)

    ap.add_argument("--fleet", legacy, dest="fleet", default=default,
                    action=_FleetAction, help=help)


def add_backend_args(ap: argparse.ArgumentParser) -> None:
    """``--backend`` / ``--devices``: execution-backend choice for the
    Cluster facade, mirrored on every launcher."""
    ap.add_argument("--backend", choices=("sim", "wallclock"), default="sim",
                    help="execution backend: 'sim' (logical clock, modeled "
                         "durations — default) or 'wallclock' (grains run "
                         "as real torch computations on the CUDA devices; "
                         "durations are measured)")
    ap.add_argument("--devices", type=int, default=None,
                    help="CUDA devices the wall-clock backend round-robins "
                         "workers over (default: every visible device; "
                         "more than are visible raises)")


def make_backend(args: argparse.Namespace):
    """The ``Cluster(backend=...)`` the flags ask for: 'sim', or for
    ``--backend wallclock`` a ``WallclockBackend`` over the first
    ``--devices`` CUDA devices (or over ``--device`` when that is not CUDA,
    e.g. the CPU)."""
    if getattr(args, "backend", "sim") != "wallclock":
        return "sim"
    from ..core.wallclock import WallclockBackend, wallclock_devices

    return WallclockBackend(devices=wallclock_devices(
        getattr(args, "device", None), getattr(args, "devices", None)))


def add_trace_args(ap: argparse.ArgumentParser) -> None:
    """``--trace`` / ``--metrics-interval``: run observability, mirrored on
    every launcher.  ``--trace out.json`` writes a Chrome/Perfetto
    ``trace_event`` file (open at https://ui.perfetto.dev); a ``.jsonl``
    suffix writes compact one-event-per-line JSON instead."""
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record grain-lifecycle/coordinator/serve events "
                         "and write them to PATH: Perfetto trace_event JSON "
                         "(load in ui.perfetto.dev), or JSONL when PATH "
                         "ends in .jsonl")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="S",
                    help="print a one-line live metrics summary every S "
                         "simulated seconds while the run executes "
                         "(implies tracing; --trace optional)")


def make_tracer(args: argparse.Namespace):
    """An ``obs.Tracer`` when ``--trace``/``--metrics-interval`` asks for
    one, else None (the runtimes keep the zero-overhead untraced path)."""
    if getattr(args, "trace", None) is None and \
            getattr(args, "metrics_interval", None) is None:
        return None
    from ..obs import Tracer
    return Tracer(metrics_interval_s=getattr(args, "metrics_interval", None))


def export_trace(tracer, args: argparse.Namespace) -> None:
    """Write the recorded events to ``--trace PATH`` (no-op otherwise)."""
    path = getattr(args, "trace", None)
    if tracer is None or path is None:
        return
    n = tracer.export(path)
    print(f"wrote {n} trace events to {path}"
          + ("" if path.endswith(".jsonl")
             else " (open at https://ui.perfetto.dev)"))


def apply_env(args: argparse.Namespace) -> None:
    """Apply launcher environment knobs after arg parsing.  ``--tuned`` /
    ``REPRO_TUNED=1`` (the tuned-substrate profile of ``launch/env.py``)
    comes with the port's distribution-and-tooling slice."""
    if getattr(args, "tuned", False) or os.environ.get("REPRO_TUNED") == "1":
        raise NotImplementedError(
            "the tuned env profile (launch/env.py) comes with the port's "
            "distribution-and-tooling slice"
        )
