#!/usr/bin/env python3
"""How often a short ``torch.profiler`` session records no device event.

    python3 scripts/profiler_probe.py [--sessions N] [--late-seconds T]

Run from the repository root on the machine with the card.  The launch
tests of ``tests/test_torch_cuda.py`` (``_device_kernels``) profile one
launch of a kernel that the port's libraries launch through ``ctypes`` and
read the names of the device kernels the session recorded.  This script
takes N such sessions in each of its arms, the arms in turns in one
process, with unprofiled work on the card between sessions (a K4 forward
and two 4096-square f32 products), as the test file has between its launch
tests:

  plain       one K2 launch (``cache_cast``), synchronize, stop;
  mixed       a torch kernel, the K2 launch, a torch kernel, synchronize;
  pad_after   as plain, then 5 ms of host sleep before the session stops;
  pad_before  ``chip_smoke.PROFILE_LEAD_S`` of host sleep after the session
              starts, then as plain (as ``_device_kernels`` and
              ``chip_smoke.device_ms`` start their launches);
  warmup      the profiler's schedule: a warm-up step (CUPTI's tracing on,
              nothing recorded) that launches K2 and synchronizes, then
              the recorded step, as plain.

It prints one JSON line per arm: sessions; sessions with no device event;
with K2 missing; with a torch kernel missing; sessions in which CUPTI's
"Activity Buffer Request" overhead ran, and in which it overlapped the
first launch, each split as [K2 seen, K2 missing]; over the sessions that
saw K2, its device start minus the host start of its ``cudaLaunchKernel``
(min, median, max, in microseconds) and its device start from the trace's
start (min); over those that missed it, the launch's host start from the
trace's start (max); the first session's result.  For the first sessions
that miss anything it prints every event they recorded, with start and
end in microseconds from the trace's start.  With ``--late-seconds T`` it
then runs T seconds of unprofiled work and a fifth as many sessions again,
under the label "late".

The probe leaves CUPTI as the environment sets it: run it under
``TEARDOWN_CUPTI=1`` (CUPTI torn down after every session and set up again
for the next), ``=0`` and unset to compare.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--late-seconds", type=float, default=0.0)
    args = ap.parse_args()
    sys.path.insert(1, os.path.dirname(HERE))
    from chip_smoke import PROFILE_LEAD_S

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        print("profiler_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.prefill import prefill as pf

    dev = torch.device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      **{name: os.environ.get(name) for name in (
                          "CUDA_MODULE_LOADING", "TEARDOWN_CUPTI")}}),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    k32 = torch.randn((2, 128, 128), generator=gen, device=dev)
    x = torch.randn((256,), generator=gen, device=dev)
    big = torch.randn((4096, 4096), generator=gen, device=dev)
    q = torch.randn((16, 1024, 128), generator=gen, device=dev)
    kv = torch.randn((2, 1024, 128), generator=gen, device=dev)

    def work():
        fa.flash_attention_fwd(q, kv, kv, group=8)
        big @ big
        big @ big
        torch.cuda.synchronize()

    def k2():
        pf.cache_cast(k32, k32, torch.bfloat16)

    def torch_op():
        x.add_(1.0)

    def session(arm):
        sched = schedule(wait=0, warmup=1, active=1) if arm == "warmup" \
            else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            if arm == "warmup":
                k2()
                torch.cuda.synchronize()
                prof.step()
            if arm == "pad_before":
                time.sleep(PROFILE_LEAD_S)
            if arm == "mixed":
                torch_op()
            k2()
            if arm == "mixed":
                torch_op()
            torch.cuda.synchronize()
            if arm == "pad_after":
                time.sleep(0.005)
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        res = prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        events = [(e.name()[:60], str(e.device_type()).split(".")[-1],
                   round((e.start_ns() - t0) / 1e3, 1),
                   round((e.end_ns() - t0) / 1e3, 1)) for e in res.events()]
        return names, events

    arms = ("plain", "mixed", "pad_after", "pad_before", "warmup")

    def new_stats():
        return {a: {"sessions": 0, "empty": 0, "k2_missing": 0,
                    "torch_missing": 0, "buffer_request": [0, 0],
                    "request_overlaps_launch": [0, 0], "offsets": [],
                    "k2_starts": [], "missed_launches": [], "first": None}
                for a in arms}

    def summary(label, stats):
        for arm in arms:
            st = dict(stats[arm])
            off, ks, ml = (st.pop(key) for key in
                           ("offsets", "k2_starts", "missed_launches"))
            off.sort()
            if off:
                st["k2_start_minus_launch_us"] = [off[0], off[len(off) // 2],
                                                  off[-1]]
                st["k2_start_from_trace_start_us_min"] = min(ks)
            if ml:
                st["missed_launch_from_trace_start_us_max"] = max(ml)
            print(json.dumps({"label": label, "arm": arm, **st}), flush=True)

    stats = new_stats()
    shown = 0
    work()
    n_late = args.sessions // 5 if args.late_seconds > 0 else 0
    for i in range(args.sessions + n_late):
        if i == args.sessions:
            summary("early", stats)
            stats = new_stats()
            t_end = time.perf_counter() + args.late_seconds
            while time.perf_counter() < t_end:
                work()
        for j in range(len(arms)):
            arm = arms[(i + j) % len(arms)]
            names, events = session(arm)
            st = stats[arm]
            st["sessions"] += 1
            k2_seen = any("cache_cast_kernel" in n for n in names)
            torch_seen = sum(1 for n in names if "cache_cast" not in n)
            miss_torch = arm == "mixed" and torch_seen == 0
            st["empty"] += not names
            st["k2_missing"] += not k2_seen
            st["torch_missing"] += miss_torch
            req = [e for e in events if e[0] == "Activity Buffer Request"]
            launch = [e for e in events if e[0] == "cudaLaunchKernel"]
            if req:
                st["buffer_request"][not k2_seen] += 1
                if launch and req[0][2] < launch[0][3] and \
                        launch[0][2] < req[0][3]:
                    st["request_overlaps_launch"][not k2_seen] += 1
            k2_dev = [e for e in events if "cache_cast_kernel" in e[0]
                      and e[1] == "CUDA"]
            at = 1 if arm == "mixed" else 0
            k2_launch = launch[at] if len(launch) > at else None
            if k2_dev and k2_launch:
                st["offsets"].append(round(k2_dev[0][2] - k2_launch[2], 1))
                st["k2_starts"].append(k2_dev[0][2])
            elif k2_launch:
                st["missed_launches"].append(k2_launch[2])
            if st["first"] is None:
                st["first"] = {"index": i * len(arms) + j, "names": names}
            if (not k2_seen or miss_torch) and shown < 6:
                shown += 1
                print(json.dumps({"session": i, "arm": arm, "names": names,
                                  "events": events}), flush=True)
            work()
    summary("late" if n_late else "early", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
