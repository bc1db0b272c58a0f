"""A process-group backend for ranks that share one card: ``gloo`` between
the processes, every collective staged through host memory.

NCCL puts one rank on a device, so two ranks of one card cannot form a
NCCL group.  ``register()`` adds the backend ``"staged"``: each group is a
``gloo`` group over the same store, and each collective copies its CUDA
tensors to the host, runs there, and copies the results back (a CPU
tensor passes straight through).  It serves the functional collectives
that DTensor and ``sharding/tp.py`` call (all-reduce, all-gather and
reduce-scatter into tensors, their coalesced forms), broadcast, all-to-all
and barrier, each waited before it returns.  Its times are the host's
copies and loopback transport, not a collective's on an interconnect.

    from repro_torch.launch.staged_pg import register
    register()
    torch.distributed.init_process_group("staged", init_method=..., rank=r,
                                         world_size=n)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["register", "BACKEND"]

BACKEND = "staged"


def _host(ts: list) -> list:
    return [t.detach().cpu() if t.is_cuda else t for t in ts]


def _back(dst: list, src: list) -> None:
    for d, s in zip(dst, src, strict=True):
        if d is not s:
            d.copy_(s)


class _StagedGroup(dist.ProcessGroup):
    """One ``gloo`` group; each collective staged through the host."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    @property
    def pg_name(self) -> str:
        return self.group_name

    def getBackendName(self) -> str:
        return BACKEND

    @staticmethod
    def _done(result):
        from torch._C._distributed_c10d import _create_work_from_future

        fut = torch.futures.Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    def allreduce(self, tensors, opts=None):
        host = _host(tensors)
        self._gloo.allreduce(host, opts or dist.AllreduceOptions()).wait()
        _back(tensors, host)
        return self._done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def allgather(self, outputs, inputs, opts=None):
        outs = [_host(o) for o in outputs]
        self._gloo.allgather(outs, _host(inputs),
                             opts or dist.AllgatherOptions()).wait()
        for o, h in zip(outputs, outs, strict=True):
            _back(o, h)
        return self._done(outputs)

    def _allgather_base(self, output, inp, opts=None):
        (out,), (i,) = _host([output]), _host([inp])
        self._gloo._allgather_base(out, i,
                                   opts or dist.AllgatherOptions()).wait()
        _back([output], [out])
        return self._done([output])

    def all_gather_single(self, output, inp, opts=None):
        return self._allgather_base(output, inp, opts)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._allgather_base(o, i, opts)
        return self._done(outputs)

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        return self.allgather_into_tensor_coalesced(outputs, inputs, opts)

    def _reduce_scatter_base(self, output, inp, opts=None):
        (out,), (i,) = _host([output]), _host([inp])
        self._gloo._reduce_scatter_base(
            out, i, opts or dist.ReduceScatterOptions()).wait()
        _back([output], [out])
        return self._done([output])

    def reduce_scatter_single(self, output, inp, opts=None):
        return self._reduce_scatter_base(output, inp, opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._reduce_scatter_base(o, i, opts)
        return self._done(outputs)

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        return self.reduce_scatter_tensor_coalesced(outputs, inputs, opts)

    def alltoall_base(self, output, inp, out_splits, in_splits, opts=None):
        (out,), (i,) = _host([output]), _host([inp])
        self._gloo.alltoall_base(out, i, out_splits, in_splits,
                                 opts or dist.AllToAllOptions()).wait()
        _back([output], [out])
        return self._done([output])

    def broadcast(self, tensors, opts=None):
        host = _host(tensors)
        self._gloo.broadcast(host, opts or dist.BroadcastOptions()).wait()
        _back(tensors, host)
        return self._done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return self._done([])


def _create(store, rank, size, timeout):
    return _StagedGroup(store, rank, size, timeout)


def register() -> None:
    """Add the ``"staged"`` backend (once per process)."""
    if BACKEND not in dist.Backend.backend_list:
        dist.Backend.register_backend(BACKEND, _create,
                                      devices=["cpu", "cuda"])
