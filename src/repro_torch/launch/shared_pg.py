"""A process-group backend for ranks that share one card: collectives in
device memory, through CUDA IPC and hand-written kernels.

NCCL puts one rank on a device, so two ranks of one card cannot form a
NCCL group.  ``register()`` adds the backend ``"shared"``.  Each rank of a
group holds a mailbox of two slots; its peers map it once, at the group's
first collective on that device type, from handles posted to the group's
store (a ``PrefixStore`` of its own, so subgroups do not collide).  A
collective moves in chunks of one slot, the two slots in turn, so a tensor
of any size passes through a mailbox of fixed size.  Per chunk each rank
waits until its peers have read the slot's last chunk, copies its own
chunk in, meets the group once on the host (a ``gloo`` all-reduce of one
element), waits until every peer's chunk is written, and reads the slots
into its output: ``shared_reduce_kernel`` sums or takes the maximum in rank
order 0..n-1 (f32 accumulation for floating types, int64 for integers,
one rounding), ``shared_gather_kernel`` copies segments
(``csrc/shared_pg.cu`` sets out the protocol and why nothing spins).  So
every rank's all-reduce is bitwise the same.

CUDA tensors take device mailboxes (``cudaMalloc``, ``cudaIpc*`` handles,
interprocess events; every copy, kernel and wait on the caller's current
stream, no host synchronisation).  CPU tensors take the same protocol over host
mailboxes, a file in ``/dev/shm`` a rank mapped by every rank of the group
(unlinked once all have mapped it), with the plain versions
(``reduce_plain``, slicing copies): the protocol, the chunking and the rank
order run on the CPU too.  A CUDA tensor takes the device route or raises;
nothing falls back to gloo or to the host.  A call that mixes CPU and CUDA
tensors, a reduce op other than SUM and MAX, or a reduce of another dtype
than f32, bf16, f16, int32 and int64 raises.

It serves what ``launch`` and DTensor call: all-reduce, all-gather and
reduce-scatter into tensors and their coalesced forms, the list all-gather,
all-to-all with uneven splits, broadcast and barrier.  Each returns a
completed ``Work``; on the card its data is ordered on the caller's stream.
Device mailboxes take at most DEVICE_BYTES_MAX a process over all its
groups (two SLOT_BYTES slots a group; a group of one rank takes none).

    from repro_torch.launch.shared_pg import register
    register()
    torch.distributed.init_process_group("shared", init_method=..., rank=r,
                                         world_size=n)

``destroy_process_group`` calls each group's ``shutdown``: it waits for
the stream, closes every peer's handle, meets the group, and only then
frees its own mailbox.
"""

from __future__ import annotations

import ctypes
import functools
import math
import mmap
import os
import secrets
import time

import torch
import torch.distributed as dist

from ..kernels.build import build_library

__all__ = ["BACKEND", "COUNTERS", "DEVICE_BYTES_MAX", "LAUNCHES", "MAX_RANKS",
           "MEMORY", "PEAK", "SLOT_BYTES", "SOURCES", "gather_plain", "load_library",
           "register", "reduce_plain", "shared_gather", "shared_reduce",
           "stats"]

BACKEND = "shared"

#: One slot of a mailbox; a mailbox holds two.
SLOT_BYTES = 32 << 20
#: Device mailbox bytes a process may hold over all its groups.
DEVICE_BYTES_MAX = 256 << 20
#: Ranks a group, and segments a gather kernel (kMaxRanks in the source).
MAX_RANKS = 16
_HANDLE = 64                      # bytes of a cudaIpc{Mem,Event}Handle_t

SOURCES = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                        "shared_pg.cu")]

#: Kernel launches by kernel name, since the counts were last set to 0.
LAUNCHES: dict[str, int] = {"shared_reduce": 0, "shared_gather": 0}
#: Per collective: calls, input bytes, host seconds inside it, chunks.
COUNTERS: dict[str, dict] = {}
#: Mailbox bytes this process holds, by device type, and the most it held.
MEMORY: dict[str, int] = {"cuda": 0, "cpu": 0}
PEAK: dict[str, int] = {"cuda": 0, "cpu": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.int64: 3, torch.int32: 4}
_OPS = {"sum": 0, "max": 1}


# ------------------------------------------------------------ plain versions
def reduce_plain(slots: list[torch.Tensor], op: str) -> torch.Tensor:
    """The kernel's arithmetic: ``slots`` combined in their order, in f32
    for floating types (int64 for integers), rounded once to their dtype."""
    wide = torch.float32 if slots[0].is_floating_point() else torch.int64
    acc = slots[0].to(wide)
    for s in slots[1:]:
        acc = (acc + s.to(wide) if op == "sum"
               else torch.maximum(acc, s.to(wide)))
    return acc.to(slots[0].dtype)


def gather_plain(srcs: list[torch.Tensor], dsts: list[torch.Tensor]) -> None:
    """Each ``dsts[i]`` takes ``srcs[i]``."""
    for s, d in zip(srcs, dsts, strict=True):
        d.copy_(s)


# ------------------------------------------------------------------ library
@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the transport's library."""
    lib = ctypes.CDLL(build_library("shared_pg", SOURCES))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pvp = ctypes.POINTER(vp)
    sig = {
        "shared_pg_malloc": [i32, i64, pvp, ctypes.c_char_p],
        "shared_pg_free": [vp],
        "shared_pg_event_create": [i32, pvp, ctypes.c_char_p],
        "shared_pg_event_destroy": [vp],
        "shared_pg_open_mem": [i32, ctypes.c_char_p, pvp],
        "shared_pg_close_mem": [vp],
        "shared_pg_open_event": [ctypes.c_char_p, pvp],
        "shared_pg_record": [vp, vp],
        "shared_pg_wait": [pvp, i32, vp],
        "shared_pg_reduce_launch": [pvp, i32, vp, i64, i32, i32, vp],
        "shared_pg_gather_launch": [pvp, pvp, ctypes.POINTER(i64), i32, vp],
    }
    for name, args in sig.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i32
    lib.shared_pg_error_string.argtypes = [i32]
    lib.shared_pg_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().shared_pg_error_string(err).decode()
        raise RuntimeError(f"shared backend: {what} failed: CUDA error "
                           f"{err} ({msg})")


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(values), 1))(*values)


def _launch_reduce(srcs: list[int], dst: int, count: int, dtype, op: str,
                   stream: int) -> None:
    err = load_library().shared_pg_reduce_launch(
        _ptrs(srcs), len(srcs), dst, count, _DTYPES[dtype], _OPS[op], stream)
    _check(err, "shared_reduce_kernel launch")
    LAUNCHES["shared_reduce"] += 1


def _launch_gather(srcs: list[int], dsts: list[int], nbytes: list[int],
                   stream: int) -> None:
    if len(srcs) > MAX_RANKS:
        raise ValueError(f"a gather takes at most {MAX_RANKS} segments")
    err = load_library().shared_pg_gather_launch(
        _ptrs(srcs), _ptrs(dsts),
        (ctypes.c_longlong * max(len(nbytes), 1))(*nbytes), len(srcs), stream)
    _check(err, "shared_gather_kernel launch")
    LAUNCHES["shared_gather"] += 1


def _reduce_dtype(dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"the shared backend reduces f32, bf16, f16, int32 "
                        f"and int64, not {dtype}")


def shared_reduce(slots: list[torch.Tensor], out: torch.Tensor,
                  op: str = "sum") -> torch.Tensor:
    """``out`` = ``slots`` summed (or their maximum) in their order:
    ``shared_reduce_kernel`` on CUDA tensors, ``reduce_plain`` on CPU ones.
    Every tensor contiguous, of ``out``'s dtype and element count."""
    _reduce_dtype(out.dtype)
    if op not in _OPS:
        raise ValueError(f"op is sum or max, not {op!r}")
    if not 1 <= len(slots) <= MAX_RANKS:
        raise ValueError(f"1 to {MAX_RANKS} slots, not {len(slots)}")
    for s in slots:
        if s.dtype != out.dtype or s.numel() != out.numel() or \
                s.device != out.device or not s.is_contiguous():
            raise ValueError("slots must be contiguous, of out's dtype, "
                             "size and device")
    if out.device.type == "cpu":
        out.view(-1).copy_(reduce_plain([s.view(-1) for s in slots], op))
        return out
    if out.device.type != "cuda" or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous cuda or cpu tensor, "
                         f"not {out.device}")
    _launch_reduce([s.data_ptr() for s in slots], out.data_ptr(),
                   out.numel(), out.dtype, op,
                   torch.cuda.current_stream(out.device).cuda_stream)
    return out


def shared_gather(srcs: list[torch.Tensor], dsts: list[torch.Tensor]) -> None:
    """Each ``dsts[i]`` takes ``srcs[i]`` (contiguous, equal bytes):
    ``shared_gather_kernel`` on CUDA tensors, ``gather_plain`` on CPU."""
    if len(srcs) != len(dsts):
        raise ValueError("as many sources as destinations")
    devs = {t.device for t in (*srcs, *dsts)}
    if len(devs) != 1:
        raise ValueError(f"one device, not {sorted(map(str, devs))}")
    for s, d in zip(srcs, dsts, strict=True):
        if s.numel() * s.element_size() != d.numel() * d.element_size() or \
                not (s.is_contiguous() and d.is_contiguous()):
            raise ValueError("each source and destination contiguous, of "
                             "equal bytes")
    if devs.pop().type == "cpu":
        gather_plain([_bytes(s) for s in srcs], [_bytes(d) for d in dsts])
        return
    _launch_gather([s.data_ptr() for s in srcs], [d.data_ptr() for d in dsts],
                   [s.numel() * s.element_size() for s in srcs],
                   torch.cuda.current_stream(srcs[0].device).cuda_stream)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat (a view)."""
    return t.reshape(-1).view(torch.uint8)


def stats() -> dict:
    """This process's mailbox bytes, per-op counters and kernel launches."""
    return {"mailbox_bytes": dict(MEMORY), "mailbox_peak_bytes": dict(PEAK),
            "ops": {k: dict(v) for k, v in COUNTERS.items()},
            "launches": dict(LAUNCHES)}


# ---------------------------------------------------------------- mailboxes
def _hold(kind: str, nbytes: int) -> None:
    MEMORY[kind] += nbytes
    PEAK[kind] = max(PEAK[kind], MEMORY[kind])


class _HostBox:
    """Two slots in host shared memory: a file in ``/dev/shm`` a rank,
    mapped by every rank of the group and unlinked once all have mapped it.
    Copies are synchronous, so the host handshake alone orders them."""

    def __init__(self, group: _SharedGroup):
        self.rank, self.size, self.slot = group.rank(), group.size(), \
            group.slot
        self.seq = 0
        key = "shared/cpu/token"
        if self.rank == 0:
            group.store.set(key, f"{os.getpid()}_{secrets.token_hex(8)}")
        token = group.store.get(key).decode()
        paths = [f"/dev/shm/repro_shared_{token}_{r}"
                 for r in range(self.size)]
        nbytes = 2 * self.slot
        fd = os.open(paths[self.rank], os.O_CREAT | os.O_EXCL | os.O_RDWR,
                     0o600)
        self._maps = []
        try:
            os.ftruncate(fd, nbytes)
            os.close(fd)
            group.handshake()                     # every file exists
            for path in paths:
                fd = os.open(path, os.O_RDWR)
                try:
                    self._maps.append(mmap.mmap(fd, nbytes))
                finally:
                    os.close(fd)
            group.handshake()                     # every rank has mapped all
        finally:
            os.unlink(paths[self.rank])
        self.bufs = [torch.frombuffer(m, dtype=torch.uint8)
                     for m in self._maps]
        _hold("cpu", nbytes)

    def _view(self, r: int, s: int, off: int, nbytes: int) -> torch.Tensor:
        at = s * self.slot + off
        return self.bufs[r][at:at + nbytes]

    def begin(self, s, stream):
        pass

    def post(self, s, pieces, stream):
        for off, src in pieces:
            self._view(self.rank, s, off, src.numel()).copy_(src)

    def written(self, s, stream):
        pass

    def arrived(self, s, stream):
        pass

    def reduce(self, s, off, out, op, stream):
        nbytes = out.numel() * out.element_size()
        out.copy_(reduce_plain([self._view(r, s, off, nbytes).view(out.dtype)
                                for r in range(self.size)], op))

    def gather(self, s, segs, stream):
        gather_plain([self._view(r, s, off, dst.numel())
                      for r, off, dst in segs], [dst for _, _, dst in segs])

    def done(self, s, stream):
        pass

    def close_peers(self):
        self.bufs = []

    def free(self):
        for m in self._maps:
            try:
                m.close()
            except BufferError:
                pass      # a view still holds it: unmapped when it goes
        if self._maps:
            MEMORY["cpu"] -= 2 * self.slot
        self._maps = []


class _DeviceBox:
    """Two slots in device memory a rank, opened by every peer through
    CUDA IPC, with interprocess events ``written`` and ``read`` a slot;
    every copy, kernel, record and wait on the caller's stream."""

    def __init__(self, group: _SharedGroup, device: torch.device):
        lib = load_library()
        self.rank, self.size, self.slot = group.rank(), group.size(), \
            group.slot
        self.seq = 0
        self.device = device.index if device.index is not None else \
            torch.cuda.current_device()
        nbytes = 2 * self.slot
        if MEMORY["cuda"] + nbytes > DEVICE_BYTES_MAX:
            raise RuntimeError(
                f"shared backend: a mailbox of {nbytes} B would pass "
                f"{DEVICE_BYTES_MAX} B of device mailboxes in this process "
                f"(holding {MEMORY['cuda']} B)")
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(_HANDLE)
        _check(lib.shared_pg_malloc(self.device, nbytes, ctypes.byref(own),
                                    handle), "cudaMalloc of a mailbox")
        _hold("cuda", nbytes)
        self._own = own.value
        blob = [handle.raw]
        self._own_events = []                  # written[0..1], read[0..1]
        for _ in range(4):
            ev, h = ctypes.c_void_p(), ctypes.create_string_buffer(_HANDLE)
            _check(lib.shared_pg_event_create(self.device, ctypes.byref(ev),
                                              h), "an interprocess event")
            self._own_events.append(ev.value)
            blob.append(h.raw)
        group.store.set(f"shared/cuda/{self.rank}", b"".join(blob))
        self.base = [0] * self.size
        self.events = [[None] * 4 for _ in range(self.size)]
        self.base[self.rank] = self._own
        self.events[self.rank] = list(self._own_events)
        self._opened, self._opened_events = [], []
        for r in range(self.size):
            if r == self.rank:
                continue
            got = group.store.get(f"shared/cuda/{r}")
            ptr = ctypes.c_void_p()
            _check(lib.shared_pg_open_mem(self.device, got[:_HANDLE],
                                          ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle of rank {r}'s mailbox")
            self._opened.append(ptr.value)
            self.base[r] = ptr.value
            for i in range(4):
                ev = ctypes.c_void_p()
                h = got[_HANDLE * (i + 1):_HANDLE * (i + 2)]
                _check(lib.shared_pg_open_event(h, ctypes.byref(ev)),
                       f"cudaIpcOpenEventHandle of rank {r}")
                self._opened_events.append(ev.value)
                self.events[r][i] = ev.value
        self._lib = lib

    def _addr(self, r, s, off):
        return self.base[r] + s * self.slot + off

    def _wait(self, which, stream):
        """The stream waits on event ``which`` of every peer."""
        evs = [self.events[r][which] for r in range(self.size)
               if r != self.rank]
        _check(self._lib.shared_pg_wait(_ptrs(evs), len(evs), stream),
               "cudaStreamWaitEvent")

    def begin(self, s, stream):
        self._wait(2 + s, stream)          # every peer has read this slot

    def post(self, s, pieces, stream):
        _launch_gather([src.data_ptr() for _, src in pieces],
                       [self._addr(self.rank, s, off) for off, _ in pieces],
                       [src.numel() for _, src in pieces], stream)

    def written(self, s, stream):
        _check(self._lib.shared_pg_record(self._own_events[s], stream),
               "cudaEventRecord")

    def arrived(self, s, stream):
        self._wait(s, stream)              # every peer's chunk is in

    def reduce(self, s, off, out, op, stream):
        _launch_reduce([self._addr(r, s, off) for r in range(self.size)],
                       out.data_ptr(), out.numel(), out.dtype, op, stream)

    def gather(self, s, segs, stream):
        _launch_gather([self._addr(r, s, off) for r, off, _ in segs],
                       [dst.data_ptr() for _, _, dst in segs],
                       [dst.numel() for _, _, dst in segs], stream)

    def done(self, s, stream):
        _check(self._lib.shared_pg_record(self._own_events[2 + s], stream),
               "cudaEventRecord")

    def close_peers(self):
        torch.cuda.synchronize(self.device)
        for ev in self._opened_events:
            self._lib.shared_pg_event_destroy(ev)
        for ptr in self._opened:
            _check(self._lib.shared_pg_close_mem(ptr),
                   "cudaIpcCloseMemHandle")
        self._opened, self._opened_events = [], []

    def free(self):
        if self._own is None:
            return
        for ev in self._own_events:
            self._lib.shared_pg_event_destroy(ev)
        _check(self._lib.shared_pg_free(self._own), "cudaFree of a mailbox")
        MEMORY["cuda"] -= 2 * self.slot
        self._own, self._own_events = None, []


# -------------------------------------------------------------------- group
def _op(reduce_op) -> str:
    if reduce_op == dist.ReduceOp.SUM:
        return "sum"
    if reduce_op == dist.ReduceOp.MAX:
        return "max"
    raise ValueError(f"the shared backend reduces by SUM and MAX, not "
                     f"{reduce_op}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a flat contiguous tensor (a view where it is contiguous)."""
    return t.detach().contiguous().reshape(-1)


class _Out:
    """A caller's output as a flat contiguous tensor (its values copied in
    where ``load``), written back on ``close`` where the caller's was not
    contiguous."""

    def __init__(self, t: torch.Tensor, load: bool = False):
        self.t = t
        if t.is_contiguous():
            self.flat = t.reshape(-1)
        else:
            self.flat = torch.empty(t.numel(), dtype=t.dtype,
                                    device=t.device)
            if load:
                self.flat.copy_(t.reshape(-1))

    def close(self):
        if not self.t.is_contiguous():
            self.t.copy_(self.flat.view(self.t.shape))


class _SharedGroup(dist.ProcessGroup):
    """One group: its mailboxes by device type, a ``gloo`` group for the
    host handshake and barrier."""

    def __init__(self, store, rank: int, size: int, timeout, slot: int):
        super().__init__(rank, size)
        if size > MAX_RANKS:
            raise ValueError(f"the shared backend takes at most {MAX_RANKS} "
                             f"ranks a group, not {size}")
        self.store, self.slot = store, slot
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._boxes: dict[str, _HostBox | _DeviceBox] = {}
        self._flag = torch.zeros(1, dtype=torch.int64)

    def _set_group_name(self, name: str) -> None:
        super()._set_group_name(name)
        self._name = name

    @property
    def group_name(self) -> str:
        # Kept from creation: ``destroy_process_group`` reads it after it
        # has taken the group out of its tables.
        return getattr(self, "_name", None) or \
            dist.distributed_c10d._world.pg_names[self]

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

    def handshake(self, value: int = 0, op=dist.ReduceOp.MAX) -> int:
        """Meet the group on the host; the group's ``op`` of ``value``."""
        self._flag.fill_(value)
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        self._gloo.allreduce([self._flag], opts).wait()
        return int(self._flag.item())

    def _box(self, tensors: list[torch.Tensor]):
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise ValueError(f"the shared backend takes the tensors of one "
                             f"call on one device, not "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        key = str(dev) if dev.type == "cuda" else dev.type
        if key not in self._boxes:
            if dev.type == "cpu":
                self._boxes[key] = _HostBox(self)
            elif dev.type == "cuda":
                self._boxes[key] = _DeviceBox(self, dev)
            else:
                raise ValueError(f"the shared backend runs on cuda and cpu, "
                                 f"not {dev}")
        return self._boxes[key], (
            torch.cuda.current_stream(dev).cuda_stream
            if dev.type == "cuda" else 0)

    def _round(self, box, stream, posts, read) -> None:
        """One chunk: wait for the slot, post, meet, wait for the peers'
        chunks, read, record."""
        s = box.seq & 1
        box.begin(s, stream)
        if posts:
            box.post(s, posts, stream)
        box.written(s, stream)
        self.handshake()
        box.arrived(s, stream)
        read(s)
        box.done(s, stream)
        box.seq += 1

    def _count(self, op: str, nbytes: int, chunks: int, t0: float) -> None:
        c = COUNTERS.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                     "chunks": 0})
        c["calls"] += 1
        c["bytes"] += nbytes
        c["chunks"] += chunks
        c["seconds"] += time.perf_counter() - t0

    # ------------------------------------------------------------- reduces
    def _allreduce_one(self, t: torch.Tensor, op: str) -> int:
        _reduce_dtype(t.dtype)
        box, st = self._box([t])
        x = _Out(t, load=True)
        per = self.slot // t.element_size()
        chunks = 0
        for lo in range(0, t.numel(), per):
            m = min(per, t.numel() - lo)
            piece = x.flat[lo:lo + m]
            self._round(box, st, [(0, _bytes(piece))],
                        lambda s, p=piece: box.reduce(s, 0, p, op, st))
            chunks += 1
        x.close()
        return chunks

    def allreduce(self, tensors, opts=None):
        t0 = time.perf_counter()
        op = _op((opts or dist.AllreduceOptions()).reduceOp)
        self._box(tensors)
        chunks = sum(self._allreduce_one(t, op) for t in tensors)
        self._count("all_reduce", sum(t.numel() * t.element_size()
                                      for t in tensors), chunks, t0)
        return self._done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def _sub(self) -> int:
        """A slot's share for one peer, a multiple of 16 bytes."""
        return self.slot // self.size() // 16 * 16

    def _reduce_scatter_one(self, output, inp, op: str) -> int:
        n, m_all = self.size(), output.numel()
        _reduce_dtype(output.dtype)
        if inp.dtype != output.dtype or inp.numel() != n * m_all:
            raise ValueError(f"reduce-scatter of {inp.numel()} "
                             f"{inp.dtype} elements into {m_all} "
                             f"{output.dtype} over {n} ranks")
        box, st = self._box([output, inp])
        x, out = _flat(inp), _Out(output)
        per = self._sub() // output.element_size()
        chunks = 0
        for lo in range(0, m_all, per):
            m = min(per, m_all - lo)
            posts = [(j * self._sub(),
                      _bytes(x[j * m_all + lo:j * m_all + lo + m]))
                     for j in range(n)]
            dst = out.flat[lo:lo + m]
            self._round(box, st, posts,
                        lambda s, d=dst: box.reduce(
                            s, self.rank() * self._sub(), d, op, st))
            chunks += 1
        out.close()
        return chunks

    def _reduce_scatter_base(self, output, inp, opts=None):
        t0 = time.perf_counter()
        op = _op((opts or dist.ReduceScatterOptions()).reduceOp)
        chunks = self._reduce_scatter_one(output, inp, op)
        self._count("reduce_scatter", inp.numel() * inp.element_size(),
                    chunks, t0)
        return self._done([output])

    def reduce_scatter_single(self, output, inp, opts=None):
        return self._reduce_scatter_base(output, inp, opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._reduce_scatter_base(o, i, opts)
        return self._done(outputs)

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        return self.reduce_scatter_tensor_coalesced(outputs, inputs, opts)

    # -------------------------------------------------------- data movement
    def _gather_into(self, inp: torch.Tensor, outs: list[torch.Tensor]) -> int:
        """Every rank's ``inp`` into ``outs[rank]`` (each of ``inp``'s
        bytes and dtype)."""
        if len(outs) != self.size():
            raise ValueError(f"{len(outs)} outputs for {self.size()} ranks")
        for o in outs:
            if o.dtype != inp.dtype or o.numel() != inp.numel():
                raise ValueError(f"all-gather of {inp.numel()} {inp.dtype} "
                                 f"into {o.numel()} {o.dtype}")
        box, st = self._box([inp, *outs])
        src = _bytes(_flat(inp))
        dsts = [_Out(o) for o in outs]
        dbytes = [_bytes(d.flat) for d in dsts]
        total, chunks = src.numel(), 0
        for lo in range(0, total, self.slot):
            m = min(self.slot, total - lo)
            self._round(box, st, [(0, src[lo:lo + m])],
                        lambda s, lo=lo, m=m: box.gather(
                            s, [(r, 0, dbytes[r][lo:lo + m])
                                for r in range(self.size())], st))
            chunks += 1
        for d in dsts:
            d.close()
        return chunks

    def _allgather_base(self, output, inp, opts=None):
        t0 = time.perf_counter()
        if output.numel() != self.size() * inp.numel():
            raise ValueError(f"all-gather of {inp.numel()} elements into "
                             f"{output.numel()} over {self.size()} ranks")
        out = _Out(output)
        chunks = self._gather_into(
            inp, list(out.flat.view(self.size(), inp.numel())))
        out.close()
        self._count("all_gather", inp.numel() * inp.element_size(), chunks,
                    t0)
        return self._done([output])

    def all_gather_single(self, output, inp, opts=None):
        return self._allgather_base(output, inp, opts)

    def allgather(self, outputs, inputs, opts=None):
        t0 = time.perf_counter()
        chunks = sum(self._gather_into(i, o)
                     for o, i in zip(outputs, inputs, strict=True))
        self._count("all_gather", sum(i.numel() * i.element_size()
                                      for i in inputs), chunks, t0)
        return self._done(outputs)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._allgather_base(o, i, opts)
        return self._done(outputs)

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        return self.allgather_into_tensor_coalesced(outputs, inputs, opts)

    def alltoall_base(self, output, inp, out_splits, in_splits, opts=None):
        t0 = time.perf_counter()
        n, rank = self.size(), self.rank()
        if inp.dtype != output.dtype:
            raise ValueError(f"all-to-all of {inp.dtype} into {output.dtype}")
        box, st = self._box([output, inp])
        row = math.prod(inp.shape[1:]) * inp.element_size()
        if math.prod(output.shape[1:]) * output.element_size() != row:
            raise ValueError("all-to-all rows of unequal width")
        ins = list(in_splits) or [inp.shape[0] // n] * n
        outs = list(out_splits) or [output.shape[0] // n] * n
        if len(ins) != n or len(outs) != n or sum(ins) != inp.shape[0] or \
                sum(outs) != output.shape[0]:
            raise ValueError(f"all-to-all splits {ins} / {outs} for rows "
                             f"{inp.shape[0]} / {output.shape[0]}")
        src, out = _bytes(_flat(inp)), _Out(output)
        dst = _bytes(out.flat)

        def segments(splits, whole):
            at, segs = 0, []
            for k in splits:
                segs.append(whole[at * row:(at + k) * row])
                at += k
            return segs

        send, recv = segments(ins, src), segments(outs, dst)
        sub = self._sub()
        mine = max([math.ceil(t.numel() / sub) for t in send + recv] + [0])
        chunks = self.handshake(mine)
        for c in range(chunks):
            lo = c * sub
            posts = [(j * sub, send[j][lo:lo + sub]) for j in range(n)
                     if send[j].numel() > lo]
            segs = [(j, rank * sub, recv[j][lo:lo + sub]) for j in range(n)
                    if recv[j].numel() > lo]
            self._round(box, st, posts,
                        lambda s, segs=segs: box.gather(s, segs, st)
                        if segs else None)
        out.close()
        self._count("all_to_all", src.numel(), chunks, t0)
        return self._done([output])

    def broadcast(self, tensors, opts=None):
        t0 = time.perf_counter()
        root = (opts or dist.BroadcastOptions()).rootRank
        box, st = self._box(tensors)
        chunks = 0
        for t in tensors:
            x = _Out(t, load=True)
            b = _bytes(x.flat)
            for lo in range(0, b.numel(), self.slot):
                piece = b[lo:lo + self.slot]
                if self.rank() == root:
                    self._round(box, st, [(0, piece)], lambda s: None)
                else:
                    self._round(box, st, [],
                                lambda s, p=piece: box.gather(
                                    s, [(root, 0, p)], st))
                chunks += 1
            x.close()
        self._count("broadcast", sum(t.numel() * t.element_size()
                                     for t in tensors), chunks, t0)
        return self._done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return self._done([])

    def shutdown(self):
        """Close every peer's mailbox, meet the group, then free this
        rank's own: no rank frees a mailbox a peer still has open.  A peer
        that is gone (the meeting fails) holds nothing open."""
        boxes, self._boxes = list(self._boxes.values()), {}
        try:
            for box in boxes:
                box.close_peers()
            if boxes:
                try:
                    self._gloo.barrier(dist.BarrierOptions()).wait()
                except RuntimeError:
                    pass
        finally:
            for box in boxes:
                box.free()


def register(slot_bytes: int = SLOT_BYTES) -> None:
    """Add the ``"shared"`` backend (once per process), each group's
    mailbox two slots of ``slot_bytes`` (a multiple of 16, at least 16
    bytes a rank of the largest group)."""
    if slot_bytes % 16 or slot_bytes < 16 * MAX_RANKS:
        raise ValueError(f"slot_bytes {slot_bytes}: a multiple of 16, at "
                         f"least {16 * MAX_RANKS}")
    if BACKEND not in dist.Backend.backend_list:
        dist.Backend.register_backend(
            BACKEND, functools.partial(_SharedGroup, slot=slot_bytes),
            devices=["cpu", "cuda"])
