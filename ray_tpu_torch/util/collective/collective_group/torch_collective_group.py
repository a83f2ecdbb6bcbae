"""torch.distributed collective group: NCCL on CUDA tensors, gloo on CPU.

The port's counterpart of the JAX package's XLA group (one rank per
worker process over a device mesh) and of the reference's NCCL group
(python/ray/util/collective/collective_group/nccl_collective_group.py:128
NCCLGroup): one rank per worker process, a rendezvous through the GCS KV
store (replacing the named-actor ``Rendezvous`` that holds an NCCL
unique id, nccl_collective_group.py:29-124), then a process group of the
group's own.

Each group builds its process group from a ``TCPStore`` that its rank 0
serves, under a ``PrefixStore`` keyed by the group's generation nonce. It
never touches torch's process-global default group, so any number of
groups, overlapping subsets of one world among them, live side by side
in a process (a disjoint tensor-parallel group per data-parallel pair,
say). The backend is the caller's: ``nccl`` takes CUDA tensors on this
process's current device, ``gloo`` CPU tensors, and a group never swaps
one for the other.

Rendezvous keys live in the GCS KV namespace ``rtt_collective`` under a
per-attempt generation nonce, so a crashed earlier group of the same name
can neither fail nor satisfy a new one.
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta
from typing import Optional

import numpy as np

from ..collective import _KV_NS
from ..types import (
    AllGatherOptions,
    AllReduceOptions,
    BarrierOptions,
    BroadcastOptions,
    RecvOptions,
    ReduceOp,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)
from .base_collective_group import BaseGroup

# How long a member waits for the others at creation, and what the
# process group gives a collective before it fails.
DEFAULT_TIMEOUT_S = 60.0


def _kv():
    from ...._private import state
    return state.current()


def _kv_put(key: str, value: bytes):
    _kv().gcs_request("kv_put", key=key, value=value, namespace=_KV_NS)


def _kv_get(key: str) -> Optional[bytes]:
    return _kv().gcs_request("kv_get", key=key, namespace=_KV_NS)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rendezvous(group_name: str, world_size: int, rank: int,
                timeout_s: float = DEFAULT_TIMEOUT_S, gen: str = "",
                addr: Optional[str] = None) -> str:
    """Agree on a coordinator address via the GCS KV (reference:
    Rendezvous via named actor, nccl_collective_group.py:29). Rank 0
    publishes ``addr`` (a free local port when None); the others poll for
    it. Keys are namespaced per group GENERATION (``gen``), so an address
    left by a crashed prior group of the same name is never handed to a
    new one."""
    key = f"{group_name}/{gen}/coordinator"
    if rank == 0:
        addr = addr or f"127.0.0.1:{_free_port()}"
        _kv_put(key, addr.encode())
        return addr
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        raw = _kv_get(key)
        if raw:
            return raw.decode()
        time.sleep(0.05)
    raise TimeoutError(
        f"Rendezvous for group '{group_name}' timed out after {timeout_s}s")


def _process_id() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


class TorchGroup(BaseGroup):
    """One collective group == one torch.distributed process group."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 backend: str = "gloo",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        super().__init__(world_size, rank, group_name)
        import torch
        import torch.distributed as dist

        if backend not in ("nccl", "gloo"):
            raise ValueError(f"TorchGroup backend must be 'nccl' or 'gloo', "
                             f"got {backend!r}")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Group '{group_name}': nccl needs a CUDA device in this "
                "process (reserve one with num_gpus=1), or use 'gloo' on "
                "CPU tensors")
        self._backend = backend
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if backend == "nccl" else torch.device("cpu"))
        timeout = timedelta(seconds=timeout_s)
        if world_size == 1:
            # Nobody to meet: an in-process store, no KV round trip.
            import uuid
            gen = uuid.uuid4().hex[:8]
            store = dist.HashStore()
        else:
            gen = self._pre_rendezvous(group_name, world_size, rank,
                                       backend, timeout_s)
            self._subset_members(group_name, world_size, rank,
                                 _process_id(), timeout_s, gen)
            if rank == 0:
                store = dist.TCPStore("127.0.0.1", 0, world_size, True,
                                      timeout=timeout,
                                      wait_for_workers=False)
                _rendezvous(group_name, world_size, rank, timeout_s, gen,
                            addr=f"127.0.0.1:{store.port}")
            else:
                host, port = _rendezvous(group_name, world_size, rank,
                                         timeout_s, gen).rsplit(":", 1)
                store = dist.TCPStore(host, int(port), world_size, False,
                                      timeout=timeout)
        self._gen = gen
        self._store = store
        prefixed = dist.PrefixStore(f"{group_name}/{gen}", store)
        if backend == "gloo":
            self._pg = dist.ProcessGroupGloo(prefixed, rank, world_size,
                                             timeout)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._pg = dist.ProcessGroupNCCL(prefixed, rank, world_size,
                                             opts)

    @staticmethod
    def _generation(group_name: str, rank: int, deadline: float) -> str:
        """Resolve this creation attempt's generation nonce. Rank 0
        ROTATES it (fresh uuid per attempt); other ranks poll for it, and
        keep following it if it changes (a stale nonce from a crashed
        prior group is superseded the moment the live rank 0 publishes).
        Namespacing all rendezvous keys under the nonce makes a dead
        group's leftovers invisible instead of spuriously failing (or
        worse, spuriously satisfying) a valid new group."""
        key = f"{group_name}/gen"
        if rank == 0:
            import uuid
            stale = _kv_get(key)
            gen = uuid.uuid4().hex[:8]
            _kv_put(key, gen.encode())
            if stale:
                # A prior generation that was never destroyed (crashed
                # group): burn its keys so no member can complete a
                # rendezvous against the dead state.
                sg = stale.decode()
                for k in ([f"{group_name}/{sg}/coordinator"]
                          + [f"{group_name}/{sg}/{kind}/{r}"
                             for kind in ("pre", "proc", "confirm")
                             for r in range(64)]):
                    try:
                        _kv().gcs_request("kv_del", key=k,
                                          namespace=_KV_NS)
                    except Exception:
                        break
            return gen
        while time.monotonic() < deadline:
            raw = _kv_get(key)
            if raw is not None:
                gen = raw.decode()
                # Own-key discriminator: under a CURRENT generation this
                # rank's pre key cannot exist before this rank publishes
                # it; its presence proves `gen` is a crashed prior group's
                # leftover pointer read before the live rank 0 rotated it.
                if _kv_get(f"{group_name}/{gen}/pre/{rank}") is None:
                    return gen
            time.sleep(0.05)
        raise TimeoutError(
            f"group '{group_name}' rendezvous: no fresh generation "
            f"published (rank 0 absent or only stale state found)")

    @staticmethod
    def _pre_rendezvous(group_name: str, world_size: int, rank: int,
                        backend: str,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
        """Agreement before any process group is built: every member
        publishes the backend it asked for under the current generation,
        and creation proceeds once all members have published the same
        one. Members that asked for different backends cannot form a
        group: that raises instead of hanging in the process group's own
        rendezvous. Returns the generation."""
        from ...._private import fault
        if fault.enabled:
            fault.fire("collective.rendezvous", group=group_name,
                       rank=rank)
        deadline = time.monotonic() + timeout_s
        gen = TorchGroup._generation(group_name, rank, deadline)
        _kv_put(f"{group_name}/{gen}/pre/{rank}", backend.encode())
        last_tags = None
        mixed_since = None
        # Grace for a straggler of an older attempt to overwrite its key,
        # scaled with the caller's budget.
        grace = min(max(3.0, 0.25 * timeout_s), 0.5 * timeout_s)
        while time.monotonic() < deadline:
            if rank != 0:
                cur = _kv_get(f"{group_name}/gen")
                cur_gen = cur.decode() if cur else gen
                if cur_gen != gen:
                    # Rank 0 started a newer attempt: follow it.
                    gen = cur_gen
                    _kv_put(f"{group_name}/{gen}/pre/{rank}",
                            backend.encode())
                    mixed_since = None
            tags = []
            for r in range(world_size):
                raw = _kv_get(f"{group_name}/{gen}/pre/{r}")
                tags.append(raw.decode() if raw is not None else None)
            if None not in tags:
                last_tags = tags
                if len(set(tags)) == 1:
                    return gen
                now = time.monotonic()
                mixed_since = mixed_since or now
                if now - mixed_since >= grace:
                    raise RuntimeError(
                        f"Group '{group_name}': members asked for "
                        f"different backends {tags}; every member must "
                        "name the same one ('nccl' or 'gloo')")
            else:
                mixed_since = None
            time.sleep(0.1)
        raise TimeoutError(
            f"group '{group_name}' pre-rendezvous timed out "
            f"(tags={last_tags})")

    @staticmethod
    def _subset_members(group_name: str, world_size: int, rank: int,
                        my_process: str,
                        timeout_s: float = DEFAULT_TIMEOUT_S,
                        gen: str = "") -> list:
        """Publish this member's process (host:pid); wait for all
        world_size members, returning their processes in group-rank order.
        Two ranks in one process would deadlock the process group, so
        repeated members raise. A confirm round guards against divergent
        first reads within a generation: every member publishes the
        membership signature it resolved and loops until all members
        published the same one."""
        _kv_put(f"{group_name}/{gen}/proc/{rank}", my_process.encode())
        deadline = time.monotonic() + timeout_s

        def _poll(key):
            while time.monotonic() < deadline:
                raw = _kv_get(key)
                if raw is not None:
                    return raw
                time.sleep(0.05)
            raise TimeoutError(
                f"group '{group_name}' rendezvous timed out on {key}")

        while True:
            members = [_poll(f"{group_name}/{gen}/proc/{r}").decode()
                       for r in range(world_size)]
            sig = ",".join(members)
            _kv_put(f"{group_name}/{gen}/confirm/{rank}", sig.encode())
            agreed = True
            for r in range(world_size):
                other = _poll(f"{group_name}/{gen}/confirm/{r}").decode()
                if other != sig:
                    agreed = False
                    break
            if agreed:
                if len(set(members)) != world_size:
                    raise RuntimeError(
                        f"Group '{group_name}': member processes "
                        f"{members} are not distinct; each rank needs a "
                        "process of its own")
                return members
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"group '{group_name}' members disagree on "
                    f"membership ({sig} vs {other})")
            time.sleep(0.1)

    def backend(self) -> str:
        return self._backend

    # -- plumbing ----------------------------------------------------------
    def _tensor(self, x):
        """A copy of ``x`` on the group's device, and whether the caller
        gave numpy (which it then gets back). A torch tensor must already
        be on the group's kind of device: nothing moves it."""
        import torch

        if isinstance(x, torch.Tensor):
            if x.device.type != self._device.type:
                raise ValueError(
                    f"the {self._backend} group takes tensors on "
                    f"{self._device.type}, got one on {x.device}")
            return x.detach().clone().contiguous(), False
        arr = np.array(x, copy=True)
        return torch.from_numpy(arr).to(self._device), True

    @staticmethod
    def _out(t, as_numpy: bool):
        return t.cpu().numpy() if as_numpy else t

    @staticmethod
    def _reduce_op(op: ReduceOp):
        import torch.distributed as dist
        return {ReduceOp.SUM: dist.ReduceOp.SUM,
                ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
                ReduceOp.MIN: dist.ReduceOp.MIN,
                ReduceOp.MAX: dist.ReduceOp.MAX}[op]

    # -- collectives -------------------------------------------------------
    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        """All ranks get reduce(tensor over ranks) (reference API
        collective.py:258)."""
        import torch.distributed as dist

        t, as_np = self._tensor(tensor)
        o = dist.AllreduceOptions()
        o.reduceOp = self._reduce_op(opts.reduceOp)
        self._pg.allreduce([t], o).wait()
        return self._out(t, as_np)

    def allgather(self, tensor, opts: AllGatherOptions = AllGatherOptions()):
        """Returns the stacked (world, *shape) tensor on every rank
        (reference API collective.py:423)."""
        import torch

        t, as_np = self._tensor(tensor)
        outs = [torch.empty_like(t) for _ in range(self._world_size)]
        self._pg.allgather([outs], [t]).wait()
        return self._out(torch.stack(outs), as_np)

    def reducescatter(self, tensor,
                      opts: ReduceScatterOptions = ReduceScatterOptions()):
        """Each rank gets its 1/world chunk (along dim 0) of the reduced
        tensor (reference API collective.py:472)."""
        import torch
        import torch.distributed as dist

        if tensor.shape[0] % self._world_size != 0:
            raise ValueError(
                f"reducescatter needs dim0 divisible by world size "
                f"({tensor.shape[0]} % {self._world_size})")
        t, as_np = self._tensor(tensor)
        chunks = [c.contiguous() for c in t.chunk(self._world_size)]
        out = torch.empty_like(chunks[0])
        o = dist.ReduceScatterOptions()
        o.reduceOp = self._reduce_op(opts.reduceOp)
        self._pg.reduce_scatter([out], [chunks], o).wait()
        return self._out(out, as_np)

    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        """Reduce to root (reference collective.py:311). Root returns the
        reduced tensor; other ranks return their input unchanged."""
        import torch.distributed as dist

        t, as_np = self._tensor(tensor)
        o = dist.ReduceOptions()
        o.rootRank = opts.root_rank
        o.reduceOp = self._reduce_op(opts.reduceOp)
        self._pg.reduce([t], o).wait()
        if self._rank == opts.root_rank:
            return self._out(t, as_np)
        return np.asarray(tensor) if as_np else tensor

    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        """src_rank's tensor to all (reference collective.py:373)."""
        import torch.distributed as dist

        t, as_np = self._tensor(tensor)
        o = dist.BroadcastOptions()
        o.rootRank = opts.src_rank
        self._pg.broadcast([t], o).wait()
        return self._out(t, as_np)

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        # An all-reduce of one element on the group's device: NCCL's own
        # barrier has to guess the device.
        self.allreduce(np.zeros((1,), dtype=np.float32))

    # -- p2p ---------------------------------------------------------------
    def send(self, tensor, opts: SendOptions):
        """P2P send (reference collective.py:531): only src and dst take
        part; the payload crosses one link once."""
        t, _ = self._tensor(tensor)
        self._pg.send([t], opts.dst_rank, 0).wait()
        return None

    def recv(self, shape_dtype_or_tensor, opts: RecvOptions):
        if isinstance(shape_dtype_or_tensor, tuple):
            shape, dtype = shape_dtype_or_tensor
            template = np.zeros(shape, dtype=dtype)
        else:
            template = shape_dtype_or_tensor
        t, as_np = self._tensor(template)
        self._pg.recv([t], opts.src_rank, 0).wait()
        return self._out(t, as_np)

    def destroy_group(self):
        pg, self._pg = self._pg, None
        if pg is not None and self._backend == "nccl":
            pg.shutdown()
        self._store = None
        if self._world_size == 1:
            return
        # Drop rendezvous keys so the group name is cleanly reusable.
        gen = self._gen
        keys = [f"{self._group_name}/{gen}/proc/{self._rank}",
                f"{self._group_name}/{gen}/confirm/{self._rank}",
                f"{self._group_name}/{gen}/pre/{self._rank}",
                f"{self._group_name}/{gen}/coordinator"]
        # The {name}/gen pointer is deliberately NOT deleted: a
        # compare-and-delete over plain KV round trips can race a
        # concurrent re-creation's rotation and wipe the NEW pointer
        # (stranding its late joiners). A stale pointer is harmless: the
        # next creation's rank 0 rotates it unconditionally, and readers
        # are guarded by the own-pre-key discriminator.
        for key in keys:
            try:
                _kv().gcs_request("kv_del", key=key, namespace=_KV_NS)
            except Exception:
                pass
