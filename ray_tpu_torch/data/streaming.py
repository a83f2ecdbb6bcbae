"""Streaming consumption utilities + split iterators.

Reference parity: _internal/iterator/stream_split_iterator.py
(StreamSplitDataIterator :31) and _internal/block_batching. The
pull-based operator topology itself lives in executor.py
(StreamingExecutor); this module provides the consumption side — block
resolution with prefetch, batch re-chunking, the streaming_split
coordinator, and the torch device feed.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, List, Optional, Tuple

from .. import api
from ..util import tracing
from . import block as B
from .context import DataContext

# A streamed bundle: (ObjectRef of block, row count or -1 if not known yet)
StreamedBundle = Tuple[api.ObjectRef, int]


def iter_blocks(bundles: Iterator[StreamedBundle],
                prefetch: int = 0) -> Iterator[B.Block]:
    """Resolve bundle refs to blocks; with `prefetch` > 0, hold that many
    upcoming refs before the one being consumed. Pulling ahead from
    `bundles` advances the streaming executor's admission, so later
    bundles execute (and their results land in the store) while the
    current block is being consumed — the reference's iter_batches
    read-ahead."""
    window: collections.deque = collections.deque()
    for bundle in bundles:
        window.append(bundle)
        if len(window) > prefetch:
            yield _get(window.popleft()[0])
    while window:
        yield _get(window.popleft()[0])


def _get(ref) -> B.Block:
    """The block behind ``ref``; the span ``data.get`` while tracing
    records."""
    if tracing.profiler._is_profiler_enabled:
        return tracing.local_call("data.get", api.get, ref)
    return api.get(ref)


def shuffled_blocks(blocks: Iterator[B.Block], buffer_size: int,
                    seed: Optional[int] = None) -> Iterator[B.Block]:
    """Consumption-side local shuffle (reference: ShufflingBatcher,
    _internal/block_batching/util — iter_batches'
    local_shuffle_buffer_size): hold a row buffer of at least
    `buffer_size` rows; each emission permutes the buffer once and
    yields the surplus prefix — a uniform draw without replacement —
    so rows mix across neighboring blocks without a distributed
    exchange. The tail is flushed permuted. Row-identity preserving:
    multiset in == multiset out."""
    import numpy as np
    rng = np.random.default_rng(seed)
    buf: Optional[B.Block] = None
    for blk in blocks:
        if not B.block_length(blk):
            continue
        buf = blk if buf is None else B.block_concat([buf, blk])
        n = B.block_length(buf)
        if n > buffer_size:
            buf = B.block_take_indices(buf, rng.permutation(n))
            yield B.block_slice(buf, 0, n - buffer_size)
            buf = B.block_slice(buf, n - buffer_size, n)
    if buf is not None and B.block_length(buf):
        n = B.block_length(buf)
        yield B.block_take_indices(buf, rng.permutation(n))


def batches_from_blocks(
    blocks: Iterator[B.Block],
    batch_size: Optional[int],
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator:
    """Re-chunk a block stream into fixed-size batches (reference:
    _internal/block_batching)."""
    leftover: Optional[B.Block] = None
    for blk in blocks:
        if leftover is not None:
            blk = _batch_step(B.block_concat, [leftover, blk])
            leftover = None
        n = B.block_length(blk)
        if batch_size is None:
            if n:
                yield _batch_step(B.to_batch_format, blk, batch_format)
            continue
        pos = 0
        while n - pos >= batch_size:
            yield _batch_step(_cut, blk, pos, pos + batch_size, batch_format)
            pos += batch_size
        if pos < n:
            leftover = B.block_slice(blk, pos, n)
    if leftover is not None and B.block_length(leftover) and not drop_last:
        yield _batch_step(B.to_batch_format, leftover, batch_format)


def _cut(blk: B.Block, start: int, end: int, batch_format: str):
    return B.to_batch_format(B.block_slice(blk, start, end), batch_format)


def _batch_step(fn: Callable, *args):
    """``fn(*args)``, one step of making batches; the span ``data.batch``
    while tracing records."""
    if tracing.profiler._is_profiler_enabled:
        return tracing.local_call("data.batch", fn, *args)
    return fn(*args)


# ---------------------------------------------------------------------------
# streaming_split
# ---------------------------------------------------------------------------
@api.remote
class _SplitCoordinator:
    """Hands blocks out to n consumers exactly once per epoch (reference:
    the SplitCoordinator actor behind streaming_split,
    stream_split_iterator.py:31).

    Blocks are pre-assigned at construction — equal=True balances by row
    count (largest block to the least-loaded consumer, the classic LPT
    greedy) — so a consumer that starts late or pulls slowly can never be
    starved by a faster peer, and every epoch replays the same
    assignment deterministically.
    """

    def __init__(self, bundles: List[Tuple[object, int]], n: int,
                 equal: bool):
        self._n = n
        self._assignment: List[List] = [[] for _ in range(n)]
        self._rows_given = [0] * n
        if equal:
            order = sorted(bundles, key=lambda b: -b[1])
            for ref, rows in order:
                tgt = min(range(n), key=lambda i: self._rows_given[i])
                self._assignment[tgt].append(ref)
                self._rows_given[tgt] += rows
        else:
            for i, (ref, rows) in enumerate(bundles):
                self._assignment[i % n].append(ref)
                self._rows_given[i % n] += rows
        self._pos = [0] * n

    def next_block(self, consumer: int):
        """Next block ref for `consumer`, or None at epoch end (the
        position resets, so the next iteration replays the shard)."""
        pos = self._pos[consumer]
        if pos >= len(self._assignment[consumer]):
            self._pos[consumer] = 0
            return None
        self._pos[consumer] = pos + 1
        return self._assignment[consumer][pos]

    def reset(self, consumer: int):
        """Rewind `consumer` to its shard start (new epoch). Iterators
        call this when (re)starting so a partially consumed or
        prefetch-overshot previous epoch can't skip blocks."""
        self._pos[consumer] = 0

    def stats(self):
        return {"rows_given": list(self._rows_given)}


def torch_device_feed(batches: Iterator, *, device=None, sharding=None,
                      device_prefetch: int = 2) -> Iterator:
    """Shared device-upload window behind Dataset.iter_torch_batches and
    DataIterator.iter_torch_batches (counterpart of the JAX package's
    ``jax_device_feed``): yields batches of tensors already on the
    device, with up to ``device_prefetch`` uploads in flight (0 = upload
    in step with consumption, no device-side buffering).

    ``device`` pins one device (None: the CUDA card; a missing card
    raises RuntimeError here, never a move to the CPU). ``sharding`` is
    a DeviceMesh (``parallel.make_mesh``) with a ``dp`` axis: axis 0 of
    each batch is split over it, and this rank keeps rows
    ``[c*B/N, (c+1)*B/N)`` for its coordinate c of N along ``dp`` (what
    ``NamedSharding(mesh, PartitionSpec("dp"))`` puts on device c), on
    its own device.

    On a CUDA target each batch is copied into pinned host memory, then
    to the card ``non_blocking`` on a side stream; the consumer's
    current stream waits on that copy's event before the batch is
    yielded, and each tensor is recorded on the consumer stream so the
    caching allocator keeps its memory until the consumer's work on it
    is done. A CPU target gets the host tensors as they are.
    """
    if device is not None and sharding is not None:
        raise ValueError("pass device= OR sharding=, not both")
    depth = int(device_prefetch)
    if depth < 0:
        raise ValueError("device_prefetch must be >= 0")
    from .._device import resolve_device

    if sharding is None:
        target, coord, parts = resolve_device(device), 0, 1
    else:
        names = tuple(sharding.mesh_dim_names or ())
        if "dp" not in names:
            raise ValueError("sharding= takes a DeviceMesh with a 'dp' "
                             f"axis, got axes {names}")
        target = resolve_device(sharding.device_type)
        coord = sharding.get_local_rank("dp")
        parts = int(sharding.size(names.index("dp")))
    return _device_feed(batches, target, coord, parts, depth)


def _device_feed(batches: Iterator, target, coord: int, parts: int,
                 depth: int) -> Iterator:
    import numpy as np
    import torch

    def rows(value) -> np.ndarray:
        a = np.asarray(value)
        if parts == 1:
            return a
        if a.shape[0] % parts:
            raise ValueError(
                f"a batch of {a.shape[0]} rows does not split over the "
                f"mesh's {parts} dp devices")
        step = a.shape[0] // parts
        return a[coord * step:(coord + 1) * step]

    cuda = target.type == "cuda"
    side = torch.cuda.Stream(target) if cuda else None

    def pinned(a: np.ndarray) -> torch.Tensor:
        # One host copy, store pages -> pinned memory, by numpy (the
        # pages may be read-only, and torch never wraps them).
        t = torch.empty(a.shape, pin_memory=True,
                        dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
        t.numpy()[...] = a
        return t

    def host(a: np.ndarray) -> torch.Tensor:
        # torch has no read-only tensor: read-only pages are copied.
        return torch.from_numpy(a if a.flags.writeable else a.copy())

    def stage(batch) -> dict:
        """This rank's rows of each column on the host: pinned for a
        card, as they are for the CPU."""
        return {k: (pinned if cuda else host)(rows(v))
                for k, v in batch.items()}

    def upload(staged: dict):
        if not cuda:
            return staged, None
        with torch.cuda.stream(side):
            put = {k: t.to(target, non_blocking=True)
                   for k, t in staged.items()}
            done = torch.cuda.Event()
            done.record(side)
        return put, done

    def ready(item):
        put, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(target)
            consumer.wait_event(done)
            for t in put.values():
                t.record_stream(consumer)
        return put

    window: collections.deque = collections.deque()
    batches = iter(batches)
    while True:
        if tracing.profiler._is_profiler_enabled:
            # The upstream's next batch, the host copies (pinned for a
            # card) and the uploads' enqueueing, as spans, and the bytes
            # copied. The staged copies are let go as the untraced path
            # lets them go, so the host allocator reuses the same blocks.
            batch = tracing.local_call("feed.fetch", next, batches, None)
            if batch is None:
                break
            staged = tracing.local_call("feed.pin", stage, batch)
            tracing.local_count("feed.bytes", sum(
                t.numel() * t.element_size() for t in staged.values()))
            item = tracing.local_call("feed.upload", upload, staged)
            del staged
        else:
            batch = next(batches, None)
            if batch is None:
                break
            item = upload(stage(batch))
        if depth == 0:
            yield ready(item)
            continue
        window.append(item)
        if len(window) > depth:
            yield ready(window.popleft())
    while window:
        yield ready(window.popleft())


def _require_drop_last_for_sharding(sharding, kwargs: dict) -> None:
    """A mesh sharding needs every batch divisible by the axis size;
    the trailing partial batch generally is not — demand an explicit
    drop_last=True instead of failing at epoch end."""
    if sharding is not None and not kwargs.get("drop_last"):
        raise ValueError(
            "iter_torch_batches(sharding=...) requires drop_last=True: "
            "the final partial batch is generally not divisible by the "
            "mesh axis and its split would fail at epoch end")


class DataIterator:
    """Per-consumer shard stream (reference: data/iterator.py DataIterator
    returned by streaming_split). Picklable — holds only the coordinator
    actor handle — so Train can ship one into each worker actor."""

    def __init__(self, coordinator, consumer_id: int):
        self._coord = coordinator
        self._id = consumer_id

    def _iter_block_refs(self):
        api.get(self._coord.reset.remote(self._id))
        while True:
            ref = api.get(self._coord.next_block.remote(self._id))
            if ref is None:
                return
            yield ref

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_batches: Optional[int] = None) -> Iterator:
        # Pull coordinator assignments `prefetch_batches` ahead of
        # consumption so the next block is in flight during compute.
        if prefetch_batches is None:
            prefetch_batches = DataContext.get_current().prefetch_batches
        blocks = iter_blocks(
            ((ref, -1) for ref in self._iter_block_refs()),
            prefetch=prefetch_batches)
        return batches_from_blocks(blocks, batch_size, batch_format,
                                   drop_last)

    def iter_rows(self) -> Iterator:
        for batch in self.iter_batches(batch_size=None):
            yield from B.block_to_rows(B.from_batch_format(batch))

    def iter_torch_batches(self, *, device=None, device_prefetch: int = 2,
                           sharding=None, **kwargs):
        """This shard's batches as torch tensors. Without ``device`` or
        ``sharding``: host tensors, converted per batch. With either: the
        device feed for train workers (``torch_device_feed``, the
        contract of Dataset.iter_torch_batches)."""
        _require_drop_last_for_sharding(sharding, kwargs)
        batches = self.iter_batches(
            batch_format="numpy",
            **{k: v for k, v in kwargs.items()
               if k in ("batch_size", "drop_last", "prefetch_batches")})
        if device is None and sharding is None:
            import torch
            return ({k: torch.as_tensor(v) for k, v in batch.items()}
                    for batch in batches)
        return torch_device_feed(batches, device=device, sharding=sharding,
                                 device_prefetch=device_prefetch)

    def materialize(self):
        """Collect this shard into a list of blocks (mostly for tests)."""
        return list(iter_blocks((r, -1) for r in self._iter_block_refs()))


def make_split_iterators(bundles: List[StreamedBundle], n: int,
                         equal: bool) -> List[DataIterator]:
    coord = _SplitCoordinator.remote(
        [(ref, rows) for ref, rows in bundles], n, equal)
    return [DataIterator(coord, i) for i in range(n)]
