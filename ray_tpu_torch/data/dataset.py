"""Dataset: lazy, distributed, block-based data pipelines.

Reference parity: python/ray/data/dataset.py (`Dataset` :152,
`map_batches` :407, `iter_batches` :4092, `streaming_split` :1537) with a
logical plan of stages executed over block ObjectRefs
(data/_internal/plan.py). Execution model: stages compose lazily; on
execute, each stage maps task/actor work over block refs — the bulk
equivalent of the reference's streaming executor, with its operator fusion
replaced by stage-chaining inside tasks where possible.

Blocks are dict-of-numpy columns in the shm object store (block.py), so a
`map_batches(num_tpus=1)` predictor reads its batch zero-copy and feeds
jax directly — the reference's GPU actor-pool inference path
(operators/actor_pool_map_operator.py:34) on TPU terms.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Union,
)

import numpy as np

from .. import api
from . import block as B


@dataclass
class ActorPoolStrategy:
    """compute= strategy (reference: data ActorPoolStrategy)."""

    size: Optional[int] = None
    min_size: Optional[int] = None
    max_size: Optional[int] = None

    @property
    def pool_min(self) -> int:
        return int(self.size or self.min_size or 2)

    @property
    def pool_max(self) -> int:
        # A fixed `size` pins the pool; (min,max) enables autoscaling
        # (reference: AutoscalingActorPool honors max_size).
        return int(self.size or self.max_size or self.pool_min)


@dataclass
class _RefBundle:
    ref: api.ObjectRef
    num_rows: int


# ---------------------------------------------------------------------------
# remote helpers (module-level so they pickle once per worker)
# ---------------------------------------------------------------------------
@api.remote
def _apply_batches(blk: B.Block, fn, batch_size, batch_format,
                   fn_args, fn_kwargs) -> B.Block:
    n = B.block_length(blk)
    if n == 0:
        return blk
    step = batch_size or n
    outs = []
    for s in range(0, n, step):
        batch = B.to_batch_format(B.block_slice(blk, s, s + step),
                                  batch_format)
        outs.append(B.from_batch_format(
            fn(batch, *fn_args, **fn_kwargs)))
    return B.block_concat(outs)


@api.remote
def _apply_rows(blk: B.Block, fn, kind) -> B.Block:
    rows_out: List[Any] = []
    for row in B.block_to_rows(blk):
        if kind == "map":
            rows_out.append(fn(row))
        elif kind == "flat_map":
            rows_out.extend(fn(row))
        else:  # filter
            if fn(row):
                rows_out.append(row)
    return B.block_from_rows(rows_out)


@api.remote(num_cpus=0)
def _concat_blocks(*blks: B.Block) -> B.Block:
    # num_cpus=0 for the same reason as _slice_block below: repartition
    # must stay schedulable under a fully-reserved cluster.
    return B.block_concat(list(blks))


@api.remote(num_cpus=0)
def _slice_block(blk: B.Block, start: int, end: int) -> B.Block:
    """num_cpus=0: slicing is a metadata-sized copy, and repartition
    must stay schedulable even when long-lived actors (a train gang)
    hold every CPU — otherwise splits starve on small clusters."""
    return B.block_slice(blk, start, end)


@api.remote
def _partition_block(blk: B.Block, n: int, mode, key, boundaries, seed):
    """Split one block into n partitions (shuffle/sort/groupby map side)."""
    length = B.block_length(blk)
    if mode == "shuffle":
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, n, size=length)
    elif mode == "sort":
        vals = blk[key]
        assign = np.searchsorted(boundaries, vals, side="right")
    elif mode == "repartition":
        # Balanced contiguous chunks: row r of this block goes to
        # partition r*n//len — output j is the arrival-order concat of
        # every block's j-th chunk, so counts balance without any
        # global slice plan (the streaming path can't know the total).
        assign = (np.arange(length, dtype=np.int64) * n) // max(1, length)
    else:  # groupby hash
        # Deterministic cross-process hash: Python's hash() is salted per
        # process for str/bytes (PYTHONHASHSEED), and partition maps run in
        # different workers — the same key MUST land in the same partition.
        import zlib
        vals = blk[key]
        assign = np.array(
            [zlib.crc32(repr(v).encode()) % n for v in vals.tolist()],
            dtype=np.int64)
    parts = tuple(
        B.block_take_indices(blk, np.nonzero(assign == i)[0])
        for i in range(n))
    # n == 1 runs with num_returns=1: the single block IS the return
    # value (a 1-tuple would arrive intact and crash the reducer).
    return parts[0] if n == 1 else parts


@api.remote
def _reduce_partition(mode, key, descending, seed, *parts: B.Block):
    out = B.block_concat(list(parts))
    n = B.block_length(out)
    if n == 0:
        return out
    if mode == "shuffle":
        rng = np.random.default_rng(seed)
        return B.block_take_indices(out, rng.permutation(n))
    if mode == "sort":
        order = np.argsort(out[key], kind="stable")
        if descending:
            order = order[::-1]
        return B.block_take_indices(out, order)
    return out


@api.remote
def _sort_and_sample(blk: B.Block, key: str, k: int):
    """Streaming-sort phase 1: sort one block, emit (sorted block,
    evenly spaced sample of the key column). num_returns=2 at call
    sites."""
    order = np.argsort(blk[key], kind="stable")
    sblk = B.block_take_indices(blk, order)
    vals = np.asarray(sblk[key])
    if len(vals):
        idx = np.linspace(0, len(vals) - 1,
                          num=min(k, len(vals))).astype(int)
        sample = vals[idx]
    else:
        sample = vals[:0]
    return sblk, sample


@api.remote
def _sort_bounds(n: int, *samples):
    """Range boundaries from the union of per-block samples."""
    live = [s for s in samples if len(s)]
    if not live or n <= 1:
        return np.asarray([])
    allv = np.sort(np.concatenate(live))
    return np.asarray([allv[int(i * len(allv) / n)] for i in range(1, n)])


@api.remote
def _partition_sorted(blk: B.Block, n: int, bounds, key: str):
    """Range-split an already-sorted block into n contiguous slices
    (streaming-sort phase 2 — cheap: searchsorted + slicing). Degenerate
    boundary sets (all-empty input blocks sample nothing, so len(bounds)
    may be < n-1) pad with empty trailing slices — the reducer count is
    fixed at n."""
    length = B.block_length(blk)
    vals = np.asarray(blk[key]) if length else np.asarray([])
    cuts = [int(c) for c in np.searchsorted(vals, bounds, side="right")]
    edges = [0] + cuts + [length]
    parts = [B.block_slice(blk, edges[i], edges[i + 1])
             for i in range(len(edges) - 1)]
    while len(parts) < n:
        parts.append(B.block_slice(blk, length, length))
    parts = tuple(parts[:n])
    return parts[0] if n == 1 else parts


@api.remote
def _merge_agg_results(key: str, *parts) -> B.Block:
    """Merge per-partition aggregate dicts into one sorted block."""
    rows = []
    for part in parts:
        rows.extend(part.values())
    rows.sort(key=lambda r: r[key])
    return B.block_from_rows(rows)


@api.remote
def _aggregate_block(blk: B.Block, key: str, aggs) -> Dict:
    """Per-partition groupby aggregation -> small dict result."""
    out: Dict[Any, Dict[str, Any]] = {}
    if B.block_length(blk) == 0:
        return out
    keys = blk[key]
    uniq, inv = np.unique(keys, return_inverse=True)
    for gi, kval in enumerate(uniq.tolist()):
        idx = np.nonzero(inv == gi)[0]
        row: Dict[str, Any] = {key: kval}
        for name, (col, op) in aggs.items():
            vals = blk[col][idx] if col else idx
            if op == "count":
                row[name] = int(len(idx))
            elif op == "sum":
                row[name] = vals.sum()
            elif op == "mean":
                row[name] = vals.mean()
            elif op == "min":
                row[name] = vals.min()
            elif op == "max":
                row[name] = vals.max()
            elif op == "std":
                # Exact: groupby shuffles by key, so a group never spans
                # partitions.
                row[name] = float(np.std(
                    np.asarray(vals, np.float64), ddof=1)) \
                    if len(idx) > 1 else 0.0
        out[kval] = row
    return out


@api.remote
def _write_block(blk: B.Block, path: str, fmt: str, index: int) -> str:
    import os
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"part-{index:05d}.{fmt}")
    table = B.to_batch_format(blk, "pyarrow")
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, fname)
    elif fmt == "csv":
        import pyarrow.csv as pacsv
        pacsv.write_csv(table, fname)
    elif fmt == "json":
        import json
        with open(fname, "w") as f:
            for row in B.block_to_rows(blk):
                f.write(json.dumps(
                    {k: (v.item() if hasattr(v, "item") else v)
                     for k, v in row.items()}) + "\n")
    else:
        raise ValueError(fmt)
    return fname


@api.remote
def _zip_blocks(left: B.Block, right: B.Block) -> B.Block:
    """Column-wise merge of two equal-length blocks (reference:
    dataset.py zip semantics: duplicate column names from the right side
    get an `_1` suffix)."""
    nl, nr = B.block_length(left), B.block_length(right)
    if nl != nr:
        raise ValueError(f"zip block length mismatch: {nl} vs {nr}")
    out = dict(left)
    for k, v in right.items():
        out[f"{k}_1" if k in out else k] = v
    return out


@api.remote
def _block_moments(blk: B.Block, on: str, want_m2: bool = True):
    """(count, mean, M2) per block — Welford form, so the driver-side
    Chan merge is numerically stable even when |mean| >> std (the naive
    sum-of-squares formula catastrophically cancels there). sum/mean
    callers skip the M2 pass (want_m2=False)."""
    col = np.asarray(blk[on], np.float64)
    mean = float(col.mean())
    m2 = float(((col - mean) ** 2).sum()) if want_m2 else 0.0
    return (len(col), mean, m2)


@api.remote
def _block_minmax(blk: B.Block, on: str):
    col = np.asarray(blk[on])
    return (col.min(), col.max())


@api.remote
def _block_unique(blk: B.Block, on: str):
    return [v.item() if hasattr(v, "item") else v
            for v in np.unique(np.asarray(blk[on]))]


class _MapBatchesActorPool:
    """AUTOSCALING actor-pool compute for map_batches (reference:
    AutoscalingActorPool inside ActorPoolMapOperator,
    operators/actor_pool_map_operator.py:34,446,530 — queue-driven
    scale-up between min and max, scale-down when drained).

    Supports bulk `map` (plan execution) and per-bundle `submit`
    (streaming execution: least-loaded dispatch; completions observed
    at submit time drive the scaling decision)."""

    # Outstanding-per-actor above this spawns another actor (reference:
    # scale up while queued-per-actor exceeds its threshold).
    _SCALE_UP_QUEUE = 2

    def __init__(self, fn_cls, min_size, max_size, opts, ctor_args,
                 ctor_kwargs):
        @api.remote
        class _BatchMapper:
            def __init__(self, blob):
                import cloudpickle
                cls, args, kwargs = cloudpickle.loads(blob)
                self.fn = cls(*args, **kwargs)

            def apply(self, blk, batch_size, batch_format, fn_args,
                      fn_kwargs):
                n = B.block_length(blk)
                if n == 0:
                    return blk
                step = batch_size or n
                outs = []
                for s in range(0, n, step):
                    batch = B.to_batch_format(
                        B.block_slice(blk, s, s + step), batch_format)
                    outs.append(B.from_batch_format(
                        self.fn(batch, *fn_args, **fn_kwargs)))
                return B.block_concat(outs)

        import cloudpickle
        blob = cloudpickle.dumps((fn_cls, ctor_args, ctor_kwargs))
        # Pool actors self-heal (reference: ActorPoolMapOperator
        # restarts failed workers and re-runs their in-flight bundles,
        # actor_pool_map_operator.py:34,446): worker death replays the
        # constructor and retries in-flight applies; transient
        # exceptions (e.g. a compile-service hiccup) retry via
        # retry_exceptions below. User opts can override.
        self._opts = {"max_restarts": 3, "max_task_retries": 2, **opts}
        self._cls = _BatchMapper
        self._blob = blob
        self._min = max(1, int(min_size))
        self._max = max(self._min, int(max_size))
        self.actors = [self._spawn() for _ in range(self._min)]
        # actor index -> WEAK refs of outstanding outputs (pruned at
        # submit). Weak, not strong: the pool must not pin completed
        # blocks in the store between submits — downstream (the
        # streaming window / consumer prefetch) owns their lifetime,
        # matching the submitter-side weakref design note below.
        self._outstanding: Dict[int, list] = {
            i: [] for i in range(self._min)}
        self._call_opts = {"retry_exceptions": True, "max_task_retries": 2}

    def _spawn(self):
        return self._cls.options(**self._opts).remote(self._blob)

    def _prune(self):
        """Drop dead and completed entries from the per-actor
        outstanding lists (ONE zero-timeout wait over the union of
        still-live refs — the pool's completion signal)."""
        live = {}
        for i, wrefs in self._outstanding.items():
            live[i] = [(w, r) for w in wrefs if (r := w()) is not None]
        all_refs = [r for pairs in live.values() for _w, r in pairs]
        if not all_refs:
            self._outstanding = {i: [] for i in self._outstanding}
            return
        _, not_ready = api.wait(all_refs, num_returns=len(all_refs),
                                timeout=0)
        pending = {id(r) for r in not_ready}
        self._outstanding = {
            i: [w for w, r in pairs if id(r) in pending]
            for i, pairs in live.items()}

    def _maybe_scale(self):
        """Queue-depth-driven autoscaling (reference:
        actor_pool_map_operator.py:446 scale_up / :530 scale_down)."""
        total = sum(len(v) for v in self._outstanding.values())
        n = len(self.actors)
        if n < self._max and total >= n * self._SCALE_UP_QUEUE:
            self.actors.append(self._spawn())
            self._outstanding[n] = []
        elif n > self._min and total <= (n - 1):
            # Drained: retire the idlest actor (never one with work).
            for i in range(n - 1, -1, -1):
                if not self._outstanding.get(i):
                    a = self.actors.pop(i)
                    # Reindex outstanding to match the actor list.
                    out = [self._outstanding[j]
                           for j in range(len(self.actors) + 1) if j != i]
                    self._outstanding = {j: v for j, v in enumerate(out)}
                    try:
                        api.kill(a)
                    except Exception:
                        pass
                    break

    @property
    def size(self) -> int:
        return len(self.actors)

    def submit(self, blk_ref, batch_size, batch_format, fn_args,
               fn_kwargs):
        self._prune()
        self._maybe_scale()
        # Least-loaded dispatch.
        idx = min(range(len(self.actors)),
                  key=lambda i: len(self._outstanding.get(i, ())))
        out = self.actors[idx].apply.options(**self._call_opts).remote(
            blk_ref, batch_size, batch_format, fn_args, fn_kwargs)
        import weakref
        self._outstanding.setdefault(idx, []).append(weakref.ref(out))
        return out

    def map(self, bundles, batch_size, batch_format, fn_args, fn_kwargs):
        from ..util.actor_pool import ActorPool
        pool = ActorPool(self.actors)
        results = list(pool.map(
            lambda a, blk_ref: a.apply.options(**self._call_opts).remote(
                blk_ref, batch_size, batch_format, fn_args, fn_kwargs),
            [b.ref for b in bundles]))
        out = []
        for r in results:
            out.append(_RefBundle(api.put(r), B.block_length(r)))
        return out

    def shutdown(self):
        for a in self.actors:
            try:
                api.kill(a)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------
class _Stage:
    """One plan stage. `fn` is the bulk executor (all bundles at once);
    `make_submitter`, when present, marks the stage map-streamable (it
    returns (submit, close), wrapped into a MapOperator); and
    `make_operator` builds a full physical operator — including
    streaming barrier ops (ShuffleOperator / SampledSortOperator) — for
    the per-operator streaming executor (reference:
    streaming_executor.py operator topology + planner physical ops)."""

    def __init__(self, name: str,
                 fn: Callable[[List[_RefBundle]], List[_RefBundle]],
                 make_submitter: Optional[Callable] = None,
                 make_operator: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.make_submitter = make_submitter
        self.make_operator = make_operator

    @property
    def streamable(self) -> bool:
        return (self.make_submitter is not None
                or self.make_operator is not None)


class _Plan:
    def __init__(self, source: Callable[[], List[_RefBundle]],
                 stages: Optional[List[_Stage]] = None,
                 name: str = "dataset",
                 iter_source: Optional[Callable] = None):
        self.source = source
        self.stages = stages or []
        self.name = name
        # Optional lazy source: yields (ref, rows) without blocking on all
        # reads up front (streaming path).
        self.iter_source = iter_source
        self._cache: Optional[List[_RefBundle]] = None

    def with_stage(self, stage: _Stage) -> "_Plan":
        p = _Plan(self.source, self.stages + [stage], self.name,
                  self.iter_source)
        # Chain from materialized prefix if present.
        if self._cache is not None:
            cached = self._cache
            p2 = _Plan(lambda: cached, [stage], self.name)
            return p2
        return p

    def execute(self) -> List[_RefBundle]:
        if self._cache is None:
            bundles = self.source()
            for stage in self.stages:
                bundles = stage.fn(bundles)
            self._cache = bundles
        return self._cache


def _bulk_shuffle(bundles: List["_RefBundle"], mode: str, key,
                  descending: bool, seed, boundaries,
                  n: Optional[int] = None) -> List["_RefBundle"]:
    """Shared bulk two-phase shuffle body (map-side partition +
    reduce-side merge) used by _shuffle_like and sort's stage. `n`
    overrides the output partition count (repartition; also the
    streaming byte-identity guard, which must match partition counts
    across paths)."""
    n = max(1, len(bundles)) if n is None else max(1, int(n))
    part_refs = []
    for b in bundles:
        parts = _partition_block.options(
            num_returns=n).remote(b.ref, n, mode, key, boundaries, seed)
        part_refs.append([parts] if n == 1 else list(parts))
    out = []
    for j in range(n):
        ref = _reduce_partition.remote(
            mode, key, descending,
            None if seed is None else seed + j,
            *[pr[j] for pr in part_refs])
        out.append(_RefBundle(ref, _wait_rows(ref)))
    if mode == "sort" and descending:
        # Range partitions are ascending; flip for descending.
        out.reverse()
    return out


class _LazySplitFeeder:
    """Shares one streaming execution of a parent dataset across n
    split shards (Dataset.split). Pulling any shard advances the shared
    stream; each shard's full history is kept (refs, not blocks) so
    shards are re-iterable across epochs — re-iteration replays the
    history, then keeps pumping if the parent isn't exhausted."""

    def __init__(self, ds: "Dataset", n: int):
        self._ds = ds
        self._n = n
        self._given: List[List] = [[] for _ in range(n)]
        self._next = 0
        self._it = None
        self._done = False
        self._lock = threading.Lock()

    def _pump_for(self, i: int, have: int) -> None:
        """Advance the parent until shard i has > `have` bundles or the
        parent is exhausted."""
        with self._lock:
            if self._it is None:
                self._it = self._ds._iter_bundles()
            while len(self._given[i]) <= have and not self._done:
                try:
                    ref, rows = next(self._it)
                except StopIteration:
                    self._done = True
                    return
                self._given[self._next].append((ref, rows))
                self._next = (self._next + 1) % self._n

    def iter_for(self, i: int):
        pos = 0
        while True:
            while pos < len(self._given[i]):
                yield self._given[i][pos]
                pos += 1
            self._pump_for(i, pos)
            if pos >= len(self._given[i]) and self._done:
                return

    def bundles_for(self, i: int) -> List["_RefBundle"]:
        return [_RefBundle(ref, rows if rows >= 0 else _wait_rows(ref))
                for ref, rows in self.iter_for(i)]


def _bundle_from_block(blk: B.Block) -> _RefBundle:
    return _RefBundle(api.put(blk), B.block_length(blk))


def _wait_rows(ref: api.ObjectRef) -> int:
    return B.block_length(api.get(ref))


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------
class Dataset:
    """Lazy distributed dataset (reference: data/dataset.py:152)."""

    def __init__(self, plan: _Plan):
        self._plan = plan

    # -- transforms --------------------------------------------------------
    def map_batches(self, fn: Union[Callable, type], *,
                    batch_size: Optional[int] = None,
                    compute: Optional[ActorPoolStrategy] = None,
                    concurrency: Optional[Union[int, tuple]] = None,
                    batch_format: str = "numpy",
                    fn_args: Sequence = (),
                    fn_kwargs: Optional[Dict] = None,
                    fn_constructor_args: Sequence = (),
                    fn_constructor_kwargs: Optional[Dict] = None,
                    num_cpus: Optional[float] = None,
                    num_tpus: Optional[float] = None,
                    num_gpus: Optional[float] = None,
                    max_concurrency: Optional[int] = None,
                    **_ignored) -> "Dataset":
        """(reference: dataset.py:407 map_batches) — fn may be a function
        (task pool) or a callable class (actor pool; `num_gpus=1` gives
        each actor a GPU of its own, pinned through CUDA_VISIBLE_DEVICES;
        without it the actor sees no card).

        `max_concurrency` (actor classes only) lets N applies interleave
        on one actor: with jax's async dispatch, batch N+1's host->device
        upload overlaps batch N's compute + result fetch, which is what
        saturates a bandwidth-bound device feed (upload becomes the only
        serial term). Default 1 — two concurrent jax computations on one
        pinned chip can contend for HBM, so opting in is explicit."""
        fn_kwargs = fn_kwargs or {}
        fn_constructor_kwargs = fn_constructor_kwargs or {}
        is_class = isinstance(fn, type)
        opts: Dict[str, Any] = {}
        if num_cpus is not None:
            opts["num_cpus"] = num_cpus
        if num_tpus is not None:
            opts["num_tpus"] = num_tpus
        if num_gpus is not None and num_gpus > 0:
            opts["num_gpus"] = num_gpus
        if max_concurrency is not None and is_class:
            opts["max_concurrency"] = int(max_concurrency)

        if is_class:
            if compute is None:
                if isinstance(concurrency, int):
                    compute = ActorPoolStrategy(size=concurrency)
                elif isinstance(concurrency, tuple):
                    compute = ActorPoolStrategy(
                        min_size=concurrency[0], max_size=concurrency[1])
                else:
                    compute = ActorPoolStrategy(size=2)

            def stage_fn(bundles: List[_RefBundle]) -> List[_RefBundle]:
                pool = _MapBatchesActorPool(
                    fn, compute.pool_min, compute.pool_max, opts,
                    tuple(fn_constructor_args),
                    fn_constructor_kwargs)
                try:
                    return pool.map(bundles, batch_size, batch_format,
                                    tuple(fn_args), fn_kwargs)
                finally:
                    pool.shutdown()

            def make_submitter():
                pool = _MapBatchesActorPool(
                    fn, compute.pool_min, compute.pool_max, opts,
                    tuple(fn_constructor_args),
                    fn_constructor_kwargs)
                # Weakrefs, not refs: holding strong ObjectRefs here
                # would pin every intermediate block until close() and
                # defeat the in-flight backpressure cap. Downstream
                # (the executor's in-flight window / the consumer's
                # prefetch)
                # keeps unconsumed refs alive; once the consumer drops a
                # ref its task is done and the weakref dies.
                import weakref
                submitted: List = []

                def submit(ref):
                    out = pool.submit(ref, batch_size, batch_format,
                                      tuple(fn_args), fn_kwargs)
                    submitted.append(weakref.ref(out))
                    if len(submitted) > 256:
                        submitted[:] = [w for w in submitted
                                        if w() is not None]
                    return out

                def close():
                    # Drain before killing: a consumer with prefetch
                    # depth > 0 still holds unresolved output refs when
                    # the bundle generator exhausts — killing in-flight
                    # actors here would fail the stream's tail. (Failed
                    # refs count as ready, so this can't hang on errors.)
                    live = [w() for w in submitted]
                    live = [r for r in live if r is not None]
                    if live:
                        try:
                            api.wait(live, num_returns=len(live),
                                     timeout=None)
                        except Exception:
                            pass
                    pool.shutdown()
                return submit, close
        else:
            def stage_fn(bundles: List[_RefBundle]) -> List[_RefBundle]:
                task = _apply_batches.options(**opts) if opts \
                    else _apply_batches
                refs = [task.remote(b.ref, fn, batch_size, batch_format,
                                    tuple(fn_args), fn_kwargs)
                        for b in bundles]
                blocks = api.get(refs)
                return [_RefBundle(r, B.block_length(blk))
                        for r, blk in zip(refs, blocks)]

            def make_submitter():
                task = _apply_batches.options(**opts) if opts \
                    else _apply_batches

                def submit(ref):
                    return task.remote(ref, fn, batch_size, batch_format,
                                       tuple(fn_args), fn_kwargs)
                return submit, None

        return Dataset(self._plan.with_stage(
            _Stage("MapBatches", stage_fn, make_submitter)))

    def _row_op(self, fn, kind: str, name: str) -> "Dataset":
        def stage_fn(bundles):
            refs = [_apply_rows.remote(b.ref, fn, kind) for b in bundles]
            blocks = api.get(refs)
            return [_RefBundle(r, B.block_length(blk))
                    for r, blk in zip(refs, blocks)]

        def make_submitter():
            return (lambda ref: _apply_rows.remote(ref, fn, kind)), None
        return Dataset(self._plan.with_stage(
            _Stage(name, stage_fn, make_submitter)))

    def map(self, fn: Callable) -> "Dataset":
        return self._row_op(fn, "map", "Map")

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._row_op(fn, "flat_map", "FlatMap")

    def filter(self, fn: Callable) -> "Dataset":
        return self._row_op(fn, "filter", "Filter")

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def _add(batch):
            batch = dict(batch)
            batch[name] = np.asarray(fn(batch))
            return batch
        return self.map_batches(_add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k not in cols})

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k in cols})

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(k, k): v for k, v in b.items()})

    # -- reorganization ----------------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        def stage_fn(bundles):
            total = sum(b.num_rows for b in bundles)
            per = max(1, total // num_blocks)
            # Build slice plan: (bundle_idx, start, end) pieces per output.
            pieces: List[List] = [[] for _ in range(num_blocks)]
            out_i, filled = 0, 0
            for bi, b in enumerate(bundles):
                pos = 0
                while pos < b.num_rows:
                    room = (per - filled if out_i < num_blocks - 1
                            else b.num_rows - pos)
                    take = min(b.num_rows - pos, max(room, 1))
                    pieces[out_i].append(
                        _slice_block.remote(b.ref, pos, pos + take))
                    pos += take
                    filled += take
                    if filled >= per and out_i < num_blocks - 1:
                        out_i += 1
                        filled = 0
            out = []
            for plist in pieces:
                if not plist:
                    ref = api.put({})
                    out.append(_RefBundle(ref, 0))
                    continue
                ref = _concat_blocks.remote(*plist)
                out.append(_RefBundle(ref, _wait_rows(ref)))
            return out

        def make_operator():
            # Streaming repartition rides the exchange with
            # mode="repartition" (balanced contiguous chunks per block,
            # arrival-order concat per output). Row ORDER differs from
            # the bulk slice plan — order-sensitive consumers (zip,
            # split_at_indices, take) all run the bulk execute() path,
            # and iter_* consumers of a repartition only rely on
            # multiset/count semantics. The bulk stage_fn above keeps
            # the exact global order for everyone else.
            from . import executor as EX
            from .context import DataContext
            n = max(1, int(num_blocks))

            def partition_submit(ref, nparts):
                parts = _partition_block.options(
                    num_returns=nparts).remote(ref, nparts,
                                               "repartition", None,
                                               None, None)
                return [parts] if nparts == 1 else list(parts)

            if DataContext.get_current().use_streaming_shuffle:
                from . import shuffle as SH
                return SH.StreamingShuffleOperator(
                    "Repartition", n, partition_submit,
                    mode="repartition")

            def reduce_submit(j, parts):
                return _reduce_partition.remote(
                    "repartition", None, False, None, *parts)

            return EX.ShuffleOperator(
                "Repartition", n, partition_submit, reduce_submit)

        return Dataset(self._plan.with_stage(
            _Stage("Repartition", stage_fn,
                   make_operator=make_operator)))

    def _shuffle_like(self, mode: str, key: Optional[str] = None,
                      descending: bool = False, seed: Optional[int] = None,
                      boundaries=None, name: str = "Shuffle") -> "Dataset":
        def stage_fn(bundles):
            return _bulk_shuffle(bundles, mode, key, descending, seed,
                                 boundaries)

        def make_operator():
            # Streaming shuffle. Default: the all-to-all exchange on
            # the direct transfer plane (shuffle.py — reducer actors
            # pull shard sets from every producer node as maps land).
            # use_streaming_shuffle=False falls back to the in-executor
            # barrier op. Partition count is a context knob because the
            # stream's length is unknown.
            from . import executor as EX
            from .context import DataContext
            ctx = DataContext.get_current()
            n = ctx.shuffle_partitions

            def partition_submit(ref, nparts):
                parts = _partition_block.options(
                    num_returns=nparts).remote(ref, nparts, mode, key,
                                               boundaries, seed)
                return [parts] if nparts == 1 else list(parts)

            if ctx.use_streaming_shuffle:
                from . import shuffle as SH
                return SH.StreamingShuffleOperator(
                    name, n, partition_submit, mode=mode, key=key,
                    descending=descending, seed=seed,
                    reverse_output=(mode == "sort" and descending))

            def reduce_submit(j, parts):
                return _reduce_partition.remote(
                    mode, key, descending,
                    None if seed is None else seed + j, *parts)

            return EX.ShuffleOperator(
                name, n, partition_submit, reduce_submit,
                ordered_output=(mode == "sort"),
                reverse_output=(mode == "sort" and descending))

        return Dataset(self._plan.with_stage(
            _Stage(name, stage_fn, make_operator=make_operator)))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed two-phase shuffle (reference: dataset.py
        random_shuffle; map-side hash partition + reduce-side permute).
        Unseeded calls produce a fresh permutation each execution (seed=None
        flows through to per-call fresh RNGs); seed=0 is honored as a real
        seed, distinct from unseeded."""
        return self._shuffle_like("shuffle", seed=seed,
                                  name="RandomShuffle")

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Sample-partitioned distributed sort (reference: dataset.py
        sort — boundary sampling + range partition + per-part merge).
        Fully lazy: the bulk path samples inside the stage; the
        streaming path is an external sort (SampledSortOperator) that
        sorts+samples blocks ON the stream, computes boundaries at the
        barrier, then range-partitions and merges — data stays in the
        object store (spilling under pressure) throughout, so a sort
        larger than the store holds its memory envelope."""
        def stage_fn(bundles):
            samples = []
            for b in bundles:
                blk = api.get(b.ref)
                if B.block_length(blk):
                    vals = np.asarray(blk[key])
                    k = min(16, len(vals))
                    samples.append(np.random.default_rng(0).choice(
                        vals, size=k, replace=False))
            n = max(1, len(bundles))
            if samples:
                allv = np.sort(np.concatenate(samples))
                boundaries = np.asarray(
                    [allv[int(i * len(allv) / n)] for i in range(1, n)])
            else:
                boundaries = np.asarray([])
            return _bulk_shuffle(bundles, "sort", key, descending, None,
                                 boundaries)

        def make_operator():
            from . import executor as EX
            from .context import DataContext
            ctx = DataContext.get_current()
            n = ctx.shuffle_partitions

            def sort_and_sample(ref):
                return _sort_and_sample.options(num_returns=2).remote(
                    ref, key, 16)

            def partition_with_bounds(ref, nparts, bounds_ref):
                parts = _partition_sorted.options(
                    num_returns=nparts).remote(ref, nparts, bounds_ref,
                                               key)
                return [parts] if nparts == 1 else list(parts)

            def bounds_from_samples(sample_refs, nparts):
                return _sort_bounds.remote(nparts, *sample_refs)

            if ctx.use_streaming_shuffle:
                from . import shuffle as SH
                return SH.StreamingSortOperator(
                    "Sort", n, sort_and_sample, partition_with_bounds,
                    bounds_from_samples, key, descending)

            def reduce_submit(j, parts):
                return _reduce_partition.remote(
                    "sort", key, descending, None, *parts)

            return EX.SampledSortOperator(
                "Sort", n, sort_and_sample, partition_with_bounds,
                reduce_submit, bounds_from_samples,
                reverse_output=descending)

        return Dataset(self._plan.with_stage(
            _Stage("Sort", stage_fn, make_operator=make_operator)))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        def stage_fn(bundles):
            out, have = [], 0
            for b in bundles:
                if have >= n:
                    break
                take = min(b.num_rows, n - have)
                if take == b.num_rows:
                    out.append(b)
                else:
                    ref = _slice_block.remote(b.ref, 0, take)
                    out.append(_RefBundle(ref, take))
                have += take
            return out
        return Dataset(self._plan.with_stage(_Stage("Limit", stage_fn)))

    def union(self, *others: "Dataset") -> "Dataset":
        plans = [self._plan] + [o._plan for o in others]

        def source():
            out = []
            for p in plans:
                out.extend(p.execute())
            return out
        return Dataset(_Plan(source, [], "union"))

    # -- consumption -------------------------------------------------------
    def count(self) -> int:
        return sum(b.num_rows for b in self._plan.execute())

    def schema(self) -> Dict[str, str]:
        for b in self._plan.execute():
            blk = api.get(b.ref)
            if B.block_length(blk):
                return B.block_schema(blk)
        return {}

    def columns(self) -> List[str]:
        return list(self.schema().keys())

    def num_blocks(self) -> int:
        return len(self._plan.execute())

    def take(self, n: int = 20) -> List[Dict]:
        out: List[Dict] = []
        for b in self._plan.execute():
            for row in B.block_to_rows(api.get(b.ref)):
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict]:
        return self.take(10 ** 18)

    def take_batch(self, batch_size: int = 20,
                   batch_format: str = "numpy"):
        """First `batch_size` rows as one batch (reference: dataset.py
        take_batch — raises on an empty dataset)."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        raise ValueError("Dataset is empty")

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    # -- global aggregates (reference: dataset.py sum/mean/std/min/max
    #    over AggregateFn) -------------------------------------------------
    def _merged_moments(self, on: str, want_m2: bool = True):
        """Chan's parallel merge of per-block (count, mean, M2)."""
        mom = api.get([_block_moments.remote(b.ref, on, want_m2)
                       for b in self._plan.execute() if b.num_rows])
        n, mean, m2 = 0, 0.0, 0.0
        for nb, mb, m2b in mom:
            if nb == 0:
                continue
            delta = mb - mean
            tot = n + nb
            mean += delta * (nb / tot)
            m2 += m2b + delta * delta * (n * nb / tot)
            n = tot
        return n, mean, m2

    def _minmax(self, on: str):
        return api.get([_block_minmax.remote(b.ref, on)
                        for b in self._plan.execute() if b.num_rows])

    def sum(self, on: str) -> float:
        n, mean, _ = self._merged_moments(on, want_m2=False)
        return float(n * mean)

    def mean(self, on: str) -> float:
        n, mean, _ = self._merged_moments(on, want_m2=False)
        return float(mean) if n else float("nan")

    def std(self, on: str, ddof: int = 1) -> float:
        """Distributed std via per-block Welford moments + Chan merge
        (numerically stable for |mean| >> std)."""
        n, _, m2 = self._merged_moments(on)
        if n <= ddof:
            return float("nan")
        return float(np.sqrt(m2 / (n - ddof)))

    def min(self, on: str) -> float:
        return float(min(lo for lo, _ in self._minmax(on)))

    def max(self, on: str) -> float:
        return float(max(hi for _, hi in self._minmax(on)))

    def unique(self, column: str) -> List:
        """Per-block remote dedupe, driver-side merge (reference:
        dataset.py unique)."""
        parts = api.get([_block_unique.remote(b.ref, column)
                         for b in self._plan.execute() if b.num_rows])
        seen = set()
        for p in parts:
            seen.update(p)
        return sorted(seen)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise combine of two same-length datasets (reference:
        dataset.py zip; right-side duplicate columns get `_1`)."""
        left_plan, right_plan = self._plan, other._plan

        def source():
            lbs = left_plan.execute()
            rbs = right_plan.execute()
            ln = sum(b.num_rows for b in lbs)
            rn = sum(b.num_rows for b in rbs)
            if ln != rn:
                raise ValueError(
                    f"zip requires equal row counts, got {ln} vs {rn}")
            # Align right blocks to left block boundaries by slicing.
            out = []
            ri, roff = 0, 0
            for lb in lbs:
                need = lb.num_rows
                pieces = []
                while need > 0:
                    rb = rbs[ri]
                    take = min(need, rb.num_rows - roff)
                    pieces.append(
                        _slice_block.remote(rb.ref, roff, roff + take))
                    roff += take
                    need -= take
                    if roff == rb.num_rows:
                        ri, roff = ri + 1, 0
                right_ref = (pieces[0] if len(pieces) == 1
                             else _concat_blocks.remote(*pieces))
                out.append(_RefBundle(
                    _zip_blocks.remote(lb.ref, right_ref), lb.num_rows))
            return out
        return Dataset(_Plan(source, [], "zip"))

    def _iter_bundles(self):
        """Streaming bundle iterator. If every stage is streamable —
        map stages via their submitters, barrier stages
        (sort/shuffle/groupby) via streaming operators — the plan runs
        on the per-operator streaming executor: each operator owns a
        queue and an in-flight budget, completions move bundles
        downstream via ready callbacks, and under store pressure only
        the most-downstream operator dispatches (reference:
        StreamingExecutor streaming_executor.py:48 + resource_manager +
        backpressure policies). Plans with a non-streamable stage
        (repartition, zip, limit) fall back to bulk execution."""
        plan = self._plan
        if plan._cache is not None or \
                any(not st.streamable for st in plan.stages):
            for b in plan.execute():
                yield (b.ref, b.num_rows)
            return
        from . import executor as EX
        from .context import DataContext
        ctx = DataContext.get_current()
        ops = []
        for st in plan.stages:
            if st.make_operator is not None:
                ops.append(st.make_operator())
            else:
                submit, close = st.make_submitter()
                ops.append(EX.MapOperator(st.name, submit, close,
                                          ordered=ctx.preserve_order))
        if plan.iter_source is not None:
            src = plan.iter_source()
        else:
            src = ((b.ref, b.num_rows) for b in plan.source())
        yield from EX.StreamingExecutor(ops, ctx).execute(src)

    def iter_rows(self) -> Iterator[Dict]:
        for ref, _ in self._iter_bundles():
            yield from B.block_to_rows(api.get(ref))

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_batches: Optional[int] = None,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator:
        """(reference: dataset.py:4092 iter_batches) — streamed: blocks
        are produced by in-flight task chains while earlier batches are
        consumed. `local_shuffle_buffer_size` mixes rows through a
        consumption-side buffer (streaming.shuffled_blocks) — the cheap
        per-epoch randomizer when a full random_shuffle exchange is
        overkill."""
        from . import streaming
        from .context import DataContext
        if prefetch_batches is None:
            prefetch_batches = DataContext.get_current().prefetch_batches
        blocks = streaming.iter_blocks(self._iter_bundles(),
                                       prefetch=prefetch_batches)
        if local_shuffle_buffer_size:
            blocks = streaming.shuffled_blocks(
                blocks, int(local_shuffle_buffer_size),
                local_shuffle_seed)
        yield from streaming.batches_from_blocks(
            blocks, batch_size, batch_format, drop_last)

    def _iter_framework_batches(self, convert, **kwargs):
        """Shared torch/tf batch iteration: numpy batches through
        iter_batches (ALL its kwargs forwarded — unknown keys raise)
        converted per framework."""
        kwargs.pop("batch_format", None)  # conversion fixes the format
        for batch in self.iter_batches(batch_format="numpy", **kwargs):
            yield {k: convert(v) for k, v in batch.items()}

    def iter_jax_batches(self, *, device=None, device_prefetch: int = 2,
                         sharding=None, **kwargs):
        """Device-resident batch iterator: not ported yet, raises
        NotImplementedError (see ``streaming.jax_device_feed``)."""
        from . import streaming
        return streaming.jax_device_feed(
            iter(()), device=device, sharding=sharding,
            device_prefetch=device_prefetch)

    def iter_torch_batches(self, **kwargs):
        """(reference: dataset.py iter_torch_batches)"""
        import torch
        return self._iter_framework_batches(torch.as_tensor, **kwargs)

    def iter_tf_batches(self, **kwargs):
        """(reference: dataset.py iter_tf_batches)"""
        import tensorflow as tf
        return self._iter_framework_batches(tf.convert_to_tensor,
                                            **kwargs)

    def to_pandas(self):
        import pandas as pd
        frames = [B.to_batch_format(api.get(b.ref), "pandas")
                  for b in self._plan.execute() if b.num_rows]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow(self):
        import pyarrow as pa
        tables = [B.to_batch_format(api.get(b.ref), "pyarrow")
                  for b in self._plan.execute() if b.num_rows]
        return pa.concat_tables(tables) if tables else pa.table({})

    def materialize(self) -> "Dataset":
        self._plan.execute()
        return self

    # -- splitting (train integration) ------------------------------------
    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """(reference: dataset.py split) — LAZY: nothing executes at
        split() time. The n datasets share one streaming execution of
        the parent (first consumption starts it); bundles assign
        round-robin, and shards consumed later buffer REFS only —
        blocks stay in the object store and spill under pressure, so a
        split of a dataset larger than the store holds its envelope."""
        ds = self.repartition(n) if equal else self
        feeder = _LazySplitFeeder(ds, n)
        return [
            Dataset(_Plan(functools.partial(feeder.bundles_for, i), [],
                          "split",
                          iter_source=functools.partial(feeder.iter_for,
                                                        i)))
            for i in range(n)
        ]

    def split_at_indices(self, indices: Sequence[int]) -> List["Dataset"]:
        """Row-index split points → len(indices)+1 datasets (reference:
        dataset.py split_at_indices)."""
        indices = list(indices)
        if any(i < 0 for i in indices) or indices != sorted(indices):
            raise ValueError("indices must be non-negative and sorted")
        bundles = self._plan.execute()
        total = sum(b.num_rows for b in bundles)
        bounds = [0] + [min(i, total) for i in indices] + [total]
        shards: List[List[_RefBundle]] = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            pieces: List[_RefBundle] = []
            pos = 0
            for b in bundles:
                b_lo, b_hi = pos, pos + b.num_rows
                s, e = max(lo, b_lo), min(hi, b_hi)
                if s < e:
                    if s == b_lo and e == b_hi:
                        pieces.append(b)
                    else:
                        ref = _slice_block.remote(
                            b.ref, s - b_lo, e - b_lo)
                        pieces.append(_RefBundle(ref, e - s))
                pos = b_hi
            shards.append(pieces)
        return [Dataset(_Plan(functools.partial(lambda s: s, shard),
                              [], "split_at_indices"))
                for shard in shards]

    def train_test_split(self, test_size: Union[int, float], *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> List["Dataset"]:
        """(reference: dataset.py train_test_split)"""
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        n_test = (int(total * test_size) if isinstance(test_size, float)
                  else int(test_size))
        if not 0 < n_test < total:
            raise ValueError(
                f"test_size {test_size} must leave non-empty splits of "
                f"{total} rows")
        train, test = ds.split_at_indices([total - n_test])
        return [train, test]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List:
        """(reference: dataset.py:1537 streaming_split →
        StreamSplitDataIterator, stream_split_iterator.py:31): n
        coordinated DataIterators sharing one block stream via a
        coordinator actor — each block is consumed by exactly one
        consumer; picklable, so Train ships one per worker."""
        from . import streaming
        # equal=True must guarantee balanced, non-empty shards even with
        # fewer (or skewed) blocks than consumers — lockstep data-parallel
        # trainers hang on uneven per-epoch batch counts. As in
        # split(n, equal=True), repartition into row-balanced blocks
        # first (a multiple of n keeps multiple blocks per consumer so
        # the shard streams rather than arriving as one chunk).
        ds = self
        if equal:
            bundles = ds._plan.execute()
            # Skip the repartition when the coordinator's LPT assignment
            # of the existing blocks already yields equal shards (e.g.
            # evenly produced blocks) — rewriting every row through
            # get/put just to re-balance balanced data doubles
            # materialization cost.
            shard_rows = [0] * n
            for b in sorted(bundles, key=lambda b: -b.num_rows):
                shard_rows[shard_rows.index(min(shard_rows))] += b.num_rows
            balanced = (len([b for b in bundles if b.num_rows]) >= n
                        and min(shard_rows) == max(shard_rows))
            if not balanced:
                n_blocks = len(bundles)
                per_consumer = max(1, min(8, n_blocks // n))
                ds = ds.repartition(n * per_consumer)
        bundles = ds._plan.execute()
        return streaming.make_split_iterators(
            [(b.ref, b.num_rows) for b in bundles], n, equal)

    # -- writes ------------------------------------------------------------
    def write_parquet(self, path: str) -> List[str]:
        bundles = self._plan.execute()
        return api.get([
            _write_block.remote(b.ref, path, "parquet", i)
            for i, b in enumerate(bundles) if b.num_rows])

    def write_json(self, path: str) -> List[str]:
        bundles = self._plan.execute()
        return api.get([
            _write_block.remote(b.ref, path, "json", i)
            for i, b in enumerate(bundles) if b.num_rows])

    def write_csv(self, path: str) -> List[str]:
        bundles = self._plan.execute()
        return api.get([
            _write_block.remote(b.ref, path, "csv", i)
            for i, b in enumerate(bundles) if b.num_rows])

    def write_datasink(self, sink) -> List[Any]:
        """Write through a custom Datasink plugin (reference:
        Dataset.write_datasink; see data/datasource.py)."""
        from .datasource import write_datasink as _wds
        return _wds(self, sink)

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._plan.stages)}+src, "
                f"name={self._plan.name})")

    def stats(self) -> str:
        bundles = self._plan.execute()
        return (f"Dataset: {len(bundles)} blocks, "
                f"{sum(b.num_rows for b in bundles)} rows")


class GroupedData:
    """(reference: data/grouped_data.py)"""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(self, aggs: Dict[str, tuple]) -> Dataset:
        ds = self._ds._shuffle_like("groupby", key=self._key,
                                    name="GroupByPartition")
        key = self._key

        def stage_fn(bundles):
            refs = [_aggregate_block.remote(b.ref, key, aggs)
                    for b in bundles]
            results = api.get(refs)
            rows = []
            for part in results:
                rows.extend(part.values())
            rows.sort(key=lambda r: r[key])
            blk = B.block_from_rows(rows)
            return [_bundle_from_block(blk)]

        def make_operator():
            # Streaming: per-partition aggregates stream in (small
            # dicts); one merge task at the barrier emits the result
            # block — groupby never materializes the dataset driverside.
            from . import executor as EX
            return EX.FinalizeOperator(
                "Aggregate",
                submit=lambda ref: _aggregate_block.remote(ref, key,
                                                           aggs),
                finalize=lambda outs: _merge_agg_results.remote(
                    key, *outs))

        return Dataset(ds._plan.with_stage(
            _Stage("Aggregate", stage_fn, make_operator=make_operator)))

    def count(self) -> Dataset:
        return self._aggregate({"count()": (None, "count")})

    def sum(self, on: str) -> Dataset:
        return self._aggregate({f"sum({on})": (on, "sum")})

    def mean(self, on: str) -> Dataset:
        return self._aggregate({f"mean({on})": (on, "mean")})

    def min(self, on: str) -> Dataset:
        return self._aggregate({f"min({on})": (on, "min")})

    def max(self, on: str) -> Dataset:
        return self._aggregate({f"max({on})": (on, "max")})

    def std(self, on: str) -> Dataset:
        return self._aggregate({f"std({on})": (on, "std")})

    def map_groups(self, fn: Callable) -> Dataset:
        ds = self._ds._shuffle_like("groupby", key=self._key,
                                    name="GroupByPartition")
        key = self._key

        def _apply(batch):
            keys = batch[key]
            uniq = np.unique(keys)
            outs = []
            for kv in uniq.tolist():
                idx = np.nonzero(keys == kv)[0]
                group = {c: v[idx] for c, v in batch.items()}
                outs.append(B.from_batch_format(fn(group)))
            return B.block_concat(outs) if outs else {}
        return ds.map_batches(_apply, batch_size=None)
