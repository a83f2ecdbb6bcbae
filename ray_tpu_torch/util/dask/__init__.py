"""Dask-on-ray_tpu_torch scheduler (reference: python/ray/util/dask/ —
`ray_dask_get` in scheduler.py, a custom dask scheduler executing graph
nodes as Ray tasks).

`ray_dask_get(dsk, keys)` implements dask's scheduler protocol: a dask
graph is a dict of key -> computation, where a computation is either a
literal, a key reference, or a task tuple `(callable, arg1, arg2, ...)`
(args may themselves be nested computations). Each task node becomes one
`@remote` task whose upstream args are ObjectRefs, so independent graph
branches run in parallel on the cluster and intermediates stay in the
object store. The protocol helpers (`istask`/`ishashable`) are
re-implemented locally so the scheduler itself imports nothing from dask
— `dask` is only needed by the caller that builds graphs
(`enable_dask_on_ray` gates on it).
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

from ... import api

__all__ = ["ray_dask_get", "enable_dask_on_ray", "disable_dask_on_ray"]


def _ishashable(x) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def _istask(x) -> bool:
    """A dask task is a tuple whose head is callable (dask.core.istask)."""
    return isinstance(x, tuple) and bool(x) and callable(x[0])


@api.remote
def _dask_task(fn, *resolved):
    """One graph node; upstream ObjectRefs arrive resolved by the runtime."""
    return fn(*resolved)


def _materialize(comp, dsk: Dict, refs: Dict[Hashable, Any], seen: set):
    """Recursively turn a computation into a value/ref structure whose
    task nodes are submitted remote tasks."""
    if _istask(comp):
        fn, *args = comp
        # Nested computations inside args collapse to refs/literals; a
        # nested task tuple becomes its own remote task (dask nests
        # subgraphs this way rather than via extra keys).
        rargs = [_resolve_arg(a, dsk, refs, seen) for a in args]
        return _dask_task.remote(fn, *rargs)
    return _resolve_arg(comp, dsk, refs, seen)


def _resolve_arg(a, dsk, refs, seen):
    if _ishashable(a) and a in dsk:
        return _get_ref(a, dsk, refs, seen)
    if _istask(a):
        return _materialize(a, dsk, refs, seen)
    if isinstance(a, list):
        return [_resolve_arg(x, dsk, refs, seen) for x in a]
    if isinstance(a, tuple):
        return tuple(_resolve_arg(x, dsk, refs, seen) for x in a)
    if isinstance(a, dict):
        return {k: _resolve_arg(v, dsk, refs, seen) for k, v in a.items()}
    return a


def _get_ref(key, dsk, refs, seen):
    if key in refs:
        return refs[key]
    if key in seen:
        raise ValueError(f"cycle detected in dask graph at key {key!r}")
    seen.add(key)
    refs[key] = _materialize(dsk[key], dsk, refs, seen)
    return refs[key]


def ray_dask_get(dsk: Dict, keys, **kwargs):
    """Dask scheduler entry (reference: scheduler.py ray_dask_get).
    Returns computed values matching the (possibly nested) `keys`
    structure, as dask schedulers must."""
    refs: Dict[Hashable, Any] = {}
    seen: set = set()

    def deep_get(v):
        if isinstance(v, api.ObjectRef):
            return api.get(v)
        if isinstance(v, list):
            return [deep_get(x) for x in v]
        if isinstance(v, tuple):
            return tuple(deep_get(x) for x in v)
        if isinstance(v, dict):
            return {k: deep_get(x) for k, x in v.items()}
        return v

    def compute(k):
        if isinstance(k, list):
            return [compute(x) for x in k]
        return deep_get(_get_ref(k, dsk, refs, seen))

    return compute(keys)


# Alias matching the reference's synchronous variant.
ray_dask_get_sync = ray_dask_get


def enable_dask_on_ray(shuffle: str = "tasks"):
    """Set ray_dask_get as dask's default scheduler (requires dask).
    Usable as a context manager, like the reference."""
    try:
        import dask
    except ImportError as e:
        raise ImportError(
            "enable_dask_on_ray requires `dask` to be installed; "
            "ray_dask_get itself works on plain graph dicts without it."
        ) from e
    return dask.config.set(scheduler=ray_dask_get, shuffle=shuffle)


def disable_dask_on_ray():
    import dask

    return dask.config.set(scheduler=None, shuffle=None)
