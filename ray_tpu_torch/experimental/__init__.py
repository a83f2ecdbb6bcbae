"""ray_tpu_torch.experimental — compiled-DAG collectives and other previews
(reference: python/ray/experimental/)."""


def broadcast_object(ref, timeout: float = 300.0) -> int:
    """Proactively replicate one object to every alive daemon node via
    a binomial push tree (reference: push_manager.h — the 1 GiB
    broadcast scalability path). Subsequent tasks on those nodes read
    the local copy instead of pulling from the source. Returns the
    number of nodes holding a copy (including the source)."""
    from .._private import state
    rt = state.current()
    if not hasattr(rt, "broadcast_object"):
        raise RuntimeError(
            "broadcast_object requires the driver/head runtime")
    return rt.broadcast_object(ref.id, timeout=timeout)
