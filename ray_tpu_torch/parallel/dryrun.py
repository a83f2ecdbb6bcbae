"""Multi-rank dry run: every parallel strategy once, on tiny shapes.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: the GPT train
step over a dp x tp mesh with ``tp_rules``, ring attention over an
``sp`` ring, the expert-parallel MoE layer over ``ep`` and a GPipe
training step over ``pp``, on ``n_devices`` ranks (processes of one
gloo world, ``launch.RankPool``). Each result must be finite and of the
expected shape; the numbers are held against the JAX package by
``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import math
from typing import Dict

from .._device import DeviceLike, resolve_device
from .launch import RankPool


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     timeout: float = 300.0) -> Dict:
    """Run the dry run on ``n_devices`` ranks on ``device`` (None: every
    rank on the CUDA card, sharing it; raises without one). Returns rank
    0's report: the loss, the shapes checked, and the mesh shapes."""
    device = resolve_device(device)
    with RankPool(n_devices, device.type, timeout=timeout) as pool:
        return pool.run(dryrun_rank, n_devices, device.type)[0]


def _seeded(shape, seed: int, device, scale: float = 1.0):
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


def dryrun_rank(n_devices: int, device_type: str) -> Dict:
    """One rank's part of ``dryrun_multichip``: every rank gets the same
    global inputs (seeded) and checks the same global outputs."""
    import numpy as np
    import torch

    from ..models import GPTConfig, make_train_step, shard_batch
    from ..parallel import MeshConfig, make_1d_mesh, make_mesh, tp_rules
    from .moe import moe_layer
    from .ops import shard_map
    from .partition import PartitionSpec as P
    from .pipeline import make_pipelined_train_fn
    from .sequence import sequence_parallel_attention

    device = torch.device(device_type)
    report = {}

    # -- the GPT train step over dp x tp ---------------------------------
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    cfg = GPTConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, max_seq_len=64)
    mesh = make_mesh(MeshConfig(dp=dp, tp=tp), device_type=device_type)
    init_state, train_step = make_train_step(cfg, device=device, mesh=mesh,
                                             rules=tp_rules())
    state = init_state(torch.Generator(device=device).manual_seed(0))
    batch_size = max(dp, 2)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch_size, 32), dtype=np.int64)
    batch = shard_batch((tokens, np.roll(tokens, -1, axis=1)), mesh)
    state, metrics = train_step(state, batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    wqkv = state["params"]["layers"][0]["wqkv"]
    if tuple(wqkv.shape) != (cfg.d_model, 3 * cfg.d_model // tp):
        raise AssertionError(f"wqkv block {tuple(wqkv.shape)} at tp={tp}")
    report["gpt"] = {"mesh": {"dp": dp, "tp": tp}, "loss": loss,
                     "wqkv_block": list(wqkv.shape)}

    # -- sequence parallelism: ring attention over "sp" ------------------
    sp_mesh = make_1d_mesh("sp", device_type=device_type)
    shape = (2, 4, 8 * n_devices, 16)
    q, k, v = (_seeded(shape, s, device) for s in (1, 2, 3))
    out = sequence_parallel_attention(sp_mesh, q, k, v)
    _finite(out, shape, "ring attention")
    report["ring"] = {"shape": list(out.shape)}

    # -- expert parallelism: MoE all_to_all over "ep" --------------------
    e = 2 * n_devices
    t, dm, f = 16 * n_devices, 32, 64
    ep_mesh = make_1d_mesh("ep", device_type=device_type)
    x = _seeded((t, dm), 4, device)
    gate_w = _seeded((dm, e), 5, device, 0.02)
    w1 = _seeded((e, dm, f), 6, device, 0.02)
    w2 = _seeded((e, f, dm), 7, device, 0.02)
    moe = shard_map(
        lambda x_, g_, a_, b_: moe_layer(x_, g_, a_, b_, axis_name="ep")[0],
        mesh=ep_mesh, in_specs=(P("ep", None), P(None, None),
                                P("ep", None, None), P("ep", None, None)),
        out_specs=P("ep", None))
    y = moe(x, gate_w, w1, w2)
    _finite(y, x.shape, "expert-parallel MoE")
    report["moe"] = {"shape": list(y.shape), "experts": e}

    # -- pipeline parallelism: a GPipe training step over "pp" -----------
    n_stages = min(4, n_devices)
    pp_mesh = make_mesh(MeshConfig(dp=n_devices // n_stages, pp=n_stages),
                        device_type=device_type)
    dp_ = 16
    stage_params = (_seeded((n_stages, dp_, dp_), 8, device, 0.3),
                    torch.zeros((n_stages, dp_), device=device))
    xp = _seeded((8, dp_), 9, device)
    yp = torch.zeros((8, dp_), device=device)
    step = make_pipelined_train_fn(
        pp_mesh, lambda pr, a: torch.tanh(a @ pr[0] + pr[1]),
        lambda o, y_: ((o - y_) ** 2).mean(), n_microbatches=4)
    ploss, grads = step(stage_params, xp, yp)
    if not math.isfinite(float(ploss)):
        raise AssertionError(f"non-finite pipeline loss {float(ploss)}")
    for g, p in zip(grads, stage_params):
        _finite(g, p.shape, "pipeline grads")
    report["pipeline"] = {"stages": n_stages, "loss": float(ploss)}
    return report


def _finite(x, shape, what: str) -> None:
    import torch

    if tuple(x.shape) != tuple(shape) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: shape {tuple(x.shape)} (want "
                             f"{tuple(shape)}) or non-finite values")
