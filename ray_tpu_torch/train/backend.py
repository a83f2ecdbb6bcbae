"""Training backends: per-framework worker-group setup hooks.

Reference parity: train/_internal/backend_executor.py Backend hooks —
`_TorchBackend.on_start` runs dist.init_process_group (torch/config.py:156),
the TF backend writes TF_CONFIG (tensorflow/config.py:24-37). The port's
device path is ``TorchBackendConfig``: NCCL between workers pinned to one
GPU each, or gloo on the CPU, chosen by the trainer's ``use_gpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# A cold training worker imports torch, builds its CUDA context and its
# NCCL communicator before the first step: what the backend gives the
# group's rendezvous and process-group setup.
WORKER_START_TIMEOUT_S = 60.0


@dataclass
class BackendConfig:
    """Base backend config (reference: train/backend.py BackendConfig)."""

    def backend_name(self) -> str:
        return "noop"

    def on_start(self, context) -> None:
        """Runs INSIDE each training worker before the train loop."""

    def on_shutdown(self, context) -> None:
        pass


@dataclass
class TorchBackendConfig(BackendConfig):
    """torch.distributed's default process group across the worker group
    (reference: train/torch/config.py TorchConfig).

    ``backend`` is ``"nccl"`` or ``"gloo"``; ``None`` takes the
    trainer's choice (``nccl`` when its ``ScalingConfig.use_gpu`` is set,
    else ``gloo``). The choice is explicit: a failed NCCL setup raises,
    it never falls back to gloo. The group is initialized at every world
    size, 1 included, so a train loop's ``torch.distributed`` calls work
    the same on one worker. With NCCL each worker's pinned GPU becomes
    its current device (``cuda:0``: the worker sees only its own card).
    """

    backend: Optional[str] = None

    def backend_name(self) -> str:
        return "torch"

    def on_start(self, context) -> None:
        from datetime import timedelta

        import torch
        import torch.distributed as dist

        if self.backend not in ("nccl", "gloo"):
            raise ValueError(
                f"TorchBackendConfig.backend must be 'nccl' or 'gloo', got "
                f"{self.backend!r} (TorchTrainer fills it from use_gpu)")
        if dist.is_initialized():
            if (dist.get_world_size() != context.world_size
                    or dist.get_rank() != context.world_rank):
                raise RuntimeError(
                    "torch.distributed is already initialized with world "
                    f"size {dist.get_world_size()}, rank {dist.get_rank()}; "
                    "a worker process cannot join a new world")
            return
        device_id = None
        if self.backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the nccl backend needs a GPU in each training worker: "
                    "set ScalingConfig(use_gpu=True)")
            torch.cuda.set_device(0)
            device_id = torch.device("cuda", 0)
        from ..util.collective.collective_group.torch_collective_group \
            import _rendezvous
        addr = _rendezvous(f"torch/{context.experiment_name}",
                           context.world_size, context.world_rank,
                           timeout_s=WORKER_START_TIMEOUT_S)
        dist.init_process_group(
            backend=self.backend, init_method=f"tcp://{addr}",
            world_size=context.world_size, rank=context.world_rank,
            timeout=timedelta(seconds=WORKER_START_TIMEOUT_S),
            device_id=device_id)


@dataclass
class TensorflowBackendConfig(BackendConfig):
    """Writes TF_CONFIG across the worker group (reference:
    train/tensorflow/config.py:24-37 _setup_tensorflow_environment →
    MultiWorkerMirroredStrategy). Each worker publishes host:port via the
    GCS KV, waits for the full roster, and exports the standard TF_CONFIG
    JSON; tf.distribute picks it up from there."""

    timeout_s: float = 60.0

    def backend_name(self) -> str:
        return "tensorflow"

    def on_start(self, context) -> None:
        if context.world_size <= 1:
            return
        import json
        import os
        import time

        from ..util.collective.collective_group.torch_collective_group \
            import _free_port, _kv_get, _kv_put
        # context.experiment_name embeds a fresh per-attempt uid
        # (controller.py make_context), so restarted groups never read a
        # previous attempt's roster keys.
        group = f"tf/{context.experiment_name}"
        addr = f"127.0.0.1:{_free_port()}"
        _kv_put(f"{group}/addr/{context.world_rank}", addr.encode())
        roster = [None] * context.world_size
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            for r in range(context.world_size):
                if roster[r] is None:
                    raw = _kv_get(f"{group}/addr/{r}")
                    if raw:
                        roster[r] = raw.decode()
            if all(roster):
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"TF_CONFIG roster incomplete after {self.timeout_s}s: "
                f"{roster}")
        os.environ["TF_CONFIG"] = json.dumps({
            "cluster": {"worker": roster},
            "task": {"type": "worker", "index": context.world_rank},
        })


@dataclass
class HorovodBackendConfig(BackendConfig):
    """Reference: train/horovod/config.py HorovodConfig. Horovod is a
    torch/TF allreduce runtime not present in this image; the config gates
    with guidance rather than silently no-op."""

    def backend_name(self) -> str:
        return "horovod"

    def on_start(self, context) -> None:
        try:
            import horovod  # noqa: F401
        except ImportError:
            raise ImportError(
                "horovod is not installed in this environment. Use "
                "TorchTrainer (NCCL between GPUs, gloo on the CPU) for "
                "torch code."
            ) from None
        import horovod.torch as hvd
        hvd.init()
