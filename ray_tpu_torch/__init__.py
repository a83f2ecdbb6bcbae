"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` that mirrors its layout (``ops``, ``models``,
``llm``, ``parallel``, ``train``, and the control plane: ``api``,
``_private``, ``serve``, ``data``, ``dag``, ``util`` with
``util.collective``). It imports torch and numpy, never
JAX and nothing of ``ray_tpu``. Each Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (``ops/csrc``), built at first
use; the rest is plain PyTorch.

The control plane is a copy of the JAX package's, with its own worker
module (``ray_tpu_torch._private.worker_proc``), session and store
directories (``$TMPDIR/rtt_sessions``, ``/dev/shm/rtt_<tag of TMPDIR>_*``)
and environment keys (``RTT_*``), so both packages, and two checkouts
under TMPDIRs of their own, can run side by side. Importing this
package loads no torch: torch loads where a stage or an engine needs it.

    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)   # GPUs detected; num_gpus= overrides

    @ray_tpu_torch.remote
    def f(x): return x * 2

    assert ray_tpu_torch.get(f.remote(21)) == 42

Entry points run on the CUDA card (``device=None``) and raise when there
is none, unless the caller passes ``device="cpu"``.
"""

from .api import (
    ActorHandle,
    ObjectRef,
    ObjectRefGenerator,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    get_gpu_ids,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from . import exceptions

__version__ = "0.1.0"

__all__ = [
    "ActorHandle", "ObjectRef", "ObjectRefGenerator", "available_resources", "cancel",
    "cluster_resources", "exceptions", "get", "get_actor",
    "get_runtime_context", "get_gpu_ids", "init", "is_initialized", "kill", "method", "nodes", "timeline",
    "put", "remote", "shutdown", "wait", "__version__",
]
