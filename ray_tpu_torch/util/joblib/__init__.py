"""joblib backend running jobs as ray_tpu_torch tasks.

Reference parity: python/ray/util/joblib/ (register_ray +
ray_backend.py RayBackend) — lets sklearn-style `with
joblib.parallel_backend("ray_tpu_torch"):` fan cross-validation / grid-search
work out over the cluster unchanged.
"""
from typing import Any

__all__ = ["register_ray"]


def register_ray():
    """Register the 'ray_tpu_torch' joblib backend (reference:
    util/joblib/__init__.py register_ray)."""
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    import ray_tpu_torch

    class _Job:
        def __init__(self, ref):
            self._ref = ref

        def get(self, timeout=None):
            out = ray_tpu_torch.get(self._ref, timeout=timeout)
            return out

    class RayTpuTorchBackend(ParallelBackendBase):
        supports_timeout = True
        default_n_jobs = -1

        def effective_n_jobs(self, n_jobs: int) -> int:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs is None or n_jobs == -1:
                return cpus
            if n_jobs < 0:
                return max(1, cpus + 1 + n_jobs)
            return n_jobs

        def apply_async(self, func, callback=None) -> Any:
            @ray_tpu_torch.remote
            def _joblib_task(f):
                return f()

            ref = _joblib_task.remote(func)
            job = _Job(ref)
            if callback is not None:
                ref.future().add_done_callback(
                    lambda fut: callback(job))
            return job

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def abort_everything(self, ensure_ready=True):
            pass

    register_parallel_backend("ray_tpu_torch", RayTpuTorchBackend)
    # alias matching the reference's name for drop-in scripts
    register_parallel_backend("ray", RayTpuTorchBackend)
