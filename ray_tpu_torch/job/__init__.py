"""ray_tpu_torch.job — job submission: run driver scripts inside the cluster.

Reference parity: python/ray/dashboard/modules/job/ — JobSubmissionClient
(sdk.py), JobManager/JobSupervisor (job_manager.py, job_supervisor.py:
a supervisor actor per job runs the entrypoint as a subprocess with the
job's runtime env, captures logs, and reports status to the GCS KV
store).

    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint="python train.py",
        runtime_env={"working_dir": "./project"})
    client.get_job_status(job_id)   # PENDING/RUNNING/SUCCEEDED/FAILED
    client.get_job_logs(job_id)

The supervisor reserves CPUs only (``entrypoint_num_cpus``), so its
worker, and the entrypoint it starts, see ``CUDA_VISIBLE_DEVICES=""``
and no card, as the reference's entrypoint sees no TPU chip. Work on
the card inside a job goes through tasks or actors that ask for
``num_gpus``.
"""
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.config import temp_root

# statuses (reference: job/common.py JobStatus)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

_KV_NS = "job"


class JobSupervisor:
    """Per-job supervisor actor (reference: job_supervisor.py JobSupervisor).

    Runs the entrypoint as a shell subprocess, streams output to a log
    file, updates job status in the GCS KV store."""

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Optional[Dict], metadata: Optional[Dict]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.metadata = metadata or {}
        self.proc = None
        self.log_path = os.path.join(temp_root(), f"rtt_job_{job_id}.log")
        self._set_status(PENDING)

    def _set_status(self, status: str, return_code: Optional[int] = None):
        from ray_tpu_torch._private import state
        rt = state.current()
        info = {"job_id": self.job_id, "status": status,
                "entrypoint": self.entrypoint, "metadata": self.metadata,
                "return_code": return_code, "updated_at": time.time(),
                "log_path": self.log_path}
        rt.gcs_request("kv_put", key=self.job_id,
                       value=json.dumps(info).encode(), namespace=_KV_NS)

    def run(self) -> str:
        """Blocks until the entrypoint exits (driver of the job)."""
        import subprocess
        env = dict(os.environ)
        env.update(self.runtime_env.get("env_vars", {}))
        env["RTT_JOB_ID"] = self.job_id
        cwd = self.runtime_env.get("working_dir") or os.getcwd()
        self._set_status(RUNNING)
        with open(self.log_path, "wb") as log_f:
            self.proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env, cwd=cwd,
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True)
            rc = self.proc.wait()
        self._set_status(SUCCEEDED if rc == 0 else
                         (STOPPED if rc == -15 else FAILED), rc)
        return SUCCEEDED if rc == 0 else FAILED

    def stop(self) -> bool:
        if self.proc is not None and self.proc.poll() is None:
            import signal
            # Kill the whole process group (entrypoint may spawn children).
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass
            return True
        return False

    def ping(self) -> bool:
        return True


class JobSubmissionClient:
    """Reference: dashboard/modules/job/sdk.py JobSubmissionClient (the
    local-cluster path; there is no separate REST head here — the driver
    process talks to the runtime directly)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)

    def _kv(self, op, **kw):
        from ray_tpu_torch._private import state
        return state.current().gcs_request(op, namespace=_KV_NS, **kw)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict] = None,
                   metadata: Optional[Dict] = None,
                   submission_id: Optional[str] = None,
                   entrypoint_num_cpus: float = 0) -> str:
        if runtime_env:
            from ray_tpu_torch._private import runtime_env as re_mod
            re_mod.validate(runtime_env)
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        if self._kv("kv_get", key=job_id) is not None:
            raise ValueError(f"Job {job_id} already exists")
        # max_concurrency: run() blocks for the job's lifetime; stop()/ping()
        # must still get through (reference: the supervisor actor serves
        # stop while polling the child, job_supervisor.py).
        supervisor = ray_tpu_torch.remote(JobSupervisor).options(
            name=f"_job_supervisor_{job_id}",
            num_cpus=entrypoint_num_cpus, max_concurrency=4).remote(
                job_id, entrypoint, runtime_env, metadata)
        ray_tpu_torch.get(supervisor.ping.remote())  # surface ctor errors
        supervisor.run.remote()  # fire and forget; status lands in KV
        return job_id

    def _info(self, job_id: str) -> Dict[str, Any]:
        raw = self._kv("kv_get", key=job_id)
        if raw is None:
            raise ValueError(f"No job with id {job_id}")
        return json.loads(raw)

    def get_job_status(self, job_id: str) -> str:
        return self._info(job_id)["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        return self._info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        info = self._info(job_id)
        try:
            with open(info["log_path"], "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> List[Dict[str, Any]]:
        out = []
        for key in self._kv("kv_keys", prefix="raysubmit_"):
            try:
                out.append(self._info(key))
            except ValueError:
                pass
        return out

    def stop_job(self, job_id: str) -> bool:
        info = self._info(job_id)  # raises for unknown job
        try:
            sup = ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")
            return ray_tpu_torch.get(sup.stop.remote())
        except Exception:
            return False

    def delete_job(self, job_id: str) -> bool:
        info = self._info(job_id)
        if info["status"] in (RUNNING, PENDING):
            raise RuntimeError(f"Cannot delete running job {job_id}")
        self._kv("kv_del", key=job_id)
        try:
            os.unlink(info["log_path"])
        except OSError:
            pass
        return True

    def wait_until_finish(self, job_id: str, timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.25)
        raise TimeoutError(f"Job {job_id} still "
                           f"{self.get_job_status(job_id)} after {timeout}s")


__all__ = ["FAILED", "JobSubmissionClient", "JobSupervisor", "PENDING",
           "RUNNING", "STOPPED", "SUCCEEDED"]
