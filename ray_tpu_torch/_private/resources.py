"""Resource detection: CPUs, memory, and NVIDIA GPUs.

The port's counterpart of the reference's accelerator-manager protocol
(python/ray/_private/accelerators/accelerator.py:5 AcceleratorManager,
nvidia_gpu.py NvidiaGPUAcceleratorManager): count the node's GPUs without
importing torch (a process that imports torch before its device is
pinned would see every card), expose them as the ``GPU`` resource, and
pin a worker to specific ids through ``CUDA_VISIBLE_DEVICES`` before it
starts.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import Dict, List, Optional

NUM_GPUS_OVERRIDE_ENV = "RTT_NUM_GPUS"
ACCEL_TYPE_OVERRIDE_ENV = "RTT_ACCELERATOR_TYPE"
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def _visible_entries() -> Optional[List[str]]:
    """The driver's CUDA_VISIBLE_DEVICES as a list (None when unset)."""
    value = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if value is None:
        return None
    return [v.strip() for v in value.split(",") if v.strip() != ""]


class GPUAcceleratorManager:
    """Detects local NVIDIA GPUs and manages visibility isolation."""

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        """``RTT_NUM_GPUS`` if set (tests fake a count with it); else the
        driver's ``CUDA_VISIBLE_DEVICES`` if set; else the driver's
        ``/proc/driver/nvidia/gpus/*`` entries; else ``nvidia-smi -L``."""
        override = os.environ.get(NUM_GPUS_OVERRIDE_ENV)
        if override is not None:
            return int(override)
        visible = _visible_entries()
        if visible is not None:
            return len(visible)
        found = glob.glob("/proc/driver/nvidia/gpus/*")
        if found:
            return len(found)
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            return 0
        return sum(line.startswith("GPU ") for line in out.splitlines())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return os.environ.get(ACCEL_TYPE_OVERRIDE_ENV) or None

    @staticmethod
    def get_visible_devices_env(gpu_ids) -> Dict[str, str]:
        """Env for a worker pinned to the node's GPUs ``gpu_ids`` (reference:
        nvidia_gpu.py set_current_process_visible_accelerator_ids). The ids
        index the driver's own ``CUDA_VISIBLE_DEVICES`` when that is set,
        so a driver limited to cards 2,3 hands out 2 and 3; an id past
        that list (a count faked with ``RTT_NUM_GPUS``) goes as it is."""
        visible = _visible_entries() or []
        names = [visible[i] if i < len(visible) else str(i)
                 for i in gpu_ids]
        return {CUDA_VISIBLE_DEVICES_ENV: ",".join(names)}


def detect_node_resources(num_cpus: Optional[int] = None,
                          num_gpus: Optional[int] = None,
                          resources: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """Build the node's static resource vector (reference: services.py
    resource autodetection feeding the raylet's static resources). An
    explicit ``num_gpus`` overrides the detected count."""
    out: Dict[str, float] = {}
    out["CPU"] = float(num_cpus if num_cpus is not None
                       else (os.cpu_count() or 1))
    gpus = num_gpus if num_gpus is not None else \
        GPUAcceleratorManager.get_current_node_num_accelerators()
    if gpus:
        out["GPU"] = float(gpus)
        accel_type = GPUAcceleratorManager.get_current_node_accelerator_type()
        if accel_type:
            out[accel_type] = float(gpus)
    try:
        import psutil  # type: ignore
        out["memory"] = float(psutil.virtual_memory().total)
    except Exception:
        try:
            out["memory"] = float(
                os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError):
            pass
    if resources:
        out.update(resources)
    return out


def gpu_worker_extra_env(gpu_ids) -> Dict[str, str]:
    """Environment for a worker pinned to specific GPUs, shared by the
    head scheduler and node daemons so the pinning policy lives in one
    place. A worker with no GPU gets ``CUDA_VISIBLE_DEVICES=""`` from the
    scheduler instead, so it never sees the driver's cards."""
    return GPUAcceleratorManager.get_visible_devices_env(gpu_ids)
