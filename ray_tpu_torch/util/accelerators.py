"""NVIDIA accelerator type constants (reference:
python/ray/util/accelerators/accelerators.py, the NVIDIA_* names, used
with ``accelerator_type=`` on tasks and actors for type-affinity
scheduling). Counterpart of the JAX package's TPU constants: a GPU type
and the cards a standard host of that type holds; the TPU pod-slice
helpers have no GPU meaning beyond the host count kept here."""

NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_T4 = "T4"
NVIDIA_TESLA_A10G = "A10G"
NVIDIA_L4 = "L4"
NVIDIA_L40S = "L40S"
NVIDIA_A100 = "A100"
NVIDIA_H100 = "H100"
NVIDIA_H200 = "H200"

# Cards per host of each type, in its standard multi-GPU server (DGX/HGX
# 8-GPU boards for V100, A100, H100, H200; the cloud's largest single
# host for the others: 4 T4, 8 A10G, 8 L4, 8 L40S).
GPUS_PER_HOST = {
    NVIDIA_TESLA_V100: 8, NVIDIA_TESLA_T4: 4, NVIDIA_TESLA_A10G: 8,
    NVIDIA_L4: 8, NVIDIA_L40S: 8, NVIDIA_A100: 8, NVIDIA_H100: 8,
    NVIDIA_H200: 8,
}

ALL_GPU_TYPES = tuple(GPUS_PER_HOST)


def gpus_per_host(accel_type: str) -> int:
    """Cards on one host of ``accel_type`` (8 for a type not listed)."""
    return GPUS_PER_HOST.get(accel_type, 8)


def num_hosts(accel_type: str, total_gpus: int) -> int:
    """Hosts that ``total_gpus`` cards of ``accel_type`` span."""
    per_host = gpus_per_host(accel_type)
    return max(1, -(-total_gpus // per_host))
