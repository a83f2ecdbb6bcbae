"""ray_tpu_torch.ops: hand-written Hopper kernels with plain PyTorch versions.

Counterpart of ``ray_tpu.ops``. Each kernel sits beside its plain version
in the same module; a CUDA tensor goes to the kernel, a CPU tensor to the
plain version. The kernels are built at first use (``_kernels.build``).
"""

from .attention import (  # noqa: F401
    DEFAULT_MASK_VALUE,
    flash_attention,
    flash_bwd_dkv_reference,
    flash_bwd_dq_reference,
    flash_bwd_reference,
    mha_reference,
)
from .layers import rms_norm, rope, swiglu  # noqa: F401
