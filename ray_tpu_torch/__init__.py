"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` that mirrors its layout (``ops``, ``models``,
``llm``, ``parallel``). It imports torch and numpy, never JAX and nothing of
``ray_tpu``. Each Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper (``ops/csrc``), built at first use; the rest
is plain PyTorch.

Entry points run on the CUDA card (``device=None``) and raise when there
is none, unless the caller passes ``device="cpu"``.
"""
