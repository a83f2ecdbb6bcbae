"""The benchmark harness of the PyTorch and CUDA port (``ray_tpu_torch``): see run.py."""
