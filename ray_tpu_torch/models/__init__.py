"""ray_tpu_torch.models: the model families of the port (GPT so far).

Counterpart of ``ray_tpu.models``: plain dicts of tensors with the JAX
package's keys and shapes, so ``convert.from_jax_params`` carries weights
across. Llama, MoE, ViT and ResNet come in later slices."""

from .convert import from_jax_params  # noqa: F401
from .gpt import (GPTConfig, gpt_forward, gpt_init, gpt_loss,  # noqa: F401
                  make_train_step)
