"""ray_tpu_torch.models: the model families of the port.

Counterpart of ``ray_tpu.models``: GPT, Llama, MoE, ResNet and ViT as
plain dicts of tensors with the JAX package's keys and shapes, so
``convert.from_jax_params`` carries weights across. The JAX package's
logical-axis tables (``*_param_axes``) belong to the parallel slices and
are not ported yet."""

from .convert import from_jax_params  # noqa: F401
from .gpt import (GPTConfig, gpt_forward, gpt_init, gpt_loss,  # noqa: F401
                  make_train_step)
from .llama import (LlamaConfig, llama_forward, llama_init,  # noqa: F401
                    llama_loss, make_llama_train_step)
from .moe import (MoEConfig, make_moe_train_step, moe_forward,  # noqa: F401
                  moe_init, moe_loss)
from .resnet import (ResNetConfig, make_predictor,  # noqa: F401
                     resnet_forward, resnet_init)
from .vit import (ViTConfig, make_classifier,  # noqa: F401
                  make_vit_train_step, vit_forward, vit_init, vit_loss)
