"""Vision Transformer family.

Counterpart of ``ray_tpu/models/vit.py``: the same config fields and
presets and the same param dict, so weights converted from the JAX
package load as they are. Images are NHWC as in JAX; patchify is a
reshape and one matmul, not a convolution. Matmuls run in the model
dtype, norms and softmax in f32, and attention is bidirectional
(``causal=False``) through ``ops.flash_attention`` (the Hopper kernels
on CUDA) over the patches and the CLS token: S = 197 for ViT-B/16 at 224.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm
from ._init import normal
from ._training import make_train_step_for
from .convert import params_to


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @classmethod
    def vit_b16(cls) -> "ViTConfig":
        """ViT-Base/16 (86M), the standard ImageNet configuration."""
        return cls()

    @classmethod
    def vit_s16(cls) -> "ViTConfig":
        """ViT-Small/16 (22M)."""
        return cls(d_model=384, n_heads=6, d_ff=1536)

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, d_model=64, n_heads=4,
                   n_layers=2, d_ff=128, num_classes=10)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(cfg: ViTConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    out_scale = scale / (2 * cfg.n_layers) ** 0.5
    ones = torch.ones(d, dtype=torch.float32, device=device)

    def draw(shape, std):
        return normal(shape, std, cfg.dtype, generator, device)

    return {
        "ln1": ones,
        "wqkv": draw((d, 3 * d), scale),
        "wo": draw((d, d), out_scale),
        "ln2": ones.clone(),
        "w1": draw((d, f), scale),
        "w2": draw((f, d), out_scale),
    }


def vit_init(cfg: ViTConfig, generator: torch.Generator,
             device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes and scales,
    drawn from ``generator`` (see ``gpt_init``). ``pos`` is f32 whatever
    the model dtype, as in JAX."""
    device = resolve_device(device)
    d = cfg.d_model
    return {
        "patch": normal((cfg.patch_dim, d), cfg.patch_dim ** -0.5,
                        cfg.dtype, generator, device),
        "cls": torch.zeros((1, 1, d), dtype=cfg.dtype, device=device),
        "pos": normal((cfg.num_patches + 1, d), 0.02, torch.float32,
                      generator, device),
        "lnf": torch.ones(d, dtype=torch.float32, device=device),
        "head": normal((d, cfg.num_classes), d ** -0.5, cfg.dtype,
                       generator, device),
        "layers": [_layer_init(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
    }


def vit_param_axes(cfg: ViTConfig) -> Dict:
    """Logical axis names per parameter (parallel.partition rule input,
    same vocabulary as gpt_param_axes so one TP/FSDP rule table covers
    both families)."""
    layer = {
        "ln1": ("embed",),
        "wqkv": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
        "ln2": ("embed",),
        "w1": ("embed", "mlp"),
        "w2": ("mlp", "embed"),
    }
    return {
        "patch": ("vocab", "embed"),   # shard like an input embedding
        "cls": (None, None, "embed"),
        "pos": (None, "embed"),
        "lnf": ("embed",),
        # "classes" is deliberately absent from every rule table: class
        # counts (10, 1000) rarely divide tp, and the head matmul is a
        # rounding error of the FLOPs — keep it replicated.
        "head": ("embed", "classes"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] -> [b, num_patches, P*P*C] by reshapes alone."""
    b, hgt, wid, c = images.shape
    p = cfg.patch_size
    nh, nw = hgt // p, wid // p
    x = images.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, p * p * c)


def _block(x: torch.Tensor, layer: Dict, cfg: ViTConfig) -> torch.Tensor:
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    y = rms_norm(x, layer["ln1"])
    # q, k and v are strided views of the projection; the kernels take
    # contiguous rows.
    q, k, v = ((t.reshape(b, s, h, hd).transpose(1, 2).contiguous())
               for t in (y @ layer["wqkv"]).split(d, dim=-1))
    attn = flash_attention(q, k, v, causal=False)  # bidirectional
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ layer["wo"]
    # jax.nn.gelu's default is the tanh form.
    y = rms_norm(x, layer["ln2"])
    return x + F.gelu(y @ layer["w1"], approximate="tanh") @ layer["w2"]


def vit_forward(params: Dict, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """images [b, H, W, C] float -> logits [b, num_classes] (fp32)."""
    x = _patchify(images.to(cfg.dtype), cfg) @ params["patch"]
    b = x.shape[0]
    cls = params["cls"].expand(b, 1, cfg.d_model).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = (x + params["pos"][None, :x.shape[1]].float()).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            # JAX keeps the block's matmul outputs (policy
            # dots_with_no_batch_dims_saveable); torch's checkpoint keeps
            # the block's input only and recomputes the whole block in
            # the backward. The values are the same.
            x = checkpoint(_block, x, layer, cfg, use_reentrant=False)
        else:
            x = _block(x, layer, cfg)
    x = rms_norm(x[:, 0], params["lnf"])  # CLS token
    return (x @ params["head"]).float()


def vit_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             cfg: ViTConfig) -> torch.Tensor:
    """Cross entropy; batch = (images [b, H, W, C], labels [b] int)."""
    images, labels = batch
    logp = F.log_softmax(vit_forward(params, images, cfg), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def make_vit_train_step(cfg: ViTConfig, optimizer=None,
                        device: DeviceLike = None, mesh=None, rules=None):
    """(init_state, train_step) for ``cfg`` on ``device`` (None: the CUDA
    card); ``train_step(state, (images, labels))``, otherwise the
    contract of ``models.gpt.make_train_step``."""
    device = resolve_device(device)
    return make_train_step_for(
        lambda generator: vit_init(cfg, generator, device),
        lambda params, batch: vit_loss(params, batch, cfg),
        optimizer=optimizer, device=device, axes=vit_param_axes(cfg),
        mesh=mesh, rules=rules)


def make_classifier(cfg: ViTConfig, params: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None):
    """A classifier closed over ``params`` (drawn from ``generator``, or
    a CPU generator seeded 0, when not given), for batch inference:
    ``predict(images [b, H, W, C])`` returns the argmax classes as a
    numpy array, as the JAX package's ``device_get`` does."""
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator().manual_seed(0)
        params = vit_init(cfg, generator, device)
    params = params_to(params, device)

    def predict(images) -> np.ndarray:
        with torch.inference_mode():
            logits = vit_forward(params, torch.as_tensor(images,
                                                         device=device), cfg)
            return logits.argmax(-1).cpu().numpy()

    return predict
