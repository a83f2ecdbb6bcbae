"""The ViT family (``models/vit.py`` in the program, ``reference/vit.py``
in the benchmark)."""

from __future__ import annotations

from typing import Dict, List

from .. import flops
from ..reference import vit as ref


def sizes(c: Dict) -> Dict:
    p, img = c["patch_size"], c["image_size"]
    return {"d": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "f": c["intermediate_size"],
            "image": img, "patch": p, "channels": c["num_channels"],
            "classes": c["num_labels"], "patches": (img // p) ** 2,
            "patch_dim": p * p * c["num_channels"]}


def port_config(c: Dict):
    import torch
    from ray_tpu_torch.models.vit import ViTConfig

    s = sizes(c)
    return ViTConfig(image_size=s["image"], patch_size=s["patch"],
                     channels=s["channels"], d_model=s["d"],
                     n_heads=s["heads"], n_layers=s["layers"], d_ff=s["f"],
                     num_classes=s["classes"],
                     dtype=getattr(torch, c["dtype"]), remat=c["remat"])


def leaf_specs(c: Dict) -> List:
    """(path, shape, init, dtype) of every weight in the program's layout
    and order; init is a normal's std, "ones" or "zeros"."""
    s = sizes(c)
    d, f, n = s["d"], s["f"], s["layers"]
    w = c["dtype"]
    scale, out = d ** -0.5, d ** -0.5 / (2 * n) ** 0.5
    specs = [("patch", (s["patch_dim"], d), s["patch_dim"] ** -0.5, w),
             ("cls", (1, 1, d), "zeros", w),
             ("pos", (s["patches"] + 1, d), 0.02, "float32"),
             ("lnf", (d,), "ones", "float32"),
             ("head", (d, s["classes"]), scale, w)]
    for i in range(n):
        p = f"layers.{i}."
        specs += [(p + "ln1", (d,), "ones", "float32"),
                  (p + "wqkv", (d, 3 * d), scale, w),
                  (p + "wo", (d, d), out, w),
                  (p + "ln2", (d,), "ones", "float32"),
                  (p + "w1", (d, f), scale, w),
                  (p + "w2", (f, d), out, w)]
    return specs


def port_train_step(c: Dict, device):
    from ray_tpu_torch.models import vit

    return vit.make_vit_train_step(port_config(c), device=device)


def train_flops(c: Dict, p: Dict) -> int:
    """Model FLOPs of one step at the cell's ``batch``."""
    s = sizes(c)
    batch = p["batch"]
    return flops.vit_train_flops(s["d"], s["layers"], s["heads"], s["f"],
                                 s["classes"], s["image"], s["patch"],
                                 s["channels"], batch)


def train_attention(c: Dict, p: Dict) -> List:
    """(kernel, shape, causal) of each attention launch of one step."""
    s = sizes(c)
    batch = p["batch"]
    shape = (batch, s["heads"], s["patches"] + 1, s["d"] // s["heads"])
    return [(k, shape, False) for _ in range(s["layers"])
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]


def reference_loss_and_grads(c: Dict, params, batch, mm, leaves,
                             rows_per_block: int):
    images, labels = batch
    s = sizes(c)
    return ref.loss_and_grads(params, images, labels, s["patch"], s["heads"],
                              mm, leaves, rows_per_block)
