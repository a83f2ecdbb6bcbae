"""The GPT family: GPT-2-shaped decoders (``models/gpt.py`` in the
program, ``reference/gpt.py`` in the benchmark)."""

from __future__ import annotations

from typing import Dict, List

from .. import flops
from ..reference import gpt as ref


def sizes(c: Dict) -> Dict:
    """The sizes the program and the reference are built at, from the
    configuration file's published keys."""
    d = c["n_embd"]
    return {"d": d, "layers": c["n_layer"], "heads": c["n_head"],
            "f": c["n_inner"] or 4 * d, "seq": c["n_positions"],
            "vocab": c["padded_vocab_size"],
            "real_vocab": c["vocab_size"]}


def port_config(c: Dict):
    import torch
    from ray_tpu_torch.models.gpt import GPTConfig

    s = sizes(c)
    return GPTConfig(vocab_size=s["vocab"], d_model=s["d"],
                     n_heads=s["heads"], n_layers=s["layers"],
                     d_ff=s["f"], max_seq_len=s["seq"],
                     dtype=getattr(torch, c["dtype"]), remat=c["remat"],
                     tie_embeddings=c["tie_word_embeddings"])


def leaf_specs(c: Dict) -> List:
    """(path, shape, init, dtype) of every weight in the program's layout
    and order; init is a normal's std, "ones" or "zeros"."""
    s = sizes(c)
    d, f, n = s["d"], s["f"], s["layers"]
    w = c["dtype"]
    scale, out = d ** -0.5, d ** -0.5 / (2 * n) ** 0.5
    specs = [("embed", (s["vocab"], d), scale, w),
             ("lnf", (d,), "ones", "float32")]
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
    from ray_tpu_torch.models import gpt

    return gpt.make_train_step(port_config(c), device=device)


def train_flops(c: Dict, p: Dict) -> int:
    """Model FLOPs of one step at the cell's ``batch`` x ``seq``."""
    s = sizes(c)
    batch, seq = p["batch"], p["seq"]
    return flops.gpt_train_flops(s["d"], s["layers"], s["heads"], s["f"],
                                 s["vocab"], batch, seq)


def train_attention(c: Dict, p: Dict) -> List:
    """(kernel, shape, causal) of each attention launch of one training
    step, a layer's worth times the layers."""
    s = sizes(c)
    batch, seq = p["batch"], p["seq"]
    shape = (batch, s["heads"], seq, s["d"] // s["heads"])
    return [(k, shape, True) for _ in range(s["layers"])
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]


def reference_loss_and_grads(c: Dict, params, batch, mm, leaves,
                             rows_per_block: int):
    tokens, targets = batch
    return ref.loss_and_grads(params, tokens, targets, sizes(c)["heads"],
                              mm, leaves, rows_per_block)
