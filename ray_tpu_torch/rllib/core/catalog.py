"""Model catalog: obs-space-driven default encoder construction.

Reference parity: rllib/core/models/catalog.py (Catalog — picks the
encoder architecture from the observation space + model config) and
rllib/models/catalog.py (MODEL_DEFAULTS: fcnet_hiddens/fcnet_activation/
conv_filters/conv_activation/post_fcnet_hiddens/use_lstm/lstm_cell_size/
max_seq_len). The JAX package's encoders (``ray_tpu/rllib/core/
catalog.py``) as torch modules: inputs stay NHWC as there, and each
submodule is named as flax names it (``Dense_0``, ``Conv_1``,
``OptimizedLSTMCell_0``), so a param dict mirrors the flax tree
(``convert.py`` fills one from it).

Torch layers need their input width when they are built, where flax
infers it at init: every encoder here is built for an input shape
(``in_shape``, without the batch dim) and knows its output width
(``out_dim``) from the shapes alone.
"""
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Reference: rllib/models/catalog.py MODEL_DEFAULTS (the subset that has
# meaning in this framework; unknown keys are rejected by validate()).
MODEL_DEFAULTS: Dict[str, Any] = {
    # MLP torso for vector obs.
    "fcnet_hiddens": [64, 64],
    "fcnet_activation": "tanh",
    # CNN torso for (H, W, C) obs; None -> auto filters from resolution.
    "conv_filters": None,
    "conv_activation": "relu",
    # Dense layers after the conv flatten (reference post_fcnet_hiddens).
    "post_fcnet_hiddens": [256],
    # Recurrent wrapper (PPO; reference use_lstm auto-wrapping).
    "use_lstm": False,
    "lstm_cell_size": 128,
    "max_seq_len": 20,
}

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    # flax's nn.gelu is the tanh approximation by default.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "linear": lambda x: x,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; one of {sorted(_ACTIVATIONS)}")


def merge_model_config(model_config: Optional[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """MODEL_DEFAULTS <- user dict, rejecting unknown keys (the
    reference warns on unknown model-config keys; silent acceptance of
    a typo'd `conv_filers` would be a debugging trap)."""
    if model_config is not None and set(model_config) == set(MODEL_DEFAULTS):
        return dict(model_config)  # already merged (idempotent fast path)
    cfg = dict(MODEL_DEFAULTS)
    if model_config:
        unknown = set(model_config) - set(MODEL_DEFAULTS) - {"hidden"}
        if unknown:
            raise ValueError(
                f"Unknown model config keys {sorted(unknown)}; "
                f"known: {sorted(MODEL_DEFAULTS)}")
        cfg.update(model_config)
        # Back-compat alias from earlier rounds: model={"hidden": ...}.
        if "hidden" in model_config and "fcnet_hiddens" not in model_config:
            cfg["fcnet_hiddens"] = list(model_config["hidden"])
    return cfg


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: a normal cut at two standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def init_flax_style(net: nn.Module, generator: torch.Generator) -> None:
    """Draw ``net``'s params as flax's initializers would (not the same
    numbers: torch cannot reproduce jax.random): lecun-normal kernels
    and zero biases for dense and conv layers, and the LSTM cell's own."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LSTMCell):
                m.init_(generator)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[Tuple[int, int],
                                                             int]:
    """flax's padding="SAME" along one dim: ((lo, hi), out size). The
    output is ceil(size / stride); of the pad that needs, the odd pixel
    goes after (hi), which nn.Conv2d's symmetric padding cannot say."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return (total // 2, total - total // 2), out


class MLPEncoder(nn.Module):
    """Dense torso for vector obs (reference: the default MLP encoder
    built by Catalog for Box(1-D) spaces). Flattens higher-rank input
    so it also serves as the fallback for image obs with
    conv_filters=[] (explicitly disabled CNN)."""

    def __init__(self, in_shape: Sequence[int],
                 hidden: Sequence[int] = (64, 64), activation: str = "tanh"):
        super().__init__()
        self.in_shape = tuple(int(d) for d in in_shape)
        self.hidden = tuple(int(h) for h in hidden)
        self.act = get_activation(activation)
        widths = (int(np.prod(self.in_shape)),) + self.hidden
        self.layers = []
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.layers.append(nn.Linear(a, b))
            self.add_module(f"Dense_{i}", self.layers[-1])
        self.out_dim = widths[-1]

    def forward(self, x):
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class ConvEncoder(nn.Module):
    """CNN torso for (B, H, W, C) image obs (reference: the CNN encoder
    Catalog builds from conv_filters). SAME padding + stride downsampling;
    the flattened features pass through post_fcnet dense layers so the
    latent width is resolution-independent.

    The convolutions run NCHW, each after an ``F.pad`` with flax's SAME
    pads; the features are flattened in H·W·C order, as flax flattens
    NHWC, so the first dense layer's rows line up with flax's kernel."""

    def __init__(self, in_shape: Sequence[int],
                 filters: Sequence[Tuple[int, int, int]],
                 activation: str = "relu", post: Sequence[int] = (256,)):
        super().__init__()
        self.in_shape = tuple(int(d) for d in in_shape)
        self.filters = tuple(tuple(int(v) for v in f) for f in filters)
        self.act = get_activation(activation)
        h, w, c = self.in_shape
        self.convs, self.pads = [], []
        for i, (out_ch, kernel, stride) in enumerate(self.filters):
            self.convs.append(nn.Conv2d(c, out_ch, kernel, stride=stride))
            self.add_module(f"Conv_{i}", self.convs[-1])
            pad_h, h = same_pads(h, kernel, stride)
            pad_w, w = same_pads(w, kernel, stride)
            self.pads.append(pad_w + pad_h)  # F.pad: last dim (W) first
            c = out_ch
        widths = (h * w * c,) + tuple(int(d) for d in post)
        self.dense = []
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.dense.append(nn.Linear(a, b))
            self.add_module(f"Dense_{i}", self.dense[-1])
        self.out_dim = widths[-1]

    def flatten(self, x):
        """NCHW features -> (B, H·W·C), flax's order of an NHWC flatten."""
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x):
        if x.ndim != 4:
            raise ValueError(
                f"ConvEncoder expects (B, H, W, C) input, got shape "
                f"{tuple(x.shape)}; batch single images with obs[None]")
        x = x.permute(0, 3, 1, 2)
        for conv, pad in zip(self.convs, self.pads):
            x = self.act(conv(F.pad(x, pad)))
        x = self.flatten(x)
        for layer in self.dense:
            x = self.act(layer(x))
        return x


class LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: input kernels ii/if/ig/io without bias,
    hidden kernels hi/hf/hg/ho with one, packed in torch's gate order
    (i, f, g, o). There is no input bias: a second trainable copy of the
    bias would take the same gradient, and Adam would move the sum twice
    as far as flax moves its one bias."""

    def __init__(self, in_dim: int, cell_size: int):
        super().__init__()
        self.cell_size = cell_size
        self.weight_ih = nn.Parameter(torch.empty(4 * cell_size, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * cell_size, cell_size))
        self.bias_hh = nn.Parameter(torch.zeros(4 * cell_size))

    def init_(self, generator: torch.Generator) -> None:
        """flax's initializers per gate: lecun-normal input kernels,
        orthogonal hidden kernels, zero biases."""
        n = self.cell_size
        for g in range(4):
            lecun_normal_(self.weight_ih[g * n:(g + 1) * n],
                          self.weight_ih.shape[1], generator)
            nn.init.orthogonal_(self.weight_hh[g * n:(g + 1) * n],
                                generator=generator)
        nn.init.zeros_(self.bias_hh)

    def forward(self, x_proj, carry):
        """One step from the input's projection ``x @ weight_ih.T``:
        carry (c, h) -> new (c, h)."""
        c, h = carry
        gates = x_proj + F.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class LSTMEncoder(nn.Module):
    """Recurrent torso (reference: the use_lstm auto-wrapper,
    rllib/models catalog + rllib/core/models/configs.py
    RecurrentEncoderConfig): inner encoder per timestep, then an LSTM
    run over time with carry resets at episode boundaries.

    The JAX package scans the cell with ``nn.scan``; here the input
    projections of all steps are one product, and the recurrence is a
    loop over T.

    Call: `(feats, carry) = enc(x, carry, resets)` with
      x: (B, T, *obs), carry: (c, h) each (B, cell), resets: (B, T)
      1.0 where the state must zero BEFORE consuming step t.
    Step mode is T=1."""

    def __init__(self, encoder: nn.Module, cell_size: int = 128):
        super().__init__()
        self.encoder = encoder
        self.cell_size = int(cell_size)
        self.OptimizedLSTMCell_0 = LSTMCell(encoder.out_dim, self.cell_size)
        self.out_dim = self.cell_size

    def forward(self, x, carry, resets):
        b, t = x.shape[0], x.shape[1]
        z = self.encoder(x.reshape((b * t,) + tuple(x.shape[2:])))
        cell = self.OptimizedLSTMCell_0
        x_proj = F.linear(z, cell.weight_ih).reshape(b, t, -1)
        keep = 1.0 - resets.to(z.dtype)
        c, h = carry
        outs = []
        for step in range(t):
            k = keep[:, step, None]
            c, h = cell(x_proj[:, step], (c * k, h * k))
            outs.append(h)
        return torch.stack(outs, 1), (c, h)

    def initial_carry(self, batch: int):
        zeros = torch.zeros((batch, self.cell_size), dtype=torch.float32)
        return (zeros, zeros)


def default_conv_filters(obs_shape: Sequence[int]
                         ) -> Tuple[Tuple[int, int, int], ...]:
    """Auto-size a conv stack for the input resolution (reference:
    rllib/models/utils.py get_filter_config's per-resolution tables,
    generalized): stride-2 4x4 convs halving the spatial dims until
    <= 4 px, channels doubling 16 -> 256."""
    h, w = int(obs_shape[0]), int(obs_shape[1])
    filters = []
    ch = 16
    while min(h, w) > 4 and len(filters) < 8:
        filters.append((ch, 4, 2))
        h, w = (h + 1) // 2, (w + 1) // 2
        ch = min(ch * 2, 256)
    if not filters:  # tiny inputs still get one conv mixing channels
        filters.append((16, 3, 1))
    return tuple(filters)


class Catalog:
    """Reference: rllib/core/models/catalog.py Catalog. Classmethods so
    custom catalogs can subclass and override encoder choice."""

    @classmethod
    def build_encoder(cls, obs_shape: Sequence[int],
                      model_config: Optional[Dict[str, Any]] = None
                      ) -> nn.Module:
        """Encoder for an observation of shape `obs_shape` (no batch
        dim). Rank-3 (H, W, C) -> CNN; anything else -> MLP. An empty
        `conv_filters` (any sequence type) explicitly disables the CNN."""
        cfg = merge_model_config(model_config)
        if cls.is_image(obs_shape, cfg):
            filters = cfg["conv_filters"] or default_conv_filters(obs_shape)
            return ConvEncoder(
                obs_shape, filters=filters,
                activation=cfg["conv_activation"],
                post=cfg["post_fcnet_hiddens"])
        return MLPEncoder(obs_shape, hidden=cfg["fcnet_hiddens"],
                          activation=cfg["fcnet_activation"])

    @classmethod
    def is_image(cls, obs_shape: Sequence[int],
                 model_config: Optional[Dict[str, Any]] = None) -> bool:
        """True when `obs_shape` gets a CNN: rank-3, and conv_filters is
        not an explicitly empty sequence (None means auto-filters)."""
        cfg = merge_model_config(model_config)
        filt = cfg["conv_filters"]
        disabled = filt is not None and len(filt) == 0
        return len(obs_shape) == 3 and not disabled


def encoder_out_dim(encoder: nn.Module, obs_shape: Sequence[int]) -> int:
    """Output feature width of an encoder for `obs_shape` inputs, from
    the shapes alone (no forward, no device), as the JAX package's
    eval_shape gives it."""
    if tuple(int(d) for d in obs_shape) != encoder.in_shape:
        raise ValueError(
            f"the encoder was built for inputs {encoder.in_shape}, "
            f"not {tuple(obs_shape)}")
    return int(encoder.out_dim)
