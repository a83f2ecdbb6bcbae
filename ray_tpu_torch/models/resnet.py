"""ResNet family (ResNet-18/50), for batch inference.

Counterpart of ``ray_tpu/models/resnet.py``: the same config fields and
presets and the same param dict, with the convolution weights kept in
JAX's HWIO layout, so weights converted from the JAX package load as
they are. Activations are NHWC as in JAX; each convolution views them
as NCHW, which is channels_last in memory (cuDNN's fast layout on the
card), and the weights as OIHW. Convolutions accumulate in f32 and
round to the model dtype; batch-norm is the inference form over stored
statistics, in f32. There is no attention and no TPU kernel here: the
convolutions were ``lax.conv_general_dilated`` in JAX and are
``F.conv2d`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ._init import normal
from .convert import params_to


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    # stage_sizes/bottleneck pick the variant: (2,2,2,2)+False = ResNet-18,
    # (3,4,6,3)+True = ResNet-50.
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls(stage_sizes=(3, 4, 6, 3), bottleneck=True)

    @classmethod
    def resnet18(cls) -> "ResNetConfig":
        return cls(stage_sizes=(2, 2, 2, 2), bottleneck=False)

    @classmethod
    def tiny(cls) -> "ResNetConfig":
        """Small variant for CPU tests."""
        return cls(stage_sizes=(1, 1), bottleneck=False, num_classes=10,
                   width=8)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _bn_init(c: int, device: torch.device) -> Dict[str, torch.Tensor]:
    def fill(value):
        return torch.full((c,), value, dtype=torch.float32, device=device)

    return {"scale": fill(1.0), "bias": fill(0.0), "mean": fill(0.0),
            "var": fill(1.0)}


def _block_channels(cfg: ResNetConfig, stage: int) -> Tuple[int, int]:
    """(inner, out) channels of a block in `stage`."""
    inner = cfg.width * (2 ** stage)
    return inner, inner * 4 if cfg.bottleneck else inner


def resnet_init(cfg: ResNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random params with the JAX package's keys, shapes (conv weights
    HWIO) and He-normal scales, drawn from ``generator`` (see
    ``gpt_init``). Batch-norm terms and the head bias are f32."""
    device = resolve_device(device)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5,
                      cfg.dtype, generator, device)

    params: Dict[str, Any] = {
        "stem": {"conv": conv(7, 7, 3, cfg.width),
                 "bn": _bn_init(cfg.width, device)},
        "stages": [],
    }
    cin = cfg.width
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        inner, cout = _block_channels(cfg, stage)
        blocks: List[Dict] = []
        for b in range(n_blocks):
            if cfg.bottleneck:
                blk = {"conv1": conv(1, 1, cin, inner),
                       "bn1": _bn_init(inner, device),
                       "conv2": conv(3, 3, inner, inner),
                       "bn2": _bn_init(inner, device),
                       "conv3": conv(1, 1, inner, cout),
                       "bn3": _bn_init(cout, device)}
            else:
                blk = {"conv1": conv(3, 3, cin, inner),
                       "bn1": _bn_init(inner, device),
                       "conv2": conv(3, 3, inner, cout),
                       "bn2": _bn_init(cout, device)}
            if b == 0 and (cin != cout or stage > 0):
                blk["proj"] = conv(1, 1, cin, cout)
                blk["proj_bn"] = _bn_init(cout, device)
            blocks.append(blk)
            cin = cout
        params["stages"].append(blocks)
    params["head"] = {
        "w": normal((cin, cfg.num_classes), cin ** -0.5, cfg.dtype,
                    generator, device),
        "b": torch.zeros(cfg.num_classes, dtype=torch.float32,
                         device=device),
    }
    return params


def resnet_param_axes(cfg: ResNetConfig) -> Dict:
    """Logical axes: convs shard output channels (-> 'mlp' axis for TP)."""
    conv = (None, None, None, "mlp")
    bn = {"scale": ("mlp",), "bias": ("mlp",),
          "mean": ("mlp",), "var": ("mlp",)}
    axes: Dict[str, Any] = {
        "stem": {"conv": conv, "bn": dict(bn)},
        "stages": [],
        "head": {"w": ("embed", "vocab"), "b": ("vocab",)},
    }
    cin = cfg.width
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        _, cout = _block_channels(cfg, stage)
        blocks = []
        for b in range(n_blocks):
            blk: Dict[str, Any] = {"conv1": conv, "bn1": dict(bn),
                                   "conv2": conv, "bn2": dict(bn)}
            if cfg.bottleneck:
                blk["conv3"] = conv
                blk["bn3"] = dict(bn)
            if b == 0 and (cin != cout or stage > 0):
                blk["proj"] = conv
                blk["proj_bn"] = dict(bn)
            blocks.append(blk)
            cin = cout
        axes["stages"].append(blocks)
    return axes


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _same_pads(x: torch.Tensor, window: int, stride: int
               ) -> Tuple[int, int, int, int]:
    """XLA's "SAME" padding of NCHW ``x`` for a square ``window`` at
    ``stride``, in ``F.pad``'s order (left, right, top, bottom). The odd
    pixel goes on the high side: stride 2 on an even size pads (0, 1)
    for a 3-wide window and (2, 3) for a 7-wide one."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x``, HWIO ``w`` -> NHWC, "SAME" padding. The NCHW view of
    NHWC memory is channels_last; the output comes back the same way."""
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    left, right, top, bottom = pads = _same_pads(xc, w.shape[0], stride)
    if left == right and top == bottom:
        # symmetric: the convolution pads by itself, with no copy
        out = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        out = F.conv2d(F.pad(xc, pads), wc, stride=stride)
    return out.permute(0, 2, 3, 1)


def _bn(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch-norm with stored statistics (f32 math)."""
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return (x.float() * inv + (p["bias"] - p["mean"] * inv)).to(x.dtype)


def _residual_block(x: torch.Tensor, blk: Dict, cfg: ResNetConfig,
                    stride: int) -> torch.Tensor:
    shortcut = x
    if cfg.bottleneck:
        y = F.relu(_bn(_conv(x, blk["conv1"]), blk["bn1"]))
        y = F.relu(_bn(_conv(y, blk["conv2"], stride), blk["bn2"]))
        y = _bn(_conv(y, blk["conv3"]), blk["bn3"])
    else:
        y = F.relu(_bn(_conv(x, blk["conv1"], stride), blk["bn1"]))
        y = _bn(_conv(y, blk["conv2"]), blk["bn2"])
    if "proj" in blk:
        shortcut = _bn(_conv(x, blk["proj"], stride), blk["proj_bn"])
    return F.relu(y + shortcut)


def resnet_forward(params: Dict, images: torch.Tensor,
                   cfg: ResNetConfig) -> torch.Tensor:
    """images [batch, h, w, 3] float -> logits [batch, classes] fp32."""
    x = images.to(cfg.dtype)
    x = F.relu(_bn(_conv(x, params["stem"]["conv"], 2),
                   params["stem"]["bn"]))
    # 3x3/2 max-pool, "SAME" with -inf padding as reduce_window pads.
    xc = x.permute(0, 3, 1, 2)
    xc = F.pad(xc, _same_pads(xc, 3, 2), value=float("-inf"))
    x = F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = _residual_block(x, blk, cfg, stride)
    x = x.float().mean(dim=(1, 2))  # global average pool
    head = params["head"]
    return x @ head["w"].float() + head["b"]


def make_predictor(cfg: ResNetConfig, params: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None):
    """A batch-inference callable closed over ``params`` (drawn from
    ``generator``, or a CPU generator seeded 0, when not given).
    ``predict(images [b, h, w, 3])`` copies host input to the device
    first (JAX's ``device_put``) and returns the argmax classes as a
    tensor on the device, not fetched."""
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator().manual_seed(0)
        params = resnet_init(cfg, generator, device)
    params = params_to(params, device)

    def predict(images) -> torch.Tensor:
        images = torch.as_tensor(images).to(device)
        with torch.inference_mode():
            return resnet_forward(params, images, cfg).argmax(-1)

    return predict
