"""The port's hand-written CUDA kernels: build, load, launch.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``ray_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edited source is rebuilt), and loaded with ``ctypes``. One source may
hold several kernels; it is compiled once. ``build()`` starts one
``nvcc`` per source, all at once. Nothing is built or loaded when this
module is imported: the CPU tests import it on machines with no ``nvcc``
and no card.

A wrapper checks device, dtype, shape, contiguity and alignment, raises
on anything its kernel does not take, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch was refused. ``LAUNCHES[name]`` counts each launch, and nothing
else adds to it. The attention wrappers launch once per chunk of at most
``HEAD_CHUNK`` batch*heads (``head_chunks``); the RMSNorm wrappers once a
call (``rms_norm_bwd`` launches ``rms_norm_dw`` after it for dw); the qkv
split's wrappers once a call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its source in csrc/
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd.cu",
    "flash_bwd_dkv": "flash_bwd.cu",
    "rms_norm_fwd": "rms_norm.cu",
    "rms_norm_bwd": "rms_norm.cu",
    "rms_norm_dw": "rms_norm.cu",
    "qkv_rope_fwd": "qkv_rope.cu",
    "qkv_rope_bwd": "qkv_rope.cu",
}

# kernel name -> launches since the count was last reset
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# kernel name -> (C symbol, argtypes); every function returns cudaError_t.
_SIGNATURES = {
    "flash_fwd": ("ray_tpu_torch_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "flash_bwd_dq": ("ray_tpu_torch_flash_bwd_dq",
                     [_P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _F, _I, _P]),
    "flash_bwd_dkv": ("ray_tpu_torch_flash_bwd_dkv",
                      [_P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _F, _I, _P]),
    "rms_norm_fwd": ("ray_tpu_torch_rms_norm_fwd",
                     [_P, _P, _P, _P, _I, _I, _L, _I, _F, _I, _P]),
    "rms_norm_bwd": ("ray_tpu_torch_rms_norm_bwd",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P]),
    "rms_norm_dw": ("ray_tpu_torch_rms_norm_dw", [_P, _P, _I, _I, _I, _P]),
    "qkv_rope_fwd": ("ray_tpu_torch_qkv_rope_fwd",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "qkv_rope_bwd": ("ray_tpu_torch_qkv_rope_bwd",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}         # source -> loaded library
_fns: Dict[str, ctypes._CFuncPtr] = {}     # kernel name -> C function
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the sources of the named kernels (all by default) that are
    not built yet, one ``nvcc`` per source, all started together. Returns,
    per source file, its library path, build seconds (0 when it was
    already built), the kernels it holds, and the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills). Raises
    RuntimeError if any build fails."""
    names = list(SOURCES if names is None else names)
    sources = list(dict.fromkeys(SOURCES[n] for n in names))
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, report = {}, {}
    for src in sources:
        path = _lib_path(src)
        kernels = [n for n in SOURCES if SOURCES[n] == src]
        if os.path.exists(path):
            report[src] = {"path": path, "seconds": 0.0, "log": "",
                           "kernels": kernels}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        jobs[src] = (path, tmp, kernels, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (path, tmp, kernels, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        report[src] = {"path": path, "seconds": time.perf_counter() - t0,
                       "log": log, "kernels": kernels}
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def _function(name: str):
    """The C entry point of kernel ``name``, building and loading its
    source at the first call."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            src = SOURCES[name]
            if src not in _libs:
                _libs[src] = ctypes.CDLL(build([name])[src]["path"])
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(_libs[src], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def _launch(name: str, *args) -> None:
    err = _function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Flash attention: flash_fwd replaces ray_tpu/ops/attention.py::_fwd_kernel,
# flash_bwd_dq ::_dq_kernel and flash_bwd_dkv ::_dkv_kernel.
# ---------------------------------------------------------------------------
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernels put batch*heads on gridDim.y, which CUDA caps at 65,535, and
# their C entries refuse more. A larger batch*heads is launched in chunks
# of the [B*H, S, D] rows: HEAD_CHUNK is a multiple of 4 below that cap, so
# each chunk's f32 [S] rows (lse, delta) start on the 16-byte grid the
# kernels load from, whatever S is (q, k, v rows are D >= 16 elements of
# >= 2 bytes).
HEAD_CHUNK = 65532


def head_chunks(bh: int) -> List[Tuple[int, int]]:
    """(first head, heads) of each launch over ``bh`` heads."""
    return [(start, min(HEAD_CHUNK, bh - start))
            for start in range(0, bh, HEAD_CHUNK)]


def _head_ptr(t: Optional[torch.Tensor], start: int, bh: int):
    """Address of head ``start`` in a contiguous [B, H, ...] tensor."""
    if t is None:
        return None
    return t.data_ptr() + start * (t.numel() // bh) * t.element_size()


def _check_attention(name: str, tensors: Dict[str, torch.Tensor],
                     rows: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    """Raise ValueError unless ``tensors`` are CUDA tensors of one shape
    [B, H, S, D] and one dtype the kernels take, and ``rows`` f32 [B, H, S]
    on the same device; all contiguous and 16-byte aligned. Returns
    (B, H, S, D)."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {first.device}")
    shapes = {k: tuple(t.shape) for k, t in tensors.items()}
    if first.dim() != 4 or len(set(shapes.values())) != 1:
        raise ValueError(f"{name} takes {', '.join(tensors)} of one shape "
                         f"[B, H, S, D] (seq_q == seq_k), got {shapes}")
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or first.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 tensors of one "
                         f"dtype, got {sorted(map(str, dtypes))}")
    b, h, s, d = first.shape
    for key, t in rows.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s):
            raise ValueError(f"{name}: {key} must be float32 [B, H, S] = "
                             f"{(b, h, s)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    every = [*tensors.values(), *rows.values()]
    if any(t.device != first.device for t in every):
        raise ValueError(f"{name}: all inputs must be on one device")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {FLASH_HEAD_DIMS}")
    for t in every:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
    if b * h <= 0:
        raise ValueError(f"{name}: batch*heads={b * h} must be positive")
    return b, h, s, d


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, save_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward on the card: q, k, v [B, H, S, D] -> (o, lse).

    lse is f32 [B, H, S] (``m + log l``) when ``save_lse``, else None."""
    b, h, s, d = _check_attention("flash_fwd", {"q": q, "k": k, "v": v}, {})
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if save_lse else None
    if s == 0:
        return o, lse
    bh, stream = b * h, torch.cuda.current_stream(q.device).cuda_stream
    for start, n in head_chunks(bh):
        _launch("flash_fwd",
                *(_head_ptr(t, start, bh) for t in (q, k, v, o, lse)),
                n, s, d, _FLASH_DTYPES[q.dtype], int(bool(causal)),
                float(scale), _device_index(q), stream)
    return o, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                 causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ on the card (K2): q, k, v, the forward's output o and its
    gradient do [B, H, S, D], lse (from ``flash_fwd``) f32 [B, H, S] ->
    (dq, delta). The kernel computes delta = rowsum(do * o), f32
    [B, H, S], on the way and returns it for ``flash_bwd_dkv``."""
    b, h, s, d = _check_attention(
        "flash_bwd_dq", {"q": q, "k": k, "v": v, "o": o, "do": do},
        {"lse": lse})
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if s == 0:
        return dq, delta
    bh, stream = b * h, torch.cuda.current_stream(q.device).cuda_stream
    for start, n in head_chunks(bh):
        _launch("flash_bwd_dq",
                *(_head_ptr(t, start, bh)
                  for t in (q, k, v, o, do, lse, delta, dq)),
                n, s, d, _FLASH_DTYPES[q.dtype], int(bool(causal)),
                float(scale), _device_index(q), stream)
    return dq, delta


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV on the card (K3): q, k, v, do [B, H, S, D]; lse and the
    delta that ``flash_bwd_dq`` returned, f32 [B, H, S]."""
    b, h, s, d = _check_attention(
        "flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do},
        {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if s == 0:
        return dk, dv
    bh, stream = b * h, torch.cuda.current_stream(q.device).cuda_stream
    for start, n in head_chunks(bh):
        _launch("flash_bwd_dkv",
                *(_head_ptr(t, start, bh)
                  for t in (q, k, v, do, lse, delta, dk, dv)),
                n, s, d, _FLASH_DTYPES[q.dtype], int(bool(causal)),
                float(scale), _device_index(q), stream)
    return dk, dv


# ---------------------------------------------------------------------------
# RMSNorm: rms_norm_fwd, rms_norm_bwd and rms_norm_dw replace no TPU kernel
# (ray_tpu/ops/layers.py::rms_norm is plain jnp, left to XLA).
# ---------------------------------------------------------------------------
_NORM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NORM_MAX_D = 8192
# The backward's persistent grid: this many blocks on each SM.
NORM_BWD_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _norm_rows(name: str, x: torch.Tensor, weight: torch.Tensor
               ) -> Tuple[torch.Tensor, int]:
    """Raise ValueError unless ``x`` is a float32 or bfloat16 CUDA tensor
    [..., D] with a contiguous last dim, D a multiple of 8 up to
    NORM_MAX_D, and ``weight`` a contiguous float32 [D] on its device, each
    row and the weight 16-byte aligned. Returns x as [rows, D] (a view
    where its leading dims merge into one stride) and that row stride."""
    if x.dtype not in _NORM_DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d <= 0 or d % 8 or d > NORM_MAX_D:
        raise ValueError(f"{name}: the last dim {d} must be a positive "
                         f"multiple of 8 up to {NORM_MAX_D}")
    if weight.dtype != torch.float32 or tuple(weight.shape) != (d,):
        raise ValueError(f"{name} takes a float32 weight [{d}], got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    if weight.device != x.device:
        raise ValueError(f"{name}: x and weight must be on one device")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: x's last dim must be contiguous")
    rows = x.reshape(-1, d)
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: {rows.shape[0]} rows, at most 2**31 - 1")
    stride = rows.stride(0) if rows.shape[0] > 1 else d
    if rows.data_ptr() % 16 or stride * x.element_size() % 16 \
            or not weight.is_contiguous() or weight.data_ptr() % 16:
        raise ValueError(f"{name}: x's rows and the weight must be 16-byte "
                         "aligned")
    return rows, stride


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm forward on the card: x [..., D] -> (y in x's shape and
    dtype, contiguous; rstd f32 [rows], which the backward reads)."""
    rows, stride = _norm_rows("rms_norm_fwd", x, weight)
    n, d = rows.shape
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        _launch("rms_norm_fwd", rows.data_ptr(), weight.data_ptr(),
                y.data_ptr(), rstd.data_ptr(), n, d, stride,
                _NORM_DTYPES[x.dtype], float(eps), _device_index(x),
                torch.cuda.current_stream(x.device).cuda_stream)
    return y.view(x.shape), rstd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                 grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm backward on the card, from the forward's x and rstd and the
    gradient of y: (dx in x's shape and dtype, contiguous; dw f32 [D]).
    rms_norm_bwd writes dx and each block's dw partials into an f32
    [blocks, D] scratch (blocks = NORM_BWD_BLOCKS_PER_SM per SM, at most
    one a row); rms_norm_dw sums them in a fixed order."""
    rows, stride = _norm_rows("rms_norm_bwd", x, weight)
    n, d = rows.shape
    if grad.dtype != x.dtype or grad.shape != x.shape \
            or grad.device != x.device:
        raise ValueError(f"rms_norm_bwd: the gradient must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, got {grad.dtype} "
                         f"{tuple(grad.shape)} on {grad.device}")
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (n,) \
            or not rstd.is_contiguous() or rstd.device != x.device:
        raise ValueError(f"rms_norm_bwd: rstd must be float32 [{n}] on "
                         f"{x.device}")
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if not n:
        return dx.view(x.shape), torch.zeros(d, dtype=torch.float32,
                                             device=x.device)
    g = grad.reshape(n, d).contiguous()
    index = _device_index(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    blocks = min(NORM_BWD_BLOCKS_PER_SM * _sm_count(index), n)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("rms_norm_bwd", rows.data_ptr(), g.data_ptr(), weight.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(), n, d, stride,
            _NORM_DTYPES[x.dtype], blocks, index, stream)
    _launch("rms_norm_dw", partial.data_ptr(), dw.data_ptr(), blocks, d,
            index, stream)
    return dx.view(x.shape), dw


# ---------------------------------------------------------------------------
# The qkv split into heads with rope: qkv_rope_fwd and qkv_rope_bwd replace
# no TPU kernel (the JAX package's split, head layout and rope are jnp, left
# to XLA).
# ---------------------------------------------------------------------------
QKV_MAX_HEAD_DIM = 256


def _check_qkv(name: str, t: torch.Tensor, head_dim: int) -> None:
    """Raise ValueError unless ``t`` is a contiguous, 16-byte aligned
    float32 or bfloat16 CUDA tensor and ``head_dim`` a multiple of 16 up to
    QKV_MAX_HEAD_DIM."""
    if t.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {t.dtype}")
    if head_dim <= 0 or head_dim % 16 or head_dim > QKV_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {head_dim} must be a positive "
                         f"multiple of 16 up to {QKV_MAX_HEAD_DIM}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")


def _check_tables(name: str, cos: torch.Tensor, sin: torch.Tensor, s: int,
                  head_dim: int, device: torch.device) -> None:
    want = (s, head_dim // 2)
    for key, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be a contiguous, 16-byte "
                             f"aligned float32 {list(want)} on {device}")


def qkv_rope_fwd(qkv: torch.Tensor, head_dim: int, cos: torch.Tensor,
                 sin: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The qkv split on the card: qkv [B, S, 3 h D] with columns
    [q | k | v] -> (q, k, v), each contiguous [B, h, S, D]; q and k rotated
    by rope with the f32 [S, D/2] tables ``cos`` and ``sin``."""
    if qkv.dim() != 3 or head_dim <= 0 or qkv.shape[-1] % (3 * head_dim) \
            or not qkv.shape[-1]:
        raise ValueError(f"qkv_rope_fwd takes qkv [B, S, 3 h D] with D = "
                         f"{head_dim}, got {tuple(qkv.shape)}")
    _check_qkv("qkv_rope_fwd", qkv, head_dim)
    b, s, width = qkv.shape
    h = width // (3 * head_dim)
    if 3 * b * h >= 2 ** 31:
        raise ValueError(f"qkv_rope_fwd: 3 * batch * heads = {3 * b * h}, "
                         "at most 2**31 - 1")
    _check_tables("qkv_rope_fwd", cos, sin, s, head_dim, qkv.device)
    q, k, v = (torch.empty((b, h, s, head_dim), dtype=qkv.dtype,
                           device=qkv.device) for _ in range(3))
    if b and s:
        _launch("qkv_rope_fwd", qkv.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                b, h, s, head_dim, _FLASH_DTYPES[qkv.dtype],
                _device_index(qkv),
                torch.cuda.current_stream(qkv.device).cuda_stream)
    return q, k, v


def qkv_rope_bwd(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The qkv split's backward on the card: dq, dk, dv [B, h, S, D] ->
    d(qkv) [B, S, 3 h D]; dq and dk by the inverse rotation."""
    grads = (dq, dk, dv)
    if dq.dim() != 4 or len({(tuple(t.shape), t.dtype, t.device)
                             for t in grads}) != 1:
        raise ValueError("qkv_rope_bwd takes dq, dk, dv of one shape "
                         "[B, h, S, D], dtype and device, got "
                         f"{[(tuple(t.shape), t.dtype) for t in grads]}")
    b, h, s, d = dq.shape
    for t in grads:
        _check_qkv("qkv_rope_bwd", t, d)
    if 3 * b * h >= 2 ** 31:
        raise ValueError(f"qkv_rope_bwd: 3 * batch * heads = {3 * b * h}, "
                         "at most 2**31 - 1")
    _check_tables("qkv_rope_bwd", cos, sin, s, d, dq.device)
    dqkv = torch.empty((b, s, 3 * h * d), dtype=dq.dtype, device=dq.device)
    if b and h and s:
        _launch("qkv_rope_bwd", dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                cos.data_ptr(), sin.data_ptr(), dqkv.data_ptr(), b, h, s, d,
                _FLASH_DTYPES[dq.dtype], _device_index(dq),
                torch.cuda.current_stream(dq.device).cuda_stream)
    return dqkv
