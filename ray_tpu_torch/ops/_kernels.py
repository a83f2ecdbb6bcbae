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
else adds to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

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
}

# kernel name -> launches since the count was last reset
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
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
    if not 0 < b * h <= 65535:
        raise ValueError(f"{name}: batch*heads={b * h} outside "
                         "[1, 65535]")
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
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            b * h, s, d, _FLASH_DTYPES[q.dtype], int(bool(causal)),
            float(scale), _device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
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
    _launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b * h, s, d, _FLASH_DTYPES[q.dtype],
            int(bool(causal)), float(scale), _device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
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
    _launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, s, d, _FLASH_DTYPES[q.dtype],
            int(bool(causal)), float(scale), _device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv
