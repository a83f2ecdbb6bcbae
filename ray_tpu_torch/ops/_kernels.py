"""The port's hand-written CUDA kernels: build, load, launch.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``ray_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edited source is rebuilt), and loaded with ``ctypes``. ``build()``
starts one ``nvcc`` per source, all at once. Nothing is built or loaded
when this module is imported: the CPU tests import it on machines with
no ``nvcc`` and no card.

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
SOURCES = {"flash_fwd": "flash_fwd.cu"}

# kernel name -> launches since the count was last reset
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (C symbol, argtypes); every function returns cudaError_t.
_SIGNATURES = {
    "flash_fwd": ("ray_tpu_torch_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
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


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` each, all started together. Returns, per kernel, its
    library path, build seconds (0 when it was already built) and the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills).
    Raises RuntimeError if any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, report = {}, {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            report[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        jobs[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (path, tmp, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        report[name] = {"path": path, "seconds": time.perf_counter() - t0,
                        "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


# ---------------------------------------------------------------------------
# flash_fwd: replaces ray_tpu/ops/attention.py::_fwd_kernel
# ---------------------------------------------------------------------------
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, save_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward on the card: q, k, v [B, H, S, D] -> (o, lse).

    lse is f32 [B, H, S] (``m + log l``) when ``save_lse``, else None."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_fwd takes q, k, v of one shape [B, H, S, D] "
            f"(seq_q == seq_k), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_fwd takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_fwd: q, k, v must be on one device")
    b, h, s, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {d} not in {FLASH_HEAD_DIMS}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_fwd: q, k, v must be contiguous and "
                             "16-byte aligned")
    if not 0 < b * h <= 65535:
        raise ValueError(f"flash_fwd: batch*heads={b * h} outside "
                         "[1, 65535]")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if save_lse else None
    if s == 0:
        return o, lse
    fn = getattr(_load("flash_fwd"), _SIGNATURES["flash_fwd"][0])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if lse is not None else None, b * h, s, d,
             _FLASH_DTYPES[q.dtype], int(bool(causal)), float(scale),
             q.device.index if q.device.index is not None
             else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse
