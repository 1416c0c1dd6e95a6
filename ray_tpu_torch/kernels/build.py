"""Build and load the port's CUDA kernels.

Every `*.cu` under `kernels/csrc/` is compiled by `nvcc` for `sm_90a` into
one shared library with a plain C interface, loaded with `ctypes`. The
sources compile in parallel (one `nvcc` each) and link once. The build
lands in `build/ray_tpu_torch/<hash>/` at the repository root, keyed by a
hash of the sources and flags, at first use in a process. A missing `nvcc`
or a failed build raises; nothing falls back to the plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
LIB_NAME = "libray_tpu_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (0 when cached)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        log = open(out_dir / (src.stem + ".log"), "w")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, _, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{(out_dir / (src.stem + '.log')).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
           *[str(obj) for _, obj, _, _ in procs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def ptxas_report() -> str:
    """What `-Xptxas -v` said for each source of the current build."""
    return "\n".join(p.read_text() for p in sorted(build_dir().glob("*.log")))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        final = build_dir()
        t0 = time.perf_counter()
        if not (final / LIB_NAME).exists():
            tmp = final.with_name(f"{final.name}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            _compile(tmp)
            try:
                os.replace(tmp, final)
            except OSError:  # another process landed the same build first
                shutil.rmtree(tmp, ignore_errors=True)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(final / LIB_NAME))
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rt_flash_fwd.argtypes = [
        p, p, p, p, p,          # q, k, v, o, lse (lse may be NULL)
        i, i, i, i, i,          # B, H, S, Skv, D
        ll, ll, ll,             # q strides in bytes (batch, head, seq)
        ll, ll, ll,             # k strides
        ll, ll, ll,             # v strides
        i, f, i,                # causal, scale, dtype code
        p,                      # bf16 launch plan (flash_fwd.LaunchPlan; NULL for f32)
        p,                      # stream
    ]
    lib.rt_flash_fwd.restype = i
    lib.rt_flash_fwd_plan_bytes.argtypes = []
    lib.rt_flash_fwd_plan_bytes.restype = i
    tail = [i, f, i, p, p]      # causal, scale, dtype code, bf16 launch plan (NULL for f32), stream
    # q k v o dO lse Δ dq, B H S Skv D, (batch, head, seq) byte strides of q k v o dO
    lib.rt_flash_bwd_dq.argtypes = [p] * 8 + [i] * 5 + [ll] * 15 + tail
    lib.rt_flash_bwd_dq.restype = i
    # q k v dO lse Δ dk dv, B H S Skv D, byte strides of q k v dO
    lib.rt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + [ll] * 12 + tail
    lib.rt_flash_bwd_dkv.restype = i
    lib.rt_flash_bwd_plan_bytes.argtypes = []
    lib.rt_flash_bwd_plan_bytes.restype = i
    lib.rt_rmsnorm.argtypes = [p, p, p, i, i, ll, f, i, p]  # x, w, y, N, D, row stride, eps, dtype, stream
    lib.rt_rmsnorm.restype = i
    lib.rt_error_string.argtypes = [i]
    lib.rt_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.rt_error_string(err).decode()})")


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]
