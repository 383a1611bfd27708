"""Build and load the port's CUDA kernels at first use.

Every source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface and loaded with `ctypes`; the wrappers in
the kernel modules pass raw device pointers (`data_ptr()` ints, which the
`c_void_p` argument types take as they are) and the raw handle of
PyTorch's current stream. Each launch function is looked up once, at its
first launch.

All sources compile in parallel (one `nvcc` each), for `sm_90a` (Hopper),
into `build/` beside this file, which `.gitignore` lists. A library is named
after a hash of its sources and flags, so an edit rebuilds it and an
unchanged tree reuses it.

Nothing here runs at import time: the CPU tests import every module, and
the build needs `nvcc`, which only a GPU host has.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_obj", "pso_step", "direction", "bfgs_update", "meanfield_step",
           "sweep_megakernel", "flash_attention")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # no FMA contraction: the fused objective's value-only and value+grad
    # instantiations must round f identically, and the elementwise kernels
    # then match their plain PyTorch versions bit for bit
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# Launch functions (all return cudaError_t): name -> (source stem, C
# argument types). A name ending in F64 is the float64 instantiation of the
# name without it (`symbol`).
F64 = "_f64"
SIGNATURES = {
    "fused_obj_launch": ("fused_obj", [_I, _I, _P, _P, _P, _I, _I, _P]),
    "fused_obj_launch" + F64: ("fused_obj", [_I, _I, _P, _P, _P, _I, _I, _P]),
    "fused_obj_trig_check_launch": ("fused_obj", [_P, _P]),
    "pso_step_launch": ("pso_step",
                        [_P, _P, _P, _P, _P, _P, _F, _F, _F, _P, _P, _I, _I, _P]),
    "pso_step_launch" + F64: ("pso_step",
                              [_P, _P, _P, _P, _P, _P, _D, _D, _D, _P, _P, _I, _I, _P]),
    "direction_launch": ("direction", [_P, _P, _P, _I, _I, _P]),
    "direction_launch" + F64: ("direction", [_P, _P, _P, _I, _I, _P]),
    "guarded_update_direction_launch": ("bfgs_update",
                                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "guarded_update_direction_launch" + F64: ("bfgs_update",
                                              [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "bfgs_update_launch": ("bfgs_update", [_P, _P, _P, _P, _I, _I, _P]),
    "bfgs_update_launch" + F64: ("bfgs_update", [_P, _P, _P, _P, _I, _I, _P]),
    "update_direction_launch": ("bfgs_update",
                                [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "update_direction_launch" + F64: ("bfgs_update",
                                      [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "meanfield_step_launch": ("meanfield_step",
                              [_P, _P, _P, _P, _F, _F, _F, _I, _P, _P, _I, _I, _P]),
    "meanfield_step_launch" + F64: ("meanfield_step",
                                    [_P, _P, _P, _P, _D, _D, _D, _I, _P, _P, _I, _I, _P]),
    "sweep_megakernel_full_launch": (
        "sweep_megakernel",
        [_I, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "sweep_megakernel_full_launch" + F64: (
        "sweep_megakernel",
        [_I, _P, _P, _P, _P, _P, _P, _P, _D, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "sweep_megakernel_commit_launch": (
        "sweep_megakernel", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "sweep_megakernel_commit_launch" + F64: (
        "sweep_megakernel", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "flash_attention_launch": ("flash_attention",
                               [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
}

# ptxas/nvcc output of the last build in this process, by source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the CUDA "
            "kernels build on the GPU host at first use")
    return str(path)


def _library_path(stem: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every library that is not built yet, all `nvcc`s at once.
    Returns the wall seconds spent; raises with the compiler's output on
    any failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem in SOURCES:
        target = _library_path(stem)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for stem, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built first if needed."""
    path = _library_path(stem)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for name, (fn_stem, argtypes) in SIGNATURES.items():
        if fn_stem == stem:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def symbol(op: str, name: str, dtype) -> str:
    """The launch function of `name` for elements of `dtype`: `name` for
    float32, its float64 instantiation for float64 where SIGNATURES has one;
    TypeError for any other dtype, before anything launches."""
    if dtype is torch.float32:
        return name
    if dtype is torch.float64 and name + F64 in SIGNATURES:
        return name + F64
    have = "float32 or float64" if name + F64 in SIGNATURES else "float32"
    raise TypeError(f"{op}: the kernel takes {have} (got {dtype})")


def check_tensor(op: str, arg: str, t, shape, device=None,
                 dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `shape` and `dtype`
    (float32 unless given; on `device` when given): the kernels take
    nothing else. Every test reads an attribute that costs well under a
    microsecond; the messages are built only on failure."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        raise ValueError(f"{op}: {arg} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{op}: {arg} is on {t.device}, expected {device}")
    if t.dtype is not dtype:
        raise TypeError(f"{op}: {arg} must be {dtype} (got {t.dtype})")
    if t.shape != shape:
        raise ValueError(f"{op}: {arg} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {arg} must be contiguous")


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device, for a
    launch (what `torch.cuda.current_stream(t.device).cuda_stream` gives,
    without building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# launch function name -> its ctypes function (argtypes set), bound at first
# use
_BOUND: Dict[str, Callable[..., int]] = {}


def _bind(name: str):
    fn = _BOUND[name] = getattr(library(SIGNATURES[name][0]), name)
    return fn


def launch(name: str, *args) -> None:
    """Call the launch function `name` (a key of SIGNATURES) with pointers
    as `data_ptr()` ints and the stream from `stream()`; raise if CUDA
    refused the launch."""
    code = (_BOUND.get(name) or _bind(name))(*args)
    if code:
        msg = library(SIGNATURES[name][0]).repro_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")
