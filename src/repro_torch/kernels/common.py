"""Kernel dispatch and build for the port's hand-written CUDA kernels.

Dispatch is by the tensor's device, decided per call:

  * CPU tensors take the kernel's plain PyTorch version (the same module
    holds it; it is the CPU path and the card-side oracle);
  * CUDA tensors launch the kernel, or raise.  Nothing routes a CUDA
    tensor to the plain version.

The simulator's kernels also have a replica instance, a leading [R]
axis served by one launch.  Under `torch.func.vmap` a wrapper called on
replica-batched tensors (`batched`) goes through a
`torch.library.custom_op` whose vmap rule moves the replica axes to the
front (`to_front`) and calls the replica wrapper once, which dispatches
by device in the same way.

Each kernel is one CUDA C++ source `csrc/<name>.cu` with a plain C
interface.  On first use it is compiled with `nvcc -shared` for sm_90a
into `build/` at the repository root, named by a hash of its source and
of the headers in `csrc/` (`common.cuh`, `hopper.cuh`), and
loaded with ctypes.  `build()` starts one `nvcc` per source, all at once.
Every C entry point `<name>_launch` launches on the caller's stream and
returns `cudaGetLastError()`; `launch()` declares its ctypes signature
once and raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"
KERNELS = ("drain_writeback", "plane_commit", "trip_plan", "rmsnorm",
           "flash_attention", "flash_decode", "topk_router",
           "selective_flush", "rmsnorm_bwd", "flash_attention_bwd",
           "topk_router_bwd")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
_OPS: dict = {}


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    one.  Raises when no GPU is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def batched(*xs) -> bool:
    """True when any argument is a tensor that carries a
    `torch.func.vmap` replica axis (the harness's `run_*_many`).  Outside
    every vmap one call answers, so the solo path pays ~0.1 us."""
    if torch._C._functorch.maybe_current_level() is None:
        return False
    return any(isinstance(x, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(x) for x in xs)


def to_front(size: int, x, dim):
    """A vmap rule's operand with its replica axis first, contiguous:
    moved there from `dim`, or `x` repeated `size` times where `dim` is
    None (an operand that is the same for every replica).  None stays
    None."""
    if x is None:
        return None
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def replica_op(name: str, schema: str, impl, rule):
    """The `torch.library.custom_op` `repro_torch::<name>` of this copy of
    the port, defined on first use: `impl` runs it on plain tensors and
    `rule(info, in_dims, *args)` is its vmap rule.  A second copy of the
    port in one process (`timing.load_tree`) takes a suffixed name."""
    if name not in _OPS:
        qual, k = name, 1
        while hasattr(torch.ops.repro_torch, qual):
            k += 1
            qual = f"{name}_{k}"
        op = torch.library.custom_op(f"repro_torch::{qual}", impl,
                                     mutates_args=(), schema=schema)
        op.register_vmap(rule)
        _OPS[name] = op
    return _OPS[name]


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor lies on a CUDA device,
    False when every tensor lies on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs span devices {sorted(kinds)}")


# element types the float kernels take, by the code their C entry reads
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def float_code(t: torch.Tensor, name: str) -> int:
    """The C entry's code for `t`'s element type; raises on a type the
    float kernels do not take."""
    if t.dtype not in FLOAT_CODES:
        raise ValueError(f"{name}: want float32 or bfloat16, got {t.dtype}")
    return FLOAT_CODES[t.dtype]


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    """Wrapper-side input check: dtype, shape and contiguity."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def lib_path(name: str) -> pathlib.Path:
    """The library of kernel `name`, named by a hash of its source, of
    every header in `csrc/` (any of which it may include) and of the
    compiler flags: an edit to any of them builds anew."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together.  Returns {name: ptxas report} for
    the sources compiled now; raises with the compiler output on error."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        tmp.replace(out)
        reports[name] = log
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return _LIBS[name]


def launch(name: str, argtypes: list, device: torch.device, *args,
           entry: str = None) -> None:
    """Call `<entry>_launch` (default `<name>_launch`) of kernel `name`'s
    library on `device`'s current stream and raise when it returns a
    nonzero `cudaGetLastError()`.

    Pointer arguments come from `ptr()`; the kernel runs on the current
    stream after this returns.  PyTorch's caching allocator reuses a freed
    block only for work ordered after it on the same stream, so inputs
    and scratch the caller drops afterwards stay valid for the kernel."""
    lib = library(name)
    entry = entry or name
    fn = getattr(lib, f"{entry}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes + [ctypes.c_void_p]     # ... stream
        fn.restype = ctypes.c_int
    err = fn(*args, ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {msg} ({err})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

