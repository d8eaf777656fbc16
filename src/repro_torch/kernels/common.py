"""Shared kernel plumbing: build, load, launch rule and launch counters.

**Build.** The CUDA sources in ``src/repro_torch/csrc/*.cu`` are compiled by
``nvcc`` for ``sm_90a`` into shared libraries with a plain C interface
(``LIBRARIES``), under ``build/kernels/`` at the repository root, and loaded
with ``ctypes``. ``matmul.cu``, ``im2col_gemm.cu``, ``winograd.cu`` and
``flash_attention.cu`` build once per operand dtype (``-DRT_FP32`` /
``-DRT_BF16`` keep one dtype's entry points, so only that dtype's templates
are instantiated), the other sources once (``matmul_wgmma.cu``,
``conv_wgmma.cu``, ``winograd_wgmma.cu`` and ``flash_wgmma.cu``, the bf16
matmul's, implicit-GEMM conv's, Winograd point-GEMM's and flash attention's
wgmma routes).
The build happens at first use (or by calling ``build_kernels()``): one
``nvcc`` process per library, all started together. A library's file name
carries a digest of its source, the shared headers and the flags, so an
edited source is rebuilt and never confused with an old build.

**Launch rule.** A wrapper whose tensors lie on the CPU computes the
kernel's plain PyTorch version (the CPU tests rely on it); a wrapper whose
tensors lie on a CUDA device launches the kernel or raises. There is no
fallback from a kernel to its plain version. A kernel that cannot be built,
loaded or launched raises :class:`KernelError`, so a caller (the serving
core) can tell it from any other failure and never serve around it.

**Dtypes.** ``DTYPES[name]`` is what a kernel takes: fp32 everywhere, and
bf16 too for the seven that port the reference's Pallas kernels (the two
matmuls, the two convs, the two Winograd point-GEMMs, flash attention: the
dtypes those run at; fp16 is not ported). The Winograd transforms take fp32 only, as the
reference computes them in fp32. The operands of one call share a dtype; a
bias and residual each have that dtype or fp32, the type the epilogue
computes in. ``on_cpu`` raises ``TypeError`` on anything else: no kernel
converts an operand quietly.

**Counters.** ``LAUNCHES[name]`` grows by one each time a wrapper launches
its kernel, and nowhere else; ``SEEN[name]`` counts the launches per call
signature (shapes, tile, epilogue flags, and the dtypes of the kernels that
take more than one: a bias and residual appear as their dtype's name, or
False), so a run can replay the exact shapes and dtypes its main
path gave a kernel. ``reset_launches()`` clears both.
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
from pathlib import Path
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

# one launch counter per hand-written kernel: the five a served plan runs
# (the Winograd point-GEMM with its input and inverse transforms, which the
# single-image Winograd entry point runs too), then the four reached through
# their ``ops`` entry points only
KERNELS = ("matmul", "conv_im2col_batch", "winograd_point_gemm_batch",
           "winograd_input_transform", "winograd_inverse_transform",
           "matmul_batch", "conv_im2col", "winograd_point_gemm",
           "flash_attention")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
# the operand dtypes each kernel takes (fp32 unless listed)
DTYPES: Dict[str, Tuple[torch.dtype, ...]] = {
    k: (torch.float32, torch.bfloat16)
    for k in ("matmul", "matmul_batch", "conv_im2col", "conv_im2col_batch",
              "winograd_point_gemm", "winograd_point_gemm_batch",
              "flash_attention")}
SEEN: Dict[str, Counter] = {k: Counter() for k in KERNELS}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# library -> (source in csrc/, its extra nvcc flags)
LIBRARIES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "matmul": ("matmul", ("-DRT_FP32",)),
    "matmul_bf16": ("matmul", ("-DRT_BF16",)),
    "matmul_wgmma": ("matmul_wgmma", ()),
    "im2col_gemm": ("im2col_gemm", ("-DRT_FP32",)),
    "im2col_gemm_bf16": ("im2col_gemm", ("-DRT_BF16",)),
    "conv_wgmma": ("conv_wgmma", ()),
    "winograd": ("winograd", ("-DRT_FP32",)),
    "winograd_bf16": ("winograd", ("-DRT_BF16",)),
    "winograd_wgmma": ("winograd_wgmma", ()),
    "flash_attention": ("flash_attention", ("-DRT_FP32",)),
    "flash_attention_bf16": ("flash_attention", ("-DRT_BF16",)),
    "flash_wgmma": ("flash_wgmma", ()),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()     # serving workers launch concurrently


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched."""


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
            SEEN[k].clear()


def snapshot() -> Tuple[Dict[str, int], Dict[str, Counter]]:
    """Copies of ``LAUNCHES`` and ``SEEN`` taken together, under the lock the
    launching threads (serving workers) count under."""
    with _COUNT_LOCK:
        return dict(LAUNCHES), {k: Counter(c) for k, c in SEEN.items()}


def count_launch(name: str, signature: Tuple) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        SEEN[name][signature] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels are built on a "
                          "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    h.update((CSRC / f"{source}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels() -> float:
    """Compile every library that has no current build, one ``nvcc`` per
    library in parallel. Returns the wall seconds spent (0.0 when all were
    built already). Raises with the compiler's output on any failure."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in LIBRARIES if not library_path(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for n in todo:
            source, flags = LIBRARIES[n]
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / f"{source}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for n, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"nvcc {n} failed ({p.returncode}):\n{log}")
            else:
                if log.strip():
                    print(f"[nvcc {n}]\n{log.rstrip()}", flush=True)
                os.replace(tmp, library_path(n))
        if failed:
            raise KernelError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` of ``LIBRARIES``, built on first
    use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                try:
                    lib = ctypes.CDLL(str(library_path(name)))
                except OSError as e:
                    raise KernelError(f"cannot load {name}: {e}") from e
                _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int = 0,
         n_longs: int = 0):
    """C function ``symbol(ptr * n_ptrs, int * n_ints, long long * n_longs,
    float * n_floats, stream) -> int`` of library ``name``, with its ctypes
    signature set. Pointers and the stream are ``c_void_p`` — anything else
    would truncate them to 32 bits. A ``c_int`` wraps silently past 2**31 - 1:
    a wrapper checks its ints with ``check_int32`` or passes them as longs."""
    try:
        fn = getattr(library(name), symbol)
    except AttributeError as e:
        raise KernelError(f"{name} has no symbol {symbol}") from e
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_longlong] * n_longs + [ctypes.c_float] * n_floats
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Operand checks and the launch rule
# ---------------------------------------------------------------------------

def on_cpu(name: str, *operands: Optional[torch.Tensor],
           epilogue: Tuple[Optional[torch.Tensor], ...] = ()) -> bool:
    """Check a kernel's tensors and say which version runs: True for the
    plain version (every tensor on the CPU), False for the kernel (every
    tensor on one CUDA device). The ``operands`` share one dtype of
    ``DTYPES[name]``; each ``epilogue`` tensor (a bias or residual, which
    the kernel widens to fp32 as the reference's ``_finish`` does) has the
    operands' dtype or fp32. Raises on anything the kernel does not take:
    another dtype (``TypeError``), a non-contiguous tensor, tensors on
    different devices, or a device that is neither."""
    takes = DTYPES.get(name, (torch.float32,))
    ops = [t for t in operands if t is not None]
    eps = [t for t in epilogue if t is not None]
    dev, dtype = ops[0].device, ops[0].dtype
    for t in (*ops, *eps):
        if t.dtype not in takes:
            raise TypeError(f"{name}: operands must be "
                            f"{' or '.join(map(dtype_name, takes))}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    for t in ops:
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands of one call share a dtype, got "
                            f"{dtype} and {t.dtype}")
    for t in eps:
        if t.dtype not in (dtype, torch.float32):
            raise TypeError(f"{name}: bias and residual share a dtype with the "
                            f"operands or are float32, got {t.dtype} on "
                            f"{dtype} operands")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype as a launch signature
    records it."""
    return str(dtype).removeprefix("torch.")


def ep_name(t: Optional[torch.Tensor]):
    """A bias or residual as a launch signature records it: its dtype's
    name, or False where the call has none."""
    return False if t is None else dtype_name(t.dtype)


def as_f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` widened to fp32 (itself if it is fp32), None where it is None:
    what a plain version computes on, as the kernels widen bf16 operands."""
    return None if t is None else t.float()


def check_int32(name: str, **values: int) -> None:
    """Raise on a value a C ``int`` parameter cannot hold: ctypes would wrap
    it silently (2**31 + 5 arrives as -2147483643)."""
    for key, v in values.items():
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"{name}: {key}={v} does not fit the kernel's "
                             f"int32 parameter")


# ---------------------------------------------------------------------------
# Launch plans of the tensor-core GEMM templates (matmul, implicit-GEMM conv)
# ---------------------------------------------------------------------------

SMS = 132                       # streaming multiprocessors of an H100 SXM
WARPS_PER_SM = 8                # two warps on each of an SM's four schedulers


def cta_warps(bm: int, bn: int) -> int:
    """Warps of one CTA of csrc/mma_tf32.cuh (``Tile::kThreads / 32``): one
    per warp tile of up to 32 x 32."""
    return (bm // min(bm, 32)) * (bn // min(bn, 32))


def fit_plan(M: int, N: int, K: int, batch: int,
             ceiling: Tuple[int, int, int], tile_m: Tuple[int, ...],
             tile_n: Tuple[int, ...]) -> Tuple[int, int, int, int]:
    """(BM, BN, BK, split_k) for a (batch x) (M, K) @ (K, N) product on the
    tile loop of csrc/mma_tf32.cuh, under a ``ceiling`` (BM, BK, BN) tile,
    with BM and BN drawn from the instantiated sizes ``tile_m`` and
    ``tile_n``. The rule:

    1. BK is the ceiling's. BM is the smallest of ``tile_m`` that covers
       min(M, ceiling BM), BN the smallest of ``tile_n`` that covers
       min(N, ceiling BN): a tile never computes more zero rows or columns
       than the next smaller instantiated size would.
    2. The output tiles of all batch entries, ``tiles`` CTAs of ``cta_warps``
       warps each, fill the card when they give every one of the ``SMS``
       streaming multiprocessors a CTA and ``WARPS_PER_SM`` warps. Then
       split_k = 1. Otherwise K is split ``want`` ways, the least that
       fills the card: K's ``steps = ceil(K / BK)`` BK steps are dealt out
       ``per = max(1, steps // want)`` to a slice, giving split_k =
       ceil(steps / per) >= want slices, or split_k = steps (one step per
       slice) where K is too short for that."""
    cm, bk, cn = ceiling
    bm = next(t for t in tile_m if t >= min(M, cm))
    bn = next(t for t in tile_n if t >= min(N, cn))
    tiles = -(-M // bm) * -(-N // bn) * batch
    steps = -(-K // bk)
    if tiles == 0 or steps <= 1:
        return bm, bn, bk, 1
    want = max(-(-SMS // tiles),
               -(-SMS * WARPS_PER_SM // (tiles * cta_warps(bm, bn))))
    if want == 1:
        return bm, bn, bk, 1
    per = max(1, steps // want)
    return bm, bn, bk, -(-steps // per)


def check_plan(name: str, K: int, bm: int, bk: int, bn: int, split_k: int,
               tile_m: Tuple[int, ...], tile_k: Tuple[int, ...],
               tile_n: Tuple[int, ...]) -> None:
    """Raise unless (bm, bk, bn) is a tile the source instantiates (every BM
    of ``tile_m`` with every BK of ``tile_k`` and every BN of ``tile_n``)
    and each of the ``split_k`` slices of the K walk owns at least one BK
    step (slices take ceil(steps / split_k) steps each, the last what
    remains)."""
    if bm not in tile_m or bk not in tile_k or bn not in tile_n:
        raise ValueError(f"{name}: ({bm}, {bk}, {bn}) is not an instantiated "
                         f"tile")
    steps = -(-K // bk)
    if split_k < 1 or (split_k > 1 and
                       (split_k - 1) * -(-steps // split_k) >= steps):
        raise ValueError(f"{name}: split_k={split_k} leaves a slice without "
                         f"a step of {bk} (K={K})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise when the C launcher returned a CUDA error (``cudaGetLastError``
    right after the launch) — a refused launch never runs, and a later
    ``synchronize`` would not report it."""
    if err != 0:
        raise KernelError(f"{name}: kernel launch failed with cudaError {err}")


def epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                   residual: Optional[torch.Tensor], relu: bool,
                   channel_axis: int) -> torch.Tensor:
    """The kernels' epilogue in plain torch: bias -> residual -> ReLU."""
    if bias is not None:
        shape = [1] * y.dim()
        shape[channel_axis] = bias.shape[0]
        y = y + bias.reshape(shape)
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    return y
