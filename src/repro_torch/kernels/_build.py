"""Builds the CUDA tile kernels with nvcc at first use and loads them with
ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a``. All sources that are not built yet are
compiled together, one nvcc process each. A library's file name carries a
hash of its sources and flags, so an edited source is rebuilt and a stale
library is never loaded. The output directory, ``kernels/build/``, is
listed in ``.gitignore``.

Each C signature has its own loader, which sets the ctypes argument types:

* ``tile_kernel`` — the tile folds of ``tile_fold.cuh``:
  ``semiring_spmv.cu``, ``spmspv_tiles.cu``, ``semiring_spmv_fused.cu``,
  ``semiring_spmv_sell.cu``, ``spmspv_fused.cu``;
* ``tile_batch_kernel`` — the same folds over a block of vectors, the
  ``*_batch`` entry points of ``semiring_spmv.cu`` and ``spmspv_tiles.cu``;
* ``spgemm_kernel`` — the masked tile SpGEMM, ``spgemm_tiles.cu``;
* ``spgemm_binary_kernel`` — its tensor-core variant for 0/1 operands,
  ``spgemm_binary.cu``;
* ``moe_dispatch_kernel`` — the MoE dispatch row gather,
  ``moe_dispatch.cu``;
* ``moe_dispatch_backward_kernel`` — its transpose, the same source's
  second entry.

A kernel with another signature gets a loader of its own rather than
passing its arguments through one of these.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("semiring_spmv.cu", "spmspv_tiles.cu", "semiring_spmv_fused.cu",
           "semiring_spmv_sell.cu", "spmspv_fused.cu", "spgemm_tiles.cu",
           "spgemm_binary.cu", "moe_dispatch.cu")
HEADERS = ("tile_fold.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# nvcc's stderr (ptxas registers, spills, shared memory) per source built
# by this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the tile kernels")
    return path


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, all nvcc processes
    started together; raise with nvcc's output if one fails."""
    with _lock:
        pending = [s for s in SOURCES if not _target(s).exists()]
        if not pending:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in pending:
            tmp = _target(s).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for s, tmp, p in procs:
            out, err = p.communicate()
            build_log[s] = out + err
            if p.returncode != 0:
                failed.append(f"nvcc failed on {s} (exit {p.returncode}):\n{out}{err}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(s))
        if failed:
            raise RuntimeError("\n".join(failed))


def _entry(source: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``source``, built if needed, with its
    argument types set; every entry point returns the launch's cudaError_t."""
    build_all()
    fn = getattr(ctypes.CDLL(str(_target(source))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def tile_kernel(source: str, symbol: str, n_index: int = 1):
    """A tile fold: (tiles, ``n_index`` index arrays, x, y, mb, T, bm, bn,
    semiring code, stream). The sell kernel has two index arrays
    (tile_cols, row_meta) and takes slot_total as T; the others have one."""
    return _entry(source, symbol,
                  [ctypes.c_void_p] * (3 + n_index) + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def tile_batch_kernel(source: str, symbol: str):
    """A tile fold over a block of vectors: (tiles, index, xs, ys, mb, T,
    bm, bn, x_len, batch, semiring code, stream)."""
    return _entry(source, symbol, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def spgemm_kernel():
    """The masked tile SpGEMM: (tiles, meta, b, mask, out, path counts, T,
    mb, nb, bm, bk, group size, semiring code, stream)."""
    return _entry("spgemm_tiles.cu", "semiring_spgemm_padded",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def spgemm_binary_kernel():
    """The tensor-core SpGEMM for 0/1 operands: (a8, meta, n_real, bt8,
    mask, active, groups, out, n_groups, T, nb, kb, bm, bk, group size,
    boolean, stream)."""
    return _entry("spgemm_binary.cu", "semiring_spgemm_binary",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def spgemm_binary_pack():
    """The variant's packing of B: (b, bt8, k, n, stream)."""
    return _entry("spgemm_binary.cu", "spgemm_binary_pack_bt",
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def moe_dispatch_kernel():
    """The MoE dispatch gather: (x, slot_tok, out, n_tokens, n_slots, d,
    element size in bytes, group, experts, device index, stream, int* path
    taken); group = experts = 0 when the plan comes with no layout hint."""
    return _entry("moe_dispatch.cu", "moe_dispatch_gather",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def moe_dispatch_backward_kernel():
    """The dispatch gather's transpose: (grad_out, tok_slots, grad_x,
    n_tokens, k, n_slots, d, element size in bytes, device index, stream)."""
    return _entry("moe_dispatch.cu", "moe_dispatch_gather_backward",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
