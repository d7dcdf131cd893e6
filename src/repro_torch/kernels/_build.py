"""Builds the CUDA tile kernels with nvcc at first use and loads them with
ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a``; a source of ``SPLIT`` becomes one
library for each value of its macro (``-D<macro>=<value>``), each holding
that value's kernels alone. All libraries that are not built yet are
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
* ``spgemm_kernel`` — the masked tile SpGEMM, ``spgemm_tiles.cu``, one
  library a semiring;
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
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("semiring_spmv.cu", "spmspv_tiles.cu", "semiring_spmv_fused.cu",
           "semiring_spmv_sell.cu", "spmspv_fused.cu", "spgemm_tiles.cu",
           "spgemm_binary.cu", "moe_dispatch.cu")
HEADERS = ("tile_fold.cuh",)
#: source -> (macro, n): built once for each of the macro's values 0..n-1.
#: Kernel 6's 20 kernels (5 semirings × 4 block shapes, up to 255 registers)
#: took ~90 s in one nvcc process, the other sources at most ~30 s
SPLIT = {"spgemm_tiles.cu": ("SPGEMM_SEMIRING", 5)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# nvcc's stderr (ptxas registers, spills, shared memory) per source built
# by this process
build_log: dict[str, str] = {}
#: seconds from the start of the build until each source's nvcc ended
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the tile kernels")
    return path


def _units() -> list:
    """(source, its ``macro=value`` define or None) of every library."""
    out = []
    for s in SOURCES:
        if s in SPLIT:
            macro, n = SPLIT[s]
            out += [(s, f"{macro}={v}") for v in range(n)]
        else:
            out.append((s, None))
    return out


def _unit_name(source: str, define: str | None) -> str:
    return source if define is None else f"{source} [{define}]"


def _target(source: str, define: str | None = None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ((define,) if define else ())).encode())
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    tag = "" if define is None else "-" + define.split("=")[1]
    return BUILD_DIR / f"{Path(source).stem}{tag}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every library that is missing, all nvcc processes started
    together; raise with nvcc's output if one fails. ``build_log`` and
    ``build_seconds`` are by library: the source's name, and a split
    one's define in brackets."""
    with _lock:
        pending = [(s, d) for s, d in _units() if not _target(s, d).exists()]
        if not pending:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for s, d in pending:
            tmp = _target(s, d).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(() if d is None else (f"-D{d}",)), "-o", str(tmp),
                   str(CSRC / s)]
            procs.append((_unit_name(s, d), _target(s, d), tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

        def finish(unit, p):
            out, err = p.communicate()
            build_seconds[unit] = time.perf_counter() - t0
            build_log[unit] = out + err

        waits = [threading.Thread(target=finish, args=(u, p)) for u, _, _, p in procs]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        failed = []
        for unit, target, tmp, p in procs:
            if p.returncode != 0:
                failed.append(f"nvcc failed on {unit} (exit {p.returncode}):\n{build_log[unit]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))


def _entry(source: str, symbol: str, argtypes: list, define: str | None = None):
    """The C entry point ``symbol`` of ``source`` (of its library for
    ``define``, a ``SPLIT`` source's), built if needed, with its argument
    types set; every entry point returns the launch's cudaError_t."""
    build_all()
    fn = getattr(ctypes.CDLL(str(_target(source, define))), symbol)
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
def spgemm_kernel(sr_code: int):
    """The masked tile SpGEMM of semiring ``sr_code``, from its own library:
    (tiles, meta, b, mask, out, path counts, T, mb, nb, bm, bk, group size,
    semiring code, stream)."""
    macro, n = SPLIT["spgemm_tiles.cu"]
    if not 0 <= sr_code < n:
        raise ValueError(f"no masked tile SpGEMM for semiring code {sr_code}")
    return _entry("spgemm_tiles.cu", "semiring_spgemm_padded",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                  define=f"{macro}={sr_code}")


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
