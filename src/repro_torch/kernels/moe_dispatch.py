"""Wrapper of the CUDA MoE dispatch gather (``csrc/moe_dispatch.cu``), the
port of the TPU kernel ``repro.kernels.moe_dispatch.moe_dispatch_gather``:

    out[s] = x[slot_tok[s]],  a zero row where slot_tok[s] ∉ [0, T)

Layout, as the TPU kernel's: x [T, D] (bf16 or f32), slot_tok int32
[S] (the pad is T), out [S, D] in x's dtype. ``models/moe.py::moe_sparse``
fills its expert buffer [B·E·C, D] with it.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

DTYPES = (torch.float32, torch.bfloat16)


def _check_operands(name: str, x: Tensor, slot_tok: Tensor) -> None:
    """Raise unless x is a contiguous bf16 or f32 [T, D] and slot_tok a
    contiguous int32 [S] on x's device, with T within the int32 index."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [T, D], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x must be one of {DTYPES}, got {x.dtype}")
    if slot_tok.dim() != 1 or slot_tok.dtype != torch.int32:
        raise ValueError(f"{name}: slot_tok must be int32 [S], "
                         f"got {slot_tok.dtype} {tuple(slot_tok.shape)}")
    if x.device != slot_tok.device:
        raise ValueError(f"{name}: operands on {x.device} and {slot_tok.device}")
    if not (x.is_contiguous() and slot_tok.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name}: {x.shape[0]} tokens exceed the int32 index")


def moe_dispatch_gather(x: Tensor, slot_tok: Tensor) -> Tensor:
    """out [S, D]: row s is x[slot_tok[s]], or zeros for a pad slot."""
    name = "moe_dispatch_gather"
    _check_operands(name, x, slot_tok)
    if x.device.type == "cpu":
        return ref.moe_dispatch_gather_ref(x, slot_tok)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    t, d = x.shape
    out = torch.empty((slot_tok.shape[0], d), dtype=x.dtype, device=x.device)
    fn = _build.moe_dispatch_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), slot_tok.data_ptr(), out.data_ptr(), t, slot_tok.shape[0], d,
                 x.element_size(), stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    moe_dispatch_gather.launches += 1
    return out


moe_dispatch_gather.launches = 0
