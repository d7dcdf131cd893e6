"""Wrapper of the CUDA MoE dispatch gather (``csrc/moe_dispatch.cu``), the
port of the TPU kernel ``repro.kernels.moe_dispatch.moe_dispatch_gather``:

    out[s] = x[slot_tok[s]],  a zero row where slot_tok[s] ∉ [0, T)

Layout, as the TPU kernel's: x [T, D] (bf16 or f32), slot_tok int32
[S] (the pad is T), out [S, D] in x's dtype. ``models/moe.py::moe_sparse``
fills its expert buffer [B·E·C, D] with it.

The optional hint ``group=C, experts=E`` says that the plan is laid out as
``dispatch_plan`` lays it out: S = B·E·C slots of B batch rows of T/B
tokens, each group of C slots holding its kept tokens ascending with the
pads at the tail. The kernel then reads each routed token row once,
however many experts it feeds. The hint changes which bytes the kernel
reads, never its result: a plan that breaks the order is still gathered
exactly. A hint that does not split S into B·E·C and T into B rows
raises.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``;
on a meta tensor (the dry run of ``launch/dryrun.py``) it checks the
operands as on the card and returns an empty output of the right shape
and dtype, launching nothing. On the card and on meta alike it reports
the bytes its kernel moves to an active counting mode
(``launch/op_analysis.py``), since a ctypes launch is no aten op that a
dispatch mode could see.
``.launches`` counts its kernel launches, and ``.paths`` counts them by
the path the kernel took (``elementwise``, ``flat``, ``window``).

``moe_dispatch_gather_backward`` is the gather's transpose (kernel 7ᵀ,
the same source's second C entry), the gradient of x:

    grad_x[r] = Σ_j grad_out[tok_slots[r, j]],  over the j with tok_slots[r, j] < S

in ascending j, summed in f32 and rounded once to grad_out's dtype; a row
with no kept slot is zero. tok_slots int32 [T, k] lists each token's
buffer slots in ascending expert order, the pad S for a dropped
assignment (``dispatch_plan``'s ``tok_slots``). Each kept slot names one
token, so the sum is a fixed fold with no atomics: the reference gets
this gradient from XLA's transpose of its gather.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

DTYPES = (torch.float32, torch.bfloat16)
# the path codes the C entry reports (0: nothing launched)
PATHS = (None, "elementwise", "flat", "window")


def _note_traffic(name: str, nbytes: int) -> None:
    """Report one launch's bytes to each active dispatch mode that counts
    kernel traffic (``launch/op_analysis.py``'s ``kernel_traffic``); with
    no mode active this is one test of the mode stack's length."""
    if torch._C._len_torch_dispatch_stack():
        for mode in _get_current_dispatch_mode_stack():
            note = getattr(mode, "kernel_traffic", None)
            if note is not None:
                note(name, nbytes)


def _check_operands(name: str, x: Tensor, slot_tok: Tensor) -> torch.device:
    """Raise unless x is a contiguous bf16 or f32 [T, D] and slot_tok a
    contiguous int32 [S] on x's device, with T within the int32 index;
    returns the device."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [T, D], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x must be one of {DTYPES}, got {x.dtype}")
    if slot_tok.dim() != 1 or slot_tok.dtype != torch.int32:
        raise ValueError(f"{name}: slot_tok must be int32 [S], "
                         f"got {slot_tok.dtype} {tuple(slot_tok.shape)}")
    dev = x.device
    if dev != slot_tok.device:
        raise ValueError(f"{name}: operands on {dev} and {slot_tok.device}")
    if not (x.is_contiguous() and slot_tok.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name}: {x.shape[0]} tokens exceed the int32 index")
    return dev


def _check_hint(name: str, t: int, s: int, group, experts) -> None:
    """Raise unless (group, experts) split S slots into B·E·C and T tokens
    into B equal batch rows."""
    if group is None or experts is None:
        raise ValueError(f"{name}: give both group and experts, or neither")
    if group < 1 or experts < 1 or group * experts >= 2**31:
        raise ValueError(f"{name}: group {group} and experts {experts} must be positive, "
                         "their product within int32")
    per_row = group * experts
    if s % per_row:
        raise ValueError(f"{name}: {s} slots are not B × {experts} experts × {group}")
    b = s // per_row
    if (b == 0 and t != 0) or (b > 0 and t % b):
        raise ValueError(f"{name}: {t} tokens do not split into {b} batch rows")


def moe_dispatch_gather(x: Tensor, slot_tok: Tensor, *, group: int | None = None,
                        experts: int | None = None) -> Tensor:
    """out [S, D]: row s is x[slot_tok[s]], or zeros for a pad slot."""
    name = "moe_dispatch_gather"
    dev = _check_operands(name, x, slot_tok)
    hinted = group is not None or experts is not None
    if hinted:
        _check_hint(name, x.shape[0], slot_tok.shape[0], group, experts)
    if dev.type == "cpu":
        return ref.moe_dispatch_gather_ref(x, slot_tok)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    t, d = x.shape
    s = slot_tok.shape[0]
    out = torch.empty((s, d), dtype=x.dtype, device=dev)
    # gather_bound's count for a plan without drops: each token row read
    # once, every slot row written, the index read
    _note_traffic(name, (min(t, s) + s) * d * x.element_size() + 4 * s)
    if dev.type == "meta":
        return out
    # the C side makes x's device current for the launch if it is not
    path = ctypes.c_int(0)
    err = _build.moe_dispatch_kernel()(
        x.data_ptr(), slot_tok.data_ptr(), out.data_ptr(), t, s, d, x.element_size(),
        group if hinted else 0, experts if hinted else 0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(path))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    if path.value:
        moe_dispatch_gather.launches += 1
        moe_dispatch_gather.paths[PATHS[path.value]] += 1
    return out


moe_dispatch_gather.launches = 0
moe_dispatch_gather.paths = dict.fromkeys(PATHS[1:], 0)


def moe_dispatch_gather_backward(grad_out: Tensor, tok_slots: Tensor) -> Tensor:
    """grad_x [T, D] in grad_out's dtype: row r sums the rows of grad_out
    [S, D] that tok_slots[r] names, in ascending j (see the module)."""
    name = "moe_dispatch_gather_backward"
    if tok_slots.dim() != 2 or not tok_slots.is_contiguous():
        raise ValueError(f"{name}: tok_slots must be a contiguous int32 [T, k], "
                         f"got {tuple(tok_slots.shape)}")
    if tok_slots.numel() >= 2**31:
        raise ValueError(f"{name}: {tuple(tok_slots.shape)} slots exceed the int32 index")
    dev = _check_operands(name, grad_out, tok_slots.view(-1))
    if dev.type == "cpu":
        return ref.moe_dispatch_gather_backward_ref(grad_out, tok_slots)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    s, d = grad_out.shape
    t, k = tok_slots.shape
    grad_x = torch.empty((t, d), dtype=grad_out.dtype, device=dev)
    # for a plan without drops: each kept slot row read, every token row
    # written, the index read
    _note_traffic(name, (min(t * k, s) + t) * d * grad_out.element_size() + 4 * t * k)
    if dev.type == "meta":
        return grad_x
    err = _build.moe_dispatch_backward_kernel()(
        grad_out.data_ptr(), tok_slots.data_ptr(), grad_x.data_ptr(), t, k, s, d,
        grad_out.element_size(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    if t and d:
        moe_dispatch_gather_backward.launches += 1
    return grad_x


moe_dispatch_gather_backward.launches = 0
