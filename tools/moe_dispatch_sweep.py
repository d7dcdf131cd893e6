#!/usr/bin/env python3
"""Kernel 7, the MoE dispatch gather (``src/repro_torch/kernels/csrc/
moe_dispatch.cu``), at values of its compile-time constants: the threads
of a CTA (``MOE_THREADS``) and the 16-byte loads a thread keeps in flight
(``MOE_VECS``) on the flat path, the tokens a window CTA stages
(``MOE_WINDOW``) and the share of L2 that x must hold for the window path
(``MOE_X_L2_PCT``; 0 takes it on every hinted plan), timed on one NVIDIA
GPU on the plans ``chip_smoke.py`` times and more mixtral prefills:

    python3 tools/moe_dispatch_sweep.py [--variants 128/2/4/40,...]

each variant written threads/vecs/window/x_l2_pct.
The plans are built by
``models/moe.py::dispatch_plan`` from seeded random routing at the
widths of deepseek-v2-lite-16b (D = 2048, 64 experts, top-6; batch 4,
decode and a 511-token prefill, bf16 and f32, and a prefill whose
left-padded prompts of 17, 64, 200 and 511 tokens route their pad
tokens alike, so groups overflow) and mixtral-8x22b (D = 6144, 8
experts, top-2; batch 2, decode and a 4,000-token prefill, bf16, and
prefills of 250, 500, 750, 1,000 and 2,000 tokens, whose x holds 6.1 to
49.2 MB: where the window path starts to pay).

Each variant is built with nvcc into ``kernels/build/sweep/`` (all
started together) and called through the same C entry point as the
wrapper, with the plan's layout hint (the path ``moe_sparse`` takes) and
without it (the flat path); each result is held with ``torch.equal`` to
the plain version, and the path the entry reports is recorded. Device
time of one call: 50 calls queued behind a sleep kernel, CUDA events
around them. ``index_select`` on x with a zero row appended and
``zero_`` of the output (the least a kernel that writes it takes) are
timed the same way. Prints the nvcc register and spill lines of each
variant, the card's name and power limit, one JSON row a plan (with x's
share of the card's L2), then one JSON object. Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
SOURCE = "moe_dispatch.cu"
KNOBS = ("MOE_THREADS", "MOE_VECS", "MOE_WINDOW", "MOE_X_L2_PCT")
PATHS = (None, "elementwise", "flat", "window")
PROMPT_LENS = (17, 64, 200, 511)


def build_variants(_build, variants):
    """Compile the source once per variant, all nvcc processes started
    together; returns {variant: fn} and the ptxas lines of its kernels."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for variant in variants:
        lib = out_dir / f"moe_dispatch-{'-'.join(map(str, variant))}.so"
        defs = [f"-D{k}={v}" for k, v in zip(KNOBS, variant)]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", str(lib), str(_build.CSRC / SOURCE)]
        procs.append((variant, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)))
    fns, log = {}, []
    for variant, lib, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variant}:\n{err}")
        lines = err.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line:
                log.append(f"{variant}: {line.strip()[-60:]}")
                log.extend(f"    {x.strip()}" for x in lines[k + 1:k + 4] if "ptxas" in x)
        fn = getattr(ctypes.CDLL(str(lib)), "moe_dispatch_gather")
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        fns[variant] = fn
    return fns, log


def plans(torch, dev, gen):
    """(label, x, slot_tok, group, experts) for the plans chip_smoke.py
    times, routed at random from ``gen``."""
    from repro_torch.models.moe import capacity, dispatch_plan
    from repro_torch.models.zoo import get_config

    def plan(cfg, b, t, ids=None):
        m = cfg.moe
        if ids is None:
            ids = torch.argsort(torch.rand((b, t, m.n_experts), generator=gen, device=dev),
                                dim=-1)[..., :m.top_k]
        c = capacity(t, m)
        return dispatch_plan(ids.to(torch.int32).contiguous(), m.n_experts, c).slot_tok, c

    out = []
    ds = get_config("deepseek-v2-lite-16b")
    e = ds.moe.n_experts
    t_pre = max(PROMPT_LENS)
    for dtype in (torch.bfloat16, torch.float32):
        for label, t in (("decode", 1), ("prefill", t_pre)):
            x = torch.randn((len(PROMPT_LENS) * t, ds.d_model), generator=gen, device=dev)
            tok, c = plan(ds, len(PROMPT_LENS), t)
            out.append((f"deepseek random {label} {str(dtype)[6:]}", x.to(dtype), tok, c, e))
    # left-padded prompts: the pad tokens of a row all route to one top-k set
    b = len(PROMPT_LENS)
    ids = torch.argsort(torch.rand((b, t_pre, e), generator=gen, device=dev),
                        dim=-1)[..., :ds.moe.top_k]
    for i, n in enumerate(PROMPT_LENS):
        ids[i, :t_pre - n] = ids[i, 0]
    tok, c = plan(ds, b, t_pre, ids)
    x = torch.randn((b * t_pre, ds.d_model), generator=gen, device=dev).to(torch.bfloat16)
    out.append(("deepseek left-padded prefill bf16", x, tok, c, e))
    mx = get_config("mixtral-8x22b")
    for label, t in (("decode", 1), ("prefill", 4000), ("prefill", 250), ("prefill", 500),
                     ("prefill", 750), ("prefill", 1000), ("prefill", 2000)):
        x = torch.randn((2 * t, mx.d_model), generator=gen, device=dev).to(torch.bfloat16)
        tok, c = plan(mx, 2, t)
        size = f" {t}" if t not in (1, 4000) else ""
        out.append((f"mixtral {label}{size} bf16", x, tok, c, mx.moe.n_experts))
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="128/2/4/40,256/2/4/40,128/4/4/40,128/1/4/40,"
                        "128/2/2/40,128/2/8/40,128/2/4/0,128/2/4/20,128/2/4/30,128/2/4/45,"
                        "128/2/4/50")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("moe_dispatch_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.kernels import _build, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    variants = [tuple(int(v) for v in x.split("/")) for x in args.variants.split(",")]
    fns, log = build_variants(_build, variants)
    for line in log:
        print(line)
    dev = torch.device("cuda")

    def device_ms(fn, reps: int = 50) -> float:
        """Device time of one call: ``reps`` calls queued behind a sleep
        kernel, so they run back to back; CUDA events around the run."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    path = ctypes.c_int(0)

    def call(fn, x, tok, group, experts, tag):
        out = torch.empty((tok.shape[0], x.shape[1]), dtype=x.dtype, device=dev)
        err = fn(x.data_ptr(), tok.data_ptr(), out.data_ptr(), x.shape[0], tok.shape[0],
                 x.shape[1], x.element_size(), group, experts, dev.index or 0,
                 torch.cuda.current_stream().cuda_stream, ctypes.byref(path))
        if err:
            raise RuntimeError(f"{tag}: launch failed with cudaError_t {err}")
        return out

    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", None)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    names = ["/".join(map(str, v)) for v in variants]
    out = {"variants": names, "knobs": list(KNOBS), "rows": []}
    for label, x, tok, c, e in plans(torch, dev, gen):
        want = ref.moe_dispatch_gather_ref(x, tok)
        x_ext = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype, device=dev)])
        tok_lib = tok.clamp(max=x.shape[0])
        valid = tok[tok < x.shape[0]]
        row = {"plan": label, "T": x.shape[0], "S": tok.shape[0], "D": x.shape[1],
               "group": c, "experts": e, "n_valid": int(valid.numel()),
               "rows_read": int(valid.unique().numel()),
               "x_l2_share": x.numel() * x.element_size() / l2 if l2 else None,
               "index_select_ms": device_ms(lambda: x_ext.index_select(0, tok_lib)),
               "zero_ms": device_ms(lambda: want.zero_())}
        want = ref.moe_dispatch_gather_ref(x, tok)
        for name, fn in zip(names, fns.values()):
            for hint, (g, ex) in (("hinted", (c, e)), ("flat", (0, 0))):
                y = call(fn, x, tok, g, ex, f"{label} {name} {hint}")
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    raise RuntimeError(f"{label} {name} {hint}: differs from the plain version")
                row[f"{name} {hint}_path"] = PATHS[path.value]
                row[f"{name} {hint}_ms"] = device_ms(lambda: call(fn, x, tok, g, ex, ""))
        out["rows"].append(row)
        print(json.dumps(row))
        del x, tok, want, x_ext, tok_lib
        torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    out["l2_bytes"] = l2
    out["nvidia_smi"] = smi.splitlines()[0]
    # per variant: the worst ratio to index_select over the plans, hinted
    out["worst_hinted_over_index_select"] = {
        name: max(r[f"{name} hinted_ms"] / r["index_select_ms"] for r in out["rows"])
        for name in names}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
