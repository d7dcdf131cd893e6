"""Cost-model calibration: predicted vs measured phase costs. A copy of
the JAX package's ``repro.obs.calibrate``, which imports no JAX.

``graphs/cost_model.estimate_phase_costs`` predicts per-device phase
costs in *element traffic/work* units; the tracer measures the same
phases in *seconds*.  The units never agree, but the **ordering** must —
the planner's whole job (`strategy="auto"`, `choose_merge`) is ranking,
not absolute prediction.  So calibration reports Spearman rank
correlation, at two grains:

* **within a cell** (one family × strategy × topology): do the phases
  rank the same way?  Predicted {load, kernel, retrieve+merge_wire} vs
  the measured per-phase span sums.  A skewed rmat under col/2d should
  have Kernel as the top phase in both columns (paper §5's central
  observation), giving ρ ≥ 0.5.
* **across strategies** (one family): does predicted ``total`` order the
  strategies the way measured wall time does?  This is the direct check
  on ``choose_partition``'s ranking claim.

The join key between spans and cost rows is span *attrs* — phase spans
carry ``phase=…, strategy=…`` (see
``repro_torch.core.distributed.build_phase_fns``), so
:func:`phase_measurements` is a filtered group-by over a
:class:`~repro_torch.obs.trace.Tracer`.

This module sits *above* both core and graphs (obs imports nothing from
them at module level; callers hand in cost rows and tracers), keeping the
layering acyclic: graphs → core, obs → (nothing), benchmarks → both.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Sequence

#: Which of the four paper phases each Fig.-3 strategy actually runs
#: (core.distributed.build_phase_fns returns exactly these closures):
#: row assembles the full vector but never merges; col merges the full
#: padded height but never loads; 2d does both over bands.  Retrieve and
#: Merge execute as one fused closure, so they calibrate as one phase
#: whose prediction is ``retrieve + merge_wire``.
PHASES_BY_STRATEGY: Dict[str, tuple] = {
    "row": ("load", "kernel"),
    "col": ("kernel", "retrieve_merge"),
    "2d": ("load", "kernel", "retrieve_merge"),
}


# ---------------------------------------------------------------------------
# Spearman rank correlation (average ranks for ties — no scipy dependency)
# ---------------------------------------------------------------------------

def _average_ranks(xs: Sequence[float]) -> List[float]:
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman's ρ with average-rank tie handling: Pearson correlation
    of the two rank vectors.  Returns NaN for < 2 points or a constant
    input (ordering is undefined there, and NaN is honest)."""
    if len(xs) != len(ys):
        raise ValueError(f"length mismatch: {len(xs)} vs {len(ys)}")
    n = len(xs)
    if n < 2:
        return math.nan
    rx = _average_ranks([float(x) for x in xs])
    ry = _average_ranks([float(y) for y in ys])
    mx, my = sum(rx) / n, sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0.0 or vy == 0.0:
        return math.nan
    return cov / math.sqrt(vx * vy)


# ---------------------------------------------------------------------------
# Joining cost rows with traced measurements
# ---------------------------------------------------------------------------

def predicted_phases(cost: Dict[str, Any], strategy: str) -> Dict[str, float]:
    """Per-phase predictions from one ``estimate_phase_costs`` row, keyed
    by the phase names the tracer uses.  Only the phases the strategy
    runs appear; ``retrieve_merge`` is ``retrieve + merge_wire`` (the
    fused closure's two cost components)."""
    out: Dict[str, float] = {}
    for phase in PHASES_BY_STRATEGY[strategy]:
        if phase == "retrieve_merge":
            out[phase] = float(cost["retrieve"]) + float(cost["merge_wire"])
        else:
            out[phase] = float(cost[phase])
    return out


def phase_measurements(tracer, **attrs) -> Dict[str, float]:
    """Summed measured seconds per phase from a tracer's ``phase/*``
    spans, optionally filtered by span attrs (``strategy="col"``, …)."""
    out: Dict[str, float] = {}
    for s in tracer.filter("phase/", **attrs):
        phase = s.attrs.get("phase", s.name.split("/", 1)[-1])
        out[phase] = out.get(phase, 0.0) + s.duration
    return out


def calibration_cell(family: str, strategy: str, topology: str,
                     cost: Dict[str, Any],
                     measured: Dict[str, float],
                     measured_wall: float | None = None) -> Dict[str, Any]:
    """One report cell: the phase-level join plus its within-cell ρ.
    ``measured`` maps phase → seconds (e.g. from
    :func:`phase_measurements`); phases missing from either side are
    dropped from the correlation (and listed under ``missing``)."""
    pred = predicted_phases(cost, strategy)
    phases = [p for p in PHASES_BY_STRATEGY[strategy]
              if p in pred and p in measured]
    missing = [p for p in PHASES_BY_STRATEGY[strategy] if p not in phases]
    rho = spearman([pred[p] for p in phases],
                   [measured[p] for p in phases]) if len(phases) >= 2 \
        else math.nan
    return {
        "family": family, "strategy": strategy, "topology": topology,
        "phases": phases, "missing": missing,
        "predicted": {p: pred[p] for p in phases},
        "measured": {p: measured[p] for p in phases},
        "predicted_total": float(cost["total"]),
        "measured_wall": measured_wall if measured_wall is not None
        else sum(measured.get(p, 0.0) for p in phases),
        "rho": rho,
    }


def calibration_report(cells: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble the full report: the per-cell list (each as produced by
    :func:`calibration_cell`) plus the per-family cross-strategy ordering
    check — predicted ``total`` vs measured wall, one ρ per family."""
    cells = list(cells)
    by_family: Dict[str, List[Dict[str, Any]]] = {}
    for c in cells:
        by_family.setdefault(c["family"], []).append(c)
    ordering: Dict[str, Any] = {}
    for family, cs in sorted(by_family.items()):
        if len(cs) < 2:
            continue
        ordering[family] = {
            "strategies": [c["strategy"] for c in cs],
            "predicted": [c["predicted_total"] for c in cs],
            "measured": [c["measured_wall"] for c in cs],
            "rho": spearman([c["predicted_total"] for c in cs],
                            [c["measured_wall"] for c in cs]),
        }
    return {"cells": cells, "ordering": ordering}


def format_report(report: Dict[str, Any]) -> str:
    """Render a calibration report as the fixed-width text block the
    bench prints and CI uploads."""
    lines = ["calibration: predicted vs measured phase costs (Spearman ρ)",
             f"{'family':<10}{'strategy':<10}{'topology':<10}"
             f"{'ρ(phases)':>10}  top phase (pred → meas)"]
    for c in report["cells"]:
        pred, meas = c["predicted"], c["measured"]
        top_p = max(pred, key=pred.get) if pred else "-"
        top_m = max(meas, key=meas.get) if meas else "-"
        rho = c["rho"]
        rho_s = f"{rho:+.2f}" if not math.isnan(rho) else "  nan"
        lines.append(f"{c['family']:<10}{c['strategy']:<10}"
                     f"{c['topology']:<10}{rho_s:>10}  "
                     f"{top_p} → {top_m}"
                     f"{'' if top_p == top_m else '  (!)'}")
    if report["ordering"]:
        lines.append("cross-strategy ordering (predicted total vs measured "
                     "wall):")
        for family, o in report["ordering"].items():
            rho = o["rho"]
            rho_s = f"{rho:+.2f}" if not math.isnan(rho) else "nan"
            pairs = ", ".join(
                f"{s}={w * 1e3:.1f}ms"
                for s, w in zip(o["strategies"], o["measured"]))
            lines.append(f"  {family:<10} ρ={rho_s}  ({pairs})")
    return "\n".join(lines)
