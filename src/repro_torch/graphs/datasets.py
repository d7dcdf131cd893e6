"""Synthetic stand-ins for the paper's Table-2 datasets.

A numpy-only copy of ``repro.graphs.datasets``, kept in the port so that
it needs nothing of the JAX package; for a given seed both give identical
edge lists. Each Table-2 graph is regenerated with **matched statistics**
(node count, directed-edge count, average degree, degree std-dev) from a
family-appropriate generator:

* ``road``    — 2D lattice with random edge dropout (r-TX: avg 2.78, std 1.0)
* ``uniform`` — Erdős–Rényi-with-multiplicity (low-skew graphs)
* ``rmat``    — R-MAT with skew tuned to the target degree std (scale-free)
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.adaptive import GraphFeatures


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    abbrev: str
    edges: int        # undirected edge count as listed in Table 2
    nodes: int
    avg_deg: float    # = 2*edges/nodes (directed nnz / nodes)
    deg_std: float
    family: str       # road | uniform | rmat
    paper_class: str  # regular | scale_free (paper §4.2.1 classes)


# Paper Table 2 (13 representative graphs). paper_class follows §4.2.1:
# road networks & low-variance graphs → regular (switch 20%); web/social/
# p2p/citation (skewed) → scale-free (switch 50%).
TABLE2: dict[str, GraphSpec] = {s.abbrev: s for s in [
    GraphSpec("amazon0302", "A302", 899792, 262111, 6.86, 5.41, "uniform", "regular"),
    GraphSpec("as20000102", "as00", 12572, 6474, 3.88, 24.99, "rmat", "scale_free"),
    GraphSpec("ca-GrQc", "ca-Q", 14484, 5242, 5.52, 7.91, "rmat", "scale_free"),
    GraphSpec("cit-HepPh", "cit-HP", 420877, 34546, 24.36, 30.87, "rmat", "scale_free"),
    GraphSpec("email-Enron", "e-En", 183831, 36692, 10.02, 36.1, "rmat", "scale_free"),
    GraphSpec("facebook_combined", "face", 88234, 4039, 43.69, 52.41, "rmat", "scale_free"),
    GraphSpec("graph500-scale18", "g-18", 3800348, 174147, 43.64, 229.92, "rmat", "scale_free"),
    GraphSpec("loc-brightkite_edges", "loc-b", 214078, 58228, 7.35, 20.35, "rmat", "scale_free"),
    GraphSpec("p2p-Gnutella24", "p2p-24", 65369, 26518, 4.93, 5.91, "uniform", "regular"),
    GraphSpec("roadNet-TX", "r-TX", 1541898, 1088092, 2.78, 1.0, "road", "regular"),
    GraphSpec("soc-Slashdot0902", "s-S02", 504230, 82168, 12.27, 41.07, "rmat", "scale_free"),
    GraphSpec("soc-Slashdot0811", "s-S11", 469180, 77360, 12.12, 40.45, "rmat", "scale_free"),
    GraphSpec("flickrEdges", "flk-E", 2316948, 105938, 43.74, 115.58, "rmat", "scale_free"),
]}


@dataclasses.dataclass
class Graph:
    """Directed edge list (both directions present for undirected sources)."""

    rows: np.ndarray
    cols: np.ndarray
    n: int
    name: str = "synthetic"

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.n)

    def features(self) -> GraphFeatures:
        return GraphFeatures.from_degrees(self.out_degrees())

    def fingerprint(self) -> str:
        """Content hash of the edge structure, computed once per instance
        and memoized (the serving layer builds a cache key from it on
        every submit — rehashing full edge arrays there was the hot-path
        cost). Graphs are immutable snapshots by convention (enforced
        nowhere, relied on everywhere): edit edges by building a new
        Graph — e.g. graphs/dynamic.py applying an EdgeDelta — never in
        place after the first fingerprint call."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha1()
            h.update(np.int64(self.n).tobytes())
            h.update(np.ascontiguousarray(self.rows, np.int64).tobytes())
            h.update(np.ascontiguousarray(self.cols, np.int64).tobytes())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()[:16]
        return fp


def _dedup(rows: np.ndarray, cols: np.ndarray, n: int):
    keys = rows.astype(np.int64) * n + cols
    keys = np.unique(keys)
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def _symmetrize(rows, cols, n):
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    sel = r != c  # drop self loops
    return _dedup(r[sel], c[sel], n)


def road_graph(n: int, target_avg: float, seed: int = 0) -> Graph:
    """√n×√n 4-neighbour lattice with edge dropout → road-network-like:
    near-uniform low degrees (paper's 'regular' class)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    edges = np.concatenate([right, down])
    # undirected avg degree of full lattice ≈ 4; drop to hit target_avg
    keep = rng.random(edges.shape[0]) < min(1.0, target_avg / 4.0)
    edges = edges[keep]
    rows, cols = _symmetrize(edges[:, 0], edges[:, 1], n)
    return Graph(rows, cols, n, "road")


def uniform_graph(n: int, n_edges: int, seed: int = 0) -> Graph:
    """Erdős–Rényi-style uniform random graph (low degree variance)."""
    rng = np.random.default_rng(seed)
    m = int(n_edges * 1.05)
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    rows, cols = _symmetrize(r, c, n)
    return Graph(rows, cols, n, "uniform")


def rmat_graph(n: int, n_edges: int, skew: float = 0.57, seed: int = 0) -> Graph:
    """R-MAT: recursive quadrant sampling; ``skew`` = a-parameter
    (0.25 = uniform, 0.57 = graph500-grade heavy tail)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    a = skew
    rem = (1.0 - a) / 3.0
    b = c = rem
    m = int(n_edges * 1.2)
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for _ in range(scale):
        u = rng.random(m)
        quad_b = (u >= a) & (u < a + b)
        quad_c = (u >= a + b) & (u < a + b + c)
        quad_d = u >= a + b + c
        rows = rows * 2 + (quad_c | quad_d)
        cols = cols * 2 + (quad_b | quad_d)
    sel = (rows < n) & (cols < n)
    rows, cols = _symmetrize(rows[sel].astype(np.int32), cols[sel].astype(np.int32), n)
    return Graph(rows, cols, n, "rmat")


def generate(abbrev: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """Generate the synthetic stand-in for a Table-2 graph. ``scale`` < 1
    shrinks node/edge counts proportionally (CPU benches)."""
    spec = TABLE2[abbrev]
    n = max(64, int(spec.nodes * scale))
    e = max(64, int(spec.edges * scale))
    if spec.family == "road":
        g = road_graph(n, spec.avg_deg, seed)
    elif spec.family == "uniform":
        g = uniform_graph(n, e, seed)
    else:
        # Tune skew by target degree-variance class: heavier tails need
        # more concentrated quadrant probability.
        cv = spec.deg_std / spec.avg_deg
        skew = float(np.clip(0.45 + 0.035 * cv, 0.45, 0.75))
        g = rmat_graph(n, e, skew, seed)
    return dataclasses.replace(g, name=spec.abbrev)


def largest_component_source(g: Graph, seed: int = 0) -> int:
    """A source vertex with non-trivial reach (max out-degree node)."""
    return int(np.argmax(g.out_degrees()))
