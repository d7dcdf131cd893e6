"""Adjacency-matrix partitioning across PIM cores → mesh devices (paper §4.1.1).

PyTorch counterpart of ``repro.core.partition``. Three strategies, the
paper's Figure 3: row-wise (D block-rows, Load = all-gather of x, no
Merge), column-wise (D block-cols, Merge = ⊕-reduce) and 2D (an R×C grid,
x gathered along one mesh axis, the output ⊕-reduced along the other).

The planning half is numpy and a copy of the JAX package's:
``balanced_cuts``, the block-cyclic deal of the 2D ``balance="nnz"`` plan
(``_lpt_block_assign``, ``_joint_col_assign``, ``_order_from_blocks``),
:class:`PartitionPlan` with its vector layouts and shard/unshard helpers,
``plan_partition``, ``_split_edges`` and ``shard_vector``. Input chunk
``g = c*R + r`` of the canonical ``[D, n_in]`` block holds piece *r* of
padded column band *c*; output chunk ``g = r*C + c`` holds piece *c* of
padded row band *r*; for ``balance="rows"`` both are plain row-major
slices.

:func:`partition` builds every part with the port's ``core/formats.py``
builders at uniform sizes and stacks them into one container of the same
format whose tensors carry a leading device axis (``core/mesh.py``'s
``[D, ...]`` view) on the mesh's device. A stacked container's ``nnz`` is
a tuple of D ints, host metadata. BSR parts are built once: the slot
count is taken from the parts' stored tiles before any payload is made,
and each part's entries are written straight into the stacked payload, so
only one partition's tiles are ever on the card. :func:`shard_tensor` and
:func:`unshard_tensor` apply the plan's layouts to tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.device import resolve_device
from repro_torch.core.formats import PaddedBSR
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor

BALANCES = ("rows", "nnz")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def balanced_cuts(weights: np.ndarray, parts: int) -> np.ndarray:
    """Contiguous prefix-sum cuts: boundaries [parts+1] over ``len(weights)``
    indices such that every band's total weight is as close as possible to
    ``sum/parts`` (each cut is placed at the cumulative-weight point nearest
    its equal-share target).  All-zero weights fall back to equal-count
    bands.  Bands may be empty (a hub row heavier than the share leaves its
    neighbours nothing to take)."""
    m = int(weights.shape[0])
    if parts <= 1:
        return np.array([0, m], dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(weights.astype(np.int64))])
    total = int(cum[-1])
    if total == 0:
        per = -(-m // parts)
        return np.minimum(np.arange(parts + 1, dtype=np.int64) * per, m)
    targets = total * np.arange(1, parts, dtype=np.float64) / parts
    hi = np.searchsorted(cum, targets)           # first idx with cum >= target
    lo = np.maximum(hi - 1, 0)
    cuts = np.where(np.abs(cum[lo] - targets) <= np.abs(cum[hi] - targets),
                    lo, hi)
    cuts = np.maximum.accumulate(np.minimum(cuts, m))
    return np.concatenate([[0], cuts, [m]]).astype(np.int64)


def _lpt_block_assign(weights: np.ndarray, parts: int, bs: int) -> np.ndarray:
    """Deal fixed-size index blocks to ``parts`` bands, heaviest block first
    to the least-loaded band, with an equal block-count cap per band (the
    load-ranked block-cyclic deal).  Returns block → band."""
    bw = np.add.reduceat(weights, np.arange(0, weights.shape[0], bs))
    assign = np.zeros(bw.shape[0], np.int64)
    loads = np.zeros(parts, np.float64)
    counts = np.zeros(parts, np.int64)
    cap = -(-bw.shape[0] // parts)
    for b in np.argsort(-bw, kind="stable"):
        open_bands = np.nonzero(counts < cap)[0]
        k = open_bands[np.argmin(loads[open_bands])]
        assign[b] = k
        loads[k] += bw[b]
        counts[k] += 1
    return assign


def _joint_col_assign(row_band: np.ndarray, rows: np.ndarray,
                      cols: np.ndarray, n: int, r_parts: int, c_parts: int,
                      bs: int) -> np.ndarray:
    """Column-block deal for the 2D grid, aware of the row deal: assign each
    column block (heaviest first, equal block-count cap) to the column band
    that minimises the running max *tile* nnz.  Returns block → band."""
    nbc = -(-n // bs)
    cnt = np.zeros((nbc, r_parts), np.int64)   # per (col block, row band)
    if rows.size:
        np.add.at(cnt, (cols // bs, row_band[rows]), 1)
    assign = np.zeros(nbc, np.int64)
    tiles = np.zeros((r_parts, c_parts), np.int64)
    counts = np.zeros(c_parts, np.int64)
    cap = -(-nbc // c_parts)
    for b in np.argsort(-cnt.sum(axis=1), kind="stable"):
        best_v, best_c = None, 0
        for c in range(c_parts):
            if counts[c] >= cap:
                continue
            v = max(int(tiles.max()), int((tiles[:, c] + cnt[b]).max()))
            if best_v is None or v < best_v:
                best_v, best_c = v, c
        assign[b] = best_c
        tiles[:, best_c] += cnt[b]
        counts[best_c] += 1
    return assign


def _order_from_blocks(assign: np.ndarray, m: int, bs: int, parts: int):
    """Block → band assignment → (order, starts): the permuted index
    sequence (band-major, blocks in original order within a band) and the
    contiguous band boundaries in permuted space."""
    order, lens = [], []
    for k in range(parts):
        blks = np.nonzero(assign == k)[0]
        seq = [np.arange(b * bs, min((b + 1) * bs, m)) for b in blks]
        cat = np.concatenate(seq) if seq else np.zeros(0, np.int64)
        order.append(cat)
        lens.append(cat.shape[0])
    return (np.concatenate(order).astype(np.int64),
            np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionPlan:
    """Where one logical (m, n) sparse matrix is cut for an (R, C) grid.

    ``row_starts``/``col_starts`` are the band boundaries (length R+1 /
    C+1) in *plan space* — original index space unless a
    ``row_order``/``col_order`` permutation is present (the 2D block-cyclic
    deal), in which case position ``p`` holds original index ``order[p]``.
    ``local_shape`` is the uniform padded per-device tile shape every band
    is placed into.  ``tile_nnz`` is the per-device nnz (row-major over the
    grid) — the planner's load-balance ground truth.
    """

    grid: Tuple[int, int]
    balance: str
    shape: Tuple[int, int]            # original (caller-padded) global shape
    row_starts: Tuple[int, ...]       # R+1 boundaries in [0, m] (plan space)
    col_starts: Tuple[int, ...]       # C+1 boundaries in [0, n] (plan space)
    local_shape: Tuple[int, int]      # uniform padded per-device tile shape
    tile_nnz: Tuple[int, ...]         # per-device nnz, row-major over grid
    row_order: np.ndarray | None = None   # [m] position → original row
    col_order: np.ndarray | None = None   # [n] position → original col

    @property
    def n_devices(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def padded_shape(self) -> Tuple[int, int]:
        r, c = self.grid
        return (self.local_shape[0] * r, self.local_shape[1] * c)

    @property
    def in_per(self) -> int:
        """Canonical input-chunk length: D chunks cover C padded col bands.
        The padded width must divide by D — balance="nnz" plans guarantee it
        by rounding, balance="rows" plans inherit the legacy contract that
        the caller pads the global shape (a non-divisible width errors here
        loudly, exactly where the old bare reshape used to)."""
        total = self.local_shape[1] * self.grid[1]
        if total % self.n_devices:
            raise ValueError(
                f"padded width {total} not divisible by {self.n_devices} "
                f"devices; pad the global shape (shape={self.shape}, "
                f"grid={self.grid})")
        return total // self.n_devices

    @property
    def out_per(self) -> int:
        """Canonical output-chunk length: D chunks cover R padded row bands
        (same divisibility contract as :attr:`in_per`)."""
        total = self.local_shape[0] * self.grid[0]
        if total % self.n_devices:
            raise ValueError(
                f"padded height {total} not divisible by {self.n_devices} "
                f"devices; pad the global shape (shape={self.shape}, "
                f"grid={self.grid})")
        return total // self.n_devices

    def imbalance(self) -> float:
        """max over devices of nnz / (total nnz / D); 1.0 = perfect."""
        total = sum(self.tile_nnz)
        if total == 0:
            return 1.0
        return max(self.tile_nnz) / (total / self.n_devices)

    def _rank_cached(self, axis: str, idx: np.ndarray) -> np.ndarray:
        """Original indices → plan-space positions, with the O(n) inverse
        permutation of a block-cyclic axis built once and memoized on the
        (immutable) plan — tiles_of/apply_delta stay O(|edges|) per call
        instead of paying a full-axis scatter every delta."""
        order = self.row_order if axis == "row" else self.col_order
        if order is None:
            return idx
        attr = f"_{axis}_rank"
        rank = self.__dict__.get(attr)
        if rank is None:
            m = self.shape[0] if axis == "row" else self.shape[1]
            rank = np.empty(m, np.int64)
            rank[order] = np.arange(m, dtype=np.int64)
            object.__setattr__(self, attr, rank)
        return rank[idx]

    def tiles_of(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Device tile id (row-major over the grid) of each edge under
        this plan's cuts — O(|edges| · log bands), no global recount."""
        r_parts, c_parts = self.grid
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        tr = np.searchsorted(np.asarray(self.row_starts),
                             self._rank_cached("row", rows),
                             side="right") - 1
        tc = np.searchsorted(np.asarray(self.col_starts),
                             self._rank_cached("col", cols),
                             side="right") - 1
        return tr * c_parts + tc

    def apply_delta(self, ins_rows: np.ndarray, ins_cols: np.ndarray,
                    del_rows: np.ndarray, del_cols: np.ndarray
                    ) -> "PartitionPlan":
        """Incremental plan repair: the band cuts stay, only the per-tile
        nnz book-keeping is patched — and only for the tiles the delta's
        edges actually land in, costing O(|delta|) instead of the O(nnz)
        global recount a fresh plan pays. The caller passes the
        *effective* delta (edges that actually appeared/disappeared, see
        core.delta.edge_diff); a delete for an edge the plan never
        counted would drive a tile negative and asserts loudly.

        Repeated deltas drift the cuts away from the degree histogram
        they were optimized for; graphs/cost_model.py:repair_choice
        watches ``imbalance()`` on the patched plan and triggers a full
        replan when it drifts past threshold."""
        counts = np.asarray(self.tile_nnz, np.int64).copy()
        n_tiles = counts.shape[0]
        if len(ins_rows):
            counts += np.bincount(self.tiles_of(ins_rows, ins_cols),
                                  minlength=n_tiles)
        if len(del_rows):
            counts -= np.bincount(self.tiles_of(del_rows, del_cols),
                                  minlength=n_tiles)
        assert counts.min(initial=0) >= 0, (
            "plan delta deletes edges the plan never counted — pass the "
            "effective delta (core.delta.edge_diff)")
        patched = dataclasses.replace(
            self, tile_nnz=tuple(int(v) for v in counts))
        # carry the memoized inverse permutations (orders are shared and
        # immutable) so a chain of repairs never re-pays the O(n) scatter
        for attr in ("_row_rank", "_col_rank"):
            if attr in self.__dict__:
                object.__setattr__(patched, attr, self.__dict__[attr])
        return patched

    # -- band → original-index maps ------------------------------------
    @staticmethod
    def _index_map(starts, order, bands: int, pieces: int, per: int):
        """[bands, pieces, per] original indices (-1 = padding) for a banded
        layout: band b, slot p holds plan-space position ``starts[b] + p``
        (mapped through ``order`` when the axis is permuted) while inside
        the band."""
        total = starts[-1]
        idx = np.full((bands, pieces * per), -1, dtype=np.int64)
        for b in range(bands):
            length = starts[b + 1] - starts[b]
            flat = np.arange(pieces * per, dtype=np.int64)
            ok = flat < length
            # clamp keeps empty bands in range; masked to -1 below anyway
            pos = np.minimum(starts[b] + np.minimum(flat, max(0, length - 1)),
                             max(0, total - 1))
            orig = pos if order is None else order[pos]
            idx[b] = np.where(ok, orig, -1)
        return idx.reshape(bands, pieces, per)

    def input_index(self) -> np.ndarray:
        """[D, in_per] original input-vector index per canonical slot
        (-1 = padding).  Chunk g = c*R + r ↦ piece r of column band c."""
        r_parts, c_parts = self.grid
        idx = self._index_map(self.col_starts, self.col_order, c_parts,
                              r_parts, self.in_per)
        # idx[c, r] → chunk c*R + r
        return idx.reshape(self.n_devices, self.in_per)

    def output_index(self) -> np.ndarray:
        """[D, out_per] original output index per canonical slot
        (-1 = padding).  Chunk g = r*C + c ↦ piece c of row band r."""
        r_parts, c_parts = self.grid
        idx = self._index_map(self.row_starts, self.row_order, r_parts,
                              c_parts, self.out_per)
        return idx.reshape(self.n_devices, self.out_per)

    # -- vector / row-block sharding -----------------------------------
    def shard_input_vector(self, x: np.ndarray, fill=0) -> np.ndarray:
        """Global [n] input vector → canonical [D, in_per] block (numpy).
        ``fill`` must be the semiring zero (+inf for min_plus)."""
        idx = self.input_index()
        ok = idx >= 0
        out = np.full(idx.shape, fill, dtype=np.asarray(x).dtype)
        out[ok] = np.asarray(x)[idx[ok]]
        return out

    def shard_input_batch(self, xs: np.ndarray, fill=0) -> np.ndarray:
        """[B, n] input block → [D, B, in_per] (the batched-matvec layout)."""
        idx = self.input_index()
        ok = idx >= 0
        b = np.asarray(xs).shape[0]
        out = np.full((idx.shape[0], b, idx.shape[1]), fill,
                      dtype=np.asarray(xs).dtype)
        out[:, :, :] = np.where(ok[:, None, :],
                                np.asarray(xs)[:, np.maximum(idx, 0)
                                               ].transpose(1, 0, 2), fill)
        return out

    def shard_input_rows(self, b_mat: np.ndarray, fill=0) -> np.ndarray:
        """[k, N] row block (SpGEMM's B operand) → [D, in_per, N]."""
        idx = self.input_index()
        ok = idx >= 0
        bm = np.asarray(b_mat)
        out = np.full((idx.shape[0], idx.shape[1], bm.shape[1]), fill,
                      dtype=bm.dtype)
        out[ok] = bm[idx[ok]]
        return out

    def shard_output_vector(self, y: np.ndarray, fill=0) -> np.ndarray:
        """Global [m] vector → output-layout [D, out_per] (masks, tests)."""
        idx = self.output_index()
        ok = idx >= 0
        out = np.full(idx.shape, fill, dtype=np.asarray(y).dtype)
        out[ok] = np.asarray(y)[idx[ok]]
        return out

    def shard_output_rows(self, mat: np.ndarray, fill=0) -> np.ndarray:
        """[m, N] row block in output layout → [D, out_per, N] (SpGEMM
        masks live in this layout)."""
        idx = self.output_index()
        ok = idx >= 0
        mm = np.asarray(mat)
        out = np.full((idx.shape[0], idx.shape[1], mm.shape[1]), fill,
                      dtype=mm.dtype)
        out[ok] = mm[idx[ok]]
        return out

    def unshard_output_vector(self, ys: np.ndarray) -> np.ndarray:
        """Canonical [D, out_per] result block → global [m] vector."""
        idx = self.output_index()
        ok = idx >= 0
        ys = np.asarray(ys).reshape(idx.shape)
        out = np.empty((self.shape[0],), dtype=ys.dtype)
        out[idx[ok]] = ys[ok]
        return out

    def unshard_output_batch(self, ys: np.ndarray) -> np.ndarray:
        """[D, B, out_per] batched result block → [B, m]."""
        idx = self.output_index()
        ok = idx >= 0
        ys = np.asarray(ys)
        out = np.empty((ys.shape[1], self.shape[0]), dtype=ys.dtype)
        out[:, idx[ok]] = ys.transpose(1, 0, 2)[:, ok]
        return out

    def unshard_output_rows(self, cs: np.ndarray) -> np.ndarray:
        """[D, out_per, N] result rows (SpGEMM C) → [m, N]."""
        idx = self.output_index()
        ok = idx >= 0
        cs = np.asarray(cs)
        out = np.empty((self.shape[0], cs.shape[2]), dtype=cs.dtype)
        out[idx[ok]] = cs[ok]
        return out


def _rank(order: np.ndarray | None, idx: np.ndarray, m: int) -> np.ndarray:
    """Original indices → plan-space positions under ``order`` (identity
    when the axis is unpermuted)."""
    if order is None:
        return idx
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m, dtype=np.int64)
    return rank[idx]


def plan_partition(rows: np.ndarray, cols: np.ndarray,
                   shape: Tuple[int, int], grid: Tuple[int, int],
                   balance: str = "rows") -> PartitionPlan:
    """Compute a :class:`PartitionPlan` for one edge list.

    ``balance="rows"`` reproduces the legacy equal-count tiles exactly
    (ceil-divided band sizes, no extra padding).  ``balance="nnz"`` cuts
    each split axis at the degree-histogram prefix-sum equal-share points
    (1D grids), or deals index blocks to bands load-ranked block-cyclically
    on both axes (true 2D grids — see the module docstring), and pads every
    band to the max band extent, rounded up so the distributed collectives
    stay shape-compatible: the row extent to a multiple of 8·C (the
    Retrieve+Merge ⊕-reduce-scatter over the column axis splits it C ways —
    8·C also covers the flat-axis scatter of the column strategy where
    C = D), the col extent to a multiple of 8·R (the Load all-gather over
    the row axis assembles it from R pieces; with R = D this also keeps the
    canonical input chunking divisible).
    """
    m, n = shape
    r_parts, c_parts = grid
    if balance not in BALANCES:
        raise ValueError(f"balance must be one of {BALANCES}, got {balance!r}")
    row_order = col_order = None
    if balance == "rows":
        m_per = -(-m // r_parts)
        n_per = -(-n // c_parts)
        row_starts = np.minimum(np.arange(r_parts + 1, dtype=np.int64) * m_per, m)
        col_starts = np.minimum(np.arange(c_parts + 1, dtype=np.int64) * n_per, n)
        local_shape = (m_per, n_per)
    else:
        row_w = (np.bincount(rows, minlength=m) if rows.size
                 else np.zeros(m, np.int64))
        col_w = (np.bincount(cols, minlength=n) if cols.size
                 else np.zeros(n, np.int64))
        if r_parts > 1 and c_parts > 1 and rows.size:
            # 2D: joint tile loads, not marginals — block-cyclic deal.
            bs_r = max(8, -(-m // (r_parts * 16)))
            bs_c = max(8, -(-n // (c_parts * 16)))
            r_assign = _lpt_block_assign(row_w, r_parts, bs_r)
            row_band = np.repeat(r_assign, bs_r)[:m]
            c_assign = _joint_col_assign(row_band, rows, cols, n,
                                         r_parts, c_parts, bs_c)
            row_order, row_starts = _order_from_blocks(r_assign, m, bs_r, r_parts)
            col_order, col_starts = _order_from_blocks(c_assign, n, bs_c, c_parts)
        else:
            row_starts = balanced_cuts(row_w, r_parts)
            col_starts = balanced_cuts(col_w, c_parts)
        m_loc = _round_up(max(1, int(np.diff(row_starts).max())), 8 * c_parts)
        n_loc = _round_up(max(1, int(np.diff(col_starts).max())), 8 * r_parts)
        local_shape = (m_loc, n_loc)
    if rows.size:
        tr = np.searchsorted(row_starts, _rank(row_order, rows, m),
                             side="right") - 1
        tc = np.searchsorted(col_starts, _rank(col_order, cols, n),
                             side="right") - 1
        tile_nnz = np.bincount(tr * c_parts + tc, minlength=r_parts * c_parts)
    else:
        tile_nnz = np.zeros(r_parts * c_parts, np.int64)
    return PartitionPlan(
        grid=grid, balance=balance, shape=(int(m), int(n)),
        row_starts=tuple(int(v) for v in row_starts),
        col_starts=tuple(int(v) for v in col_starts),
        local_shape=local_shape,
        tile_nnz=tuple(int(v) for v in tile_nnz),
        row_order=row_order,
        col_order=col_order,
    )


@dataclasses.dataclass(frozen=True)
class PartitionedMatrix:
    """Stacked per-device partitions of one logical sparse matrix.

    Every tensor of ``parts`` has a leading device axis of size R*C
    (row-major over the grid); ``grid=(R, 1)`` is row-wise, ``(1, C)``
    column-wise. ``plan`` is the :class:`PartitionPlan` that produced the
    tiles and owns the vector-layout helpers.
    """

    parts: object  # stacked COO/CSR/CSC/PaddedBSR, leading axis D
    grid: Tuple[int, int]
    shape: Tuple[int, int]          # global (padded) shape
    local_shape: Tuple[int, int]    # per-device tile shape
    fmt: str
    plan: PartitionPlan | None = None

    @property
    def n_devices(self) -> int:
        return self.grid[0] * self.grid[1]

    def stored_bytes(self) -> int:
        """Bytes of every stacked tensor."""
        return sum(t.numel() * t.element_size() for t in _tensors(self.parts))


def _tensors(parts) -> list:
    return [v for f in dataclasses.fields(parts)
            for v in [getattr(parts, f.name)] if isinstance(v, Tensor)]


def device_part(parts, g: int):
    """One device's container from a stacked one: each tensor's slice g (a
    contiguous view) and, for the element formats, that part's ``nnz``."""
    kw = {}
    for f in dataclasses.fields(parts):
        v = getattr(parts, f.name)
        if isinstance(v, Tensor):
            kw[f.name] = v[g]
        elif f.name == "nnz":
            kw[f.name] = v[g]
    return dataclasses.replace(parts, **kw)


def _split_edges(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 plan: PartitionPlan):
    """Assign each edge to its plan band; return per-tile localized edges
    (local coordinates are plan-space positions within the band)."""
    r_parts, c_parts = plan.grid
    row_starts = np.asarray(plan.row_starts)
    col_starts = np.asarray(plan.col_starts)
    pos_r = _rank(plan.row_order, rows, plan.shape[0])
    pos_c = _rank(plan.col_order, cols, plan.shape[1])
    tr = np.searchsorted(row_starts, pos_r, side="right") - 1
    tc = np.searchsorted(col_starts, pos_c, side="right") - 1
    tid = tr * c_parts + tc
    out = []
    for d in range(r_parts * c_parts):
        sel = tid == d
        r_off = row_starts[d // c_parts]
        c_off = col_starts[d % c_parts]
        out.append((pos_r[sel] - r_off, pos_c[sel] - c_off, vals[sel]))
    return out


def _stack(built: list, **static):
    """One container of the parts' format, each tensor stacked over a new
    leading device axis; ``nnz`` becomes a tuple of the parts' counts."""
    first = built[0]
    kw = dict(static)
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, Tensor):
            kw[f.name] = torch.stack([getattr(b, f.name) for b in built])
        elif f.name == "nnz":
            kw[f.name] = tuple(int(b.nnz) for b in built)
    return dataclasses.replace(first, **kw)


def _stacked_bsr(per_tile, local_shape: Tuple[int, int], sr: Semiring,
                 block: Tuple[int, int], device, keep=None) -> PaddedBSR:
    """The parts as ``formats.build_bsr_padded`` builds each at the
    largest slot count any part needs, stacked: every part's stored
    elements are computed first (``formats._densify_tiles``, the tiles
    themselves never on the host), then written into one ⊕-identity
    payload [D, mb, slots, bm, bn]. With ``keep`` (a part's index) only
    that part's payload is made, [1, mb, slots, bm, bn], at the slot count
    of the whole stack (the other parts' tiles are counted, not
    densified)."""
    bm, bn = block
    m, n = local_shape
    mb, nb = -(-m // bm), -(-n // bn)

    def count(r, c):                     # stored tiles per block row
        return np.bincount(np.unique((r // bm) * nb + c // bn) // nb, minlength=mb)

    kept = per_tile if keep is None else [per_tile[keep]]
    ents = [formats._densify_tiles(r, c, v, local_shape, sr, block) for r, c, v in kept]
    counts = [np.bincount(e.keys // nb, minlength=mb) for e in ents]
    slots = max(max(1, int(c.max()) if c.size else 1)
                for c in (counts if keep is None else
                          [count(r.astype(np.int64), c.astype(np.int64)) for r, c, _ in per_tile]))
    d = len(ents)
    tile_cols = np.zeros((d, mb, slots), dtype=np.int32)
    tiles = torch.full((d, mb, slots, bm, bn), formats._background(sr), dtype=sr.dtype,
                       device=device)
    flat = tiles.view(-1)
    for g, (ent, cnt) in enumerate(zip(ents, counts)):
        trow, tcol = ent.keys // nb, ent.keys % nb
        row_start = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        slot = np.arange(ent.keys.shape[0], dtype=np.int64) - row_start[trow]
        tile_cols[g, trow, slot] = tcol
        where = ((g * mb + trow) * slots + slot)[ent.tile] * (bm * bn) + ent.offset
        flat[torch.from_numpy(where).to(device)] = torch.from_numpy(ent.value).to(device)
    return PaddedBSR(tiles=tiles, tile_cols=torch.from_numpy(tile_cols).to(device),
                     shape=(mb * bm, nb * bn), block=block)


def partition(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              shape: Tuple[int, int], grid: Tuple[int, int], fmt: str,
              sr: Semiring, block: Tuple[int, int] = (128, 128),
              balance: str = "rows",
              plan: PartitionPlan | None = None, device=None,
              part: int | None = None) -> PartitionedMatrix:
    """Partition + convert each tile to ``fmt`` with uniform padded sizes,
    stacked on ``device`` (the card unless named).

    ``balance`` picks the plan's cut mode (see module docstring); passing a
    prebuilt ``plan`` (e.g. the cost-model planner's choice) overrides it.

    ``part`` (a flat device id) keeps that device's part alone, stacked as
    ``[1, ...]``: one rank's part on a ``RankMesh``. Its padded sizes are
    the whole stack's (the other parts are sized on the host, never made
    on the device), and the plan, grid and shapes stay global.
    """
    device = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if plan is None:
        plan = plan_partition(rows, cols, shape, grid, balance)
    elif plan.grid != tuple(grid) or plan.shape != tuple(shape):
        raise ValueError(f"plan {plan.grid}/{plan.shape} != requested {grid}/{tuple(shape)}")
    per_tile = _split_edges(rows, cols, vals, plan)
    local_shape = plan.local_shape
    nnz_max = max(1, max(r.shape[0] for r, _, _ in per_tile))
    nnz_max = ((nnz_max + 7) // 8) * 8

    if part is not None and not 0 <= part < len(per_tile):
        raise ValueError(f"part {part} of a {len(per_tile)}-device partition")
    if fmt == "bsr":
        stacked = _stacked_bsr(per_tile, local_shape, sr, block, device, keep=part)
        local_shape = stacked.shape                    # padded up to block multiple
        plan = dataclasses.replace(plan, local_shape=local_shape)
    elif fmt in ("coo", "csr", "csc"):
        build = {"coo": formats.build_coo, "csr": formats.build_csr,
                 "csc": formats.build_csc}[fmt]
        # with ``part``, the other parts are built on the host for their sizes
        built = [build(r, c, v, local_shape, sr, nnz_max,
                       device if part is None or g == part else "cpu")
                 for g, (r, c, v) in enumerate(per_tile)]
        static = {}
        if fmt == "csc":
            # one max_col_nnz for every part, as the JAX package's shard_map needs
            static["max_col_nnz"] = max(b.max_col_nnz for b in built)
        stacked = _stack(built if part is None else [built[part]], **static)
    else:
        raise ValueError(fmt)
    r_parts, c_parts = grid
    return PartitionedMatrix(
        parts=stacked,
        grid=tuple(grid),
        shape=(local_shape[0] * r_parts, local_shape[1] * c_parts),
        local_shape=local_shape,
        fmt=fmt,
        plan=plan,
    )


def _tile_edges(tile, fmt: str, sr: Semiring):
    """Extract one tile's true (rows, cols, vals) from its format container."""
    if fmt == "coo":
        k = int(tile.nnz)
        return (tile.rows[:k].cpu().numpy(), tile.cols[:k].cpu().numpy(),
                tile.vals[:k].cpu().numpy())
    if fmt == "csr":
        k = int(tile.nnz)
        return (tile.seg_ids[:k].cpu().numpy(), tile.cols[:k].cpu().numpy(),
                tile.vals[:k].cpu().numpy())
    if fmt == "csc":
        k = int(tile.nnz)
        col_ptr = tile.col_ptr.cpu().numpy()
        cols = np.repeat(np.arange(col_ptr.shape[0] - 1), np.diff(col_ptr))[:k]
        return tile.rows[:k].cpu().numpy(), cols, tile.vals[:k].cpu().numpy()
    if fmt == "bsr":
        # PaddedBSR stores dense tiles: structural nonzeros are the entries
        # that differ from the ⊕-identity background (true zero-valued
        # edges are not representable, as in the builders).
        tiles = tile.tiles.cpu().numpy()                # [mb, T, bm, bn]
        tile_cols = tile.tile_cols.cpu().numpy()        # [mb, T]
        bm, bn = tile.block
        i, j, lr, lc = np.nonzero(tiles != formats._background(sr))
        return (i * bm + lr, tile_cols[i, j].astype(np.int64) * bn + lc,
                tiles[i, j, lr, lc])
    raise ValueError(fmt)


def unpartition(pm: PartitionedMatrix, sr: Semiring):
    """Invert :func:`partition`: recover the global (rows, cols, vals) edge
    list from the per-device tiles, sorted by (row, col). With the plan's
    band offsets this is exact: partition → unpartition is the identity on
    any duplicate-free edge list."""
    plan = pm.plan
    if plan is None:
        raise ValueError("unpartition needs a PartitionedMatrix with a plan")
    r_parts, c_parts = plan.grid
    rr, cc, vv = [], [], []
    for d in range(pm.n_devices):
        r, c, v = _tile_edges(device_part(pm.parts, d), pm.fmt, sr)
        pos_r = np.asarray(r, np.int64) + plan.row_starts[d // c_parts]
        pos_c = np.asarray(c, np.int64) + plan.col_starts[d % c_parts]
        rr.append(pos_r if plan.row_order is None else plan.row_order[pos_r])
        cc.append(pos_c if plan.col_order is None else plan.col_order[pos_c])
        vv.append(v)
    rows = np.concatenate(rr) if rr else np.zeros(0, np.int64)
    cols = np.concatenate(cc) if cc else np.zeros(0, np.int64)
    vals = np.concatenate(vv) if vv else np.zeros(0)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def shard_vector(x: np.ndarray, n_parts: int, fill=0) -> np.ndarray:
    """Pad + reshape a global vector into [n_parts, n_per] for shard_map.
    ``fill`` must be the semiring zero (+inf for min_plus).  Legacy helper
    for uniform (balance="rows") layouts; plan-aware callers use
    :meth:`PartitionPlan.shard_input_vector`."""
    n_per = -(-x.shape[0] // n_parts)
    pad = n_parts * n_per - x.shape[0]
    xp = np.pad(x, (0, pad), constant_values=fill)
    return xp.reshape(n_parts, n_per)


# ---------------------------------------------------------------------------
# The plan's layouts on tensors (on the device; the index maps are made on
# the host from the plan and copied over, nothing is read back)
# ---------------------------------------------------------------------------

def shard_tensor(plan: PartitionPlan, x: Tensor, fill, dim: int = 0,
                 side: str = "input") -> Tensor:
    """The index dim ``dim`` of ``x`` in the plan's canonical layout: a
    new leading device axis D, and ``dim`` becomes the chunk of that side
    (``in_per`` or ``out_per``). [n] → [D, in_per]; [B, n] with dim=1 →
    [D, B, in_per] (``shard_input_batch``); [k, N] → [D, in_per, N]
    (``shard_input_rows``); ``side="output"`` for output-layout operands
    such as SpGEMM masks. Padding slots hold ``fill`` (the semiring
    zero)."""
    idx_np = plan.input_index() if side == "input" else plan.output_index()
    d, per = idx_np.shape
    idx = torch.from_numpy(idx_np).to(x.device)
    t = torch.index_select(x, dim, idx.clamp(min=0).reshape(-1))
    t = t.unflatten(dim, (d, per)).movedim(dim, 0)     # [D, ..., per, ...]
    ok = (idx >= 0).view([d] + [per if i == dim else 1 for i in range(x.dim())])
    return torch.where(ok, t, torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def unshard_tensor(plan: PartitionPlan, ys: Tensor, dim: int = 0) -> Tensor:
    """Invert the output layout: ys [D, ..., out_per (at dim+1), ...] →
    [..., m (at dim), ...] in the original index order
    (``unshard_output_vector``/``_batch``/``_rows``)."""
    idx_np = plan.output_index()
    ok = idx_np >= 0
    d, per = idx_np.shape
    flat = ys.movedim(0, dim).flatten(dim, dim + 1)    # [..., D·per, ...]
    keep = torch.from_numpy(np.nonzero(ok.reshape(-1))[0]).to(ys.device)
    dest = torch.from_numpy(idx_np[ok]).to(ys.device)
    shape = list(flat.shape)
    shape[dim] = plan.shape[0]
    out = flat.new_empty(shape)
    return out.index_copy_(dim, dest, torch.index_select(flat, dim, keep))
