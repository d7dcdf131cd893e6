"""The pieces of the block launches of kernels 1 and 2 that the CPU can
check: the union operands of kernel 2 over a block
(``ops._spmspv_union_batch``) against the per-vector metas of
``ops._spmspv_meta_batch``, and the fold order of the shared-memory block
fold (``csrc/tile_fold.cuh``, ``tree_leaves``): the 32 lane leaves taken
in bit-reversed order onto a stack of at most five partials must give,
bit for bit, the value that ``warp_fold``'s xor butterfly leaves in lane
0, the value the single-vector kernels write. numpy float32, with -0.0,
subnormals and ±inf among the inputs; exact, since both sides make the
same roundings or the test fails."""
import numpy as np
import pytest
import torch

from repro_torch.core import SEMIRINGS, build_bsr_padded
from repro_torch.kernels import ops


def tall_matrix(seed=0, n=3000, block=(16, 16)):
    """A banded matrix of many block rows, so that a sparse frontier leaves
    most block rows with no active slot."""
    rng = np.random.default_rng(seed)
    nnz = 12000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = np.clip(rows + rng.integers(-20, 21, nnz), 0, n - 1).astype(np.int32)
    sr = SEMIRINGS["bool_or_and"]
    return build_bsr_padded(rows, cols, np.ones(nnz, np.int32), (n, n), sr, block=block,
                            device="cpu")


def union_members(union, t, g, i, k):
    """The union slots (and their tile-columns) whose mask bit k is set in
    group g's block row i, in union order."""
    n = int(union[g, i, 0])
    slots, cols = union[g, i, 1:1 + n], union[g, i, 1 + t:1 + t + n]
    bit = ((union[g, i, 1 + 2 * t:1 + 2 * t + n].long() & 0xFFFFFFFF) >> k) & 1
    return slots[bit.bool()], cols[bit.bool()]


@pytest.mark.parametrize("b", [1, 31, 32, 33, 64])
def test_union_lists_each_vectors_active_slots_in_its_order(b):
    """For every vector and block row, the union slots whose bit the vector
    has are its meta's active slots, in the meta's order, with the same
    tile-columns; row 0 is an empty frontier and most block rows have an
    empty union; n_union counts the slots some vector of the group needs."""
    a = tall_matrix()
    rng = np.random.default_rng(b)
    keep = torch.zeros((b, a.shape[1]), dtype=torch.bool)
    for v in range(1, b):
        # vertices in the first quarter only, off tile-column 0 (which pad
        # slots alias): the block rows far below have no active slot
        keep[v, rng.integers(16, a.shape[1] // 4, int(rng.integers(1, 6)))] = True
    meta = ops._spmspv_meta_batch(a, keep)
    union = ops._spmspv_union_batch(meta)
    mb, t = a.tile_cols.shape
    g = -(-b // 32)
    assert union.dtype == torch.int32 and tuple(union.shape) == (g, mb, 1 + 3 * t)
    for v in range(b):
        for i in range(mb):
            n = int(meta[v, i, 0])
            slots, cols = union_members(union, t, v // 32, i, v % 32)
            assert torch.equal(slots, meta[v, i, 1:1 + n]), (v, i)
            assert torch.equal(cols, meta[v, i, 1 + t:1 + t + n]), (v, i)
    for gi in range(g):
        needed = meta[32 * gi:32 * gi + 32, :, 0] > 0
        n_union = union[gi, :, 0]
        assert torch.equal(n_union == 0, ~needed.any(dim=0))
        slots = union[gi, :, 1:1 + t]
        for i in range(mb):
            got = slots[i, :int(n_union[i])]
            assert torch.equal(got, torch.sort(got).values)           # slot order
            want = set()
            for v in range(32 * gi, min(b, 32 * gi + 32)):
                want |= set(meta[v, i, 1:1 + int(meta[v, i, 0])].tolist())
            assert set(got.tolist()) == want
    if b > 1:
        assert int((union[:, :, 0] == 0).sum()) > g * mb // 2


def test_union_of_an_empty_block_and_a_full_frontier():
    """B = 0 gives an empty union; a frontier with every vertex live makes
    every slot of every block row a union slot whose mask has all the
    group's bits (bit 31 included)."""
    a = tall_matrix(n=400)
    mb, t = a.tile_cols.shape
    empty = ops._spmspv_union_batch(ops._spmspv_meta_batch(a, torch.zeros((0, a.shape[1]),
                                                                          dtype=torch.bool)))
    assert tuple(empty.shape) == (0, mb, 1 + 3 * t)
    meta = ops._spmspv_meta_batch(a, torch.ones((32, a.shape[1]), dtype=torch.bool))
    union = ops._spmspv_union_batch(meta)
    assert torch.equal(union[0, :, 0], torch.full((mb,), t, dtype=torch.int32))
    assert torch.equal(union[0, :, 1:1 + t], torch.arange(t, dtype=torch.int32).expand(mb, t))
    assert torch.equal(union[0, :, 1 + t:1 + 2 * t], a.tile_cols)
    assert bool((union[0, :, 1 + 2 * t:] == -1).all())


# ---------------------------------------------------------------------------
# The fold order: lane leaves, the butterfly, and the bit-reversed stack.

def plus(a, b):
    return np.float32(a) + np.float32(b)


def min_nan(a, b):
    """tile_fold.cuh's min_nan: a where a < b or a is NaN, else b."""
    return a if (a < b or a != a) else b


SEMI = {"plus": (plus, np.float32(0.0)), "min": (min_nan, np.float32(np.inf))}


def awkward(rng, size):
    """float32 values with -0.0, +0.0, subnormals, ±inf and ordinary
    numbers of both signs."""
    pool = np.array([-0.0, 0.0, 1e-45, -1e-45, 3e-39, -2e-39, np.inf, -np.inf],
                    dtype=np.float32)
    v = rng.standard_normal(size).astype(np.float32) * np.float32(4.0)
    pick = rng.random(size) < 0.35
    v[pick] = pool[rng.integers(0, pool.size, int(pick.sum()))]
    return v


def lane_leaves(a, x, add, zero, vec, times=True):
    """Lane l's partial in tile_fold_kernel: chunks l, l + 32, ... of vec
    elements each, folded element by element from the identity; ⊗ is the
    product (or the sum, for ⟨min,+⟩)."""
    n_chunks = a.size // vec
    leaves = []
    for lane in range(32):
        p = zero
        for c in range(lane, n_chunks, 32):
            for e in range(vec):
                i = c * vec + e
                p = add(p, np.float32(a[i] * x[i] if times else a[i] + x[i]))
        leaves.append(np.float32(p))
    return leaves


def butterfly_lane0(leaves, add):
    """warp_fold literally: at offsets 16, 8, 4, 2, 1 every lane sets
    v = add(v, v of lane ^ offset); lane 0's value at the end."""
    v = list(leaves)
    for off in (16, 8, 4, 2, 1):
        v = [add(v[lane], v[lane ^ off]) for lane in range(32)]
    return np.float32(v[0])


def bitrev5(q):
    return int(f"{q:05b}"[::-1], 2)


def stack_tree(leaves, add):
    """tree_leaves: leaf bitrev5(q) for q = 0..31 onto a binary-counter
    stack; st[k] holds the pending subtree of 2^k leaves, each combine
    add(earlier, later)."""
    st = [None] * 5
    for q in range(32):
        cur = leaves[bitrev5(q)]
        k = 0
        while q >> k & 1:
            cur = add(st[k], cur)
            k += 1
        if k == 5:
            return np.float32(cur)
        st[k] = cur
    raise AssertionError("32 leaves end with five combines")


@pytest.mark.parametrize("bn,vec", [(128, 4), (12, 4), (10, 1), (130, 1)])
@pytest.mark.parametrize("semi", list(SEMI))
def test_bit_reversed_stack_equals_the_butterfly(semi, bn, vec):
    add, zero = SEMI[semi]
    rng = np.random.default_rng(bn)
    with np.errstate(invalid="ignore", over="ignore"):
        for trial in range(60):
            a, x = awkward(rng, bn), awkward(rng, bn)
            leaves = lane_leaves(a, x, add, zero, vec)
            want = butterfly_lane0(leaves, add)
            got = stack_tree(leaves, add)
            assert got.view(np.uint32) == want.view(np.uint32), (trial, got, want)
        # leaves built to make the order show: a signed zero and a sum
        # that cancels only in the butterfly's pairing
        leaves = [np.float32(-0.0)] * 32
        leaves[0], leaves[16], leaves[1] = np.float32(1e8), np.float32(-1e8), np.float32(1.0)
        assert stack_tree(leaves, add).view(np.uint32) == \
            butterfly_lane0(leaves, add).view(np.uint32)


def min_canonical_nan(a, b):
    """min.NaN.f32 as the block fold's first pass for the min semirings
    uses it: the canonical NaN if either side is NaN, else the smaller; of
    two zeros of opposite sign either may come back (this one returns a)."""
    if a != a or b != b:
        return np.float32(np.nan)
    return a if a <= b else b


@pytest.mark.parametrize("bn,vec", [(128, 4), (12, 4), (10, 1), (130, 1)])
@pytest.mark.parametrize("mul", ["plus", "times"])
def test_min_first_pass_keeps_every_bit_it_vouches_for(mul, bn, vec):
    """The min semirings' first pass folds a slot's elements in any order
    with min.NaN; where its result is neither a zero nor NaN it equals
    the exact fold (lane leaves, butterfly tree) bit for bit, and the
    kernel recomputes the others. Inputs with ±0.0 minima, NaN, ±inf and
    subnormals, so both outcomes occur."""
    rng = np.random.default_rng(7 + bn)
    times = mul == "times"
    vouched = rechecked = 0
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(200):
            a = rng.standard_normal(bn).astype(np.float32)
            x = rng.standard_normal(bn).astype(np.float32)
            kind = rng.integers(4)
            if kind == 1:                           # a zero minimum, of either sign
                a, x = np.abs(a), np.abs(x)
                i = rng.integers(bn, size=3)
                a[i] = np.float32(-0.0) if times else -x[i]
                x[i[0]] = np.float32(0.0) if times else x[i[0]]
            elif kind == 2:
                a[rng.integers(bn)] = np.nan
            elif kind == 3:
                a[rng.integers(bn, size=2)] = [np.inf, -np.inf]
                x[rng.integers(bn, size=2)] = [-0.0, 3e-39]
            s = (a * x if times else a + x).astype(np.float32)
            exact = butterfly_lane0(lane_leaves(a, x, min_nan, np.float32(np.inf), vec,
                                                times=times), min_nan)
            fast = np.float32(np.inf)
            for v in s[rng.permutation(bn)]:                     # any order
                fast = min_canonical_nan(fast, v)
            if fast != fast or fast == 0:
                rechecked += 1
                continue
            vouched += 1
            assert fast.view(np.uint32) == exact.view(np.uint32)
    assert vouched > 20 and rechecked > 10, (vouched, rechecked)


def test_the_tree_is_not_a_left_fold():
    """The stack order matters: a left-to-right fold of the same leaves
    gives other bits under ⟨+,×⟩ (so the test above can fail)."""
    leaves = [np.float32(0.0)] * 32
    leaves[0], leaves[1], leaves[16] = np.float32(1e8), np.float32(1.0), np.float32(-1e8)
    left = np.float32(0.0)
    for v in leaves:
        left = plus(left, v)
    assert left != butterfly_lane0(leaves, plus)
    assert stack_tree(leaves, plus) == butterfly_lane0(leaves, plus)
