"""The list kernels' plan, made on the host (modem_tpu_torch.kernels.
scl_decode.list_tiers, sc_decode.pack_list_rows), and plain versions of
the kernel's two new selections held to the plain decoder's own: the
merge of the lanes' sorted lists by rank, and the least-reliable search
bounded by the row's width.  CPU only: the kernels run on the card
(tests/test_torch_card.py)."""

import numpy as np
import pytest
import torch

from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.fec.schedule import (C_D, C_LAST, C_OP, C_SIDR,
                                          C_SIDR2, C_SIDW, C_SUB, C_WIDTH,
                                          CHUNK, Schedule, _regions)
from modem_tpu_torch.kernels.sc_decode import (LIST_OFFSET_COLS,
                                               SMEM_BLOCK_MAX,
                                               SMEM_RESERVED, ScPlan,
                                               pack_list_rows, tiers_of)
from modem_tpu_torch.kernels.scl_decode import (BIG, LIST_BUDGET,
                                                LIST_STATIC_SHARED, _first,
                                                list_tiers, rank_count)
from modem_tpu_torch.numerology import MODES

CODES = {**{f"mode{m}": (s.cons_bits, s.crc_bits, s.code_order)
            for m, s in sorted(MODES.items())},
         "toy": (224, 144, 8), "chunked": (960, 480, 10),
         "narrow": (56, 36, 6), "n4096": (4032, 2304, 12)}
TIER_CASES = [(name, lsz, bc) for name in CODES for lsz in (2, 4, 8)
              for bc in (True, False)]


def _sched(name, emit_spc=True) -> Schedule:
    return ScPlan.from_frozen(PolarCode(*CODES[name]).frozen,
                              emit_spc=emit_spc).sched


@pytest.mark.parametrize("case", TIER_CASES, ids=str)
def test_list_tiers_fit_one_block(case):
    """Every lane's shared tier fits one block beside the static shared
    memory and the system's share, and one depth shallower would not;
    the global tier keeps the input's depth and the root codeword."""
    name, lsz, bc = case
    sched = _sched(name)
    t = list_tiers(sched, lsz, bc)
    assert t.lanes == lsz and t.beta_bytes == (1 if bc else 4)
    assert t.shared_bytes <= LIST_BUDGET
    assert t.shared_bytes + LIST_STATIC_SHARED + SMEM_RESERVED \
        <= SMEM_BLOCK_MAX
    assert t.shared_bytes == lsz * (4 * t.s_llr_len
                                    + t.beta_bytes * t.s_beta_len)
    assert t.shared_bytes % 16 == 0 and (4 * lsz * t.s_llr_len) % 16 == 0
    if t.depth > 1:
        assert tiers_of(sched, bc, t.depth - 1, lanes=lsz,
                        limit=1 << 40).shared_bytes > LIST_BUDGET
    assert t.llr_lo >= sched.d0_len
    assert sched.out_off + sched.code_len <= t.beta_lo
    lofs, bslot, sz_llr, sz_beta = _regions(sched.code_len)
    assert (t.llr_lo, t.beta_lo) == (
        (lofs[t.depth], bslot[t.depth, 0]) if t.depth < sched.n_depths
        else (sz_llr, sz_beta))


@pytest.mark.parametrize("lsz,bc,depth,nbytes,scratch", [
    (8, True, 8, 221184, 3645440), (4, True, 5, 196608, 1736704),
    (2, True, 4, 147456, 819200), (8, False, 13, 196608, 8585216)])
def test_wire_list_tiers(lsz, bc, depth, nbytes, scratch):
    """Mode 6: the depth, the shared bytes and the global scratch a frame
    (all lanes) of each instance."""
    sched = _sched("mode6")
    t = list_tiers(sched, lsz, bc)
    assert (t.depth, t.shared_bytes) == (depth, nbytes)
    assert lsz * (4 * t.g_llr_len + t.beta_bytes * t.g_beta_len) == scratch


def test_wire_rows_in_the_shared_tier():
    """At L = 8 with int8 betas 8,622 of mode 6's 10,252 rows lie wholly
    in the shared tier; of the forks only 12 SPC, 21 RATE1 and 3 REP rows
    (and 13 RATE0 leaves) touch the global tier."""
    from modem_tpu_torch.kernels.sc_decode import in_shared_tier
    sched = _sched("mode6")
    shared = in_shared_tier(sched.ops, list_tiers(sched, 8))
    assert int(shared.sum()) == 8622
    op = sched.ops[:, C_OP]
    assert [int(((op == k) & ~shared).sum()) for k in (3, 4, 5, 6)] == [
        13, 3, 21, 12]


def test_list_tiers_forced_depths():
    """Every depth from 1 to the depth count that fits the budget can be
    forced; one that does not, depth 0 and past the count are refused."""
    sched = _sched("n4096")
    for depth in range(1, sched.n_depths + 1):
        t = tiers_of(sched, True, depth, lanes=8, limit=1 << 40)
        if t.shared_bytes <= LIST_BUDGET:
            assert list_tiers(sched, 8, True, depth).depth == depth
        else:
            with pytest.raises(ValueError, match="shared memory"):
                list_tiers(sched, 8, True, depth)
    assert list_tiers(sched, 8, True, sched.n_depths).shared_bytes == 0
    for depth in (0, sched.n_depths + 1):
        with pytest.raises(ValueError):
            list_tiers(sched, 8, True, depth)


def test_kernel_a_tiers_unchanged_by_the_lane_count():
    """tiers_of at one lane is kernel A's, whatever the list kernels ask."""
    sched = _sched("mode6")
    assert tiers_of(sched) == tiers_of(sched, lanes=1)
    assert tiers_of(sched).shared_bytes == 49152


def unpack_list_rows(packed: np.ndarray, n_ops: int) -> np.ndarray:
    """pack_list_rows inverted, as the kernel's ListRow reads a row: the
    table [n_ops, 14] with SUB at 0."""
    q = np.ascontiguousarray(packed).view("<u4")[:n_ops].astype(np.int64)
    ops = np.zeros((n_ops, 14), dtype=np.int64)
    ops[:, list(LIST_OFFSET_COLS)] = q[:, :6]
    ops[:, C_OP] = q[:, 6] & 7
    ops[:, C_D] = (q[:, 6] >> 3) & 31
    ops[:, C_WIDTH] = (q[:, 6] >> 8) & 1023
    ops[:, C_LAST] = (q[:, 6] >> 18) & 1
    ops[:, C_SIDR] = q[:, 7] & 255
    ops[:, C_SIDR2] = (q[:, 7] >> 8) & 255
    ops[:, C_SIDW] = (q[:, 7] >> 16) & 255
    return ops


def _override_tables():
    ops = _sched("chunked").ops
    tables = {}
    for op in sorted(set(ops[:, C_OP].tolist())):
        sel = ops[ops[:, C_OP] == op]
        tables[f"op{op}"] = np.tile(sel, (64 // len(sel) + 1, 1))[:64]
    return tables


TABLES = _override_tables()
PACK_CASES = ([(name, True) for name in CODES]
              + [("chunked", False), ("mode6", False)])


@pytest.mark.parametrize("case", PACK_CASES, ids=str)
def test_packed_list_rows_unpack_to_the_schedule(case):
    """Every column the list kernels read survives the packing, 32 bytes
    a row, and one zero row follows the last."""
    ops = _sched(*case).ops
    packed = pack_list_rows(ops)
    assert packed.dtype == np.int32 and packed.shape == (len(ops) + 1, 8)
    got = unpack_list_rows(packed, len(ops))
    keep = [c for c in range(14) if c != C_SUB]
    assert np.array_equal(got[:, keep], ops[:, keep])
    assert not packed[len(ops):].any()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_packed_list_rows_of_override_tables(name):
    ops = TABLES[name]
    got = unpack_list_rows(pack_list_rows(ops), len(ops))
    keep = [c for c in range(14) if c != C_SUB]
    assert np.array_equal(got[:, keep], ops[:, keep])


def test_pack_list_rows_refuses_what_its_fields_cannot_hold():
    ops = _sched("toy").ops
    for col, bad in ((C_OP, 8), (C_D, 32), (C_WIDTH, 0), (C_WIDTH, 513),
                     (C_LAST, 2), (C_SIDW, 256), (LIST_OFFSET_COLS[0], -1)):
        table = ops.copy()
        table[3, col] = bad
        with pytest.raises(ValueError):
            pack_list_rows(table)


def test_mode6_list_table_is_328_kb():
    sched = _sched("mode6")
    assert pack_list_rows(sched.ops)[:sched.n_ops].nbytes == 328064


# -- the kernel's selections, as plain versions -------------------------------

def merge_rank(top_v: torch.Tensor) -> torch.Tensor:
    """The kernel's merge of the lanes' sorted lists: top_v [..., L, L],
    lane a's best L in (value, id) order with ids a * 128 + p -> the
    rank [..., L, L] of each entry in the union.  Entry (a, i) has i
    entries before it in its own list and, in lane b's, the entries at a
    smaller value or (b < a) an equal one, counted by the kernel's
    binary search: steps L/2 .. 1, then one more compare."""
    lsz = top_v.shape[-1]
    rank = torch.arange(lsz).expand_as(top_v).clone()
    for a in range(lsz):
        v = top_v[..., a, :]
        for b in range(lsz):
            if b == a:
                continue
            lst = top_v[..., b, :]

            def ahead(e):
                w = lst.gather(-1, e)
                return (w < v) | ((w == v) & (b < a))

            n = torch.zeros_like(v, dtype=torch.long)
            step = lsz // 2
            while step:
                n = n + step * ahead(n + step - 1).long()
                step //= 2
            n = n + ahead(n).long()
            rank[..., a, :] += n
    return rank


def _sorted_lists(rng, batch, lsz, kind):
    """[batch, L, L] per-lane sorted value lists: random, tie-heavy
    (values from a few levels), or with BIG and inf entries."""
    if kind == "random":
        v = rng.standard_normal((batch, lsz, lsz)).astype(np.float32)
    else:
        levels = np.array([0.0, 0.5, 1.0, BIG, np.inf], dtype=np.float32)
        if kind == "ties":
            levels = levels[:3]
        v = levels[rng.integers(0, len(levels), (batch, lsz, lsz))]
    return torch.from_numpy(np.sort(v, axis=-1))


@pytest.mark.parametrize("lsz", [2, 4, 8])
@pytest.mark.parametrize("kind", ["random", "ties", "big"])
def test_merge_by_rank_equals_rank_count(lsz, kind):
    """The binary-search merge ranks every entry as rank_count does over
    the L x L union with ids lane * 128 + position (the plain decoder's
    (value, index) order): a permutation, the same on ties, BIG and inf."""
    rng = np.random.default_rng(lsz)
    top = _sorted_lists(rng, 200, lsz, kind)
    ids = (torch.arange(lsz)[:, None] * 128
           + torch.arange(lsz)[None, :]).expand_as(top)
    want = rank_count(top.reshape(-1, lsz * lsz),
                      ids.reshape(-1, lsz * lsz)).reshape(top.shape)
    got = merge_rank(top)
    assert torch.equal(got, want)
    assert torch.equal(got.reshape(-1, lsz * lsz).sort(dim=-1).values,
                       torch.arange(lsz * lsz).expand(len(top), -1))


def least_reliable(a: np.ndarray, n: int):
    """The kernel's width-bounded search over one lane's leaf a [width]:
    (values [n], columns [n]) of the n least |a| in (value, column) order
    with the columns past the width at BIG.  At width <= 32 one column a
    lane and a rank count, the m columns at most BIG first, then BIG
    columns from 32 on; wider, n argmin rounds over ceil(width / 32)
    columns a lane, a round whose least is over BIG taking a BIG column
    past the scanned ones where the 512 have one."""
    width = len(a)
    big = np.float32(BIG)
    if width <= 32:
        mag = np.full(32, big, dtype=np.float32)
        mag[:width] = np.abs(a)
        order = sorted(range(32), key=lambda j: (mag[j], j))
        m = int((mag <= big).sum())
        vals, cols = [], []
        for r in range(n):
            j = order[r]
            vals.append(mag[j] if mag[j] <= big else big)
            cols.append(j if mag[j] <= big else 32 + r - m)
        return np.array(vals, dtype=np.float32), np.array(cols)
    slots = -(-width // 32)
    mag = np.full(32 * slots, big, dtype=np.float32)
    mag[:width] = np.abs(a)
    taken = np.zeros(32 * slots, dtype=bool)
    vals, cols = [], []
    for r in range(n):
        free = np.flatnonzero(~taken)
        j = free[np.lexsort((free, mag[free]))[0]]
        if mag[j] > big and 32 * slots < CHUNK:
            vals.append(big)
            cols.append(32 * slots + r)
        else:
            taken[j] = True
            vals.append(mag[j])
            cols.append(j)
    return np.array(vals, dtype=np.float32), np.array(cols)


WIDTHS = [1, 2, 3, 4, 7, 8, 9, 16, 25, 31, 32, 33, 63, 64, 65, 100, 127,
          128, 200, 255, 256, 257, 384, 500, 511, 512]


@pytest.mark.parametrize("kind", ["random", "ties", "inf", "mostly_inf"])
@pytest.mark.parametrize("width", WIDTHS)
def test_width_bounded_search_equals_first(width, kind):
    """The width-bounded search gives _first's values over the 512
    columns with those past the width at BIG, and its columns where they
    lie inside the width (past it any column >= width serves: the kernel
    never flips one), for n = 4, 7 and 8."""
    rng = np.random.default_rng(width)
    for i in range(20):
        if kind == "random":
            a = rng.standard_normal(width).astype(np.float32)
        elif kind == "ties":
            a = rng.choice(np.float32([-1, -0.5, 0.5, 1]), width)
        elif kind == "inf":
            a = rng.choice(np.float32([-np.inf, np.inf, 0.25, -2]), width)
        else:
            # fewer finite columns than the search takes, none at first
            a = rng.choice(np.float32([-np.inf, np.inf]), width)
            a[rng.choice(width, min(i % 4, width), replace=False)] = 0.5
        mag = torch.full((CHUNK,), BIG, dtype=torch.float32)
        mag[:width] = torch.from_numpy(np.abs(a))
        for n in (4, 7, 8):
            want_v, want_i = _first(mag, n)
            got_v, got_i = least_reliable(a, n)
            assert np.array_equal(got_v, want_v.numpy()), (n, a)
            inside = want_i.numpy() < width
            assert np.array_equal(got_i[inside], want_i.numpy()[inside])
            assert (got_i[~inside] >= width).all()


def test_host_constants_match_the_kernel():
    """The plan's limits are the kernel's: the static shared memory it
    asserts, the depths its maps hold, the row it unpacks."""
    import pathlib
    from modem_tpu_torch.kernels.sc_decode import LIST_ROW_WORDS
    from modem_tpu_torch.kernels.scl_decode import MAX_DEPTHS
    src = (pathlib.Path(__file__).resolve().parents[1] / "modem_tpu_torch"
           / "csrc" / "scl_decode.cu").read_text()
    assert f"constexpr int kStaticShared = {LIST_STATIC_SHARED};" in src
    assert f"constexpr int kMaxDepths = {MAX_DEPTHS};" in src
    assert LIST_ROW_WORDS * 4 == 32 and "uint4 a, b;" in src
