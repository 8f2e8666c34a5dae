"""Kernel A's plan, made on the host (modem_tpu_torch.kernels.sc_decode):
the packed row stream, the tiers of a frame's state and where the kernel
places its barriers, for the codes of all 8 modes, the toy codes, the
decomposed-SPC schedule and override tables.  CPU only: the kernel that
reads the plan runs on the card (tests/test_torch_card.py)."""

import numpy as np
import pytest

from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.fec.schedule import (C_BDST, C_BSRC, C_BSRC2, C_DST,
                                          C_OP, C_SRC, C_SRC2, C_WIDTH,
                                          OP_COMBINE, OP_F, OP_G, Schedule,
                                          _regions)
from modem_tpu_torch.kernels.sc_decode import (
    BLOCKS_PER_SM, FIELD_BITS, NARROW, PACKED_COLS, RUN_MAX, SHARED_BUDGET,
    SMEM_BLOCK_MAX, SMEM_PER_SM, SMEM_RESERVED, STATIC_SHARED, ScPlan,
    in_shared_tier, narrow_runs, pack_rows, tiers_of)
from modem_tpu_torch.numerology import MODES

KERNEL_COLS = (C_OP, C_WIDTH) + PACKED_COLS
CODES = {**{f"mode{m}": (s.cons_bits, s.crc_bits, s.code_order)
            for m, s in sorted(MODES.items())},
         "toy": (224, 144, 8), "chunked": (960, 480, 10),
         "narrow": (56, 36, 6), "n4096": (4032, 2304, 12)}


def unpack_rows(packed: np.ndarray, n_ops: int):
    """pack_rows inverted, as the kernel's PackedRow reads a row: (the
    table [n_ops, 14] with the packed columns filled and the others 0,
    RUN [n_ops])."""
    q = np.ascontiguousarray(packed).view("<u8")[:n_ops]
    lo, hi = q[:, 0].astype(np.int64), (q[:, 1] >> np.uint64(54)).astype(
        np.int64)
    mask = (1 << FIELD_BITS) - 1
    ops = np.zeros((n_ops, 14), dtype=np.int32)
    for k, col in enumerate(PACKED_COLS):
        word = lo if k < 3 else q[:, 1].astype(np.int64)
        ops[:, col] = (word >> (FIELD_BITS * (k % 3))) & mask
    ops[:, C_WIDTH] = (lo >> 54) & 0x3FF
    ops[:, C_OP] = hi & 7
    return ops, hi >> 3


def _sched(name, emit_spc=True) -> Schedule:
    return ScPlan.from_frozen(PolarCode(*CODES[name]).frozen,
                              emit_spc=emit_spc).sched


def _override_tables():
    """Override tables of the chunked code: 64 cycled rows of each opcode
    class, 300 of only narrow rows and 300 of only wide ones."""
    ops = _sched("chunked").ops
    tables = {}
    for op in sorted(set(ops[:, C_OP].tolist())):
        sel = ops[ops[:, C_OP] == op]
        tables[f"op{op}"] = np.tile(sel, (64 // len(sel) + 1, 1))[:64]
    for kind, keep in (("narrow", ops[:, C_WIDTH] <= NARROW),
                       ("wide", ops[:, C_WIDTH] > NARROW)):
        tables[kind] = np.tile(ops[keep], (300 // keep.sum() + 1, 1))[:300]
    return tables


TABLES = _override_tables()
CASES = ([(name, True) for name in CODES] + [("chunked", False),
                                              ("mode6", False)])


def _table(case):
    name, emit_spc = case
    return _sched(name, emit_spc).ops


def _tiers(ops_or_sched, code_len=None):
    """The default int8 tiers of a schedule or of a table of code_len."""
    if code_len is None:
        return tiers_of(ops_or_sched)
    return tiers_of(Schedule.from_table(ops_or_sched, code_len))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_packed_rows_unpack_to_the_schedule(case):
    """Every column kernel A reads survives the packing, RUN is
    narrow_runs, and one zero row follows the last (the kernel loads it
    and never runs it)."""
    sched = _sched(*case)
    ops, tiers = sched.ops, tiers_of(sched)
    packed = pack_rows(ops, tiers)
    assert packed.dtype == np.int32 and packed.shape == (len(ops) + 1, 4)
    got, run = unpack_rows(packed, len(ops))
    assert np.array_equal(got[:, KERNEL_COLS], ops[:, KERNEL_COLS])
    assert np.array_equal(run, narrow_runs(ops, tiers))
    assert not packed[len(ops):].any()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_packed_override_tables(name):
    ops = TABLES[name]
    tiers = _tiers(ops, 1024)
    got, run = unpack_rows(pack_rows(ops, tiers), len(ops))
    assert np.array_equal(got[:, KERNEL_COLS], ops[:, KERNEL_COLS])
    assert np.array_equal(run, narrow_runs(ops, tiers))
    if name == "narrow":          # 300 rows in runs of RUN_MAX
        full, rest = divmod(300, RUN_MAX)
        assert run.tolist()[::RUN_MAX] == [RUN_MAX] * full + [rest]
    if name == "wide":
        assert not run.any()


def test_mode6_table_is_164_kb():
    sched = _sched("mode6")
    assert sched.n_ops == 10252
    assert pack_rows(sched.ops, tiers_of(sched))[:10252].nbytes == 164032


@pytest.mark.parametrize("case", CASES, ids=str)
def test_narrow_runs_cover_each_narrow_shared_row_once(case):
    """Runs start at rows at most NARROW wide and wholly in the shared
    tier, hold only such rows, at most RUN_MAX of them, cover every such
    row exactly once and no other, and stop only at another row, the end
    or RUN_MAX.  At the default tiers of a wire-size code that is every
    narrow row (a short code's narrow rows at depth 0 read the input)."""
    sched = _sched(*case)
    ops, tiers = sched.ops, tiers_of(sched)
    ok = (ops[:, C_WIDTH] <= NARROW) & in_shared_tier(ops, tiers)
    if case[0].startswith("mode"):
        assert np.array_equal(ok, ops[:, C_WIDTH] <= NARROW)
    run = narrow_runs(ops, tiers)
    cover = np.zeros(len(ops), dtype=int)
    for i in np.flatnonzero(run):
        k = run[i]
        assert 1 <= k <= RUN_MAX
        assert ok[i:i + k].all()
        cover[i:i + k] += 1
        end = i + k
        assert end == len(ops) or not ok[end] or k == RUN_MAX
    assert np.array_equal(cover, ok.astype(int))


def test_narrow_runs_follow_the_tiers():
    """With the shared tier moved deeper, the narrow rows it no longer
    holds run on the block: with no shared tier there are no runs."""
    sched = _sched("n4096")
    runs = [int((narrow_runs(sched.ops, tiers_of(sched, True, d)) > 0)
                .sum()) for d in range(1, sched.n_depths + 1)]
    assert runs[0] > 0 and runs[-1] == 0
    covered = [int(narrow_runs(sched.ops, tiers_of(sched, True, d)).sum())
               for d in range(1, sched.n_depths + 1)]
    assert covered == sorted(covered, reverse=True)


def test_in_shared_tier_by_opcode():
    """A row is in the shared tier when every range it reads or writes
    starts there: F the three LLR ranges, G those and its beta read,
    COMBINE its four beta ranges, a leaf its LLRs and its betas."""
    sched = _sched("mode6")
    t = tiers_of(sched)
    ops = sched.ops
    got = in_shared_tier(ops, t)
    for row, shared in zip(ops, got):
        lr, lw, br, bw = _ranges(row)
        want = (all(lo >= t.llr_lo for lo, _ in lr + lw)
                and all(lo >= t.beta_lo for lo, _ in br + bw))
        assert shared == want, row


def test_pack_rows_refuses_what_its_fields_cannot_hold():
    sched = _sched("toy")
    for col, bad in ((C_SRC, 1 << FIELD_BITS), (C_BDST, -1), (C_WIDTH, 0),
                     (C_WIDTH, 513), (C_OP, 8)):
        table = sched.ops.copy()
        table[3, col] = bad
        with pytest.raises(ValueError):
            pack_rows(table, tiers_of(sched))


def _ranges(row):
    """A row's (LLR reads, LLR writes, beta reads, beta writes), each a
    list of [lo, hi) offset ranges, as kernel A's run_row makes them."""
    op, w = int(row[C_OP]), int(row[C_WIDTH])

    def at(col):
        return (int(row[col]), int(row[col]) + w)

    if op in (OP_F, OP_G):
        return ([at(C_SRC), at(C_SRC2)], [at(C_DST)],
                [at(C_BSRC)] if op == OP_G else [], [])
    if op == OP_COMBINE:
        return [], [], [at(C_BSRC), at(C_BSRC2)], [at(C_BDST), at(C_DST)]
    return [at(C_SRC)], [], [], [at(C_BDST)]


@pytest.mark.parametrize("beta_compact", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_every_access_lies_in_one_tier(case, beta_compact):
    """With the default tiers, each LLR read lies wholly in the input, the
    global scratch or the shared tier, each LLR write in one of the last
    two, each beta access in the global or the shared tier, all inside
    the buffers the wrapper allocates; the root codeword is global; the
    shared tier fits the budget, and one depth shallower would not."""
    sched = _sched(*case)
    t = tiers_of(sched, beta_compact)
    n, d0 = sched.code_len, sched.d0_len
    llr_tiers = ((0, n), (d0, t.llr_lo), (t.llr_lo, sched.sz_llr))
    beta_tiers = ((0, t.beta_lo), (t.beta_lo, sched.sz_beta))

    def tiers_holding(rng, tiers):
        return sum(lo <= rng[0] and rng[1] <= hi for lo, hi in tiers)

    for row in sched.ops:
        lr, lw, br, bw = _ranges(row)
        for rng in lr:
            assert tiers_holding(rng, llr_tiers) == 1, row
        for rng in lw:
            assert tiers_holding(rng, llr_tiers[1:]) == 1, row
        for rng in br + bw:
            assert tiers_holding(rng, beta_tiers) == 1, row
    assert sched.out_off + n <= t.beta_lo
    assert t.g_llr_len == t.llr_lo - d0 >= 0 and t.g_beta_len == t.beta_lo
    assert t.shared_bytes <= SHARED_BUDGET
    assert t.shared_bytes % 16 == 0 and (4 * t.s_llr_len) % 16 == 0
    if t.depth > 1:
        assert tiers_of(sched, beta_compact,
                        t.depth - 1).shared_bytes > SHARED_BUDGET


def test_wire_tiers_keep_four_blocks_an_sm():
    """Mode 6: int8 betas from depth 5 (48 KB), f32 betas from depth 8
    (54 KB); with the static shared memory and the system's share, four
    blocks fit an SM's 228 KB either way."""
    sched = _sched("mode6")
    lofs, bslot, sz_llr, sz_beta = _regions(sched.code_len)
    for beta_compact, depth, nbytes in ((True, 5, 49152), (False, 8, 55296)):
        t = tiers_of(sched, beta_compact)
        assert (t.depth, t.shared_bytes) == (depth, nbytes)
        assert (t.llr_lo, t.beta_lo) == (lofs[depth], bslot[depth, 0])
        assert BLOCKS_PER_SM * (nbytes + STATIC_SHARED
                                + SMEM_RESERVED) <= SMEM_PER_SM
    assert tiers_of(sched).s_llr_len == 8192
    assert tiers_of(sched).s_beta_len == 16384


def test_forced_depths():
    """Every depth from 1 to the depth count can be forced where it fits a
    block; depth 0 (the input), past the count, and a shared tier over
    227 KB are refused."""
    for name in ("narrow", "n4096"):
        sched = _sched(name)
        for depth in range(1, sched.n_depths + 1):
            assert tiers_of(sched, True, depth).depth == depth
        assert tiers_of(sched, True, sched.n_depths).shared_bytes == 0
        for depth in (0, sched.n_depths + 1):
            with pytest.raises(ValueError):
                tiers_of(sched, True, depth)
    wire = _sched("mode6")
    assert tiers_of(wire, True, 2).shared_bytes <= SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tiers_of(wire, True, 1)             # 278,528 + 139,264 bytes


def _kernel_order(packed, n_ops):
    """The rows as the kernel's loop reads the packed stream: (the rows,
    each row's actor, 0 the block and 1 warp 0 alone, and whether a block
    barrier follows it)."""
    ops, run = unpack_rows(packed, n_ops)
    actor = np.zeros(n_ops, dtype=int)
    barrier = np.zeros(n_ops, dtype=bool)
    i = 0
    while i < n_ops:
        k = int(run[i])
        if k == 0:
            barrier[i] = True
            i += 1
            continue
        assert (ops[i:i + k, C_WIDTH] <= 32).all()   # one lane a column
        actor[i:i + k] = 1
        barrier[i + k - 1] = True
        i += k
    return ops, actor, barrier


def _replay(ops, actor, barrier, sz_llr, sz_beta):
    """Walk the rows with their LLR and beta slot sets; raise on a
    read-after-write, write-after-read or write-after-write between two
    actors with no block barrier between them."""
    spaces = {}
    for name, size in (("llr", sz_llr), ("beta", sz_beta)):
        spaces[name] = {"w_epoch": np.full(size, -1),
                        "w_actor": np.zeros(size, dtype=int),
                        "r_epoch": np.full(size, -1),
                        "r_actor": np.zeros(size, dtype=int),
                        "r_many": np.zeros(size, dtype=bool)}
    epoch = 0
    for i, row in enumerate(ops):
        a = actor[i]
        lr, lw, br, bw = _ranges(row)
        for name, reads, writes in (("llr", lr, lw), ("beta", br, bw)):
            sp = spaces[name]
            for lo, hi in reads:
                if ((sp["w_epoch"][lo:hi] == epoch)
                        & (sp["w_actor"][lo:hi] != a)).any():
                    raise AssertionError(f"row {i}: read after write")
            for lo, hi in writes:
                if ((sp["w_epoch"][lo:hi] == epoch)
                        & (sp["w_actor"][lo:hi] != a)).any():
                    raise AssertionError(f"row {i}: write after write")
                if ((sp["r_epoch"][lo:hi] == epoch)
                        & (sp["r_many"][lo:hi]
                           | (sp["r_actor"][lo:hi] != a))).any():
                    raise AssertionError(f"row {i}: write after read")
            for lo, hi in reads:
                same = sp["r_epoch"][lo:hi] == epoch
                sp["r_many"][lo:hi] = same & (sp["r_many"][lo:hi]
                                              | (sp["r_actor"][lo:hi] != a))
                sp["r_epoch"][lo:hi] = epoch
                sp["r_actor"][lo:hi] = a
            for lo, hi in writes:
                sp["w_epoch"][lo:hi] = epoch
                sp["w_actor"][lo:hi] = a
        if barrier[i]:
            epoch += 1


@pytest.mark.parametrize("case", [("mode6", True), ("mode10", True),
                                  ("chunked", True), ("narrow", True),
                                  ("chunked", False)], ids=str)
def test_hazard_replay(case):
    """Between the rows warp 0 runs alone and the rows of the whole block,
    every read-after-write, write-after-read and write-after-write is
    separated by a block barrier, as the kernel reads the stream."""
    sched = _sched(*case)
    ops, actor, barrier = _kernel_order(
        pack_rows(sched.ops, tiers_of(sched)), sched.n_ops)
    assert (actor == 1).any()
    _replay(ops, actor, barrier, sched.sz_llr, sched.sz_beta)


@pytest.mark.parametrize("name", ["narrow", "wide", "op0", "op6"])
def test_hazard_replay_override(name):
    ops = TABLES[name]
    sched = Schedule.from_table(ops, 1024)
    _replay(*_kernel_order(pack_rows(ops, tiers_of(sched)), len(ops)),
            sched.sz_llr, sched.sz_beta)


def test_hazard_replay_catches_a_missing_barrier():
    """The replay itself: drop the barrier that closes a narrow run before
    a wide row that reads what the run wrote, and it raises."""
    sched = _sched("chunked")
    ops, actor, barrier = _kernel_order(
        pack_rows(sched.ops, tiers_of(sched)), sched.n_ops)
    ends = np.flatnonzero(barrier & (actor == 1))
    with pytest.raises(AssertionError):
        for end in ends:
            cut = barrier.copy()
            cut[end] = False
            _replay(ops, actor, cut, sched.sz_llr, sched.sz_beta)


def test_host_constants_match_the_kernel():
    """The plan's limits are the kernel's: the longest narrow run it
    stages, the static shared memory it asserts, one lane of warp 0 a
    column of a narrow row."""
    import pathlib
    src = (pathlib.Path(__file__).resolve().parents[1] / "modem_tpu_torch"
           / "csrc" / "sc_decode.cu").read_text()
    assert f"constexpr int kRunRows = {RUN_MAX};" in src
    assert f"sizeof(Shared) <= {STATIC_SHARED}" in src
    assert NARROW == 32
