"""The options of the port's polar decoder (kernel C'), plain versions on
the CPU, against the JAX package: make_decoder(frozen, L, exact, *,
unroll, rank_select, decompose_spc, beta_compact, ops_override) of
modem_tpu_torch.kernels.scl_decode beside modem_tpu.fec.scl_vm.
make_decoder and make_pallas_decoder (interpret mode), and the pipelines'
scl_unroll.

Inputs are made from a seed with numpy.  Tolerances: surviving codeword
sets equal and sorted path metrics within rtol 1e-5, atol 1e-3 (f32
penalty sums reduced in another order); on integer LLRs every sum is
exact in any order, so the port equals the VM outright, lane order and
path metrics included; an option that only changes how the port gets
there (rank selection, f32 betas, unroll on the CPU) is array_equal to
the default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu.fec import scl_vm
from modem_tpu.fec.polar import PolarCode as JaxPolarCode
from modem_tpu.kernels.scl_pallas import make_pallas_decoder
from modem_tpu_torch import pipeline as port_pipeline
from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.fec.schedule import (C_BDST, C_D, C_DST, C_OP, C_SIDW,
                                          C_SRC, C_WIDTH)
from modem_tpu_torch.kernels import unroll
from modem_tpu_torch.kernels.sc_decode import ScPlan
from modem_tpu_torch.kernels.scl_decode import (LIVE_PATTERNS, make_decoder,
                                                rank_count, scl_decode,
                                                scl_decode_reference)
from test_torch_card import toy_batches, toy_pipeline
from test_torch_scl_decode import CODES, _every_op_mask, _noisy_llrs

TOY = JaxPolarCode(n=224, k=144, order=8)     # tests/test_pallas.py:12
RTOL, ATOL = 1e-5, 1e-3


def toy_llrs(frames=4, seed=0, sigma=0.5):
    """tests/test_pallas.py's toy_llrs: noisy frames of one codeword."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, TOY.mesg_bits, dtype=np.uint8)
    m[TOY.k:] = 0
    cw = TOY.encode_systematic_np(m)
    tx = 1.0 - 2.0 * TOY.shorten_np(cw).astype(np.float64)
    return np.stack([TOY.lengthen_np(2 * (tx + sigma * rng.standard_normal(
        TOY.n)) / sigma ** 2) for _ in range(frames)]).astype(np.float32)


def integer_llrs(n, frames=8, seed=11):
    """LLRs of +-1 ... +-4: every penalty sum exact in any order."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 5, (frames, n))
            * rng.choice([-1, 1], (frames, n))).astype(np.float32)


def port(frozen, lsz, llrs, **kw):
    cw, pm = make_decoder(frozen, lsz, device="cpu", **kw)(
        torch.from_numpy(llrs))
    return cw.numpy(), pm.numpy()


def vm(frozen, lsz, llrs, **kw):
    fn = jax.jit(jax.vmap(scl_vm.make_decoder(frozen, lsz, **kw)))
    return tuple(np.asarray(v) for v in fn(jnp.asarray(llrs)))


def rows_sorted(a):
    return a[np.lexsort(a.T[::-1])]


def assert_same_sets(got, want):
    (cws, pm), (cws_r, pm_r) = got, want
    assert cws.shape == cws_r.shape
    for b in range(cws.shape[0]):
        assert np.array_equal(rows_sorted(cws[b]), rows_sorted(cws_r[b])), b
    assert np.allclose(np.sort(pm, axis=1), np.sort(pm_r, axis=1),
                       rtol=RTOL, atol=ATOL)


# -- (a) decompose_spc ---------------------------------------------------------

@pytest.mark.parametrize("lsz", [8, 1])
def test_decompose_spc_matches_vm(lsz):
    """The SPC-free schedule: the VM's sets and sorted path metrics on
    noisy frames; at L = 1 plain SC on it equals the VM's codeword."""
    llrs = toy_llrs()
    got = port(TOY.frozen, lsz, llrs, decompose_spc=True)
    want = vm(TOY.frozen, lsz, llrs, exact=True, decompose_spc=True)
    assert_same_sets(got, want)
    plan = make_decoder(TOY.frozen, lsz, decompose_spc=True,
                        device="cpu").plan
    assert plan.sched.n_ops > ScPlan.from_frozen(TOY.frozen).sched.n_ops
    assert not (plan.sched.ops[:, C_OP] == 6).any()      # no SPC rows


@pytest.mark.parametrize("lsz", [8, 2, 1])
def test_decompose_spc_integer_llrs_equal_vm_exactly(lsz):
    """Integer LLRs: lane order, codewords and path metrics equal the
    VM's bit for bit (the narrow leaves' BIG columns and inf sums tie,
    and ties break to the lowest index as in the VM)."""
    llrs = integer_llrs(TOY.code_len)
    got = port(TOY.frozen, lsz, llrs, decompose_spc=True)
    want = vm(TOY.frozen, lsz, llrs, exact=True, decompose_spc=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("lsz", [8, 1])
def test_decompose_spc_matches_pallas_interpret(lsz):
    """The same against make_pallas_decoder(decompose_spc=True) in
    interpret mode (~10 s a case)."""
    llrs = toy_llrs()
    pal = make_pallas_decoder(TOY.frozen, lsz, frames_per_cell=2,
                              interpret=True, decompose_spc=True)
    want = tuple(np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert_same_sets(port(TOY.frozen, lsz, llrs, decompose_spc=True), want)


def test_decompose_spc_narrow_leaves():
    """The decomposed narrow code has RATE1 leaves narrower than the 7
    enumerated columns; the port still equals the VM on integer LLRs."""
    code = JaxPolarCode(*CODES["narrow"][:3])
    sched = make_decoder(code.frozen, 8, decompose_spc=True,
                         device="cpu").plan.sched
    rate1 = sched.ops[sched.ops[:, C_OP] == 5]
    assert (rate1[:, C_WIDTH] < 7).any()
    llrs = integer_llrs(code.code_len)
    got = port(code.frozen, 8, llrs, decompose_spc=True)
    want = vm(code.frozen, 8, llrs, exact=True, decompose_spc=True)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# -- (b) rank_select -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CODES) + ["every_op"])
@pytest.mark.parametrize("exact", [True, False])
def test_rank_select_equals_default(name, exact):
    """Every fork selection by one rank count: array_equal to the
    default plain decode at L = 8, 4 and 2 (lists, lane order, pm)."""
    if name == "every_op":
        frozen, _cw, llrs = _every_op_mask()
    else:
        frozen, _cw, llrs = _noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(frozen)
    x = torch.from_numpy(llrs)
    for lsz in (8, 4, 2):
        a = scl_decode_reference(x, plan.sched, lsz, exact)
        b = scl_decode_reference(x, plan.sched, lsz, exact, rank_select=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), lsz


def test_rank_select_integer_ties():
    """Integer LLRs (many equal candidates): the rank path keeps the
    default's tie order at every list size, exact and fast."""
    frozen = TOY.frozen
    x = torch.from_numpy(integer_llrs(TOY.code_len))
    plan = ScPlan.from_frozen(frozen)
    for exact in (True, False):
        for lsz in (8, 4, 2):
            a = scl_decode_reference(x, plan.sched, lsz, exact)
            b = scl_decode_reference(x, plan.sched, lsz, exact,
                                     rank_select=True)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_live_patterns_hold_every_top8():
    """The dominance reduction: over random and tied subset sums (one
    lane's 7 ascending least-reliable magnitudes, SPC parity either way),
    the 8 best of the 128 patterns in (value, code) order always lie in
    LIVE_PATTERNS."""
    rng = np.random.default_rng(5)
    pat = ((np.arange(128)[None, :] >> np.arange(7)[:, None]) & 1)
    parity = pat.sum(axis=0) % 2
    for trial in range(400):
        if trial % 2:
            vals = np.sort(rng.integers(0, 3, 8)).astype(np.float32)
        else:
            vals = np.sort(rng.exponential(1.0, 8)).astype(np.float32)
        for spc, odd in ((False, 0), (True, 0), (True, 1)):
            ev = vals[1:] if spc else vals[:7]
            subs = np.zeros(128, np.float32)
            for j in range(7):
                subs = subs + ev[j] * pat[j]
            if spc:
                subs = subs + np.where(odd ^ parity, vals[0], 0.0)
            order = np.lexsort((np.arange(128), subs))[:8]
            assert set(order.tolist()) <= set(LIVE_PATTERNS), (trial, order)


def test_rank_count_orders_like_a_stable_sort():
    """rank_count is the position in a stable sort by (value, index)."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.integers(0, 5, (6, 40)).astype(np.float32))
    idx = torch.arange(40).expand(6, -1)
    order = torch.sort(v, dim=-1, stable=True).indices
    want = torch.empty_like(order)
    want.scatter_(-1, order, torch.arange(40).expand(6, -1))
    assert torch.equal(rank_count(v, idx), want)


@pytest.mark.parametrize("exact", [True, False])
def test_rank_select_matches_pallas_interpret(exact):
    """Against make_pallas_decoder(rank_select=True) in interpret mode,
    whose own pin (tests/test_pallas.py:127) is marked slow: the port's
    rank path keeps its sets."""
    llrs = toy_llrs()
    pal = make_pallas_decoder(TOY.frozen, 8, frames_per_cell=2,
                              interpret=True, exact=exact, rank_select=True)
    want = tuple(np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert_same_sets(port(TOY.frozen, 8, llrs, exact=exact,
                          rank_select=True), want)


# -- (c) beta_compact ----------------------------------------------------------

@pytest.mark.parametrize("lsz,exact", [(8, True), (8, False), (1, True)])
def test_beta_compact_false_equals_default(lsz, exact):
    llrs = toy_llrs()
    got = port(TOY.frozen, lsz, llrs, exact=exact, beta_compact=False)
    want = port(TOY.frozen, lsz, llrs, exact=exact)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_beta_compact_false_matches_pallas_f32_betas():
    """The port's f32 betas beside the Pallas kernel's (beta_bf16=False,
    interpret mode): the same sets."""
    llrs = toy_llrs()
    pal = make_pallas_decoder(TOY.frozen, 8, frames_per_cell=2,
                              interpret=True, beta_bf16=False)
    want = tuple(np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert_same_sets(port(TOY.frozen, 8, llrs, beta_compact=False), want)


# -- (d) ops_override ------------------------------------------------------------

@pytest.mark.parametrize("lsz,exact", [(8, True), (4, False), (1, True)])
def test_ops_override_own_rows_equal_default(lsz, exact):
    """The schedule's own rows as an override table (scratch from zeros)
    decode as the default."""
    llrs = toy_llrs()
    table = ScPlan.from_frozen(TOY.frozen).sched.ops.copy()
    got = port(TOY.frozen, lsz, llrs, exact=exact, ops_override=table)
    want = port(TOY.frozen, lsz, llrs, exact=exact)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _bad(col, value, row_op=None):
    """The toy schedule with one column of one row (the first of opcode
    row_op, else row 0) set to value."""
    ops = ScPlan.from_frozen(TOY.frozen).sched.ops.copy()
    i = 0 if row_op is None else int(np.flatnonzero(ops[:, C_OP] == row_op)[0])
    ops[i, col] = value
    return ops


@pytest.mark.parametrize("table", [
    _bad(C_OP, 7), _bad(C_OP, -1), _bad(C_WIDTH, 0), _bad(C_WIDTH, 513),
    _bad(C_SRC, 10 ** 6), _bad(C_SRC, -4), _bad(C_SRC, 250),
    _bad(C_DST, 0), _bad(C_D, 8), _bad(C_BDST, 10 ** 6, row_op=3),
    _bad(C_SIDW, 99, row_op=3), _bad(C_SIDW, -1, row_op=2),
    np.zeros((3, 13), np.int32)],
    ids=["opcode", "negative opcode", "width 0", "width 513",
         "LLR read past the scratch", "negative read",
         "read past the channel LLRs", "write into the channel LLRs",
         "depth past the maps", "beta write past the scratch",
         "slot id past the maps", "negative slot id", "13 columns"])
def test_ops_override_out_of_range_raises(table):
    """A row outside the scratch raises ValueError on the host, before any
    launch, at every list size."""
    for lsz in (8, 1):
        with pytest.raises(ValueError):
            make_decoder(TOY.frozen, lsz, ops_override=table, device="cpu")


# -- (e) the unroll generator ------------------------------------------------

@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (56, 36, 6),
                                       (960, 480, 10)])
def test_unroll_source_round_trips(n, k, order):
    """The generated source parses back to the schedule's table for A, B
    and C, embeds the interpreted kernel's text verbatim behind its
    guard, and its library key follows the text."""
    sched = ScPlan.from_frozen(PolarCode(n, k, order).frozen).sched
    for lsz, exact, src, guard in ((1, True, "sc_decode",
                                    "SC_DECODE_UNROLLED"),
                                   (8, True, "scl_decode",
                                    "SCL_DECODE_UNROLLED"),
                                   (4, False, "scl_decode",
                                    "SCL_DECODE_UNROLLED")):
        text = unroll.generate(sched, lsz, exact)
        assert np.array_equal(unroll.parse_rows(text), sched.ops)
        assert f"#define {guard}\n" in text
        assert (unroll._build.CSRC / f"{src}.cu").read_text() in text
        assert f"run_row<{lsz}, {'true' if exact else 'false'}" in text \
            or lsz == 1
        path = unroll.library_path(sched, lsz, exact)
        assert path.name.startswith("libunrolled_")
    assert (unroll.library_path(sched, 8, True)
            != unroll.library_path(sched, 8, False))


# -- (f) scl_unroll on the pipelines -------------------------------------------

def test_batch_pipeline_scl_unroll_equals_default():
    """BatchPipeline(scl_unroll=True, device="cpu") runs the plain
    versions (no unroll on the CPU) and equals the default on every key
    of the toy recordings, at L = 1 and 8; None follows
    SCL_UNROLL_DEFAULT."""
    assert port_pipeline.SCL_UNROLL_DEFAULT is False
    for lsz in (1, 8):
        pipes = [toy_pipeline(port_pipeline.BatchPipeline, "cpu",
                              list_size=lsz, scl_unroll=u)
                 for u in (True, None)]
        assert pipes[0].scl_unroll and not pipes[1].scl_unroll
        x = toy_batches()[0.3]
        got, want = (p.fetch(p.decode_batch(x)) for p in pipes)
        for key in want:
            assert np.array_equal(got[key], want[key]), (lsz, key)


def test_adaptive_pipeline_scl_unroll_equals_default():
    """The same for AdaptivePipeline on the escalating toy batch; both of
    its sub-pipelines take the option."""
    x = toy_batches()[0.3]
    pipes = [toy_pipeline(port_pipeline.AdaptivePipeline, "cpu",
                          list_size=4, scl_unroll=u) for u in (True, False)]
    assert pipes[0].sc.scl_unroll and pipes[0].scl.scl_unroll
    got, want = (p.decode_batch(x) for p in pipes)
    assert pipes[0].last_fallbacks == pipes[1].last_fallbacks > 0
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_scl_unroll_refuses_wire_size_schedules():
    """scl_unroll=True on a schedule past the longest unrolled build
    (unroll.MAX_ROWS; mode 6's 10,252 rows) raises ValueError, on any
    device; the toy schedule is within it."""
    with pytest.raises(ValueError, match="unrolled"):
        port_pipeline.BatchPipeline(8000, 6, device="cpu", scl_unroll=True)
    pipe = toy_pipeline(port_pipeline.BatchPipeline, "cpu", scl_unroll=True)
    assert pipe.plan.sched.n_ops <= unroll.MAX_ROWS
    unroll.check_rows(pipe.plan.sched)


def test_cpu_tensors_launch_nothing():
    """On CPU tensors every option runs the plain version and no counter
    moves."""
    llrs = torch.from_numpy(toy_llrs(2))
    plan = ScPlan.from_frozen(TOY.frozen)
    before = (scl_decode.launches, scl_decode.fast_launches,
              dict(scl_decode.variant_launches))
    for kw in ({"rank_select": True}, {"beta_compact": False},
               {"unroll": True}, {"zero_scratch": True}):
        scl_decode(llrs, plan, 8, **kw)
    after = (scl_decode.launches, scl_decode.fast_launches,
             dict(scl_decode.variant_launches))
    assert after == before
    with pytest.raises(ValueError):
        scl_decode(llrs, plan, 8, rank_select=True, unroll=True)
    with pytest.raises(ValueError):
        make_decoder(TOY.frozen, 3, device="cpu")
