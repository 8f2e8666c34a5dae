"""The plain twins of the port's kernel probes (modem_tpu_torch.probes) on
the CPU, against the JAX probes of bench/.

- D (probes.p256): bench/probe_p256.py nests its bodies in ``main``, so
  they are restated here in jnp (probe_p256.py:69-108) and run through
  ``pl.pallas_call(..., interpret=True)`` in a fori_loop of R = 4, as
  ``timeit`` runs them; the twin must agree at p256.RTOL, except the
  madd, held to rtol 1e-6 here (XLA may contract its multiply-add); the
  bound's counts and the cluster sizes the kernel runs at.
- E (probes.rank3): bench/probe_rank3.py nests its kernels in ``main``;
  restated here (probe_rank3.py:52-129) and run through pallas_call in
  interpret mode, the twin at R = 1 must equal them (atol 1e-5 for the
  slot extract) and the probe's own numpy expectation; the iterated twin
  (R = 4 and 43) must equal that expectation composed R times (atol
  1e-5 an iteration for the slot extract), on the probe's tile and on a
  tile of ties and signed zeros; the bound's counts, one a function; the
  wrapper's refusals.
- F (probes.interleave): bench/probe_interleave.py is loaded by path
  (bench/ has no __init__.py) and its chain_body, leaf_body and
  leaf_width_body run under lax.fori_loop as make_probe and
  make_width_probe run them (and leaf_width_body at width 4, one or two
  chains, the port's narrow variant); the twin's output must agree
  within rtol 1e-5, atol 1e-3 (column sums in another order), and the
  path metrics pm it adds in within rtol 1e-5 on their own.
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from modem_tpu_torch.kernels.scl_decode import rank_count
from modem_tpu_torch.probes import interleave, p256, rank3

BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench"


def iota2(shape, dim):
    return jax.lax.broadcasted_iota(jnp.int32, shape, dim)


# -- D: bench/probe_p256.py ----------------------------------------------------

def jax_p256_body(name, P):
    """The probe's body ``name`` at P rows (probe_p256.py:69-108)."""
    if name == "madd":
        return lambda v, i: v * 1.0001 + 0.001

    if name == "min_reduce":
        def red(v, i):
            m = jnp.min(v, axis=1, keepdims=True)
            return v + m
        return red

    if name == "transpose":
        def tp(v, i):
            col = v[:, 0:1]
            row = col.T
            return v + row[0, 0]
        return tp

    if name == "one_hot":
        def onehot(v, i):
            perm = jnp.zeros((P, 1), jnp.int32) + (i % P)
            m = (iota2((P, P), 1) == perm).astype(jnp.float32)
            return jnp.dot(m, v, preferred_element_type=jnp.float32)
        return onehot

    if name == "eye_sum":
        def eyesum(v, i):
            a = jnp.dot(v[:, :P], v[:, :P],
                        preferred_element_type=jnp.float32)
            eye = (iota2((P, P), 0) == iota2((P, P), 1)).astype(jnp.float32)
            d = jnp.sum(a * eye, axis=1, keepdims=True)
            return v + d
        return eyesum

    def bcast_fp(v, i):
        Fh = P // 8
        pos = iota2((Fh, 2 * P), 1)
        cand = jnp.concatenate([v[:, 0:1].T, v[:, 1:2].T], axis=1)
        cf = jnp.where((pos % P) // 8 == iota2((Fh, 2 * P), 0),
                       jnp.broadcast_to(cand, (Fh, 2 * P)), 3e38)
        m = jnp.min(cf, axis=1, keepdims=True)
        s = jnp.sum(m)
        return v + s
    return bcast_fp


def jax_p256(name, x, reps):
    """timeit's kernel (probe_p256.py:38-48) in interpret mode."""
    P = x.shape[0]
    body_fn = jax_p256_body(name, P)

    def kernel(x_ref, o_ref):
        o_ref[:] = jax.lax.fori_loop(0, reps, lambda i, v: body_fn(v, i),
                                     x_ref[:])

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((P, 512), jnp.float32),
        interpret=True)(x))


@pytest.mark.parametrize("name", p256.BODIES)
def test_p256_twin_matches_probe(name):
    for P in p256.PS:
        x = p256.inputs(P, "cpu")
        want = jax_p256(name, x.numpy(), p256.CHECK_R)
        got = p256.run_plain(name, x, p256.CHECK_R).numpy()
        rtol, atol = ((1e-6, 1e-5) if name == "madd"
                      else (p256.RTOL[name], 0.0))
        assert np.allclose(got, want, rtol=rtol, atol=atol), (name, P)


def test_p256_bound_counts_the_bodies():
    """The bound reads and writes the state once and counts what each
    body needs: the one-hot no arithmetic (a row copied: bytes alone
    bound it), the eye-sum the diagonal of its product (2 P^2 + 3 P + e
    an iteration, not 2 P^3), the selector the 2 P frame minima, the F
    sums and the add."""
    b = p256.bound("one_hot", 128, 1)
    assert b["bytes"] == 2 * 4 * 128 * 512
    assert b["operations"] == 0 and b["bound_by"] == "bytes"
    assert p256.bound("eye_sum", 256, 10)["operations"] == 10 * (
        2 * 256 ** 2 + 3 * 256 + 256 * 512)
    assert p256.bound("selector", 128, 2)["operations"] == 2 * (
        2 * 128 + 128 // 8 + 128 * 512)
    assert p256.bound("madd", 128, p256.R)["bound_by"] == "operations"


@pytest.mark.parametrize("P", p256.PS)
def test_p256_clusters_hold_the_state_on_chip(P):
    """Each P's smallest cluster is the least number of blocks whose
    share of the [P, 512] f32 state fits half an SM's 256 KB of
    registers (the rest for the kernel's other values); the others
    double it up to 16 blocks, the card's largest cluster; every block
    keeps whole frames of 8 rows, and a warp one to four rows."""
    sizes = p256.CLUSTERS[P]
    state = P * p256.COLS * 4
    assert state / sizes[0] <= 128 * 1024 < state / (sizes[0] // 2)
    assert sizes == tuple(sizes[0] << k for k in range(len(sizes)))
    assert sizes[-1] == 16
    for n in sizes:
        rows = P // n
        assert rows % 8 == 0 and 1 <= rows / min(16, rows) <= 4


# -- E: bench/probe_rank3.py ---------------------------------------------------

P3, C3, L3 = 128, 16, 8


def jax_rank3_kernel(kind):
    """The probe's kernel ``kind`` (probe_rank3.py:52-129)."""
    P, C = P3, C3
    if kind == "rank3_allpairs":
        def k(x_ref, o_ref):
            v = x_ref[:]
            a = jax.lax.broadcast_in_dim(v, (P, C, C), (0, 1))
            b = jax.lax.broadcast_in_dim(v, (P, C, C), (0, 2))
            o_ref[:] = jnp.sum(jnp.where(b < a, 1.0, 0.0), axis=2)
    elif kind == "rank3_computed_mask":
        def k(x_ref, o_ref):
            v = x_ref[:]
            tri = jnp.where(iota2((C, C), 0) < iota2((C, C), 1), 1.0, 0.0)
            t3 = jax.lax.broadcast_in_dim(tri, (P, C, C), (1, 2))
            a3 = jax.lax.broadcast_in_dim(v, (P, C, C), (0, 1))
            b3 = jax.lax.broadcast_in_dim(v, (P, C, C), (0, 2))
            o_ref[:] = jnp.sum(jnp.where(b3 == a3, t3, 0.0), axis=2)
    elif kind == "rank2_slot_extract":
        def k(x_ref, o_ref):
            v = x_ref[:]
            r = jnp.floor(v * 3.0)
            cols = [jnp.sum(jnp.where(r == j, v, 0.0), axis=1,
                            keepdims=True) for j in range(8)]
            o_ref[:] = jnp.concatenate(cols, axis=1)
    elif kind == "sublane_roll":
        def k(x_ref, o_ref):
            o_ref[:] = pltpu.roll(x_ref[:], P - 3, 0)
    else:
        L = L3

        def k(x_ref, o_ref):
            v = x_ref[:]
            l2 = iota2((P, C), 0) % L
            cnt = jnp.zeros((P, C), jnp.float32)
            for o in range(L):
                if o == 0:
                    rolled = v
                else:
                    r_main = pltpu.roll(v, P - o, 0)
                    r_wrap = pltpu.roll(v, L - o, 0)
                    rolled = jnp.where(l2 < L - o, r_main, r_wrap)
                a3 = jax.lax.broadcast_in_dim(v, (P, C, C), (0, 1))
                b3 = jax.lax.broadcast_in_dim(rolled, (P, C, C), (0, 2))
                cnt = cnt + jnp.sum(jnp.where(b3 < a3, 1.0, 0.0), axis=2)
            o_ref[:] = cnt
    return k


@pytest.mark.parametrize("kind", rank3.KINDS)
def test_rank3_twin_matches_probe(kind):
    x = rank3.inputs()
    cols = 8 if kind == "rank2_slot_extract" else C3
    want = np.asarray(pl.pallas_call(
        jax_rank3_kernel(kind),
        out_shape=jax.ShapeDtypeStruct((P3, cols), jnp.float32),
        interpret=True)(x))
    got = rank3.plain(kind, torch.from_numpy(x)).numpy()
    atol = rank3.ATOL.get(kind, 0.0)
    assert np.allclose(got, want, atol=atol, rtol=0)
    # and the probe's own numpy expectation
    rank3.check_one(kind, torch.from_numpy(got), x)


def test_frame_rank_is_the_rank_selection_count():
    """The frame rank's twin is kernels.scl_decode.rank_count, the count
    of the rank_select path: on distinct values it is the probe's
    strict-less count; on ties it breaks by in-frame index, as the
    decoder's selections do."""
    x = rank3.inputs()
    assert len(np.unique(x)) == x.size
    got = rank3.plain("frame_rank_rolled", torch.from_numpy(x)).numpy()
    assert np.array_equal(got, rank3.expected("frame_rank_rolled", x))
    tied = np.round(x * 2).astype(np.float32)
    frames = torch.from_numpy(tied.reshape(P3 // L3, L3 * C3))
    ranks = rank_count(frames, torch.arange(L3 * C3).expand_as(frames))
    for f in range(P3 // L3):
        assert sorted(ranks[f].tolist()) == list(range(L3 * C3))
    assert np.array_equal(
        rank3.plain("frame_rank_rolled", torch.from_numpy(tied)).numpy(),
        ranks.reshape(P3, C3).float().numpy())


@pytest.mark.parametrize("kind", rank3.KINDS)
@pytest.mark.parametrize("reps", [4, 43])
@pytest.mark.parametrize("tile", ["probe", "ties"])
def test_rank3_iterated_twin_matches_numpy(kind, reps, tile):
    """R iterations of the twin against the probe's numpy expectation
    composed R times: the roll by -3R rows (past 128 at R = 43), the
    others summed over the tile's rows rotated by 0 .. R - 1 columns."""
    x = rank3.inputs() if tile == "probe" else rank3.ties()
    rank3.check_one(kind, rank3.plain(kind, torch.from_numpy(x), reps), x,
                    reps)


def test_rank3_iterations_compose():
    """What R iterations compute, independent of the module's own
    expectation: the roll by 3 a step wraps (R = 43: 129 rows, one past
    the tile); over 16 iterations every column of a row takes each of
    the row's values once, so the all-pairs ranks of distinct values sum
    to 0 + 1 + ... + 15 in every column, and a row's frame ranks to the
    same total in every column; the counts stay exact in f32 up to
    MAX_REPS."""
    x = rank3.inputs()
    xt = torch.from_numpy(x)
    assert torch.equal(rank3.plain("sublane_roll", xt, 43),
                       torch.roll(xt, -1, dims=0))
    assert torch.equal(rank3.plain("rank3_allpairs", xt, 16),
                       torch.full((rank3.P, rank3.C), 120.0))
    fr = rank3.plain("frame_rank_rolled", xt, 16)
    once = rank3.plain("frame_rank_rolled", xt, 1)
    assert torch.equal(fr, once.sum(dim=1, keepdim=True).expand_as(fr))
    assert rank3.MAX_REPS * (rank3.L * rank3.C - 1) < 2 ** 24


def test_rank3_ties_tile_holds_signed_zeros():
    """The tile of ties: every row holds repeated values and every frame
    -0.0 beside +0.0; both count as one value (float equality): the tie
    count pairs them and the frame rank orders them by in-frame index,
    as the list decoder's rank selection does."""
    x = rank3.ties()
    zero = x == 0
    for f in range(P3 // L3):
        z = np.signbit(x[f * L3:(f + 1) * L3][zero[f * L3:(f + 1) * L3]])
        assert z.any() and not z.all()
    assert all(len(np.unique(row)) < C3 for row in x)
    row = np.zeros((P3, C3), np.float32)
    row[:, ::2] = -0.0
    t = torch.from_numpy(row)
    ties = rank3.plain("rank3_computed_mask", t)
    assert ties[0].tolist() == [float(C3 - 1 - q) for q in range(C3)]
    fr = rank3.plain("frame_rank_rolled", t)
    assert fr[:L3].flatten().tolist() == [float(i) for i in range(L3 * C3)]
    for kind in ("rank3_computed_mask", "frame_rank_rolled"):
        rank3.check_one(kind, rank3.plain(kind, t), row)
        rank3.check_one(kind, rank3.plain(kind, torch.from_numpy(x)), x)


def test_rank3_ops_counts_the_functions():
    """The bound reads the tile and writes the output once a launch and
    counts what each function needs an iteration, one count a function
    (no layout): the all-pairs rank's 240 pairs a row, the tie count's
    120, one slot an element, the frame rank at the least compares a
    comparison ranking of 128 keys needs (ceil(log2 128!) = 717 a frame,
    under a serial merge sort's 769 and the bitonic network's 1,792 the
    kernel runs), two operations each, and the roll none (bytes bound
    it)."""
    assert [rank3.ops(k) for k in rank3.KINDS] == [61_440, 30_720, 8_192,
                                                   0, 22_944]
    assert rank3.ops("rank3_allpairs") == 2 * 240 * 128
    assert rank3.ops("rank3_computed_mask") == 2 * 120 * 128
    assert rank3.ops("rank2_slot_extract") == 4 * 128 * 16
    assert rank3.FRAME_COMPARES == (math.factorial(128) - 1).bit_length()
    assert rank3.FRAME_COMPARES == 717
    assert rank3.FRAME_COMPARES < 128 * 7 - 2 ** 7 + 1 < 28 * 64
    assert rank3.ops("frame_rank_rolled") == 2 * 717 * 16
    b = rank3.bound("frame_rank_rolled", 10)
    assert b["operations"] == 10 * 22_944
    assert b["bytes"] == 2 * 4 * 128 * 16
    roll = rank3.bound("sublane_roll", rank3.R)
    assert roll["operations"] == 0 and roll["bound_by"] == "bytes"
    assert roll["bytes"] == 16_384
    assert rank3.bound("rank2_slot_extract", 3)["bytes"] == 4 * 128 * 24


def test_rank3_refuses():
    """The wrapper raises ValueError, before any launch, on a kind off
    its table, R outside 1 .. MAX_REPS, a tile of another shape or an
    output it cannot write (another shape, or not contiguous)."""
    xt = torch.from_numpy(rank3.inputs())
    for kind, reps in (("rank4_allpairs", 1), ("rank3_allpairs", 0),
                       ("sublane_roll", -1),
                       ("frame_rank_rolled", rank3.MAX_REPS + 1)):
        with pytest.raises(ValueError):
            rank3.run(kind, xt, reps)
    with pytest.raises(ValueError):
        rank3.run("sublane_roll", xt[:, :8])
    with pytest.raises(ValueError):
        rank3.run("rank2_slot_extract", xt, 1, torch.empty(P3, C3))
    with pytest.raises(ValueError):
        rank3.run("rank3_allpairs", xt, 1, torch.empty(C3, P3).t())


# -- F: bench/probe_interleave.py ----------------------------------------------

@pytest.fixture(scope="module")
def probe_f():
    spec = importlib.util.spec_from_file_location(
        "probe_interleave", BENCH / "probe_interleave.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_interleave(mod, body, x, n_chains, reps):
    """make_probe's kernel (probe_interleave.py:86-103) without Pallas:
    (its output, the path metrics pm it adds in)."""
    def run(i, st):
        xs, pm = st[:-1], st[-1]
        out = []
        for c in range(n_chains):
            x2, pm = body(xs[c], pm)
            out.append(x2)
        return (*out, pm)

    init = tuple(jnp.asarray(x[c]) for c in range(n_chains)) + (
        jnp.zeros((1, mod.P), jnp.float32),)
    st = jax.lax.fori_loop(0, reps, run, init)
    acc = st[-1]
    for c in range(n_chains):
        acc = acc + jnp.sum(st[c], axis=0, keepdims=True)
    return np.asarray(acc), np.asarray(st[-1])


def assert_held(got, want):
    """The twin's (out, pm) against the JAX probe's: out within
    interleave.RTOL and ATOL, pm within interleave.PM_RTOL (relative
    only: pm is ~1e-6 x the iterations, under ATOL)."""
    (out, pm), (out_w, pm_w) = got, want
    assert np.allclose(out.numpy(), out_w, rtol=interleave.RTOL,
                       atol=interleave.ATOL)
    assert np.allclose(pm.numpy(), pm_w, rtol=interleave.PM_RTOL, atol=0.0)
    assert np.abs(pm_w).min() > 0


@pytest.mark.parametrize("body", interleave.BODIES)
@pytest.mark.parametrize("n_chains", [1, 2])
def test_interleave_twin_matches_probe(probe_f, body, n_chains):
    x = interleave.inputs(3)
    fn = probe_f.chain_body if body == "chain" else probe_f.leaf_body
    want = jax_interleave(probe_f, fn, x.numpy(), n_chains,
                          interleave.CHECK_REPS)
    assert_held(interleave.run_plain(body, x, n_chains,
                                     interleave.CHECK_REPS), want)


def jax_width(mod, x, width, n_chains, reps):
    """make_width_probe's kernel (probe_interleave.py:161-173) without
    Pallas, pm threaded through ``n_chains`` states in turn (one, as the
    probe's, at 128 and 256): (out, pm); out sums the first min(width,
    128) columns into pm's."""
    def run(i, st):
        xs, pm = st[:-1], st[-1]
        out = []
        for c in range(n_chains):
            x2, pm = mod.leaf_width_body(xs[c], pm, width)
            out.append(x2)
        return (*out, pm)

    init = tuple(jnp.asarray(x[c, :, :width]) for c in range(n_chains)) + (
        jnp.zeros((1, mod.P), jnp.float32),)
    st = jax.lax.fori_loop(0, reps, run, init)
    acc = np.asarray(st[-1]).copy()
    cols = min(width, 128)
    for c in range(n_chains):
        acc[:, :cols] = acc[:, :cols] + np.asarray(
            jnp.sum(st[c][:, :cols], axis=0, keepdims=True))
    return acc, np.asarray(st[-1])


@pytest.mark.parametrize("width", [128, 256])
def test_interleave_width_twin_matches_probe(probe_f, width):
    """make_width_probe's kernel (probe_interleave.py:161-173) without
    Pallas, against the twin."""
    x = interleave.inputs(3, 256, 1)
    reps = interleave.CHECK_REPS
    want = jax_width(probe_f, x.numpy(), width, 1, reps)
    assert_held(interleave.run_width_plain(x, width, reps), want)


@pytest.mark.parametrize("n_chains", [1, 2])
def test_interleave_narrow_twin_matches_probe_body(probe_f, n_chains):
    """The narrow variant (the probe's leaf_width_body at width 4, one
    or two chains) against that body under lax.fori_loop."""
    x = interleave.inputs(3, interleave.NARROW)
    reps = interleave.CHECK_REPS
    want = jax_width(probe_f, x.numpy(), interleave.NARROW, n_chains, reps)
    assert_held(interleave.run_width_plain(x, interleave.NARROW, reps,
                                           n_chains), want)


def test_interleave_verdict_rule():
    """The probe's rule: dual < 0.6 x double is latency-bound."""
    assert interleave.verdict(1.0, 1.1, 2.0).startswith("LATENCY")
    assert interleave.verdict(1.0, 1.9, 2.0).startswith("THROUGHPUT")


def test_cpu_tensors_take_the_twins():
    """On a CPU tensor each kernel wrapper runs its plain twin and counts
    no launch; a tensor the kernels do not take raises."""
    counts = (p256.run.launches, rank3.run.launches, interleave.run.launches)
    before = [dict(c) for c in counts]
    x = p256.inputs(128, "cpu")
    assert torch.equal(p256.run("madd", x, 2), p256.run_plain("madd", x, 2))
    xt = torch.from_numpy(rank3.inputs())
    assert torch.equal(rank3.run("sublane_roll", xt),
                       rank3.plain("sublane_roll", xt))
    for kind in rank3.KINDS:
        out = torch.empty(P3, rank3.out_cols(kind))
        assert rank3.run(kind, xt, 4, out) is out
        assert torch.equal(out, rank3.plain(kind, xt, 4))
    xi = interleave.inputs(0)
    for got, want in ((interleave.run("chain", xi, 1, 2),
                       interleave.run_plain("chain", xi, 1, 2)),
                      (interleave.run("leaf", xi, 2, 2, shared=True),
                       interleave.run_plain("leaf", xi, 2, 2)),
                      (interleave.run_width(xi, 128, 2),
                       interleave.run_width_plain(xi, 128, 2)),
                      (interleave.run_width(xi, interleave.NARROW, 2, 2,
                                            shared=True),
                       interleave.run_width_plain(xi, interleave.NARROW, 2,
                                                  2))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for n in p256.CLUSTERS[128]:
        assert torch.equal(p256.run("one_hot", x, 3, n),
                           p256.run_plain("one_hot", x, 3))
    for c in interleave.CLUSTERS:
        assert all(torch.equal(g, w) for g, w in zip(
            interleave.run("leaf", xi, 1, 2, cluster=c),
            interleave.run_plain("leaf", xi, 1, 2)))
    assert before == [dict(c) for c in counts]
    for bad in (1, 3, 32):
        with pytest.raises(ValueError):
            p256.run("madd", x, 1, bad)
    with pytest.raises(ValueError):
        p256.run("madd", p256.inputs(256, "cpu"), 1, 2)
    for bad in (0, 3, 16):
        with pytest.raises(ValueError):
            interleave.run("chain", xi, 1, 2, cluster=bad)
        with pytest.raises(ValueError):
            interleave.run_width(xi, 128, 2, cluster=bad)
    with pytest.raises(ValueError):
        interleave.run("chain", xi, 2, 2, shared=True)
    with pytest.raises(ValueError):
        interleave.run_width(xi, 256, 2, 2)
    with pytest.raises(ValueError):
        p256.run("madd", x.double(), 1)
    with pytest.raises(ValueError):
        rank3.run("sublane_roll", xt[:, :8])
