"""The plain twins of the port's kernel probes (modem_tpu_torch.probes) on
the CPU, against the JAX probes of bench/.

- D (probes.p256): bench/probe_p256.py nests its bodies in ``main``, so
  they are restated here in jnp (probe_p256.py:69-108) and run through
  ``pl.pallas_call(..., interpret=True)`` in a fori_loop of R = 4, as
  ``timeit`` runs them; the twin must agree at p256.RTOL, except the
  madd, held to rtol 1e-6 here (XLA may contract its multiply-add).
- E (probes.rank3): bench/probe_rank3.py nests its kernels in ``main``;
  restated here (probe_rank3.py:52-129) and run through pallas_call in
  interpret mode, the twin must equal them (atol 1e-5 for the slot
  extract) and the probe's own numpy expectation.
- F (probes.interleave): bench/probe_interleave.py is loaded by path
  (bench/ has no __init__.py) and its chain_body, leaf_body and
  leaf_width_body run under lax.fori_loop as make_probe and
  make_width_probe run them (and leaf_width_body at width 4, one or two
  chains, the port's narrow variant); the twin's output must agree
  within rtol 1e-5, atol 1e-3 (column sums in another order), and the
  path metrics pm it adds in within rtol 1e-5 on their own.
"""

import importlib.util
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
    """The bound reads and writes the state once and counts the products
    in full (2 P^2 x 512 for the one-hot, 2 P^3 for the eye-sum)."""
    b = p256.bound("one_hot", 128, 1)
    assert b["bytes"] == 2 * 4 * 128 * 512
    assert b["operations"] == 128 * 128 + 2 * 128 * 128 * 512
    assert p256.bound("eye_sum", 256, 10)["operations"] == 10 * (
        2 * 256 ** 3 + 3 * 256 * 256 + 256 * 512)
    assert p256.bound("madd", 128, p256.R)["bound_by"] == "operations"


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
    assert before == [dict(c) for c in counts]
    with pytest.raises(ValueError):
        interleave.run("chain", xi, 2, 2, shared=True)
    with pytest.raises(ValueError):
        interleave.run_width(xi, 256, 2, 2)
    with pytest.raises(ValueError):
        p256.run("madd", x.double(), 1)
    with pytest.raises(ValueError):
        rank3.run("sublane_roll", xt[:, :8])
