"""The port's list decoders (modem_tpu_torch.kernels.scl_decode) against
the JAX package's: the numpy oracle, the XLA schedule VM
(make_decoder(frozen, L, exact)) and the Pallas kernel in interpret
mode, for the exact mode (kernel B) and the Fast-SSC-List mode
(exact=False, kernel C).

Same seeded numpy LLRs into every decoder.  The surviving codeword sets
must be equal (sorted by codeword); path metrics, sorted, within rtol
1e-5 and atol 1e-3 of the VM and of Pallas (f32 penalty sums taken in
another order) and within rtol 1e-4 and atol 1e-2 of the oracle, which
sums in f64.  On integer LLRs every sum is exact in any order, and the
port must equal the VM outright, lane order included.  The fast mode is
held to the same tolerances against its own VM and Pallas instances; at
wire size it loses the one oracle frame the VM's fast mode loses.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu.fec import scl_vm
from modem_tpu.fec.polar import PolarCode as JaxPolarCode
from modem_tpu.fec.polar import polar_transform_np
from modem_tpu.fec.scl_np import scl_decode_np
from modem_tpu.kernels.scl_pallas import make_pallas_decoder
from modem_tpu_torch.fec import schedule
from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.kernels.sc_decode import ScPlan
from modem_tpu_torch.kernels.scl_decode import (scl_decode,
                                                scl_decode_reference)

_ORACLE = os.path.join(os.path.dirname(__file__), "..", "bench",
                       "ab_scl_oracle_64800.json")

# (n, k, order, sigma): the toy code; a code wider than one 512-column
# chunk; a 64-bit code of narrow leaves (RATE1 leaves narrower than the
# 7 enumerated positions, so BIG columns and BIG / 2 clones meet in the
# selections)
CODES = {"toy": (224, 144, 8, 0.75), "chunked": (960, 480, 10, 0.85),
         "narrow": (56, 36, 6, 0.8)}
FRAMES = 8


def _noisy_llrs(n, k, order, sigma, frames=FRAMES, seed=9):
    code = JaxPolarCode(n=n, k=k, order=order)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic_np(m)
    tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
    llrs = np.stack([
        code.lengthen_np(2 * (tx + sigma * rng.standard_normal(code.n))
                         / sigma ** 2) for _ in range(frames)])
    return code.frozen, cw, llrs.astype(np.float32)


def _every_op_mask():
    """The 2048-bit mask of tests/test_pallas.py that makes every op class
    of the Pallas kernel (full and sub-chunk F/G/COMBINE, every leaf)."""
    frozen = np.zeros(2048, dtype=np.uint8)
    frozen[0:512] = 1                      # RATE0 512
    frozen[1024:1280] = 1                  # REP 256
    frozen[1279] = 0
    frozen[1536] = 1                       # SPC 256
    frozen[1792:1919] = 1                  # REP 128
    frozen[1919] = 0
    rng = np.random.default_rng(3)
    msg = np.where(frozen == 1, 0, rng.integers(0, 2, 2048)).astype(np.uint8)
    cw = polar_transform_np(msg)
    tx = 1.0 - 2.0 * cw.astype(np.float64)
    llrs = np.stack([2 * (tx + 0.5 * rng.standard_normal(2048)) / 0.25
                     for _ in range(2)]).astype(np.float32)
    return frozen, cw, llrs


def _plan(frozen):
    return ScPlan.from_frozen(np.asarray(frozen, dtype=np.uint8))


NAMES = sorted(CODES) + ["every_op"]


@functools.lru_cache(maxsize=None)
def case(name):
    """(frozen, sent codeword, llrs, {L: port codewords, pm}) for one of
    NAMES, decoded once by the port on the CPU at L = 8 and L = 4."""
    if name == "every_op":
        frozen, cw, llrs = _every_op_mask()
    else:
        frozen, cw, llrs = _noisy_llrs(*CODES[name])
    plan = _plan(frozen)
    out = {}
    for lsz in (8, 4):
        cws, pm = scl_decode(torch.from_numpy(llrs), plan, lsz)
        out[lsz] = cws.numpy(), pm.numpy()
    return frozen, cw, llrs, out


def _rows_sorted(a):
    """The rows (codewords) of a [L, n] list in lexicographic order."""
    return a[np.lexsort(a.T[::-1])]


def assert_same_lists(cws, pm, cws_r, pm_r, rtol, atol):
    """Per frame: the same codewords in the list (with multiplicity),
    path metrics within tolerance after sorting."""
    assert cws.shape == cws_r.shape
    for b in range(cws.shape[0]):
        assert np.array_equal(_rows_sorted(cws[b]),
                              _rows_sorted(cws_r[b])), b
    assert np.allclose(np.sort(pm, axis=1), np.sort(pm_r, axis=1),
                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_shapes_and_recovery(name):
    frozen, cw, llrs, out = case(name)
    for lsz, (cws, pm) in out.items():
        assert cws.shape == (len(llrs), lsz, len(frozen))
        assert cws.dtype == np.uint8 and pm.dtype == np.float32
        assert pm.shape == (len(llrs), lsz)
    if name in CODES:   # the every-op mask is no designed code
        assert (out[8][0] == cw).all(axis=2).any(axis=1).any()


@pytest.mark.parametrize("name", NAMES)
def test_matches_numpy_oracle(name):
    frozen, _cw, llrs, out = case(name)
    cws, pm = out[8]
    ref = [scl_decode_np(x.astype(np.float64), frozen, 8) for x in llrs]
    assert_same_lists(cws, pm, np.stack([r[0] for r in ref]),
                      np.stack([r[1] for r in ref]), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lsz", [8, 4])
def test_matches_xla_vm(name, lsz):
    frozen, _cw, llrs, out = case(name)
    vm = jax.jit(jax.vmap(scl_vm.make_decoder(frozen, lsz, exact=True)))
    c_vm, p_vm = (np.asarray(v) for v in vm(jnp.asarray(llrs)))
    assert_same_lists(*out[lsz], c_vm, p_vm, rtol=1e-5, atol=1e-3)


# interpret mode costs ~10-20 s a case on the CPU, most of it compiling
@pytest.mark.parametrize("name,lsz", [(n, lsz) for lsz in (8, 4)
                                      for n in NAMES])
def test_matches_pallas_interpret(name, lsz):
    frozen, _cw, llrs, out = case(name)
    pal = make_pallas_decoder(frozen, lsz, frames_per_cell=2,
                              interpret=True, exact=True)
    c_p, p_p = (np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert_same_lists(*out[lsz], c_p, p_p, rtol=1e-5, atol=1e-3)


def test_integer_llrs_match_vm_exactly():
    """LLRs of +-1 ... +-4: every penalty sum is exact in any order, so
    every selection sees the VM's values and ties, and the decode equals
    the VM's bit for bit: lane order, codewords and path metrics."""
    frozen, _cw, _llrs = _noisy_llrs(*CODES["toy"])
    rng = np.random.default_rng(11)
    llrs = (rng.integers(1, 5, (FRAMES, len(frozen)))
            * rng.choice([-1, 1], (FRAMES, len(frozen)))).astype(np.float32)
    cws, pm = scl_decode_reference(torch.from_numpy(llrs),
                                   _plan(frozen).sched, 8)
    vm = jax.jit(jax.vmap(scl_vm.make_decoder(frozen, 8, exact=True)))
    c_vm, p_vm = (np.asarray(v) for v in vm(jnp.asarray(llrs)))
    assert np.array_equal(cws.numpy(), c_vm)
    assert np.array_equal(pm.numpy(), p_vm)
    # ties are there to break: equal path metrics inside one list
    assert any(len(np.unique(p)) < len(p) for p in p_vm)


def test_pattern_tables_match():
    assert np.array_equal(schedule.PAT7, scl_vm.PAT7)
    assert np.array_equal(schedule.SPAR7, scl_vm.SPAR7)


def test_wrapper_checks_inputs():
    plan = _plan(PolarCode(224, 144, 8).frozen)
    x = torch.zeros(2, 256)
    for bad in (1, 3, 16):
        with pytest.raises(ValueError):
            scl_decode(x, plan, bad)
    with pytest.raises(TypeError):
        scl_decode(x.double(), plan, 8)
    with pytest.raises(ValueError):
        scl_decode(torch.zeros(2, 255), plan, 8)
    with pytest.raises(ValueError):
        scl_decode(torch.zeros(256, 2).t(), plan, 8)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs scl_decode_reference and launches nothing."""
    frozen, _cw, llrs = _noisy_llrs(*CODES["toy"], frames=2)
    plan = _plan(frozen)
    before = scl_decode.launches, scl_decode.fast_launches
    for exact in (True, False):
        got = scl_decode(torch.from_numpy(llrs), plan, 8, exact)
        want = scl_decode_reference(torch.from_numpy(llrs), plan.sched, 8,
                                    exact)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (scl_decode.launches, scl_decode.fast_launches) == before


def wire_frame(code, sigma, i):
    """Frame i at sigma of bench/ab_scl.py, with the port's polar code:
    (f32 LLRs [65536], the sent codeword)."""
    rng = np.random.default_rng(int(sigma * 1000) * 100000 + i)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic(torch.from_numpy(m))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    rx = tx + sigma * torch.from_numpy(rng.standard_normal(code.n))
    return code.lengthen(2.0 * rx / sigma ** 2).float(), cw


def test_wire_size_recovery_matches_oracle():
    """The plain list-8 decoder at wire size (no JAX) recovers the sent
    codeword exactly where bench/ab_scl_oracle_64800.json's bit-by-bit
    oracle does, on frames 0-2 and 10 at sigma 0.7 (10 is the first the
    oracle loses)."""
    with open(_ORACLE) as f:
        oracle = json.load(f)
    code = PolarCode(64800, 43072, 16)
    frames = (0, 1, 2, 10)
    assert not oracle["0.7:10"] and oracle["0.7:0"]
    made = [wire_frame(code, 0.7, i) for i in frames]
    llrs = torch.stack([m[0] for m in made])
    cws, _pm = scl_decode(llrs, _plan(code.frozen), 8)
    for j, i in enumerate(frames):
        hit = bool((cws[j] == made[j][1]).all(dim=1).any())
        assert hit == oracle[f"0.7:{i}"], i



# -- the Fast-SSC-List mode (exact=False, kernel C) -------------------------

@functools.lru_cache(maxsize=None)
def fast_case(name):
    """(frozen, sent codeword, llrs, {L: port codewords, pm}) of
    :func:`case`'s inputs decoded by the port's fast mode at L = 2, 4, 8."""
    frozen, cw, llrs, _ = case(name)
    plan = _plan(frozen)
    out = {lsz: tuple(v.numpy() for v in scl_decode(
        torch.from_numpy(llrs), plan, lsz, exact=False)) for lsz in (2, 4, 8)}
    return frozen, cw, llrs, out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lsz", [2, 4, 8])
def test_fast_matches_xla_vm(name, lsz):
    """The surviving sets of make_decoder(frozen, L, exact=False)."""
    frozen, _cw, llrs, out = fast_case(name)
    vm = jax.jit(jax.vmap(scl_vm.make_decoder(frozen, lsz, exact=False)))
    c_vm, p_vm = (np.asarray(v) for v in vm(jnp.asarray(llrs)))
    assert_same_lists(*out[lsz], c_vm, p_vm, rtol=1e-5, atol=1e-3)
    if name in CODES and lsz == 8:
        assert (out[8][0] == _cw).all(axis=2).any(axis=1).any()


# the exact=False cases of tests/test_pallas.py, at every list size;
# ~15 s a case on the CPU
@pytest.mark.parametrize("name", ["toy", "chunked"])
@pytest.mark.parametrize("lsz", [2, 4, 8])
def test_fast_matches_pallas_interpret(name, lsz):
    frozen, _cw, llrs, out = fast_case(name)
    pal = make_pallas_decoder(frozen, lsz, frames_per_cell=2,
                              interpret=True, exact=False)
    c_p, p_p = (np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert_same_lists(*out[lsz], c_p, p_p, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_fast_integer_llrs_match_vm_exactly(name):
    """Integer LLRs: the fast decode equals the VM's bit for bit, lane
    order, codewords and path metrics, at L = 8 and 2."""
    frozen = case(name)[0]
    rng = np.random.default_rng(11)
    shape = (FRAMES, len(frozen))
    llrs = (rng.integers(1, 5, shape)
            * rng.choice([-1, 1], shape)).astype(np.float32)
    for lsz in (8, 2):
        cws, pm = scl_decode_reference(torch.from_numpy(llrs),
                                       _plan(frozen).sched, lsz, exact=False)
        vm = jax.jit(jax.vmap(scl_vm.make_decoder(frozen, lsz, exact=False)))
        c_vm, p_vm = (np.asarray(v) for v in vm(jnp.asarray(llrs)))
        assert np.array_equal(cws.numpy(), c_vm)
        assert np.array_equal(pm.numpy(), p_vm)


def test_fast_wire_size_recovery_matches_vm_outcomes():
    """The plain fast list-8 decoder at wire size (no JAX): the recovery
    of tests/test_scl_vm.py's WIRE_ORACLE frames, and the one oracle
    frame the fast mode loses, (0.72, 52), which the oracle and the
    exact mode recover."""
    with open(_ORACLE) as f:
        oracle = json.load(f)
    code = PolarCode(64800, 43072, 16)
    frames = [(0.70, 0, True), (0.70, 1, True), (0.70, 2, True),
              (0.72, 0, False), (0.72, 52, False)]
    assert oracle["0.72:52"] and not oracle["0.72:0"]
    made = [wire_frame(code, sigma, i) for sigma, i, _ in frames]
    llrs = torch.stack([m[0] for m in made])
    cws, _pm = scl_decode(llrs, _plan(code.frozen), 8, exact=False)
    for j, (sigma, i, want) in enumerate(frames):
        hit = bool((cws[j] == made[j][1]).all(dim=1).any())
        assert hit == want, (sigma, i)


def test_card_wire_inputs_are_these():
    """tests/test_torch_card.py's wire-size LLRs (no JAX) are bit for bit
    the ones the JAX package's polar code makes from the same seed."""
    from test_torch_card import WIRE, noisy_llrs
    _code, llrs = noisy_llrs(*WIRE, frames=3)
    assert np.array_equal(llrs.numpy(), _noisy_llrs(*WIRE, frames=3)[2])
