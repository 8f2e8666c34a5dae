"""The port's SC decoder (modem_tpu_torch.kernels.sc_decode) against the
JAX package's L=1 decoders: the numpy oracle, the XLA schedule VM and
the Pallas kernel in interpret mode.

Same seeded numpy LLRs into every decoder.  Tolerances: codewords
bit-exact; path metrics within rtol 1e-5, atol 1e-3 (f32 sums taken in
another order; the numpy oracle sums in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu.fec.polar import PolarCode as JaxPolarCode
from modem_tpu.fec.scl_np import scl_decode_np
from modem_tpu.fec.scl_vm import make_decoder
from modem_tpu.kernels.scl_pallas import make_pallas_decoder
from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.kernels.sc_decode import (ScPlan, sc_decode,
                                               sc_decode_reference)

# the toy code, and a code wider than one 512-column chunk (depth-0
# F/G span several schedule rows)
CODES = {"toy": (224, 144, 8, 0.75), "chunked": (960, 480, 10, 0.85)}


def _noisy_llrs(n, k, order, sigma, frames=8, seed=9):
    code = JaxPolarCode(n=n, k=k, order=order)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic_np(m)
    tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
    llrs = np.stack([
        code.lengthen_np(2 * (tx + sigma * rng.standard_normal(code.n))
                         / sigma ** 2) for _ in range(frames)])
    return code, cw, llrs.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CODES))
def case(request):
    n, k, order, sigma = CODES[request.param]
    code, cw, llrs = _noisy_llrs(n, k, order, sigma)
    port = PolarCode(n=n, k=k, order=order)
    plan = ScPlan.from_frozen(port.frozen)
    cws, pm = sc_decode(torch.from_numpy(llrs), plan)
    return code, cw, llrs, cws.numpy(), pm.numpy()


def test_shapes_and_dtypes(case):
    code, _cw, llrs, cws, pm = case
    assert cws.shape == (len(llrs), 1, code.code_len)
    assert cws.dtype == np.uint8 and pm.dtype == np.float32
    assert pm.shape == (len(llrs), 1)


def test_matches_numpy_oracle(case):
    code, _cw, llrs, cws, pm = case
    for b in range(len(llrs)):
        c_np, p_np = scl_decode_np(llrs[b].astype(np.float64),
                                   code.frozen, 1)
        assert (cws[b] == c_np).all()
        assert np.allclose(pm[b], p_np, rtol=1e-5, atol=1e-3)


def test_matches_xla_vm(case):
    code, _cw, llrs, cws, pm = case
    vm = jax.jit(jax.vmap(make_decoder(code.frozen, 1, exact=True)))
    c_vm, p_vm = (np.asarray(v) for v in vm(jnp.asarray(llrs)))
    assert (cws == c_vm).all()
    assert np.allclose(pm, p_vm, rtol=1e-5, atol=1e-3)


def test_matches_pallas_interpret(case):
    code, _cw, llrs, cws, pm = case
    pal = make_pallas_decoder(code.frozen, 1, frames_per_cell=4,
                              interpret=True, exact=True)
    c_p, p_p = (np.asarray(v) for v in pal(jnp.asarray(llrs)))
    assert (cws == c_p).all()
    assert np.allclose(pm, p_p, rtol=1e-5, atol=1e-3)


def test_noise_point_exercises_both_outcomes(case):
    """The seeded noise leaves some frames decoded and breaks others, so
    the parity above covers wrong decisions as well as right ones."""
    _code, cw, _llrs, cws, _pm = case
    hits = (cws[:, 0] == cw).all(axis=1)
    assert hits.any() and not hits.all()


@pytest.mark.parametrize("op_name,frozen", [
    ("rate0", [1, 1, 1, 1]),
    ("rate1", [0, 0, 0, 0]),
    ("rep", [1, 1, 1, 0]),
    ("spc", [1, 0, 0, 0]),
])
def test_leaf_rules(op_name, frozen):
    """One-leaf schedules pin each L=1 closed form: RATE0 pays relu(-a);
    RATE1 is the hard decision; REP flips only on a strict win and pays
    the smaller sum; SPC on odd parity flips the lowest-index minimum
    |a| and pays it."""
    from modem_tpu_torch.fec.schedule import build_schedule
    sched = build_schedule(np.asarray(frozen, np.uint8).tobytes())
    assert len(sched.ops) == 1
    llrs = torch.tensor([[1.0, -2.0, 0.5, 3.0],     # odd parity
                         [-1.0, 0.5, -0.5, 2.0],    # even parity
                         [0.5, -1.0, 0.5, 2.0],     # tied minima
                         [-1.0, 1.0, 0.0, 0.0]],    # REP tie
                        dtype=torch.float32)
    cw, pm = sc_decode_reference(llrs, sched)
    cw, pm = cw[:, 0].numpy(), pm[:, 0].numpy()
    # the rows without exact zero LLRs against the bit-by-bit oracle (an
    # LLR of exactly 0 is a tie that the two formulations break apart)
    for b in range(3):
        c_np, p_np = scl_decode_np(llrs[b].numpy().astype(np.float64),
                                   np.asarray(frozen, np.uint8), 1)
        assert (cw[b] == c_np[0]).all(), (op_name, b)
        assert np.isclose(pm[b], p_np[0], rtol=1e-6), (op_name, b)
    want_pm = {"rate0": [2.0, 1.5, 1.0, 1.0], "rate1": [0.0] * 4,
               "rep": [2.0, 1.5, 1.0, 1.0],
               "spc": [0.5, 0.0, 0.5, 0.0]}[op_name]
    assert np.allclose(pm, want_pm), (op_name, pm)
    if op_name == "rep":
        assert not cw[3].any()      # the tie keeps the all-+1 hypothesis


def test_wrapper_checks_inputs():
    plan = ScPlan.from_frozen(PolarCode(224, 144, 8).frozen)
    with pytest.raises(TypeError):
        sc_decode(torch.zeros(2, 256, dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        sc_decode(torch.zeros(2, 255), plan)
    with pytest.raises(ValueError):
        sc_decode(torch.zeros(256, 2).t(), plan)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs sc_decode_reference and launches nothing."""
    plan = ScPlan.from_frozen(PolarCode(224, 144, 8).frozen)
    _code, _cw, llrs = _noisy_llrs(224, 144, 8, 0.75, frames=2)
    before = sc_decode.launches
    got = sc_decode(torch.from_numpy(llrs), plan)
    want = sc_decode_reference(torch.from_numpy(llrs), plan.sched)
    assert sc_decode.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
def test_kernel_matches_plain_version_on_card(cuda_device, name):
    n, k, order, sigma = CODES[name]
    _code, _cw, llrs = _noisy_llrs(n, k, order, sigma, frames=16)
    plan = ScPlan.from_frozen(PolarCode(n=n, k=k, order=order).frozen)
    x = torch.from_numpy(llrs).to(cuda_device)
    before = sc_decode.launches
    cw, pm = sc_decode(x, plan)
    torch.cuda.synchronize()
    assert sc_decode.launches == before + 1
    cw_r, pm_r = sc_decode_reference(x, plan.sched)
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm, pm_r, rtol=1e-5, atol=1e-3)
