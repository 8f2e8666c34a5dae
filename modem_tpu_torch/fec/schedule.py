"""The polar decoder's instruction schedule, numpy.

Counterpart of the host half of ``modem_tpu/fec/scl_vm.py``
(``Schedule``, ``build_schedule``, ``scl_params`` and the column and
opcode constants), kept equal to it by the tests.  The successive-
cancellation tree of one frozen mask is pruned into Fast-SSC constituent
nodes (RATE0 / REP / RATE1 / SPC leaves; Sarkis et al.) and linearised
into a static table of fixed-width (<= CHUNK) micro-ops.  The table is
the instruction stream of the SC kernel (kernels/sc_decode.py).

Row layout (int32, 14 columns): opcode, depth, LLR source offsets (SRC,
SRC2), LLR destination (DST; for COMBINE the beta offset of the right
half), beta source / destination offsets (BSRC, BSRC2, BDST), beta slot
ids (SIDR, SIDR2, SIDW; used by list decoding), column count WIDTH, LAST
chunk flag and SUB (internal op whose half width is below CHUNK).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

CHUNK = 512      # widest op (columns)
T_RATE1 = 4      # fork rounds per RATE1 node of the fast list mode

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC = range(7)

(C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST, C_SIDR,
 C_SIDR2, C_SIDW, C_WIDTH, C_LAST, C_SUB) = range(14)


@dataclasses.dataclass
class Schedule:
    ops: np.ndarray        # [n_ops, 14] int32
    sz_llr: int            # LLR slots per path (depth 0 included)
    sz_beta: int           # partial-sum slots per path
    n_depths: int
    code_len: int
    out_off: int           # beta offset of the root codeword (slot A_0)

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def d0_len(self) -> int:
        """Length of the depth-0 LLR region (the channel LLRs)."""
        return max(self.code_len, CHUNK)

    @classmethod
    def from_table(cls, ops: np.ndarray, code_len: int) -> "Schedule":
        """A schedule from its instruction table (e.g. one built by the
        JAX package): the buffer geometry depends on code_len only."""
        ops = np.ascontiguousarray(ops, dtype=np.int32)
        if ops.ndim != 2 or ops.shape[1] != 14:
            raise ValueError(f"schedule table shape {ops.shape}")
        _lofs, bslot, sz_llr, sz_beta = _regions(code_len)
        return cls(ops=ops, sz_llr=sz_llr, sz_beta=sz_beta,
                   n_depths=code_len.bit_length(), code_len=code_len,
                   out_off=int(bslot[0, 0]))


def _regions(n: int):
    """Buffer geometry for code length n: LLR region offset per depth,
    beta slot offsets [depth, side], and the two buffer sizes."""
    depths = n.bit_length()
    lofs = []
    pos = 0
    for d in range(depths):
        lofs.append(pos)
        pos += max(n >> d, CHUNK)
    sz_llr = pos
    # beta slots: per depth, A (left child result) and B (right child).
    # Depth 0 is the root: it has no sibling, so B_0 aliases A_0.
    bslot = np.zeros((depths, 2), dtype=np.int64)
    pos = 0
    for d in range(depths):
        alloc = max(n >> d, CHUNK)
        bslot[d, 0] = pos
        bslot[d, 1] = pos + (alloc if d > 0 else 0)
        pos += (2 * alloc) if d > 0 else alloc
    return lofs, bslot, sz_llr, pos


@functools.lru_cache(maxsize=None)
def build_schedule(frozen_key: bytes, emit_spc: bool = True) -> Schedule:
    """frozen_key: bytes of the frozen mask (hashable).

    emit_spc=False decomposes single-parity-check nodes into subtrees
    (the list decoder's cross-check oracle); the SC kernel uses the
    default SPC leaves.
    """
    frozen = np.frombuffer(frozen_key, dtype=np.uint8)
    n = len(frozen)
    lofs, bslot, _sz_llr, _sz_beta = _regions(n)
    ops: list[tuple] = []
    cols = {"src": C_SRC, "src2": C_SRC2, "dst": C_DST, "bsrc": C_BSRC,
            "bsrc2": C_BSRC2, "bdst": C_BDST, "sidr": C_SIDR,
            "sidr2": C_SIDR2, "sidw": C_SIDW}

    def sid(d, side):
        return 2 * d + side

    def emit(op, d, w, side, **kw):
        """Emit chunked instructions for an op covering w columns."""
        nchunks = max(1, -(-w // CHUNK))
        for j in range(nchunks):
            off = j * CHUNK
            row = [0] * 14
            row[C_OP] = op
            row[C_D] = d
            row[C_WIDTH] = min(CHUNK, w - off)
            row[C_LAST] = int(j == nchunks - 1)
            row[C_SUB] = int(op in (OP_F, OP_G, OP_COMBINE)
                             and w % CHUNK != 0)
            for key, val in kw.items():
                # offsets advance with the chunk; slot ids do not
                row[cols[key]] = val + (0 if key.startswith("sid")
                                        else off)
            ops.append(tuple(row))

    def walk(lo, hi, d, side):
        w = hi - lo
        fz = frozen[lo:hi]
        s = int(fz.sum())
        own = bslot[d, side]
        if w <= CHUNK:
            leaf = None
            if s == w:
                leaf = OP_RATE0
            elif s == 0:
                leaf = OP_RATE1
            elif s == w - 1 and fz[-1] == 0:
                leaf = OP_REP
            elif s == 1 and fz[0] == 1 and emit_spc:
                leaf = OP_SPC
            if leaf is not None:
                emit(leaf, d, w, side, src=lofs[d], bdst=own,
                     sidw=sid(d, side))
                return
        h = w // 2
        emit(OP_F, d, h, side, src=lofs[d], src2=lofs[d] + h,
             dst=lofs[d + 1])
        walk(lo, lo + h, d + 1, 0)
        emit(OP_G, d, h, side, src=lofs[d], src2=lofs[d] + h,
             dst=lofs[d + 1], bsrc=bslot[d + 1, 0], sidr=sid(d + 1, 0))
        walk(lo + h, hi, d + 1, 1)
        # combine: own slot <- [bl * br | br] from children slots
        emit(OP_COMBINE, d, h, side, bsrc=bslot[d + 1, 0],
             bsrc2=bslot[d + 1, 1], bdst=own, dst=own + h,
             sidr=sid(d + 1, 0), sidr2=sid(d + 1, 1),
             sidw=sid(d, side))

    walk(0, n, 0, 0)
    return Schedule.from_table(np.array(ops, dtype=np.int32), n)


def scl_params(list_size: int, exact: bool, decompose_spc: bool):
    """(emit_spc, t_r1, t_spc, spc_exact) for a list size and mode, as
    ``modem_tpu.fec.scl_vm.scl_params``: exact=True is the bit-by-bit
    SCL-equivalent one-shot RATE1/SPC enumeration on the SPC-leaf
    schedule; at list_size=1 every mode is plain SC."""
    emit_spc = not (exact and decompose_spc)
    t_r1 = (list_size - 1) if exact else T_RATE1
    t_spc = list_size if exact else T_RATE1
    return emit_spc, t_r1, t_spc, bool(exact)
