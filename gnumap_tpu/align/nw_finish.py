"""Device finish for retained hits, in plain jnp/lax: pure-diagonal
detection and the exact direction-bit traceback.

Both run on a static number of hit slots (SENTINEL = empty) and reproduce
``oracle.nw_align(traceback=True)`` bit for bit: the same integer DP, the
same [FROZEN v4] band mask, and the oracle's tie-breaks (end cell = smallest
column, M preferred over Ix; predecessor preference M > Ix > Iy).

[FROZEN v6] Pure-diagonal detection.  Most retained hits align gap-free
(CIGAR ``<len>M``).  ``pure_detect`` proves such a hit with a banded forward
pass that also carries the gapless diagonal prefix sum gl of every band lane
(in diagonal-band coordinates a lane is a diagonal):

  * at the end row, cells equal to the score are M cells when open > 0 and
    ext > 0 (Ix trails M by at least min(open, ext); the column-0 ramp is
    negative), so the oracle's end cell is the smallest lane whose
    max(M, Ix) equals the score;
  * if gl at that lane equals the score, M equals the diagonal prefix at
    every row, so the backwalk's M-preferred tie rule follows the diagonal:
    CIGAR ``<len>M``, first aligned column = lane - boff;
  * otherwise no claim is made and the hit goes to ``traceback``.

Callers gate pure detection on open > 0, ext > 0 and a banded config.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from gnumap_tpu.config import DEEP, NEG_INF, POISON


def _emission(codes, emis_row):
    """codes (H, n) window codes 0..5, emis_row (H, 5) -> (H, n) int32;
    the poison code gets DEEP."""
    e = jnp.full(codes.shape, DEEP, jnp.int32)
    for v in range(5):
        e = jnp.where(codes == v, emis_row[:, v:v + 1], e)
    return e


def pure_detect(emis, windows, lens, scores, *, boff: int, bw: int,
                open_q: int, ext_q: int):
    """(pure bool[H], jfin int32[H]) for H hit slots.

    emis:    int32[H, L, 5]  emission table of each hit's read-strand
    windows: int32[H, W]     genome window codes (N = 4)
    lens:    int32[H]        true read lengths (0 = empty slot)
    scores:  int32[H]        the hits' alignment scores
    pure[h] proves the oracle's traceback is all-M with first aligned
    window column jfin[h] (see the module docstring)."""
    H, L, _ = emis.shape
    W = windows.shape[1]
    # lane b of row i is column c = i - boff + b; ext[:, k] = column k-boff+1
    pad_r = max(0, L + bw - 1 - boff - W)
    ext = jnp.concatenate(
        [jnp.full((H, boff), POISON, jnp.int32), windows.astype(jnp.int32),
         jnp.full((H, pad_r), POISON, jnp.int32)], axis=1)
    lane = jnp.arange(bw, dtype=jnp.int32)
    col0 = lane - boff                         # row-0 column of each lane
    M0 = jnp.broadcast_to(jnp.where((col0 >= 0) & (col0 <= W), 0, NEG_INF),
                          (H, bw)).astype(jnp.int32)
    neg = jnp.full((H, bw), NEG_INF, jnp.int32)
    ramp1 = lane * ext_q
    ramp2 = open_q + (lane - 1) * ext_q

    def body(carry, xs):
        M, Ix, Iy, gl, cM, cIx, cgl = carry
        emis_row, i = xs
        codes = jax.lax.dynamic_slice_in_dim(ext, i - 1, bw, axis=1)
        e = _emission(codes, emis_row)
        diag = jnp.maximum(jnp.maximum(M, Ix), Iy)
        M_new = jnp.maximum(e + diag, NEG_INF)
        gl_new = jnp.maximum(gl + e, NEG_INF)
        t = jnp.maximum(M - open_q, Ix - ext_q)
        Ix_new = jnp.maximum(
            jnp.concatenate([t[:, 1:], neg[:, :1]], axis=1), NEG_INF)
        pm = jax.lax.cummax(M_new + ramp1, axis=1)
        Iy_new = jnp.maximum(
            jnp.concatenate([neg[:, :1], pm[:, :-1]], axis=1) - ramp2,
            NEG_INF)
        end = (i == lens)[:, None]
        return (M_new, Ix_new, Iy_new, gl_new,
                jnp.where(end, M_new, cM), jnp.where(end, Ix_new, cIx),
                jnp.where(end, gl_new, cgl)), None

    init = (M0, neg, neg, jnp.zeros((H, bw), jnp.int32), neg, neg, neg)
    rows = jnp.arange(1, L + 1, dtype=jnp.int32)
    (_, _, _, _, cM, cIx, cgl), _ = jax.lax.scan(
        body, init, (jnp.transpose(emis, (1, 0, 2)), rows))
    fin = jnp.maximum(cM, cIx)
    BIG = jnp.int32(1 << 30)
    end_ll = jnp.min(jnp.where(fin == scores[:, None], lane, BIG), axis=1)
    found = end_ll < BIG
    at = jnp.where(found, end_ll, 0)[:, None]
    cm_at = jnp.take_along_axis(cM, at, axis=1)[:, 0]
    ci_at = jnp.take_along_axis(cIx, at, axis=1)[:, 0]
    cg_at = jnp.take_along_axis(cgl, at, axis=1)[:, 0]
    pure = (found & (cm_at >= ci_at) & (cg_at == scores) & (lens > 0)
            & (scores > 0))
    return pure, jnp.where(pure, end_ll - boff, 0)


def traceback(emis, windows, lens, *, open_q: int, ext_q: int, band=None):
    """Exact traceback of H hit slots.

    emis int32[H, L, 5], windows int32[H, W], lens int32[H] (0 = empty).
    Returns (ops int16[H, Lp], jfin int32[H]), Lp = L rounded up to 8:
      ops[h, i] = (n_deletions_after_read_base_i+1 << 1) | (1 if read base
      i+1 was an insertion else 0) for rows 1..len; jfin = the oracle's
      pos_in_window.  Empty slots give zeros.

    A forward lax.scan over read rows emits four direction bits per cell
      bits 0..1  M's diagonal predecessor (0 = M, 1 = Ix, 2 = Iy)
      bit  2     Ix came from M above (1) or from Ix (0)
      bit  3     Iy came from M at the left (1) or from Iy (0)
    and captures the end-row M/Ix; a second scan walks every hit back in
    lockstep, one read row per step, resolving each row's deletion run
    with a prefix max over the Iy-open bits."""
    H, L, _ = emis.shape
    W = windows.shape[1]
    Lp = -(-L // 8) * 8
    jj = jnp.arange(W + 1, dtype=jnp.int32)
    neg = jnp.full((H, 1), NEG_INF, jnp.int32)
    win = windows.astype(jnp.int32)

    def body(carry, xs):
        M, Ix, Iy, eM, eIx = carry                     # (H, W+1)
        emis_row, i = xs
        e = _emission(win, emis_row)
        prev_best = jnp.maximum(jnp.maximum(M, Ix), Iy)
        M_new = jnp.concatenate(
            [neg, jnp.maximum(e + prev_best[:, :-1], NEG_INF)], axis=1)
        if band is not None:
            boff, bw = band
            off_b = (jj < i - boff) | (jj > i - boff + bw - 1)
            off_b = off_b.at[0].set(False)[None, :]
            M_new = jnp.where(off_b, NEG_INF, M_new)
        Ix_new = jnp.maximum(jnp.maximum(M - open_q, Ix - ext_q), NEG_INF)
        pm = jax.lax.cummax(M_new + jj * ext_q, axis=1)
        Iy_new = jnp.concatenate(
            [neg, jnp.maximum(pm[:, :-1] - open_q - (jj[1:] - 1) * ext_q,
                              NEG_INF)], axis=1)
        if band is not None:
            Ix_new = jnp.where(off_b, NEG_INF, Ix_new)
            Iy_new = jnp.where(off_b, NEG_INF, Iy_new)
        # direction bits of columns 1..W (oracle.nw_align's backwalk rules)
        pm_, pix, piy = M[:, :-1], Ix[:, :-1], Iy[:, :-1]
        best = prev_best[:, :-1]
        m_dir = jnp.where(pm_ == best, 0, jnp.where(pix == best, 1, 2))
        ix_bit = (M[:, 1:] - open_q) >= (Ix[:, 1:] - ext_q)
        iy_bit = (M_new[:, :-1] - open_q) >= (Iy_new[:, :-1] - ext_q)
        d = (m_dir | (ix_bit.astype(jnp.int32) << 2)
             | (iy_bit.astype(jnp.int32) << 3)).astype(jnp.int8)
        end = (i == lens)[:, None]
        return (M_new, Ix_new, Iy_new, jnp.where(end, M_new, eM),
                jnp.where(end, Ix_new, eIx)), d

    M0 = jnp.zeros((H, W + 1), jnp.int32)
    I0 = jnp.full((H, W + 1), NEG_INF, jnp.int32)
    rows = jnp.arange(1, L + 1, dtype=jnp.int32)
    (_, _, _, eM, eIx), dirs = jax.lax.scan(
        body, (M0, I0, I0, I0, I0), (jnp.transpose(emis, (1, 0, 2)), rows))
    # end cell: smallest column on ties, M preferred over Ix
    fin = jnp.maximum(eM, eIx)
    j0 = jnp.argmax(fin, axis=1).astype(jnp.int32)
    m_at = jnp.take_along_axis(eM, j0[:, None], axis=1)[:, 0]
    ix_at = jnp.take_along_axis(eIx, j0[:, None], axis=1)[:, 0]
    st0 = jnp.where(m_at >= ix_at, 0, 1)
    col = jnp.arange(W, dtype=jnp.int32)               # column - 1

    def back(carry, xs):
        j, st = carry
        d_row, r = xs                                  # (H, W) int8, row
        active = r <= lens
        init = r == lens
        j = jnp.where(init, j0, j)
        st = jnp.where(init, st0, st)
        d32 = d_row.astype(jnp.int32)
        # deletion run: nearest Iy-open bit at or left of column j
        last_set = jax.lax.cummax(
            jnp.where(((d32 >> 3) & 1) == 1, col, -1), axis=1)
        c_lane = jnp.take_along_axis(
            last_set, jnp.clip(j - 1, 0, W - 1)[:, None], axis=1)[:, 0]
        c_lane = jnp.where(j >= 1, c_lane, -1)
        is_iy = active & (st == 2)
        d_cnt = jnp.where(is_iy, j - c_lane, 0)
        j = jnp.where(is_iy, c_lane, j)
        st = jnp.where(is_iy, 0, st)
        # consume read base r (state is M or Ix now)
        at = jnp.take_along_axis(
            d32, jnp.clip(j - 1, 0, W - 1)[:, None], axis=1)[:, 0]
        at = jnp.where(j >= 1, at, 0)
        is_m = active & (st == 0)
        is_i = active & (st == 1)
        ix_next = jnp.where((j == 0) | (((at >> 2) & 1) == 0), 1, 0)
        st = jnp.where(is_m, at & 3, jnp.where(is_i, ix_next, st))
        j = jnp.where(is_m, j - 1, j)
        op = jnp.where(active, (d_cnt << 1) | is_i.astype(jnp.int32), 0)
        return (j, st), op

    zeros = jnp.zeros((H,), jnp.int32)
    (jfin, _), ops = jax.lax.scan(back, (zeros, zeros),
                                  (dirs, rows), reverse=True)
    ops = jnp.transpose(ops).astype(jnp.int16)         # (H, L)
    ops = jnp.pad(ops, ((0, 0), (0, Lp - L)))
    live = lens > 0
    return (jnp.where(live[:, None], ops, 0),
            jnp.where(live, jfin, 0).astype(jnp.int32))


def decode_ops(ops_row: np.ndarray, length: int):
    """Host-side decode of one hit's ops row -> (cigar, ref_len).

    ops_row[i] = (n_deletions_after_consuming_read_base_i+1 << 1) | op_bit
    for i in [0, length); op_bit 1 = I, 0 = M.  Forward CIGAR is
    c_1 D^{d_1} c_2 D^{d_2} ... c_len (no leading/trailing D by
    construction — the walk starts/ends on a consume)."""
    row = ops_row[:length]
    d = row >> 1
    opb = row & 1
    n_ins = int(opb.sum())
    n_del = int(d.sum())
    if n_ins == 0 and n_del == 0:
        return f"{length}M", length
    parts = []
    run_op, run_n = None, 0
    for i in range(length):
        op = "I" if opb[i] else "M"
        if op == run_op:
            run_n += 1
        else:
            if run_n:
                parts.append(f"{run_n}{run_op}")
            run_op, run_n = op, 1
        if d[i]:
            parts.append(f"{run_n}{run_op}")
            parts.append(f"{int(d[i])}D")
            run_op, run_n = None, 0
    if run_n:
        parts.append(f"{run_n}{run_op}")
    return "".join(parts), (length - n_ins) + n_del
