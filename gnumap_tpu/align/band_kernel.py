"""Banded affine-gap scoring kernel for the GPU (Pallas, Triton route).

Computes, for every valid (read-strand, candidate) pair, the same integer
score as ``nw_ref.nw_scores_multi(..., band=cfg.band())`` and
``oracle.nw_align`` ([FROZEN v4] band), holding each pair's band state in
registers across all read rows so that emissions and genome bytes are read
once instead of a (pairs x W) state rectangle per row.

Layout: pairs across lanes.  One program owns a block of ``BLOCK`` pairs,
one pair per thread; the ``bw`` band columns are unrolled in Python and the
read rows run in a ``fori_loop``.  In diagonal-band coordinates lane ``b``
of read row ``i`` is window column ``c = i - boff + b`` (1-based), so

  * the diagonal predecessor (i-1, c-1) is the same lane of the previous row;
  * the vertical predecessor (i-1, c) is lane ``b + 1`` of the previous row
    (lane ``bw - 1`` has none: it is outside the band, exactly NEG_INF);
  * the in-row gap chain Iy is a running max along the unrolled lanes.

Cells whose column lies outside ``[1, W]`` take the poison code 5, whose
emission ``DEEP`` floors M to exactly NEG_INF.  Column 0 needs no special
case: its lane carries M = NEG_INF and the leading-insertion ramp as Ix
through the ordinary recurrence, and the ramp's closed form
``-(open + (len - 1) * ext)`` joins the score at the end row (column 0 is
exempt from the band).

Three values are carried per lane instead of M, Ix and Iy: the diagonal
source ``D = max(M, Ix, Iy)``, the vertical source
``T = max(M - open, Ix - ext)`` and the window code.  Ix and Iy are not
floored at NEG_INF: M is, and every consumer of Ix or Iy takes a max with
M or with a floored value, so values below NEG_INF never reach a score.

Valid pairs are compacted to the front before the call; blocks past the
valid count exit at once, so work scales with the real candidate count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gnumap_tpu.config import DEEP, NEG_INF, POISON, SENTINEL, WINDOW_ALIGN

# pairs per program, one per thread: 128 pairs on 4 warps was the fastest
# of (64, 2), (128, 4), (128, 8) and (256, 8) on an H100 (80GB HBM3)
BLOCK = 128
NUM_WARPS = 4


def _band_kernel(n_ref, read_ref, ws_ref, lens_ref, emis_ref, g_ref, out_ref,
                 *, B2: int, G: int, W: int, boff: int, bw: int,
                 open_q: int, ext_q: int):
    base = pl.program_id(0) * BLOCK

    @pl.when(base < n_ref[0])
    def _():
        sl = pl.ds(base, BLOCK)
        read = read_ref[sl]
        ws = ws_ref[sl]
        ln = lens_ref[sl]
        maxlen = jnp.max(ln)

        def col_code(c):
            """Window code of 1-based column ``c`` (a traced or static
            scalar) for every pair of the block."""
            gi = ws + (c - 1)
            ok = (gi >= 0) & (gi < G)
            code = g_ref[jnp.clip(gi, 0, G - 1)].astype(jnp.int32)
            code = jnp.where(ok, code, 4)
            inwin = (c >= 1) & (c <= W)
            return jnp.where(inwin, code, POISON)

        zero = jnp.zeros((BLOCK,), jnp.int32)
        # row 0: M[0][c] = 0 for c in [0, W], Ix = Iy = NEG_INF elsewhere
        D, T = [], []
        for b in range(bw):
            c = b - boff
            m0 = 0 if 0 <= c <= W else NEG_INF
            D.append(zero + m0)
            T.append(zero + max(m0 - open_q, NEG_INF - ext_q))
        # lane b holds column b - boff; row 1 first shifts lanes down, so
        # lane 0's code is never read
        win = [zero + POISON] + [col_code(b - boff) for b in range(1, bw)]

        def row(i, carry):
            D, T, win, cap = carry
            win = win[1:] + (col_code(i - boff + bw - 1),)
            off = (i - 1) * 5 * B2 + read
            ev = [emis_ref[off + v * B2] for v in range(5)]
            nD, nT, ends = [], [], []
            M_prev = None
            y = None
            for b in range(bw):
                w = win[b]
                e = jnp.where(w == 4, ev[4], DEEP)
                for v in range(4):
                    e = jnp.where(w == v, ev[v], e)
                M = jnp.maximum(e + D[b], NEG_INF)
                Ix = T[b + 1] if b + 1 < bw else None
                if b >= 1:
                    t = M_prev - open_q
                    y = t if y is None else jnp.maximum(t, y - ext_q)
                d = M
                if Ix is not None:
                    d = jnp.maximum(d, Ix)
                if y is not None:
                    d = jnp.maximum(d, y)
                nD.append(d)
                t2 = M - open_q
                nT.append(t2 if Ix is None
                          else jnp.maximum(t2, Ix - ext_q))
                ends.append(M if Ix is None else jnp.maximum(M, Ix))
                M_prev = M

            def capture(ends, cap):
                fin = ends[0]
                for f in ends[1:]:
                    fin = jnp.maximum(fin, f)
                return jnp.where(i == ln, fin, cap)

            # the end-row max runs only on rows where some pair ends
            any_end = jnp.max(jnp.where(i == ln, 1, 0)) > 0
            cap = jax.lax.cond(any_end, capture, lambda ends, cap: cap,
                               tuple(ends), cap)
            return tuple(nD), tuple(nT), win, cap

        carry = (tuple(D), tuple(T), tuple(win), zero)
        _, _, _, cap = jax.lax.fori_loop(1, maxlen + 1, row, carry)
        # column 0's leading-insertion ramp at the end row
        ramp = jnp.maximum(-open_q - (ln - 1) * ext_q, NEG_INF)
        out_ref[sl] = jnp.where(ln > 0, jnp.maximum(cap, ramp), 0)


@functools.partial(jax.jit, static_argnames=(
    "W", "slack", "boff", "bw", "open_q", "ext_q", "interpret"))
def nw_scores_banded(emis2: jax.Array, cands: jax.Array, lens2: jax.Array,
                     g_codes: jax.Array, *, W: int, slack: int, boff: int,
                     bw: int, open_q: int, ext_q: int,
                     interpret: bool = False) -> jax.Array:
    """Banded scores for every (read-strand, candidate) pair.

    emis2:   int32[B2, L, 5]  emission tables (pad rows all-zero)
    cands:   int32[B2, C]     candidate anchors, SENTINEL = empty slot
    lens2:   int32[B2]        true read lengths
    g_codes: int8[G]          genome codes (N = 4)
    returns: int32[B2, C]     scores, NEG_INF at SENTINEL slots
    """
    B2, L, _ = emis2.shape
    C = cands.shape[1]
    G = g_codes.shape[0]
    NP = B2 * C
    NPp = -(-NP // BLOCK) * BLOCK
    flat = cands.reshape(-1)
    valid = flat != SENTINEL
    # compact the valid pairs to the front, in (read-strand, slot) order
    k = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n = k[-1] + 1
    slot = jnp.where(valid, k, NPp)
    src = jnp.zeros((NPp,), jnp.int32).at[slot].set(
        jnp.arange(NP, dtype=jnp.int32), mode="drop")
    live = jnp.arange(NPp, dtype=jnp.int32) < n
    read = src // C
    ws = ((flat[src] - slack) // WINDOW_ALIGN) * WINDOW_ALIGN
    ws = jnp.where(live, ws, 0)
    lens_p = jnp.where(live, lens2[read], 0)
    emis_t = jnp.transpose(emis2, (1, 2, 0)).reshape(-1)    # (L * 5 * B2,)
    kernel = functools.partial(
        _band_kernel, B2=B2, G=G, W=W, boff=boff, bw=bw,
        open_q=open_q, ext_q=ext_q)
    out = pl.pallas_call(
        kernel,
        grid=(NPp // BLOCK,),
        out_shape=jax.ShapeDtypeStruct((NPp,), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nw_band",
    )(n.reshape(1), read, ws, lens_p, emis_t, g_codes)
    tgt = jnp.where(live, src, NP)
    scores = jnp.full((NP,), NEG_INF, jnp.int32).at[tgt].set(
        out, mode="drop")
    return scores.reshape(B2, C)
