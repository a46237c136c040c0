"""Batched probabilistic NW, pure jnp (the XLA reference kernel).

Score-only affine-gap fitting alignment over many independent (read,
candidate-locus) pairs at once: ``lax.scan`` over read rows, each step doing
vector updates over (pairs, W+1) int32 state.  The in-row gap chain
is the exact prefix-max unrolling frozen in oracle.nw_align (see its
docstring) — bit-identical integer scores on every backend.

Padded-read handling [FROZEN]: rows at or beyond a read's length have
all-zero emission AND free read-gap transitions (open = extend = 0), so every
final-row state at row Lmax equals the corresponding row-L state maximum —
scores are exactly invariant to padding for any window.  The oracle scores
unpadded reads over the same fixed window width; equality is tested.

The banded GPU kernel (band_kernel.py) replaces it on the hot path with
identical semantics; this file remains the plain reference and the path
for CPUs and unbanded configs.

Reference analog: ``ScoredSeq::align`` inner loop (SURVEY.md §3.3 [REPO?]).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gnumap_tpu.config import NEG_INF


@functools.partial(jax.jit, static_argnames=("open_q", "ext_q", "band"))
def nw_scores(emis: jax.Array, windows: jax.Array, lens: jax.Array, *,
              open_q: int, ext_q: int, band=None) -> jax.Array:
    """Alignment scores for P independent pairs.

    emis:    int32[P, L, 5]  emission tables (pad rows all-zero)
    windows: int32[P, W]     genome window codes (N = 4)
    lens:    int32[P]        true read lengths (rows >= len are pad)
    band:    (boff, bw) [FROZEN v3] DP band (MapperConfig.band) or None
    returns: int32[P]        fitting-alignment scores

    The score is captured at each read's true last row (matching
    oracle.nw_align, whose DP has exactly len rows); with band=None the
    free-pad rows make the captured value equal the old row-Lmax max, so
    unbanded scores are unchanged.
    """
    P, L, _ = emis.shape
    W = windows.shape[1]
    jj = jnp.arange(W + 1, dtype=jnp.int32)
    neg = jnp.full((P, 1), NEG_INF, dtype=jnp.int32)
    row_ids = jnp.arange(L, dtype=jnp.int32)

    def body(carry, xs):
        M, Ix, Iy, cap = carry
        emis_row, in_read, i = xs            # i = 1-based row number
        opn = jnp.where(in_read, open_q, 0).astype(jnp.int32)[:, None]
        ext = jnp.where(in_read, ext_q, 0).astype(jnp.int32)[:, None]
        e = jnp.take_along_axis(emis_row, windows, axis=1)
        prev_best = jnp.maximum(jnp.maximum(M, Ix), Iy)
        M_new = jnp.concatenate(
            [neg, jnp.maximum(e + prev_best[:, :-1], NEG_INF)], axis=1)
        if band is not None:                 # [FROZEN v3]: M masked pre-pm
            boff, bw = band
            off_b = (jj[None, 1:] < i - boff) | (jj[None, 1:]
                                                 > i - boff + bw - 1)
            off_b = jnp.concatenate(
                [jnp.zeros((1, 1), bool), off_b], axis=1)
            M_new = jnp.where(off_b, NEG_INF, M_new)
        Ix_new = jnp.maximum(jnp.maximum(M - opn, Ix - ext), NEG_INF)
        pm = jax.lax.cummax(M_new + jj[None, :] * ext_q, axis=1)
        Iy_new = jnp.concatenate(
            [neg,
             jnp.maximum(pm[:, :-1] - open_q - (jj[1:] - 1)[None, :] * ext_q,
                         NEG_INF)], axis=1)
        if band is not None:
            Ix_new = jnp.where(off_b, NEG_INF, Ix_new)
            Iy_new = jnp.where(off_b, NEG_INF, Iy_new)
        fin = jnp.max(jnp.maximum(M_new, Ix_new), axis=1)
        cap = jnp.where(i == lens, fin, cap)
        return (M_new, Ix_new, Iy_new, cap), None

    M0 = jnp.zeros((P, W + 1), dtype=jnp.int32)
    I0 = jnp.full((P, W + 1), NEG_INF, dtype=jnp.int32)
    cap0 = jnp.zeros((P,), dtype=jnp.int32)   # len-0 reads score 0
    in_read = (row_ids[:, None] < lens[None, :])          # (L, P)
    (_, _, _, cap), _ = jax.lax.scan(
        body, (M0, I0, I0, cap0),
        (jnp.transpose(emis, (1, 0, 2)), in_read, row_ids + 1))
    return cap


def nw_scores_multi(emis: jax.Array, windows: jax.Array, lens: jax.Array,
                    open_q: int, ext_q: int, band=None) -> jax.Array:
    """Like nw_scores but one emission table shared across C candidate
    windows per read: emis int32[B, L, 5], windows int32[B, C, W] ->
    scores int32[B, C].  The emission gather is 5 predicated selects
    (windows hold codes 0..4), which vectorizes cleanly.
    ``band`` as in nw_scores ([FROZEN v3]).
    """
    B, L, _ = emis.shape
    _, C, W = windows.shape
    jj = jnp.arange(W + 1, dtype=jnp.int32)
    neg = jnp.full((B, C, 1), NEG_INF, dtype=jnp.int32)
    row_ids = jnp.arange(L, dtype=jnp.int32)

    def body(carry, xs):
        M, Ix, Iy, cap = carry                       # (B, C, W+1), (B, C)
        emis_row, in_read, i = xs                    # (B, 5), (B,), ()
        opn = jnp.where(in_read, open_q, 0).astype(jnp.int32)[:, None, None]
        ext = jnp.where(in_read, ext_q, 0).astype(jnp.int32)[:, None, None]
        e = jnp.zeros((B, C, W), dtype=jnp.int32)
        for v in range(5):
            e = jnp.where(windows == v, emis_row[:, v][:, None, None], e)
        prev_best = jnp.maximum(jnp.maximum(M, Ix), Iy)
        M_new = jnp.concatenate(
            [neg, jnp.maximum(e + prev_best[..., :-1], NEG_INF)], axis=-1)
        if band is not None:                 # [FROZEN v3]: M masked pre-pm
            boff, bw = band
            off_b = (jj[1:] < i - boff) | (jj[1:] > i - boff + bw - 1)
            off_b = jnp.concatenate(
                [jnp.zeros((1,), bool), off_b])[None, None, :]
            M_new = jnp.where(off_b, NEG_INF, M_new)
        Ix_new = jnp.maximum(jnp.maximum(M - opn, Ix - ext), NEG_INF)
        pm = jax.lax.cummax(M_new + jj * ext_q, axis=2)
        Iy_new = jnp.concatenate(
            [neg,
             jnp.maximum(pm[..., :-1] - open_q - (jj[1:] - 1) * ext_q,
                         NEG_INF)], axis=-1)
        if band is not None:
            Ix_new = jnp.where(off_b, NEG_INF, Ix_new)
            Iy_new = jnp.where(off_b, NEG_INF, Iy_new)
        fin = jnp.max(jnp.maximum(M_new, Ix_new), axis=-1)
        cap = jnp.where((i == lens)[:, None], fin, cap)
        return (M_new, Ix_new, Iy_new, cap), None

    M0 = jnp.zeros((B, C, W + 1), dtype=jnp.int32)
    I0 = jnp.full((B, C, W + 1), NEG_INF, dtype=jnp.int32)
    cap0 = jnp.zeros((B, C), dtype=jnp.int32)   # len-0 reads score 0
    in_read = (row_ids[:, None] < lens[None, :])          # (L, B)
    (_, _, _, cap), _ = jax.lax.scan(
        body, (M0, I0, I0, cap0),
        (jnp.transpose(emis, (1, 0, 2)), in_read, row_ids + 1))
    return cap


def max_read_scores(emis: jax.Array) -> jax.Array:
    """Max attainable score per read: sum_i max_b emis[i, b] (b < 4).
    Pad rows are all-zero and contribute 0.  int32[B]."""
    return jnp.sum(jnp.max(emis[..., :4], axis=-1), axis=-1)
