"""Per-base probability vectors (PWMs) from quality / intensity data.

GNUMAP's defining input transform: each read base becomes a probability
distribution over {A,C,G,T} derived from the sequencer's quality or intensity
values rather than a hard call (Clement et al. 2010; SURVEY.md §1 L2,
reference ``SeqReader.*`` / ``centers.h`` [REPO?]).

PWMs are quantized to int32 fixed point (rows sum to ``PWM_SCALE``) so that
all downstream scoring is exact integer arithmetic — identical on x86 NumPy,
XLA:CPU and the GPU (SURVEY.md §7 "bit-identical scores").
"""

from __future__ import annotations

import numpy as np

from gnumap_tpu.config import BASE_N, N_BASES, PWM_SCALE


def phred_to_prob(qual: np.ndarray) -> np.ndarray:
    """Phred quality Q -> probability the called base is correct."""
    return 1.0 - np.power(10.0, -np.asarray(qual, dtype=np.float64) / 10.0)


def _quantize_rows(p: np.ndarray) -> np.ndarray:
    """Quantize probability rows to int32 summing exactly to PWM_SCALE.

    Largest-remainder rounding: floor everything, then hand the leftover
    units to the cells with the largest fractional parts (ties broken by
    base order A<C<G<T — frozen tie-break).
    """
    p = np.asarray(p, dtype=np.float64)
    scaled = p * PWM_SCALE
    base = np.floor(scaled).astype(np.int64)
    rem = scaled - base
    deficit = PWM_SCALE - base.sum(axis=-1)
    # rank bases by remainder (desc), stable so base order breaks ties
    order = np.argsort(-rem, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(N_BASES)[None, :] *
                      np.ones(order.shape[:-1] + (1,), dtype=np.int64), axis=-1)
    bump = (ranks < deficit[..., None]).astype(np.int64)
    return (base + bump).astype(np.int32)


def pwm_from_calls(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """(L,) base codes + (L,) Phred quals -> (L, 4) int32 quantized PWM.

    Called base gets p = 1-10^(-Q/10); the other three split (1-p)/3 evenly.
    N bases get a uniform distribution.
    """
    codes = np.asarray(codes)
    L = codes.shape[-1]
    p = phred_to_prob(quals)
    pwm = np.empty(codes.shape + (N_BASES,), dtype=np.float64)
    pwm[...] = ((1.0 - p) / 3.0)[..., None]
    called = np.clip(codes, 0, 3)
    np.put_along_axis(pwm, called[..., None], p[..., None], axis=-1)
    pwm[codes == BASE_N] = 0.25
    return _quantize_rows(pwm)


def pwm_from_probs(probs: np.ndarray) -> np.ndarray:
    """(L, 4) float probabilities (e.g. from Illumina ``_prb.txt``) -> int32 PWM.

    Rows are renormalized to sum to 1 before quantization.
    """
    p = np.asarray(probs, dtype=np.float64)
    s = p.sum(axis=-1, keepdims=True)
    s = np.where(s <= 0, 1.0, s)
    p = np.where(p.sum(axis=-1, keepdims=True) <= 0, 0.25, p / s)
    return _quantize_rows(p)


_PWM_TABLE = None
PWM_TABLE_QMAX = 127


def pwm_table() -> np.ndarray:
    """int32[QMAX+1, 5, 4]: the quantized PWM row for every (Phred quality,
    called code) pair — code 4 (N) is the uniform row.

    A Phred-derived PWM row depends ONLY on (q, code), so the whole batch
    PWM is one table gather.  Built with pwm_from_calls itself, so rows are
    bit-identical to the per-read path by construction; lets the device
    reconstruct PWMs from (codes, quals) without shipping the (B, L, 4)
    int32 array over the host->device link."""
    global _PWM_TABLE
    if _PWM_TABLE is None:
        t = np.empty((PWM_TABLE_QMAX + 1, 5, 4), np.int32)
        for c in range(5):
            codes = np.full(PWM_TABLE_QMAX + 1, c, np.int8)
            t[:, c, :] = pwm_from_calls(codes,
                                        np.arange(PWM_TABLE_QMAX + 1))
        _PWM_TABLE = t
    return _PWM_TABLE


def pwm_rows_from_table(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Host-side table lookup (exactly pwm_from_calls, batched)."""
    t = pwm_table()
    q = np.clip(np.asarray(quals, np.int64), 0, PWM_TABLE_QMAX)
    c = np.clip(np.asarray(codes, np.int64), 0, 4)
    # single flat fancy index: ~7x faster than the 2-array form at batch
    # scale (same rows by construction)
    return t.reshape(-1, 4)[(q * 5 + c).ravel()].reshape(q.shape + (4,))


def pwm_revcomp(pwm_q: np.ndarray) -> np.ndarray:
    """Reverse-complement a quantized PWM: reverse positions, swap A<->T, C<->G."""
    return np.ascontiguousarray(pwm_q[..., ::-1, ::-1])
