"""Substitution matrices: normal, bisulfite (GNUMAP-bs), user override.

The reference's pluggable scoring hierarchy (``ScoredSeq`` with
``NormalScoredSeq`` / ``BSScoredSeq`` / ``SNPScoredSeq`` subclasses,
SURVEY.md §1 L3 [REPO?]) becomes *data*, not classes: every mode is just a
different int32 substitution matrix handed to the same DP kernel — the
"alternate DP parameterization" required by BASELINE.json:5.

Matrix layout: ``S[read_base (4), genome_code (5)]`` in fixed point
(``S_SCALE`` units).  Column 4 is the genome-N column.

Emission precompute: for a read PWM ``P`` (L,4) the
per-cell DP emission is ``E[i, g] = sum_b P[i,b] * S[b,g]`` — a single
(L,4)x(4,5) integer matmul done once per read/strand, after which the DP only
gathers ``E[i, genome_window[j]]``.
"""

from __future__ import annotations

import numpy as np

from gnumap_tpu.config import MapperConfig, S_SCALE


def _quant(S: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(S, dtype=np.float64) * S_SCALE).astype(np.int32)


def normal_matrix(cfg: MapperConfig) -> np.ndarray:
    """Standard match/mismatch matrix; genome-N scores as mismatch."""
    if cfg.subst_matrix is not None:
        S4 = np.asarray(cfg.subst_matrix, dtype=np.float64)
        if S4.shape != (4, 4):
            raise ValueError("subst_matrix must be 4x4 (read base x genome base)")
    else:
        S4 = np.full((4, 4), cfg.mismatch_score, dtype=np.float64)
        np.fill_diagonal(S4, cfg.match_score)
    S = np.full((4, 5), cfg.mismatch_score, dtype=np.float64)
    S[:, :4] = S4
    return _quant(S)


def bisulfite_matrix(cfg: MapperConfig, strand: str) -> np.ndarray:
    """GNUMAP-bs asymmetric matrices (SURVEY.md §2 "Bisulfite mode").

    Bisulfite conversion turns unmethylated genome C into read T.  On the
    forward strand a read T over a genome C therefore scores as a match; on
    the reverse strand (read is the complement) a read A over a genome G
    scores as a match.  All other cells follow the normal matrix.
    """
    S = normal_matrix(cfg).astype(np.float64) / S_SCALE
    match = cfg.match_score
    if strand == "+":
        S[3, 1] = match  # read T vs genome C
    elif strand == "-":
        S[0, 2] = match  # read A vs genome G
    else:
        raise ValueError("strand must be '+' or '-'")
    return _quant(S)


def matrices_for_mode(cfg: MapperConfig) -> tuple[np.ndarray, np.ndarray]:
    """(S_plus, S_minus) int32 matrices for the configured mode.

    In normal mode both strands share one matrix; bisulfite mode is
    strand-asymmetric.
    """
    if cfg.bisulfite:
        return bisulfite_matrix(cfg, "+"), bisulfite_matrix(cfg, "-")
    S = normal_matrix(cfg)
    return S, S


def emission_int(pwm_q: np.ndarray, S_q: np.ndarray) -> np.ndarray:
    """Integer emission table: (..., L, 4) PWM x (4,5) matrix -> (..., L, 5).

    Exact int32 matmul (values bounded by PWM_SCALE * S_SCALE * max|S|).
    """
    return np.matmul(pwm_q.astype(np.int64), S_q.astype(np.int64)).astype(np.int32)


def max_read_score(emis: np.ndarray, lens: np.ndarray | None = None) -> np.ndarray:
    """Maximum attainable alignment score per read: sum_i max_g E[i, g].

    This is the denominator of the reference's ``-a`` retention threshold
    (keep loci scoring >= a * max attainable, SURVEY.md §3.4).  ``lens``
    masks padded tail positions for batched fixed-shape reads.
    """
    per_pos = emis[..., :4].max(axis=-1)  # exclude genome-N column
    if lens is not None:
        L = emis.shape[-2]
        mask = np.arange(L)[None, :] < np.asarray(lens)[:, None]
        per_pos = np.where(mask, per_pos, 0)
    return per_pos.sum(axis=-1).astype(np.int64)
