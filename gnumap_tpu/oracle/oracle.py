"""FROZEN CPU ORACLE — pure-NumPy reference implementation of the whole mapper.

This file is the conformance anchor prescribed by SURVEY.md §4: the reference
mount was empty (zero files), so bit-level behavior could not be read from the
C++ GNUMAP binary.  Semantics below implement the published GNUMAP algorithm
(Clement et al., Bioinformatics 2010: probabilistic Needleman-Wunsch with
affine gaps over per-base probability vectors; fractional multi-map posterior
weighting) with every ambiguous detail FROZEN and documented.  All device paths
are property-tested against this file.

Simplicity over speed on purpose: Python loops are fine, workloads are small.

FROZEN SEMANTICS (change any of these => regenerate all golden files):
  * DP: "fitting" alignment — read global, genome-window ends free.
      M[0][j] = 0;  Ix[0][j] = Iy[0][j] = -inf
      M[i][0] = Iy[i][0] = -inf;  Ix[i][0] = -(open + (i-1)*ext)
      M[i][j]  = E[i-1][g[j-1]] + max(M,Ix,Iy)[i-1][j-1]
      Ix[i][j] = max(M[i-1][j] - open, Ix[i-1][j] - ext)   # read base vs gap
      Iy[i][j] = max(M[i][j-1] - open, Iy[i][j-1] - ext)   # genome base vs gap
      score    = max_j max(M[L][j], Ix[L][j])
  * Integer fixed point: emissions int32 (PWM_SCALE*S_SCALE units), NEG_INF
    sentinel; gap penalties quantized with SCORE_ONE.
  * Tie-breaks: traceback end = smallest j achieving the max, state preference
    M > Ix > Iy; candidate order = ascending genome position, '+' before '-'.
  * Seeds at read offsets 0, j, 2j, ... <= L-m; seeds whose k-mer contains N
    are skipped; seeds with more than max_hits_per_seed index hits are skipped
    (repeat cap); per-strand candidates deduped; over the cap the
    max_candidates ranked best by (seed votes desc, position asc) are kept
    [FROZEN v2]; candidate order stays ascending by position.
  * Retention: locus kept iff score >= threshold_for(max_attainable(strand))
    (exact integer ceil(a_q * ms / 2^32), MapperConfig.threshold_for) and
    score > 0; weights w_i = s_i / sum(s_j) over all retained loci of both
    strands (float64).
  * Coverage: +w at every genome position consumed by the alignment (M and D
    columns).  SNP tallies: for M columns, tallies[p,b] += w * pwm[i,b]/SCALE.
  * Window [FROZEN, shared with the device paths via MapperConfig]:
    start = floor((cand - gap_slack)/WINDOW_ALIGN)*WINDOW_ALIGN,
    width = max_read_len + 2*gap_slack + WINDOW_ALIGN; out-of-range -> N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from gnumap_tpu.config import (BASE_N, NEG_INF, PWM_SCALE, MapperConfig)
from gnumap_tpu.core import packing, pwm as pwm_mod
from gnumap_tpu.align import scoring


# ---------------------------------------------------------------------------
# Genome + index (oracle flavor: python dict)
# ---------------------------------------------------------------------------

SPACER_N = 64  # Ns inserted between concatenated contigs


@dataclasses.dataclass
class OracleGenome:
    codes: np.ndarray                 # concatenated int8 codes with N spacers
    names: List[str]
    starts: np.ndarray                # per-contig start offset in codes
    lengths: np.ndarray               # per-contig length

    @classmethod
    def from_contigs(cls, contigs: List[Tuple[str, str]]) -> "OracleGenome":
        names, starts, lengths, parts = [], [], [], []
        off = 0
        spacer = np.full(SPACER_N, BASE_N, dtype=np.int8)
        for name, seq in contigs:
            c = packing.encode(seq)
            names.append(name)
            starts.append(off)
            lengths.append(len(c))
            parts.append(c)
            parts.append(spacer)
            off += len(c) + SPACER_N
        return cls(np.concatenate(parts) if parts else np.zeros(0, np.int8),
                   names, np.array(starts), np.array(lengths))

    def locate(self, pos: int) -> Tuple[int, int]:
        """Global offset -> (contig_idx, 0-based offset in contig)."""
        idx = int(np.searchsorted(self.starts, pos, side="right")) - 1
        return idx, pos - int(self.starts[idx])

    def window(self, start: int, width: int) -> np.ndarray:
        """Genome window with N padding outside [0, len)."""
        out = np.full(width, BASE_N, dtype=np.int8)
        lo, hi = max(start, 0), min(start + width, len(self.codes))
        if hi > lo:
            out[lo - start:hi - start] = self.codes[lo:hi]
        return out


def build_oracle_index(gen: OracleGenome, cfg: MapperConfig,
                       collapse: str | None = None) -> Dict[int, List[int]]:
    if collapse is None:
        kmers, valid = packing.kmer_codes(gen.codes, cfg.mer_size)
    else:
        # bisulfite [FROZEN]: base-3 collapsed-alphabet k-mers
        from gnumap_tpu.index.builder import kmer_codes_b3
        kmers, valid = kmer_codes_b3(gen.codes, cfg.mer_size, collapse)
    table: Dict[int, List[int]] = {}
    for p in range(len(kmers)):
        if valid[p]:
            table.setdefault(int(kmers[p]), []).append(p)
    return table


def build_oracle_bs_indexes(gen: OracleGenome, cfg: MapperConfig):
    """(plus, minus) collapsed indexes for bisulfite mode [FROZEN]:
    plus-strand reads seed on the C->T-collapsed alphabet, minus-strand
    (reverse-complemented) reads on G->A — conversion never breaks a seed
    (GNUMAP-bs, SURVEY.md §2)."""
    return (build_oracle_index(gen, cfg, "ct"),
            build_oracle_index(gen, cfg, "ga"))


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

def nw_align(emis: np.ndarray, window: np.ndarray, cfg: MapperConfig,
             traceback: bool = False):
    """Integer affine-gap fitting alignment of one read against one window.

    ``emis``: (L, 5) int32 emission table (pwm @ S).  Returns ``score`` or
    ``(score, pos_in_window, cigar, ref_len)`` with traceback.
    Mirrors reference ``ScoredSeq::align`` semantics (SURVEY.md §3.3).

    Row-vectorized: the in-row gap chain Iy[i][j] = max(M[i][j-1]-open,
    Iy[i][j-1]-ext) is unrolled exactly to a prefix max of M[i][k]+k*ext —
    identical values, computed with np.maximum.accumulate.  All cells are
    floored at NEG_INF (frozen; the device paths clamp identically).
    """
    L = emis.shape[0]
    W = len(window)
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    band = cfg.band()
    M = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    Ix = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    Iy = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    M[0, :] = 0
    jj = np.arange(W + 1, dtype=np.int64)
    win = window.astype(np.int64)
    for i in range(1, L + 1):
        # [FROZEN v3] band mask (config.MapperConfig.band): out-of-band
        # cells are exactly NEG_INF.  M is masked BEFORE the in-row prefix
        # max so the Iy chain only sources in-band columns — the order the
        # banded device DP realizes by construction.
        if band is not None:
            boff, bw = band
            off_band = (jj[1:] < i - boff) | (jj[1:] > i - boff + bw - 1)
        e = emis[i - 1].astype(np.int64)[win]                 # (W,)
        prev_best = np.maximum(np.maximum(M[i - 1], Ix[i - 1]), Iy[i - 1])
        M[i, 1:] = np.maximum(e + prev_best[:-1], NEG_INF)
        if band is not None:
            M[i, 1:][off_band] = NEG_INF
        Ix[i, :] = np.maximum(
            np.maximum(M[i - 1] - open_q, Ix[i - 1] - ext_q), NEG_INF)
        pm = np.maximum.accumulate(M[i] + jj * ext_q)
        Iy[i, 1:] = np.maximum(pm[:-1] - open_q - (jj[1:] - 1) * ext_q, NEG_INF)
        if band is not None:
            Ix[i, 1:][off_band] = NEG_INF
            Iy[i, 1:][off_band] = NEG_INF
    finals = np.maximum(M[L], Ix[L])
    score = int(finals.max())
    if not traceback:
        return score
    j = int(np.argmax(finals))          # smallest j on ties (np.argmax = first)
    state = 0 if M[L, j] >= Ix[L, j] else 1   # prefer M on tie
    i = L
    ops: List[str] = []
    while i > 0:
        if state == 0:                  # M: consumed read i, genome j
            ops.append("M")
            prev = (M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            best = max(prev)
            state = prev.index(best)    # M > Ix > Iy preference
            i, j = i - 1, j - 1
        elif state == 1:                # Ix: consumed read i only
            ops.append("I")
            if j == 0:
                i -= 1
                continue                # column-0 ramp: stays Ix
            if M[i - 1, j] - open_q >= Ix[i - 1, j] - ext_q:
                state = 0
            i -= 1
        else:                           # Iy: consumed genome j only
            ops.append("D")
            if M[i, j - 1] - open_q >= Iy[i, j - 1] - ext_q:
                state = 0
            j -= 1
    ops.reverse()
    # Strip leading/trailing D (free genome ends never traced, but guard).
    cigar = _rle(ops)
    ref_len = sum(1 for o in ops if o in "MD")
    pos_in_window = j            # first consumed genome column is j+1 -> offset j
    return score, pos_in_window, cigar, ref_len


def _rle(ops: List[str]) -> str:
    out = []
    i = 0
    while i < len(ops):
        k = i
        while k < len(ops) and ops[k] == ops[i]:
            k += 1
        out.append(f"{k - i}{ops[i]}")
        i = k
    return "".join(out)


# ---------------------------------------------------------------------------
# Full per-read mapping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Hit:
    strand: str
    gpos: int          # global genome offset of candidate locus (window anchor)
    score: int
    weight: float = 0.0
    pos: int = -1      # global 0-based offset of first aligned genome base
    cigar: str = ""
    ref_len: int = 0


def candidates_for(codes: np.ndarray, index: Dict[int, List[int]],
                   cfg: MapperConfig,
                   collapse: str | None = None) -> List[int]:
    L = len(codes)
    m = cfg.mer_size
    if collapse is None:
        kmers, valid = packing.kmer_codes(codes, m)
    else:
        from gnumap_tpu.index.builder import kmer_codes_b3
        kmers, valid = kmer_codes_b3(codes, m, collapse)
    # [FROZEN v2] candidates are vote-counted: votes[cand] = number of
    # (seed offset, index hit) pairs anchoring it.  Over the cap, keep the
    # max_candidates ranked best by (votes desc, position asc); output is
    # ascending by position.  Mirrors pipeline.mapper.dedupe_cap.
    votes: Dict[int, int] = {}
    for off in range(0, L - m + 1, cfg.seed_jump):
        if off >= len(kmers) or not valid[off]:
            continue
        hits = index.get(int(kmers[off]), [])
        if len(hits) > cfg.max_hits_per_seed:
            continue
        for p in hits:
            votes[p - off] = votes.get(p - off, 0) + 1
    ranked = sorted(votes, key=lambda c: (-votes[c], c))
    return sorted(ranked[:cfg.max_candidates])


def map_read(codes: np.ndarray, pwm_q: np.ndarray, gen: OracleGenome,
             index: Dict[int, List[int]], cfg: MapperConfig) -> List[Hit]:
    """Map one read; returns retained hits with posterior weights."""
    S_plus, S_minus = scoring.matrices_for_mode(cfg)
    L = len(codes)
    # FROZEN: window width uses the configured max read length (not the
    # actual read length) and starts floor-align to WINDOW_ALIGN, so batched
    # fixed-shape scoring sees the exact same candidate windows.
    W = cfg.window_width()
    hits: List[Hit] = []
    thresholds = {}
    # bisulfite mode [FROZEN]: per-strand collapsed-alphabet seeding —
    # ``index`` must be the (plus, minus) pair from build_oracle_bs_indexes
    if cfg.bisulfite:
        if not (isinstance(index, tuple) and len(index) == 2):
            raise ValueError("bisulfite mode requires the (plus, minus) "
                             "collapsed index pair "
                             "(build_oracle_bs_indexes)")
        strand_idx = {"+": (index[0], "ct"), "-": (index[1], "ga")}
    else:
        strand_idx = {"+": (index, None), "-": (index, None)}
    for strand, S_q in (("+", S_plus), ("-", S_minus)):
        if strand == "+":
            c_s, p_s = codes, pwm_q
        else:
            c_s, p_s = packing.revcomp(codes), pwm_mod.pwm_revcomp(pwm_q)
        emis = scoring.emission_int(p_s, S_q)
        max_s = int(scoring.max_read_score(emis[None])[0])
        thresholds[strand] = cfg.threshold_for(max_s)
        s_index, s_collapse = strand_idx[strand]
        for cand in candidates_for(c_s, s_index, cfg, collapse=s_collapse):
            win_start = cfg.window_start(cand)
            window = gen.window(win_start, W)
            score = nw_align(emis, window, cfg)
            if score >= thresholds[strand] and score > 0:
                hits.append(Hit(strand=strand, gpos=cand, score=score))
    if not hits:
        return []
    # Traceback retained loci, then dedupe by final (strand, pos) BEFORE
    # normalizing: distinct seed anchors (e.g. shifted by an indel) that
    # resolve to the same alignment must not double-count in the posterior
    # denominator. [FROZEN: keep max score per (strand, pos)]
    S_by = {"+": S_plus, "-": S_minus}
    for h in hits:
        if h.strand == "+":
            p_s = pwm_q
        else:
            p_s = pwm_mod.pwm_revcomp(pwm_q)
        emis = scoring.emission_int(p_s, S_by[h.strand])
        win_start = cfg.window_start(h.gpos)
        window = gen.window(win_start, W)
        _, pos_in_window, cigar, ref_len = nw_align(emis, window, cfg,
                                                    traceback=True)
        h.pos = win_start + pos_in_window
        h.cigar = cigar
        h.ref_len = ref_len
    best: Dict[Tuple[str, int], Hit] = {}
    for h in hits:
        key = (h.strand, h.pos)
        if key not in best or h.score > best[key].score:
            best[key] = h
    hits = list(best.values())
    total = float(sum(h.score for h in hits))
    for h in hits:
        h.weight = h.score / total
    # Frozen output order: ascending genome position, '+' before '-'.
    hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
    return hits


def accumulate(hits: List[Hit], codes: np.ndarray, pwm_q: np.ndarray,
               coverage: np.ndarray, tallies: np.ndarray | None,
               cfg: MapperConfig) -> None:
    """Scatter posterior weight into coverage (and SNP tallies)."""
    for h in hits:
        coverage[h.pos:h.pos + h.ref_len] += h.weight
        if tallies is not None:
            p_s = pwm_q if h.strand == "+" else pwm_mod.pwm_revcomp(pwm_q)
            gp = h.pos
            i = 0
            for num, op in _iter_cigar(h.cigar):
                if op == "M":
                    for k in range(num):
                        tallies[gp + k] += h.weight * (
                            p_s[i + k].astype(np.float64) / PWM_SCALE)
                    gp += num
                    i += num
                elif op == "D":
                    gp += num
                elif op == "I":
                    i += num


def _iter_cigar(cigar: str):
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            yield num, ch
            num = 0
