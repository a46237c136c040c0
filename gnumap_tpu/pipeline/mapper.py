"""End-to-end batch mapper: seed -> gather windows -> DP -> posterior -> emit.

Accelerator re-design of the reference worker-thread loop (SURVEY.md §3.1):
the per-read Python/C++ loop becomes one jitted device program over a fixed
(batch, strand, candidate) lattice —

  device (jit, static shapes):
    * strand expansion (reverse complement of codes + PWM, length-aware)
    * integer emission tables  E = PWM @ S  per strand
    * seeding: vectorized k-mer codes -> CSR gather -> candidate anchors,
      sort-dedupe-cap per read (two sorts replace the hash-set of the
      reference's per-read candidate dedupe)
    * batched banded affine NW scores: the GPU kernel
      (align/band_kernel.py) or the jnp scan (nw_ref.nw_scores_multi)
    * optional device finish: retention, pure-diagonal detection and the
      exact traceback of retained hits (align/nw_finish.py)
  host (NumPy, exact integer/float64 math):
    * retention threshold ceil(a * max_score) (float64, matches oracle)
    * traceback of retained loci only (few per read), dedupe by final
      (strand, pos), posterior weight normalization  w_i = s_i / sum s_j
    * coverage / SNP-tally scatter-add, SAM record formatting

The retained-loci-only traceback is the "rescoring winners" design from
SURVEY.md §7: the hot device loop stays store-light (scores only).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnumap_tpu.align import band_kernel, nw_finish, nw_ref, scoring
from gnumap_tpu.align.select import resolve_align_impl
from gnumap_tpu.config import NEG_INF, SENTINEL, MapperConfig
from gnumap_tpu.core import packing, pwm as pwm_mod
from gnumap_tpu.index.builder import CsrIndex, Genome
from gnumap_tpu.io import sam as sam_io
from gnumap_tpu.io.fastq import ReadBatch
from gnumap_tpu.oracle import oracle

# position tables longer than this take element gathers instead of the
# padded (n/8, 8) row-gather copy (tests monkeypatch this to cover both)
ROWGATHER_MAX = 1 << 26


@dataclasses.dataclass
class ReadHit:
    strand: str
    pos: int            # global 0-based genome offset of first aligned base
    score: int
    weight: float
    cigar: str
    ref_len: int
    primary: Optional[bool] = None  # genome-partitioned multi-host mode:
                                    # the globally-best hit may live on
                                    # another host, so primacy is decided
                                    # by a cross-host reduce rather than
                                    # local hit order; None = local order
                                    # (hit 0 primary), the single-host rule


@dataclasses.dataclass
class BatchStats:
    n_reads: int = 0
    n_mapped: int = 0
    n_multi: int = 0
    n_candidates: int = 0
    dp_cells: int = 0          # rectangle-equivalent work: L x W per
                               # candidate (the r1-r4 record's accounting)
    dp_cells_banded: int = 0   # cells the banded kernel actually computes:
                               # L x bw per candidate (the two accountings
                               # differ ~3x)
    device_s: float = 0.0
    host_s: float = 0.0


def _cells_per_cand(cfg: "MapperConfig"):
    """(rectangle, banded-computed) DP cells per (candidate, read-row)."""
    W = cfg.window_width()
    b = cfg.band()
    return W, (b[1] if b is not None else W)



# ---------------------------------------------------------------------------
# Pure device-program stages (shared by the single-chip TpuMapper and the
# sharded dist.DistMapper — SURVEY.md §2 parallelism table)
# ---------------------------------------------------------------------------

def revcomp_batch(codes, pwm_q, lens):
    """Length-aware reverse complement so the rc read still occupies
    positions [0, len) with N/zero padding at the tail.

    The positional reversal is a (B, L, L) one-hot contraction rather than
    a gather.  EXACTNESS: the operands are bf16, so PWM values split into
    two bf16-exact limbs (< 64) that recombine after the contraction; each
    output is a single nonzero product accumulated in f32, so it is exact
    whatever precision or order the backend's matmul uses."""
    B, L = codes.shape
    ar = jnp.arange(L, dtype=jnp.int32)
    src = jnp.clip(lens[:, None] - 1 - ar[None, :], 0, L - 1)
    in_read = ar[None, :] < lens[:, None]
    oh = (src[:, :, None] == ar[None, None, :]).astype(jnp.bfloat16)
    payload = jnp.concatenate(
        [codes.astype(jnp.int32)[:, :, None],
         pwm_q >> 6, pwm_q & 63], axis=2).astype(jnp.bfloat16)
    gathered = jnp.einsum("bij,bjk->bik", oh, payload,
                          preferred_element_type=jnp.float32
                          ).astype(jnp.int32)
    g = gathered[:, :, 0]
    pw = (gathered[:, :, 1:5] << 6) + gathered[:, :, 5:9]
    rc_codes = jnp.where(in_read,
                         jnp.where(g < 4, 3 - g, 4), 4).astype(jnp.int8)
    rc_pwm = jnp.where(in_read[:, :, None], pw[:, :, ::-1], 0)
    return rc_codes, rc_pwm


def seed_kmers(codes2, offsets, m):
    """k-mer codes at the static seed offsets + invalid (contains-N) mask."""
    code4 = jnp.where(codes2 == 4, 0, codes2).astype(jnp.int32)
    isn = codes2 == 4
    km = jnp.zeros(codes2.shape[:1] + offsets.shape, dtype=jnp.int32)
    bad = jnp.zeros_like(km, dtype=bool)
    for k in range(m):
        km = km * 4 + code4[:, offsets + k]
        bad = bad | isn[:, offsets + k]
    return km, bad


def seed_kmers_b3(codes2, offsets, m, digits):
    """Base-3 collapsed k-mer codes at the static seed offsets (bisulfite
    seeding [FROZEN]; digit tables in index/builder.BS_DIGITS)."""
    d = digits[jnp.clip(codes2.astype(jnp.int32), 0, 4)]
    isn = d < 0
    base = jnp.where(isn, 0, d)
    km = jnp.zeros(codes2.shape[:1] + offsets.shape, dtype=jnp.int32)
    bad = jnp.zeros_like(km, dtype=bool)
    for k in range(m):
        km = km * 3 + base[:, offsets + k]
        bad = bad | isn[:, offsets + k]
    return km, bad


def csr_hits(km, bad, bucket_start, positions, offsets, cfg):
    """Per-seed candidate anchors from a CSR table: (B2, S, caph) int32 with
    SENTINEL at invalid slots.  ``bucket_start`` may be a shard (with the
    k-mer codes already rebased by the caller)."""
    start = bucket_start[km]
    count = bucket_start[km + 1] - start
    seed_ok = (~bad) & (count > 0) & (count <= cfg.max_hits_per_seed)
    caph = cfg.max_hits_per_seed
    ar = jnp.arange(caph, dtype=jnp.int32)
    hit_ok = seed_ok[:, :, None] & (ar[None, None, :] < count[:, :, None])
    # Row gather + phase select: fetch whole aligned 8-wide rows of
    # `positions` and resolve the start%8 phase with an 8-way select
    # (fewer gathered rows than caph element gathers per seed).  Tables
    # longer than ROWGATHER_MAX take the element gather, which needs no
    # padded copy of `positions`.
    npos = positions.shape[0]
    if npos > ROWGATHER_MAX:
        ar8 = jnp.arange(caph, dtype=jnp.int32)
        pos = positions[jnp.clip(start[:, :, None] + ar8[None, None, :],
                                 0, npos - 1)]
        cand = pos - offsets[None, :, None]
        return jnp.where(hit_ok, cand, SENTINEL)
    nr = max(-(-npos // 8), 1)
    pos2d = jnp.zeros((nr * 8,), positions.dtype).at[:npos].set(
        positions).reshape(nr, 8)
    r0 = start >> 3
    o = start & 7
    nfetch = -(-(caph + 7) // 8)
    rows = pos2d[jnp.clip(
        r0[:, :, None] + jnp.arange(nfetch, dtype=jnp.int32), 0, nr - 1)]
    flat = rows.reshape(*start.shape, nfetch * 8)
    pos = flat[..., 0:caph]
    for k in range(1, 8):
        pos = jnp.where((o == k)[:, :, None], flat[..., k:k + caph], pos)
    cand = pos - offsets[None, :, None]
    return jnp.where(hit_ok, cand, SENTINEL)


def dedupe_cap(cand, C, impl: str = "sort"):
    """Dedupe-cap per read: (B2, S*caph) -> (B2, C) ascending with
    SENTINEL padding (replaces the reference's per-read hash set).

    [FROZEN v2] When more than C unique candidates survive dedupe, keep the
    C ranked best by (seed votes desc, position asc), where a candidate's
    votes = how many (seed offset, index hit) pairs anchored it.  A true
    locus is anchored by ~every seed of the read while background k-mer
    collisions get one vote each, so on whole-genome indexes (config 5:
    ~4 random hits/seed at 1 Gbp, mer 14) the cap keeps the loci the
    reference would have scored best instead of the C smallest positions.
    When unique candidates <= C (every small-genome config) the kept set is
    unchanged.  Output stays ascending-by-position [FROZEN].  Mirrors
    oracle.candidates_for.

    impl='matrix': NO sorts — votes, the frozen (votes desc,
    pos asc) rank, and the ascending output order are all O(N^2)-per-read
    comparison REDUCTIONS (N = seeds x caph ~ 152), elementwise work that
    XLA fuses.  impl='sort' (default): the two-sort formulation,
    bit-identical to matrix."""
    flat = cand.reshape(cand.shape[0], -1)
    B2, N = flat.shape
    if impl == "matrix":
        idx = jnp.arange(N, dtype=jnp.int32)
        fi = flat[:, :, None]                  # element i
        fj = flat[:, None, :]                  # element j
        eq = fi == fj
        votes = jnp.sum(eq, axis=2, dtype=jnp.int32)
        first = ~jnp.any(eq & (idx[None, None, :] < idx[None, :, None]),
                         axis=2)
        real = first & (flat != SENTINEL)
        # rank among real entries by (votes desc, pos asc); real positions
        # are distinct so the key is total and rank is a permutation
        vi = votes[:, :, None]
        vj = votes[:, None, :]
        better = real[:, None, :] & ((vj > vi)
                                     | ((vj == vi) & (fj < fi)))
        rank = jnp.sum(better, axis=2, dtype=jnp.int32)
        kept = real & (rank < C)
        # ascending-position slot within the kept set, then a one-hot
        # gather written as a reduce
        rank2 = jnp.sum(kept[:, None, :] & (fj < fi), axis=2,
                        dtype=jnp.int32)
        slots = jnp.arange(C, dtype=jnp.int32)[None, :, None]
        onehot = (rank2[:, None, :] == slots) & kept[:, None, :]
        out = jnp.sum(jnp.where(onehot, fj, 0), axis=2)
        n_kept = jnp.sum(kept, axis=1, dtype=jnp.int32)
        return jnp.where(slots[0, :, 0][None, :] < n_kept[:, None],
                         out, SENTINEL)
    s1 = jnp.sort(flat, axis=1)
    idxs = jnp.arange(N, dtype=jnp.int32)[None, :]
    uniq = jnp.concatenate(
        [jnp.ones_like(s1[:, :1], dtype=bool), s1[:, 1:] != s1[:, :-1]],
        axis=1)
    # votes per run-start entry = distance to the next run start
    t = jnp.where(uniq, idxs, N).astype(jnp.int32)
    nxt = jnp.concatenate(
        [jax.lax.cummin(t[:, ::-1], axis=1)[:, ::-1][:, 1:],
         jnp.full((B2, 1), N, jnp.int32)], axis=1)
    votes = nxt - idxs
    real = uniq & (s1 != SENTINEL)
    key_votes = jnp.where(real, -votes, jnp.int32(1))
    key_pos = jnp.where(real, s1, SENTINEL)
    _, by_rank = jax.lax.sort((key_votes, key_pos), num_keys=2)
    top = by_rank[:, :C]
    if N < C:
        top = jnp.pad(top, ((0, 0), (0, C - N)), constant_values=SENTINEL)
    return jnp.sort(top, axis=1)


def windows_for(cand_chunk, g_codes, cfg):
    """Gather genome windows for a chunk of candidates; OOB -> N."""
    W = cfg.window_width()
    G = g_codes.shape[0]
    idx = (cfg.window_start(cand_chunk.astype(jnp.int32))[:, :, None]
           + jnp.arange(W, dtype=jnp.int32)[None, None, :])
    oob = (idx < 0) | (idx >= G)
    win = g_codes[jnp.clip(idx, 0, G - 1)].astype(jnp.int32)
    return jnp.where(oob, 4, win)


def dp_scores(cfg: MapperConfig, align_impl: str, emis2, cands, lens2,
              g_codes, interpret: bool = False):
    """DP scores for every (read-strand, candidate) slot, int32[B2, C]
    (SENTINEL slots hold junk; callers mask them).  align_impl 'pallas'
    runs the banded GPU kernel; 'jnp', and every unbanded config
    (cfg.band() is None), run the nw_ref scan over candidate chunks."""
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    band = cfg.band()
    if align_impl == "pallas" and band is not None:
        with jax.named_scope("nw_band_kernel"):
            return band_kernel.nw_scores_banded(
                emis2, cands, lens2, g_codes, W=cfg.window_width(),
                slack=cfg.gap_slack, boff=band[0], bw=band[1],
                open_q=open_q, ext_q=ext_q, interpret=interpret)
    C = cands.shape[1]
    ck = max(1, min(16, C))          # candidates per scan: bounds the
    while C % ck:                    # (B2, ck, W+1) DP state
        ck -= 1
    cc = jnp.transpose(cands.reshape(cands.shape[0], C // ck, ck), (1, 0, 2))

    def chunk_fn(cand_chunk):
        win = windows_for(jnp.where(cand_chunk == SENTINEL, 0, cand_chunk),
                          g_codes, cfg)
        return nw_ref.nw_scores_multi(emis2, win, lens2, open_q, ext_q,
                                      band=band)

    with jax.named_scope("nw_scan"):
        scores = jax.lax.map(chunk_fn, cc)          # (nchunk, B2, ck)
    return jnp.transpose(scores, (1, 0, 2)).reshape(cands.shape)


def pack_reads(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Host-side H2D packing: ONE uint8 array (B, L + ceil(L/4)) —
    columns [0, L) are Phred quals clipped to [0, 127] with 255 marking
    an N base; columns [L, ...) are 2-bit packed base codes.

    1.25 bytes/base.  Exact: the PWM table lookup clamps quals to
    PWM_TABLE_QMAX (=127) anyway, and an N base's PWM row is uniform
    regardless of qual, so the clip/sentinel lose nothing."""
    codes = np.asarray(codes)
    q = np.asarray(quals)
    B, L = codes.shape
    L4 = (L + 3) // 4
    isn = codes >= 4
    q8 = np.where(isn, np.uint8(255),
                  np.clip(q, 0, 127).astype(np.uint8))
    c2 = np.where(isn, 0, codes).astype(np.uint8)
    if L4 * 4 != L:
        c2 = np.concatenate(
            [c2, np.zeros((B, L4 * 4 - L), np.uint8)], axis=1)
    c4 = c2.reshape(B, L4, 4)
    pc = (c4[:, :, 0] | (c4[:, :, 1] << 2)
          | (c4[:, :, 2] << 4) | (c4[:, :, 3] << 6)).astype(np.uint8)
    return np.concatenate([q8, pc], axis=1)


def device_unpack(packed, L: int):
    """Inverse of pack_reads, on device (fused into the map program)."""
    p = packed.astype(jnp.int32)
    q = p[:, :L]
    pc = p[:, L:]
    rep = jnp.repeat(pc, 4, axis=1)[:, :L]
    sh = (jnp.arange(L, dtype=jnp.int32) % 4) * 2
    c = (rep >> sh) & 3
    isn = q == 255
    codes = jnp.where(isn, 4, c).astype(jnp.int8)
    quals = jnp.where(isn, 0, q)
    return codes, quals


def _materialize(dev_out) -> np.ndarray:
    """Resolve a submit() handle to a host array (Future or device array)."""
    if isinstance(dev_out, concurrent.futures.Future):
        return dev_out.result()
    return np.asarray(dev_out)


def device_pwm(codes, quals, lens, table):
    """PWM reconstruction on device — bit-identical to
    core/pwm.pwm_from_calls (the table is built with it), with pad
    positions zeroed (the frozen pad-row rule).  Ships (codes, quals)
    instead of the (B, L, 4) int32 PWM over the host->device link.

    The (qual, code) lookup is a one-hot contraction over the 128-entry
    qual axis + a 5-way code select, not a gather.  Exact via two
    bf16-exact limbs (< 64) recombined after the contraction, as in
    revcomp_batch."""
    Q = table.shape[0]
    q = jnp.clip(quals.astype(jnp.int32), 0, Q - 1)
    c = jnp.clip(codes.astype(jnp.int32), 0, 4)
    oh = (q[:, :, None] == jnp.arange(Q, dtype=jnp.int32)[None, None, :]
          ).astype(jnp.bfloat16)
    t2 = jnp.concatenate([table >> 6, table & 63],
                         axis=2).astype(jnp.bfloat16)      # (Q, 5, 8)
    tq = jnp.einsum("blq,qck->blck", oh, t2,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    pw = (tq[..., :4] << 6) + tq[..., 4:]                  # (B, L, 5, 4)
    sel = pw[:, :, 4, :]
    for v in range(4):
        sel = jnp.where((c == v)[:, :, None], pw[:, :, v, :], sel)
    pw = sel
    L = codes.shape[1]
    in_read = jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None]
    return jnp.where(in_read[:, :, None], pw, 0)


def strand_expand(codes, pwm_q, lens, S_plus, S_minus):
    """codes/pwm -> both-strand codes2 + integer emission tables."""
    rc_codes, rc_pwm = revcomp_batch(codes, pwm_q, lens)
    codes2 = jnp.concatenate([codes, rc_codes], axis=0)
    emis_p = jnp.matmul(pwm_q, S_plus, preferred_element_type=jnp.int32)
    emis_m = jnp.matmul(rc_pwm, S_minus, preferred_element_type=jnp.int32)
    emis2 = jnp.concatenate([emis_p, emis_m], axis=0)
    return codes2, emis2


def device_threshold(max_sc, ratio_q: int):
    """Exact retention threshold ceil(ratio_q * max_sc / 2^RATIO_BITS) on
    device, bit-identical to MapperConfig.threshold_for.

    JAX runs without 64-bit types by default, so the 57-bit product is
    computed in uint32 16-bit limbs (wrap-around adds detect carries).
    ratio_q <= 2^32."""
    from gnumap_tpu.config import RATIO_BITS
    assert RATIO_BITS == 32
    a1 = jnp.uint32(ratio_q >> 16)
    a0 = jnp.uint32(ratio_q & 0xFFFF)
    ms = max_sc.astype(jnp.uint32)
    m1 = ms >> 16
    m0 = ms & 0xFFFF
    c = a1 * m0
    d = a0 * m1
    e = a0 * m0
    s_lo = c + d
    carry1 = (s_lo < c).astype(jnp.uint32)
    sh = s_lo >> 16
    sl = s_lo & 0xFFFF
    low = sl << 16
    low2 = low + e
    carry2 = (low2 < low).astype(jnp.uint32)
    hi = carry1 * jnp.uint32(65536) + sh + carry2
    thr = a1 * m1 + hi + (low2 != 0).astype(jnp.uint32)
    return thr.astype(jnp.int32)



def tb_capacity(H: int) -> int:
    """Device-traceback capacity for H hit slots: the hits that pure
    detection cannot prove all-M (the gapped minority) get an exact
    traceback in K slots; a batch needing more falls back to the exact
    host path.  H/8 holds batches with several per cent of indel reads;
    each slot costs a (W+1)-wide forward DP row per read row."""
    return max(64, H // 8)


def device_hit_rows(cfg: MapperConfig, cands, valid, scores, max_sc,
                    emis2, lens2, g_codes) -> dict:
    """Retention threshold + winner compaction + device traceback: the
    per-hit rows shared by the fetch-blob tail (device_tb_tail) and the
    on-device accumulation stage (device_accumulate).

    n_tb counts the hits sent to the traceback (those not proven pure);
    n_tb > tb_capacity(H) means some hits have no traceback, and callers
    treat it as capacity overflow."""
    B2, C = cands.shape
    H = cfg.hit_capacity * B2
    K = tb_capacity(H)
    assert B2 * C < (1 << 21), "flat_idx must fit 21 bits (w0 packing)"
    assert cfg.window_width() < (1 << 8), \
        "j_final must fit 8 bits (w0 packing): max_read_len <= 223"
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    band = cfg.band()
    with jax.named_scope("retain_compact"):
        thr = device_threshold(max_sc, cfg.ratio_q())
        keep = valid & (scores >= thr[:, None]) & (scores > 0)
        flat_keep = keep.reshape(-1)
        k = jnp.cumsum(flat_keep.astype(jnp.int32)) - 1
        n_keep = k[-1] + 1
        slot = jnp.where(flat_keep, k, H)
        flat_idx = jnp.arange(B2 * C, dtype=jnp.int32)
        hit_flat = jnp.full((H,), -1, jnp.int32).at[slot].set(
            flat_idx, mode="drop")
        valid_h = hit_flat >= 0
        safe = jnp.where(valid_h, hit_flat, 0)
        row_h = safe // C
        cand_h = jnp.where(valid_h, cands.reshape(-1)[safe], SENTINEL)
        score_h = jnp.where(valid_h, scores.reshape(-1)[safe], 0)
        len_h = jnp.where(valid_h, lens2[row_h], 0)
        emis_h = emis2[row_h]
        win_h = windows_for(jnp.where(valid_h, cand_h, 0)[:, None],
                            g_codes, cfg)[:, 0]
    iota_h = jnp.arange(H, dtype=jnp.int32)
    with jax.named_scope("pure_detect"):
        if band is not None and open_q > 0 and ext_q > 0:
            pure, jf_pure = nw_finish.pure_detect(
                emis_h, win_h, len_h, score_h, boff=band[0], bw=band[1],
                open_q=open_q, ext_q=ext_q)
        else:
            pure = jnp.zeros((H,), bool)
            jf_pure = jnp.zeros((H,), jnp.int32)
        need = valid_h & jnp.logical_not(pure)
        kk = jnp.cumsum(need.astype(jnp.int32)) - 1
        n_tb = kk[-1] + 1
        src = jnp.zeros((K,), jnp.int32).at[jnp.where(need, kk, K)].set(
            iota_h, mode="drop")
        live = jnp.arange(K, dtype=jnp.int32) < n_tb
    with jax.named_scope("nw_traceback"):
        # the exact traceback runs only on the compacted remainder
        ops_c, jfin_c = nw_finish.traceback(
            emis_h[src], win_h[src], jnp.where(live, len_h[src], 0),
            open_q=open_q, ext_q=ext_q, band=band)
        tgt = jnp.where(live, src, H)
        ops = jnp.zeros((H, ops_c.shape[1]), jnp.int16).at[tgt].set(
            ops_c, mode="drop")
        jfin_tb = jnp.zeros((H,), jnp.int32).at[tgt].set(
            jfin_c, mode="drop")
        jfin = jnp.where(pure, jf_pure, jfin_tb)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    return dict(valid_h=valid_h, hit_flat=hit_flat, row_h=row_h,
                cand_h=cand_h, score_h=score_h, len_h=len_h,
                ops=ops, jfin=jfin, n_keep=n_keep, n_valid=n_valid,
                n_tb=n_tb)


def device_tb_tail(cfg: MapperConfig, cands, valid, scores, max_sc,
                   emis2, lens2, g_codes, rows: "dict | None" = None):
    """Retention threshold + winner compaction + traceback + indel-compacted
    blob — the device tail shared by TpuMapper._device_map_tb and the
    sharded DistMapper step (per shard).  Returns ONE flat int32 blob, so
    each batch needs one device-to-host copy:

      blob[:4*H]    per-hit meta x H = hit_capacity*B2 rows:
                      w0 = flat_idx | (j_final << 21)   (-1 = empty slot)
                      w1 = cand,  w2 = score,  w3 = indel_slot (-1 = none)
      blob[4*H:-3]  compacted ops of the K = tb_capacity(H) indel-bearing
                    hits (indels are rare; overflow -> host fallback)
      blob[-3:]     [n_keep, n_valid, n_tb]  (n_tb > K = overflow)
    """
    H = cfg.hit_capacity * cands.shape[0]
    if rows is None:
        rows = device_hit_rows(cfg, cands, valid, scores, max_sc,
                               emis2, lens2, g_codes)
    valid_h = rows["valid_h"]
    hit_flat = rows["hit_flat"]
    cand_h, score_h, len_h = rows["cand_h"], rows["score_h"], rows["len_h"]
    ops, jfin = rows["ops"], rows["jfin"]
    n_keep, nv = rows["n_keep"], rows["n_valid"]
    with jax.named_scope("indel_compact"):
        Lp = ops.shape[1]
        K = tb_capacity(H)
        in_read = (jnp.arange(Lp, dtype=jnp.int32)[None, :]
                   < len_h[:, None])
        has_indel = jnp.any((ops != 0) & in_read, axis=1) & valid_h
        ki = jnp.cumsum(has_indel.astype(jnp.int32)) - 1
        islot = jnp.where(has_indel, ki, -1)       # per-hit ops slot
        src = jnp.full((K,), 0, jnp.int32).at[
            jnp.where(has_indel, ki, K)].set(
            jnp.arange(H, dtype=jnp.int32), mode="drop")
        ops_c = ops[src]                            # (K, Lp) int16
    w0 = jnp.where(valid_h, hit_flat | (jfin << 21), -1)
    meta = jnp.stack([w0, cand_h, score_h, islot], axis=1)
    tail = jnp.stack([n_keep, nv, rows["n_tb"]])
    ops32 = jax.lax.bitcast_convert_type(
        ops_c.astype(jnp.uint16).reshape(K, Lp // 2, 2), jnp.int32)
    return jnp.concatenate(
        [meta.reshape(-1), ops32.reshape(-1), tail], axis=0)


def tb_blob_len(cfg: MapperConfig, B: int) -> int:
    """Host-side length of the device_tb_tail blob for a B-read batch."""
    H = cfg.hit_capacity * 2 * B
    K = tb_capacity(H)
    Lp = ((cfg.max_read_len + 7) // 8) * 8
    return 4 * H + K * (Lp // 2) + 3


def acc_span(cfg: MapperConfig) -> int:
    """Delta-window width for device accumulation: a 128-multiple
    covering the widest possible alignment span (bounded by the candidate
    window) PLUS one 128 row, because span starts are floor-aligned to
    128 positions (the accumulators are laid out in 128-position rows)
    and the pos % 128 residue shifts the delta within the window."""
    return ((cfg.window_width() + 127) // 128) * 128 + 128


def acc_padded_len(cfg: MapperConfig, G: int) -> int:
    """Accumulator length: genome + room for every clipped span, rounded
    to whole 128-position rows."""
    span = acc_span(cfg)
    return ((G + 2 * span + 127) // 128) * 128


def _segmented(comb, vals, seg, reverse=False):
    """Segmented associative scan over (vals, seg-ids); ids must be
    grouped (sorted).  Standard operator: restart at id changes."""
    def op(a, b):
        va, sa = a
        vb, sb = b
        return jnp.where(sa == sb, comb(va, vb), vb), sb
    if reverse:
        out, _ = jax.lax.associative_scan(op, (vals[::-1], seg[::-1]))
        return out[::-1]
    out, _ = jax.lax.associative_scan(op, (vals, seg))
    return out


def _add_rows(arr, first_row, valid, delta):
    """arr[first_row[h] + k] += delta[h, k] for every valid hit h.

    Deterministic: all contributions to one accumulator row are summed
    first (sorted by (row, hit slot), segmented scan), so the scatter-add
    that applies them sees each row index once (unique_indices holds; the
    other sums get distinct out-of-range indices and are dropped)."""
    H, nr, lanes = delta.shape
    R = arr.shape[0]
    n = H * nr
    keys = jnp.where(valid[:, None],
                     first_row[:, None] + jnp.arange(nr, dtype=jnp.int32),
                     R).reshape(-1)
    iota = jnp.arange(n, dtype=jnp.int32)
    skey, perm = jax.lax.sort((keys, iota), num_keys=2)
    sums = _segmented(jnp.add, delta.reshape(n, lanes)[perm],
                      skey[:, None])
    last = jnp.concatenate([skey[1:] != skey[:-1],
                            jnp.ones((1,), bool)]) & (skey < R)
    rows = jnp.where(last, skey, R + iota)
    return arr.at[rows].add(sums, mode="drop", unique_indices=True)


def device_accumulate(cfg: MapperConfig, B: int, pwm2, rows: dict,
                      cov, tal, snp: bool):
    """[FROZEN v5] On-device coverage / SNP-tally accumulation.

    Per retained hit: dedupe by (read-strand row, final position) keeping
    the max score (ties keep either — the duplicates are bit-identical
    contributions), posterior weights w = score / sum(scores of the
    read's deduped hits), then accumulate

      coverage[pos : pos + ref_len]      += w                       (f32)
      tallies[genome_idx(read base i)]   += w * PWM[i] / PWM_SCALE  (f32)

    into DEVICE-RESIDENT arrays fetched only at checkpoint/stream end.

    Structure:
      * per-read weight denominators and hit counts via SEGMENTED
        ASSOCIATIVE SCANS over the (read, row, pos, -score)-sorted hit
        list (reads form contiguous segments after the sort);
      * coverage/tally contributions as DENSE span-wide per-hit delta
        windows built with elementwise/gather ops;
      * deltas summed per accumulator row and applied by one scatter-add
        with unique row indices (_add_rows).

    Semantics: f32 arithmetic in a fixed order (per accumulator row, the
    (row, hit slot)-sorted segmented sum), so a fixed stream gives
    bit-identical accumulators run to run; the host path keeps the exact
    hit-ordered float64 contract and remains the golden reference —
    device accumulation is validated against it to f32 tolerance and for
    run-to-run determinism (tests/test_device_accum.py).  The f64
    conversion happens at the fetch boundary (fetch_accumulators).

    cov is (Gpad//128, 128) f32 (position p at [p//128, p%128]) and tal
    (Gpad*4//128, 128) f32 (flat index 4p+b), Gpad = G padded by 2 spans
    and rounded to 128 (the pad absorbs clipped out-of-range spans;
    fetch slices [:G]).

    Returns (cov', tal', stats_vec) with stats_vec int32[4] =
    [n_mapped, n_multi, n_valid_candidates, n_keep].
    """
    from gnumap_tpu.config import PWM_SCALE
    H = rows["valid_h"].shape[0]
    L = cfg.max_read_len
    span = acc_span(cfg)
    Gpad = cov.shape[0] * 128
    valid_h = rows["valid_h"]
    row_h, score_h, len_h = rows["row_h"], rows["score_h"], rows["len_h"]
    ops, jfin = rows["ops"], rows["jfin"]
    with jax.named_scope("acc_dedupe_weights"):
        pos_h = cfg.window_start(rows["cand_h"]) + jfin
        BIG = jnp.int32(2 ** 31 - 1)
        read_id = row_h % B
        k0 = jnp.where(valid_h, read_id, BIG)
        k1 = jnp.where(valid_h, row_h, BIG)
        k2 = jnp.where(valid_h, pos_h, BIG)
        iota = jnp.arange(H, dtype=jnp.int32)
        sk0, sk1, sk2, sneg, sidx = jax.lax.sort(
            (k0, k1, k2, -score_h, iota), num_keys=4)
        first = jnp.concatenate(
            [jnp.ones((1,), bool),
             (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])])
        win_sorted = first & (sk0 != BIG)
        sc_sorted = jnp.where(win_sorted, (-sneg).astype(jnp.float32), 0.0)
        # per-read totals: forward segmented sum, then broadcast each
        # read's final running sum backward (sums are nondecreasing, so
        # a reverse segmented max propagates the segment total)
        ps = _segmented(jnp.add, sc_sorted, sk0)
        tot = _segmented(jnp.maximum, ps, sk0, reverse=True)
        w_sorted = jnp.where(win_sorted,
                             sc_sorted / jnp.maximum(tot, 1.0), 0.0)
        w = jnp.zeros((H,), jnp.float32).at[sidx].set(w_sorted)
    with jax.named_scope("acc_stats"):
        pc = _segmented(jnp.add, win_sorted.astype(jnp.int32), sk0)
        endseg = jnp.concatenate([sk0[1:] != sk0[:-1],
                                  jnp.ones((1,), bool)]) & (sk0 != BIG)
        n_mapped = jnp.sum((endseg & (pc >= 1)).astype(jnp.int32))
        n_multi = jnp.sum((endseg & (pc >= 2)).astype(jnp.int32))
        stats_vec = jnp.stack(
            [n_mapped, n_multi, rows["n_valid"], rows["n_keep"]])
    with jax.named_scope("acc_walk"):
        # genome index of read base i (0-based) = pos + exclusive-prefix
        # of ((1 - is_insertion) + n_deletions_after) over earlier rows —
        # the vectorized form of decode_ops' CIGAR walk
        opb = (ops[:, :L] & 1).astype(jnp.int32)
        dcnt = (ops[:, :L] >> 1).astype(jnp.int32)
        arL = jnp.arange(L, dtype=jnp.int32)[None, :]
        in_read = arL < len_h[:, None]
        step = jnp.where(in_read, (1 - opb) + dcnt, 0)
        cs = jnp.cumsum(step, axis=1) - step
        gidx = pos_h[:, None] + cs
        ref_len = jnp.sum(step, axis=1)
    # span starts floor-align to 128 positions (whole accumulator rows);
    # the residue s = pos - 128*units shifts the delta inside the window
    base_units = jnp.clip(pos_h >> 7, 0, (Gpad - span) >> 7)
    base = base_units << 7
    s = pos_h - base
    kk = jnp.arange(span, dtype=jnp.int32)[None, :]
    with jax.named_scope("acc_coverage"):
        cov_delta = jnp.where(
            (kk >= s[:, None]) & (kk < (s + ref_len)[:, None]),
            w[:, None], 0.0).reshape(-1, span // 128, 128)
        cov = _add_rows(cov, base_units, valid_h, cov_delta)
    if snp:
        with jax.named_scope("acc_tallies"):
            val = pwm2[row_h].astype(jnp.float32) \
                * (w[:, None, None] * (1.0 / PWM_SCALE))   # (H, L, 4)
            # pure-match layout: genome column k sources read row k - s
            idx = kk - s[:, None]
            okp = (idx >= 0) & (idx < len_h[:, None])
            tal_delta = jnp.take_along_axis(
                val, jnp.clip(idx, 0, L - 1)[:, :, None], axis=1) \
                * okp[:, :, None]
            # gapped hits (rare): exact per-base columns via a compacted
            # one-hot contraction, replacing those hits' delta rows
            has_g = jnp.any((ops[:, :L] != 0) & in_read, axis=1) & valid_h
            K = tb_capacity(H)
            kg = jnp.cumsum(has_g.astype(jnp.int32)) - 1
            slot = jnp.where(has_g, kg, K)
            srcg = jnp.full((K,), 0, jnp.int32).at[slot].set(
                iota, mode="drop")
            tgtg = jnp.full((K,), H, jnp.int32).at[slot].set(
                iota, mode="drop")
            cg = (gidx - base[:, None])[srcg]              # (K, L)
            okg = ((opb == 0) & in_read)[srcg] \
                & (cg >= 0) & (cg < span)
            valg = val[srcg]                               # (K, L, 4)

            def chunk_fn(args):
                c_c, ok_c, v_c = args
                oh = ((c_c[:, :, None]
                       == jnp.arange(span, dtype=jnp.int32)[None, None])
                      & ok_c[:, :, None]).astype(jnp.float32)
                # each genome column receives <= 1 read row, so the
                # contraction has <= 1 nonzero term: exact in f32
                return jnp.einsum("kls,klb->ksb", oh, v_c,
                                  precision=jax.lax.Precision.HIGHEST)

            CH = 256
            Kp = ((K + CH - 1) // CH) * CH
            padk = ((0, Kp - K), (0, 0))
            cg_p = jnp.pad(cg, padk)
            okg_p = jnp.pad(okg, padk)
            valg_p = jnp.pad(valg, ((0, Kp - K), (0, 0), (0, 0)))
            delta_g = jax.lax.map(chunk_fn, (
                cg_p.reshape(-1, CH, L), okg_p.reshape(-1, CH, L),
                valg_p.reshape(-1, CH, L, 4))).reshape(Kp, span, 4)[:K]
            tal_delta = tal_delta.at[tgtg].set(delta_g, mode="drop")
            # row-major (span, 4) flattens to the 4p+b interleave
            tal_delta = tal_delta.reshape(H, span // 32, 128)
            tal = _add_rows(tal, base_units * 4, valid_h, tal_delta)
    return cov, tal, stats_vec


def decode_tb_blob(cfg: MapperConfig, B: int, n: int, lens_np, blob,
                   b_offset: int = 0):
    """Decode one device_tb_tail blob into per-read hits.

    B = device batch rows, n = real reads, lens_np = int32[B] read lengths;
    hits for read b land at out[b] (callers with read-sharded blobs pass
    b_offset to report global stats only).  Returns (out, n_keep, n_valid)
    or None on capacity overflow (caller falls back to the full-fetch host
    path)."""
    C = cfg.max_candidates
    H = cfg.hit_capacity * 2 * B
    K = tb_capacity(H)
    meta_all = blob[:4 * H].reshape(H, 4)
    n_keep = int(blob[-3])
    n_valid = int(blob[-2])
    n_tb = int(blob[-1])
    if n_keep > H or n_tb > K:
        return None
    meta = meta_all[:n_keep]
    ops_c = np.ascontiguousarray(
        blob[4 * H:-3].reshape(K, -1)).view(np.uint16)
    flat_idx = meta[:, 0] & ((1 << 21) - 1)
    jfin = (meta[:, 0] >> 21) & 0xFF
    rows = flat_idx // C
    b_idx = rows % B
    minus = (rows >= B).astype(np.int8)
    pos = cfg.window_start(meta[:, 1]) + jfin
    lens_h = lens_np[b_idx]
    islot = meta[:, 3]
    sc = meta[:, 2]
    out: List[List[ReadHit]] = [[] for _ in range(n)]
    # Vectorized dedupe + weights (the per-hit dict loop was ~40us/hit —
    # the host ceiling on multi-map-heavy batches).  Frozen semantics
    # preserved: dedupe by (read, strand, pos) keeping max score with
    # FIRST-in-hit-order winning ties (stable lexsort), weights
    # normalized over the deduped set in float64, output sorted by
    # (pos, '+' before '-').
    real = b_idx < n
    idx = np.nonzero(real)[0]
    if len(idx) == 0:
        return out, n_keep, n_valid
    order = idx[np.lexsort((-sc[idx], pos[idx], minus[idx], b_idx[idx]))]
    bo, mo, po = b_idx[order], minus[order], pos[order]
    first = np.empty(len(order), bool)
    first[0] = True
    first[1:] = (bo[1:] != bo[:-1]) | (mo[1:] != mo[:-1]) \
        | (po[1:] != po[:-1])
    winners = order[first]
    totals = np.bincount(b_idx[winners],
                         weights=sc[winners].astype(np.float64),
                         minlength=n)
    # emission order: (read, pos, strand) ascending
    emit = winners[np.lexsort((minus[winners], pos[winners],
                               b_idx[winners]))]
    w_emit = sc[emit].astype(np.float64) / totals[b_idx[emit]]
    for j, h in enumerate(emit):
        b = int(b_idx[h])
        L = int(lens_h[h])
        if islot[h] >= 0:
            cigar, rl = nw_finish.decode_ops(ops_c[islot[h]], L)
        else:
            cigar, rl = f"{L}M", L
        out[b].append(ReadHit("-" if minus[h] else "+", int(pos[h]),
                              int(sc[h]), float(w_emit[j]), cigar, rl))
    return out, n_keep, n_valid


class TpuMapper:
    """Holds the device-resident genome/index and the compiled map program."""

    def __init__(self, genome: Genome, index: CsrIndex, cfg: MapperConfig,
                 align_impl: str = "auto",
                 finish_impl: Optional[str] = None,
                 accumulate: str = "host", interpret: bool = False):
        """align_impl: 'auto' | 'jnp' | 'pallas' (align.select);
        interpret=True runs the 'pallas' kernel in the Pallas interpreter
        (CPU tests).  finish_impl: 'host' (native C++ traceback) or
        'device' (align.nw_finish); default 'device' with the kernel."""
        if index.mer_size != cfg.mer_size:
            raise ValueError("index mer_size != cfg.mer_size")
        self.genome = genome
        self.index = index
        self.cfg = cfg
        self.align_impl = resolve_align_impl(align_impl, interpret)
        self._interpret = interpret
        S_plus, S_minus = scoring.matrices_for_mode(cfg)
        self.S_plus_np, self.S_minus_np = S_plus, S_minus
        # device-resident int8 genome (window gathers and the DP kernel)
        self.g_codes = jnp.asarray(genome.codes)
        # seed-lookup backend: CSR (dense hash-as-arrays), FM (BWT), or the
        # bisulfite per-strand collapsed CSR pair; identical candidate sets
        # per backend (index/fm.py docstring, builder.BsIndexPair)
        from gnumap_tpu.index.fm import FmIndex, FmBsPair
        from gnumap_tpu.index.builder import BsIndexPair

        def _fm_args(fi):
            return (jnp.asarray(fi.sa), jnp.asarray(fi.bwt_words),
                    jnp.asarray(fi.occ), jnp.asarray(fi.c_table))

        if isinstance(index, BsIndexPair):
            self.index_kind = "csr_bs"
            self._idx_args = (jnp.asarray(index.plus.bucket_start),
                              jnp.asarray(index.plus.positions),
                              jnp.asarray(index.minus.bucket_start),
                              jnp.asarray(index.minus.positions))
        elif isinstance(index, FmBsPair):
            self.index_kind = "fm_bs"
            self._idx_args = _fm_args(index.plus) + _fm_args(index.minus)
        elif isinstance(index, FmIndex):
            self.index_kind = "fm"
            self._idx_args = _fm_args(index)
        else:
            self.index_kind = "csr"
            self._idx_args = (jnp.asarray(index.bucket_start),
                              jnp.asarray(index.positions))
        if cfg.bisulfite != self.index_kind.endswith("_bs"):
            raise ValueError(
                "bisulfite mode seeds on the per-strand collapsed alphabet "
                "[FROZEN]: build the index with builder.build_bs_index or "
                "fm.build_bs_fm_index (and only for bisulfite=True)")
        if self.index_kind == "fm_bs" and cfg.mer_size > 15:
            raise ValueError("FM bisulfite k-mer codes are base-4 int32: "
                             "mer_size <= 15 (the CSR pair's base-3 table "
                             "supports up to 18)")
        self.bucket_start, self.positions = (
            self._idx_args if self.index_kind == "csr" else (None, None))
        self.S_plus = jnp.asarray(S_plus)
        self.S_minus = jnp.asarray(S_minus)
        L, m = cfg.max_read_len, cfg.mer_size
        self.offsets = np.arange(0, L - m + 1, cfg.seed_jump, dtype=np.int32)
        # The genome/index arrays are ARGUMENTS of the jitted program, not
        # closure captures — captured device arrays become HLO constants and
        # the whole index would be shipped to the compiler on every compile.
        self.pwm_table = jnp.asarray(pwm_mod.pwm_table())
        self._big_args = tuple(a for a in (
            *self._idx_args, self.g_codes,
            self.S_plus, self.S_minus, self.pwm_table) if a is not None)
        self._map_jit_inner = jax.jit(self._device_map_args)
        self._map_jit = lambda c, p, l: self._map_jit_inner(
            c, p, l, *self._big_args)
        # packed single-output variant: one device-to-host copy per batch
        self._map_packed_inner = jax.jit(self._device_map_packed)
        self._map_packed = lambda c, p, l: self._map_packed_inner(
            c, p, l, *self._big_args)
        # device-finish variant: retention threshold + winner compaction +
        # traceback all on device; the host only decodes CIGARs and
        # normalizes posteriors.
        self.finish_impl = (finish_impl if finish_impl is not None else
                            ("device" if self.align_impl == "pallas"
                             else "host"))
        if self.finish_impl not in ("host", "device"):
            raise ValueError(f"finish_impl {self.finish_impl!r}")
        self._map_tb_inner = jax.jit(self._device_map_tb)
        self._map_tb = lambda c, p, l: self._map_tb_inner(
            c, p, l, *self._big_args)
        # quality-derived variants: ship (codes, quals), build PWM on device
        self._map_tb_q_inner = jax.jit(self._device_map_tb_q)
        self._map_tb_q = lambda p, l: self._map_tb_q_inner(
            p, l, *self._big_args)
        self._map_packed_q_inner = jax.jit(self._device_map_packed_q)
        self._map_packed_q = lambda p, l: self._map_packed_q_inner(
            p, l, *self._big_args)
        # [FROZEN v5] device accumulation (device_accumulate): coverage /
        # SNP tallies live ON DEVICE across batches (donated buffers) and
        # only a 4-int stats vector (or, with SAM on, the tb blob) reaches
        # the host per batch.  Requires the device-finish pipeline.
        self.accumulate = accumulate
        if accumulate == "device":
            if self.finish_impl != "device":
                raise ValueError("accumulate='device' requires "
                                 "finish_impl='device'")
            self._cov_dev = None
            self._tal_dev = None
            self.reset_accumulators()
            self._map_acc_inner = jax.jit(self._device_map_acc)
            self._map_acc_q_inner = jax.jit(self._device_map_acc_q)
            self._apply_acc_inner = jax.jit(self._apply_acc,
                                            donate_argnums=(0, 1))
        # fetch workers (see submit); sized for map_stream's depth-3
        # pipeline — the device serializes the programs themselves
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=3, thread_name_prefix="gnumap-fetch")

    # ------------------------------------------------------------------
    # Device program
    # ------------------------------------------------------------------
    def _seed(self, codes2, idx_args=None):
        """Candidate anchors per (read x strand): int32[B2, C] + valid
        mask.  ``idx_args`` = CSR (bucket_start, positions) or FM
        (sa, bwt_words, occ, c_table) arrays."""
        cfg = self.cfg
        idx_args = self._idx_args if idx_args is None else idx_args
        if self.index_kind == "csr_bs":
            # bisulfite [FROZEN]: plus rows seed C->T-collapsed against the
            # C->T genome index, minus (revcomp) rows G->A (GNUMAP-bs —
            # conversion never breaks a seed); base-3 k-mer codes
            from gnumap_tpu.index.builder import BS_DIGITS
            B = codes2.shape[0] // 2
            kmp, badp = seed_kmers_b3(
                codes2[:B], self.offsets, cfg.mer_size,
                jnp.asarray(BS_DIGITS["ct"], jnp.int32))
            kmm, badm = seed_kmers_b3(
                codes2[B:], self.offsets, cfg.mer_size,
                jnp.asarray(BS_DIGITS["ga"], jnp.int32))
            cand = jnp.concatenate([
                csr_hits(kmp, badp, idx_args[0], idx_args[1],
                         self.offsets, cfg),
                csr_hits(kmm, badm, idx_args[2], idx_args[3],
                         self.offsets, cfg)], axis=0)
        elif self.index_kind == "fm_bs":
            # bisulfite on the FM backend: collapse the read halves, search
            # each in its collapsed FM index (base-4 codes suffice — no
            # dense bucket table to size)
            from gnumap_tpu.index.fm import fm_hits
            B = codes2.shape[0] // 2
            cp = jnp.where(codes2[:B] == 1, jnp.int8(3), codes2[:B])
            cm = jnp.where(codes2[B:] == 2, jnp.int8(0), codes2[B:])
            kmp, badp = seed_kmers(cp, self.offsets, cfg.mer_size)
            kmm, badm = seed_kmers(cm, self.offsets, cfg.mer_size)
            cand = jnp.concatenate([
                fm_hits(kmp, badp, *idx_args[:4], self.offsets, cfg),
                fm_hits(kmm, badm, *idx_args[4:], self.offsets, cfg)],
                axis=0)
        else:
            km, bad = seed_kmers(codes2, self.offsets, cfg.mer_size)
            if self.index_kind == "fm":
                from gnumap_tpu.index.fm import fm_hits
                cand = fm_hits(km, bad, *idx_args, self.offsets, cfg)
            else:
                cand = csr_hits(km, bad, *idx_args, self.offsets, cfg)
        # the sort-free 'matrix' dedupe stays as an A/B reference
        # (GNUMAP_DEDUPE_IMPL=matrix|sort)
        cands = dedupe_cap(cand, cfg.max_candidates,
                           impl=os.environ.get("GNUMAP_DEDUPE_IMPL",
                                               "sort"))
        return cands, cands != SENTINEL

    def _split_big(self, big):
        ni = len(self._idx_args)
        idx_args = big[:ni]
        g_codes, S_plus, S_minus, table = big[ni:]
        return idx_args, g_codes, S_plus, S_minus, table

    def _device_map_args(self, codes, pwm_q, lens, *big):
        """big = the device-resident genome/index arrays in _big_args
        order (passed as traced args, see __init__)."""
        idx_args, g_codes, S_plus, S_minus, _ = self._split_big(big)
        return self._device_map(codes, pwm_q, lens, idx_args,
                                g_codes, S_plus, S_minus)

    def _device_map_tb_q(self, packed, lens, *big):
        """Quality-derived batches: reads arrive as ONE pack_reads uint8
        array; codes/quals unpack and the PWM builds on device."""
        codes, quals = device_unpack(packed, self.cfg.max_read_len)
        table = self._split_big(big)[4]
        pwm_q = device_pwm(codes, quals, lens, table)
        return self._device_map_tb(codes, pwm_q, lens, *big)

    def _device_map_packed_q(self, packed, lens, *big):
        codes, quals = device_unpack(packed, self.cfg.max_read_len)
        table = self._split_big(big)[4]
        pwm_q = device_pwm(codes, quals, lens, table)
        return self._device_map_packed(codes, pwm_q, lens, *big)

    def _device_map_packed(self, codes, pwm_q, lens, *big):
        """All outputs in ONE int32 blob: [cands | scores | max_sc]."""
        cands, valid, scores, max_sc = self._device_map_args(
            codes, pwm_q, lens, *big)
        return jnp.concatenate(
            [cands, scores, max_sc[:, None]], axis=1)

    @staticmethod
    def unpack_blob(blob, C):
        cands = blob[:, :C]
        scores = blob[:, C:2 * C]
        max_sc = blob[:, 2 * C]
        return cands, cands != SENTINEL, scores, max_sc

    def _device_map(self, codes, pwm_q, lens, idx_args=None,
                    g_codes=None, S_plus=None, S_minus=None):
        cfg = self.cfg
        idx_args = self._idx_args if idx_args is None else idx_args
        g_codes = self.g_codes if g_codes is None else g_codes
        S_plus = self.S_plus if S_plus is None else S_plus
        S_minus = self.S_minus if S_minus is None else S_minus
        with jax.named_scope("strand_emission"):
            codes2, emis2 = strand_expand(codes, pwm_q, lens,
                                          S_plus, S_minus)
            max_sc = nw_ref.max_read_scores(emis2)
        with jax.named_scope("seed"):
            cands, valid = self._seed(codes2, idx_args)
        lens2 = jnp.concatenate([lens, lens], axis=0)
        scores = dp_scores(cfg, self.align_impl, emis2, cands, lens2,
                           g_codes, self._interpret)
        scores = jnp.where(valid, scores, NEG_INF)
        return cands, valid, scores, max_sc

    def _device_map_tb(self, codes, pwm_q, lens, *big):
        """Scoring + exact retention + winner compaction + device traceback,
        all in ONE device program with ONE flat int32 output blob:

          blob[:4*H]    per-hit meta [flat_idx | j_final << 21, cand,
                        score, indel_slot] x H rows (-1 = empty slot,
                        indel_slot -1 = pure-match)
          blob[4*H:-3]  compacted traceback ops for the K indel-bearing
                        hits only (two uint16 rows per int32 word) — hits
                        whose walk is all matches need no ops (CIGAR is
                        "<len>M", pos comes from j_final), and those are
                        the overwhelming majority
          blob[-3:]     [n_keep, n_valid, n_tb]

        Hit capacity H = hit_capacity * B2 rows, traceback capacity
        K = max(64, H/8) (tb_capacity); if a batch needs more (n_keep > H
        or n_tb > K — pathological loads), finish_devtb falls back to the
        full-fetch host path (device_tb_tail)."""
        cfg = self.cfg
        cands, valid, scores, max_sc = self._device_map_args(
            codes, pwm_q, lens, *big)
        _, g_codes, S_plus, S_minus, _ = self._split_big(big)
        # strand_expand here is CSE'd with the identical call inside
        # _device_map_args (same jit program)
        _, emis2 = strand_expand(codes, pwm_q, lens, S_plus, S_minus)
        lens2 = jnp.concatenate([lens, lens], axis=0)
        return device_tb_tail(cfg, cands, valid, scores, max_sc, emis2,
                              lens2, g_codes)

    # ------------------------------------------------------------------
    # [FROZEN v5] device accumulation (see device_accumulate)
    # ------------------------------------------------------------------
    def reset_accumulators(self):
        """(Re)zero the device-resident coverage/tally arrays.  Arrays
        are padded by one span so clipped genome-edge spans land in the
        pad (sliced off at fetch) — the device analog of drop-mode."""
        G = len(self.genome.codes)
        Gpad = acc_padded_len(self.cfg, G)
        self._cov_dev = jnp.zeros((Gpad // 128, 128), jnp.float32)
        # tallies are interleaved: (pos p, base b) -> flat 4p+b ->
        # [(4p+b)//128, (4p+b)%128], so 128 positions are 4 whole rows
        self._tal_dev = (jnp.zeros((Gpad * 4 // 128, 128), jnp.float32)
                         if self.cfg.snp_mode
                         else jnp.zeros((acc_span(self.cfg) * 4 // 128,
                                         128), jnp.float32))

    def fetch_accumulators(self):
        """Device f32 accumulators -> host float64 (the [FROZEN v5] fetch
        boundary).  Returns (coverage, tallies-or-None)."""
        G = len(self.genome.codes)
        cov = np.asarray(self._cov_dev).reshape(-1)[:G].astype(np.float64)
        tal = (np.asarray(self._tal_dev).reshape(-1, 4)[:G].astype(
                   np.float64)
               if self.cfg.snp_mode else None)
        return cov, tal

    def load_accumulators(self, cov, tal=None):
        """Resume from checkpointed host arrays (f64 -> f32)."""
        G = len(self.genome.codes)
        Gpad = acc_padded_len(self.cfg, G)
        c = np.zeros((Gpad,), np.float32)
        c[:G] = np.asarray(cov)[:G]
        self._cov_dev = jnp.asarray(c.reshape(-1, 128))
        if tal is not None and self.cfg.snp_mode:
            t = np.zeros((Gpad, 4), np.float32)
            t[:G] = np.asarray(tal)[:G]
            self._tal_dev = jnp.asarray(t.reshape(-1, 128))

    def _device_map_acc(self, codes, pwm_q, lens, *big):
        """Accumulate-path program 1: the full map + tb pipeline, emitting
        the raw per-hit rows (+ both-strand PWM) as DEVICE-RESIDENT
        outputs for the separate accumulation program (_apply_acc).  Two
        programs instead of one keeps each compile small and fast; the
        intermediates never leave the device."""
        cfg = self.cfg
        cands, valid, scores, max_sc = self._device_map_args(
            codes, pwm_q, lens, *big)
        _, g_codes, S_plus, S_minus, _ = self._split_big(big)
        # strand_expand / revcomp_batch here CSE with the identical calls
        # inside _device_map_args (same jit program)
        _, emis2 = strand_expand(codes, pwm_q, lens, S_plus, S_minus)
        _, rc_pwm = revcomp_batch(codes, pwm_q, lens)
        pwm2 = jnp.concatenate([pwm_q, rc_pwm], axis=0)
        lens2 = jnp.concatenate([lens, lens], axis=0)
        rows = device_hit_rows(cfg, cands, valid, scores, max_sc, emis2,
                               lens2, g_codes)
        blob = device_tb_tail(cfg, cands, valid, scores, max_sc, emis2,
                              lens2, g_codes, rows=rows)
        # nvk = [n_valid, n_keep, n_tb]: n_tb (which bounds the gapped-hit
        # count device_accumulate's K-capacity replacement sees) rides
        # along so finish_acc can detect BOTH capacity overflows BEFORE any
        # delta is applied
        return (blob, rows["row_h"], rows["cand_h"], rows["score_h"],
                rows["len_h"], rows["ops"], rows["jfin"],
                jnp.stack([rows["n_valid"], rows["n_keep"], blob[-1]]),
                pwm2)

    def _device_map_acc_q(self, packed, lens, *big):
        codes, quals = device_unpack(packed, self.cfg.max_read_len)
        table = self._split_big(big)[4]
        pwm_q = device_pwm(codes, quals, lens, table)
        return self._device_map_acc(codes, pwm_q, lens, *big)

    def _apply_acc(self, cov, tal, row_h, cand_h, score_h, len_h, ops,
                   jfin, nvk, pwm2):
        """Accumulate-path program 2: [FROZEN v5] dedupe + weights +
        scatter-add into the donated device accumulators."""
        rows = dict(valid_h=cand_h != SENTINEL,
                    row_h=row_h, cand_h=cand_h, score_h=score_h,
                    len_h=len_h, ops=ops, jfin=jfin,
                    n_valid=nvk[0], n_keep=nvk[1])
        B = pwm2.shape[0] // 2
        return device_accumulate(self.cfg, B, pwm2, rows, cov, tal,
                                 self.cfg.snp_mode)

    def _submit_acc(self, batch: ReadBatch):
        """[FROZEN v5.1] submit runs ONLY the map program; the accumulate
        program (_apply_acc) is deferred to finish_acc so that
          (1) capacity overflow is detected BEFORE any delta reaches the
              device accumulators (host fallback instead of a mid-stream
              RuntimeError), and
          (2) a mid-stream checkpoint sees exactly ``batches_done``
              batches — an in-flight submitted batch has not touched
              device state, so resuming replays it without double
              counting (r4 advisor high-severity finding).
        The heavy map program still pipelines across batches; only the
        cheap accumulate program serializes at finish."""
        if batch.pwm_arr is None:
            out1 = self._map_acc_q_inner(
                jnp.asarray(pack_reads(batch.codes, batch.quals)),
                jnp.asarray(batch.lens), *self._big_args)
        else:
            out1 = self._map_acc_inner(
                jnp.asarray(batch.codes), jnp.asarray(batch.pwm_arr),
                jnp.asarray(batch.lens), *self._big_args)
        blob, hit_args = out1[0], out1[1:]
        # background fetches force + overlap the map program's execution
        nvk_fut = self._fetch_pool.submit(np.asarray, hit_args[-2])
        blob_fut = (self._fetch_pool.submit(np.asarray, blob)
                    if self.cfg.sam_out else None)
        return (hit_args, nvk_fut, blob_fut)

    def finish_acc(self, batch: ReadBatch, dev_out,
                   stats: Optional[BatchStats] = None
                   ) -> List[List[ReadHit]]:
        """[FROZEN v5.1] Apply this batch's accumulation (deferred from
        submit — see _submit_acc), then decode the per-batch fetch:
        either the stats vector (no SAM — the host does nothing per
        batch) or the tb blob (SAM on — decoded for records only).

        Capacity overflow (n_keep > H or n_tb > K — pathological
        multi-map / indel loads) is detected BEFORE any delta is applied:
        the batch falls back to the exact host path and its float64
        contributions fold into the device accumulators
        (_finish_acc_overflow)."""
        cfg = self.cfg
        B = batch.codes.shape[0]
        H = cfg.hit_capacity * 2 * B
        K = tb_capacity(H)
        hit_args, nvk_fut, blob_fut = dev_out
        t0 = time.perf_counter()
        nvk = nvk_fut.result()
        n_valid, n_keep, n_tb = (int(x) for x in nvk)
        if n_keep > H or n_tb > K:
            return self._finish_acc_overflow(batch, n_keep, n_tb,
                                             n_valid, stats, t0)
        cov, tal, stvec = self._apply_acc_inner(
            self._cov_dev, self._tal_dev, *hit_args)
        self._cov_dev, self._tal_dev = cov, tal
        if cfg.sam_out:
            arr = blob_fut.result()
            t1 = time.perf_counter()
            out, n_keep, n_valid = decode_tb_blob(
                cfg, B, batch.n, batch.lens, arr)   # caps checked above
            n_mapped = sum(1 for hh in out if hh)
            n_multi = sum(1 for hh in out if len(hh) > 1)
        else:
            arr = np.asarray(stvec)      # forces the accumulate program
            t1 = time.perf_counter()
            n_mapped, n_multi, n_valid, n_keep = (int(x) for x in arr)
            out = [[] for _ in range(batch.n)]
        t2 = time.perf_counter()
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += n_mapped
            stats.n_multi += n_multi
            stats.n_candidates += n_valid
            rect, band = _cells_per_cand(cfg)
            stats.dp_cells += n_valid * cfg.max_read_len * rect
            stats.dp_cells_banded += n_valid * cfg.max_read_len * band
            stats.device_s += t1 - t0
            stats.host_s += t2 - t1
        return out

    def _finish_acc_overflow(self, batch: ReadBatch, n_keep: int,
                             n_tb: int, n_valid: int,
                             stats: Optional[BatchStats], t0: float
                             ) -> List[List[ReadHit]]:
        """Capacity-overflow fallback: the batch's deltas were NOT applied
        (detection precedes application), so re-map it on the exact
        full-fetch host path and fold the float64 contributions into the
        device accumulators (fetch -> ordered host scatter -> re-quantize
        f32).  Values can differ from a hypothetical infinite-capacity
        device batch only at f32 rounding; determinism for a fixed stream
        is preserved.  Raise cfg.hit_capacity if this fires on every
        batch."""
        import logging
        cfg = self.cfg
        B = batch.codes.shape[0]
        logging.getLogger(__name__).warning(
            "device-accumulation capacity overflow (n_keep=%d > H=%d or "
            "n_tb=%d > K=%d): exact host-path fallback for this batch",
            n_keep, cfg.hit_capacity * 2 * B, n_tb,
            tb_capacity(cfg.hit_capacity * 2 * B))
        out = self.finish_host(
            batch, self._map_packed(jnp.asarray(batch.codes),
                                    jnp.asarray(batch.pwm_q),
                                    jnp.asarray(batch.lens)), None)
        t1 = time.perf_counter()
        cov, tal = self.fetch_accumulators()
        cov_rows = [(h.pos, h.ref_len, h.weight)
                    for hits in out for h in hits]
        _scatter_coverage(cov, cov_rows)
        if cfg.snp_mode:
            tal_rows = []
            for b, hits in enumerate(out):
                L = int(batch.lens[b])
                for h in hits:
                    tal_rows.append((b, h.strand == "-", h.pos, h.weight,
                                     None if h.cigar == f"{L}M"
                                     else h.cigar))
            _scatter_tallies(tal, batch, tal_rows)
        self.load_accumulators(cov, tal)
        t2 = time.perf_counter()
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += sum(1 for hh in out if hh)
            stats.n_multi += sum(1 for hh in out if len(hh) > 1)
            stats.n_candidates += n_valid
            rect, band = _cells_per_cand(cfg)
            stats.dp_cells += n_valid * cfg.max_read_len * rect
            stats.dp_cells_banded += n_valid * cfg.max_read_len * band
            stats.device_s += t1 - t0
            stats.host_s += t2 - t1
        return out

    # ------------------------------------------------------------------
    # Host finishing
    # ------------------------------------------------------------------
    def submit(self, batch: ReadBatch):
        """Dispatch the device program asynchronously (XLA async dispatch);
        pair with finish().  Enables device/host pipelining in map_stream
        (the reference's SeqManager double-buffering analog).  Quality-
        derived batches (pwm_arr None) ship quals and rebuild the PWM on
        device — 8x less H2D traffic."""
        if self.accumulate == "device":
            return self._submit_acc(batch)
        dev = self.finish_impl == "device"
        if batch.pwm_arr is None:
            fn = self._map_tb_q if dev else self._map_packed_q
            out = fn(jnp.asarray(pack_reads(batch.codes, batch.quals)),
                     jnp.asarray(batch.lens))
        else:
            fn = self._map_tb if dev else self._map_packed
            out = fn(jnp.asarray(batch.codes), jnp.asarray(batch.pwm_arr),
                     jnp.asarray(batch.lens))
        # The device-to-host copy runs on a worker thread, so the caller
        # can dispatch later batches and finish earlier ones while this
        # batch executes and transfers.
        return self._fetch_pool.submit(np.asarray, out)

    def finish(self, batch: ReadBatch, dev_out,
               stats: Optional[BatchStats] = None) -> List[List[ReadHit]]:
        if self.accumulate == "device":
            return self.finish_acc(batch, dev_out, stats)
        if self.finish_impl == "device":
            return self.finish_devtb(batch, dev_out, stats)
        return self.finish_host(batch, dev_out, stats)

    def finish_host(self, batch: ReadBatch, dev_out,
                    stats: Optional[BatchStats] = None
                    ) -> List[List[ReadHit]]:
        t0 = time.perf_counter()
        blob = _materialize(dev_out)
        outputs = self.unpack_blob(blob, self.cfg.max_candidates)
        t1 = time.perf_counter()
        out = host_finish(self.genome, self.S_plus_np, self.S_minus_np,
                          self.cfg, batch, *outputs)
        t2 = time.perf_counter()
        if stats is not None:
            _, valid, _, _ = outputs
            _update_stats(stats, self.cfg, batch, out, valid,
                          t1 - t0, t2 - t1)
        return out

    def finish_devtb(self, batch: ReadBatch, dev_out,
                     stats: Optional[BatchStats] = None
                     ) -> List[List[ReadHit]]:
        """Decode the device traceback blob: group hits per read, dedupe by
        (strand, pos), normalize posterior weights.  No DP on the host."""
        cfg = self.cfg
        t0 = time.perf_counter()
        blob = _materialize(dev_out)
        t1 = time.perf_counter()
        B = batch.codes.shape[0]
        decoded = decode_tb_blob(cfg, B, batch.n, batch.lens, blob)
        if decoded is None:
            # capacity overflow (extreme repeat / indel batch): re-dispatch
            # on the full-fetch host path — exact, just slower (compiles
            # the packed program + ships the full PWM on first use; raise
            # cfg.hit_capacity if this fires on every batch)
            import logging
            logging.getLogger(__name__).warning(
                "device-finish hit-capacity overflow "
                "(n_keep=%d n_tb=%d, H=%d K=%d): host-path fallback",
                int(blob[-3]), int(blob[-1]),
                cfg.hit_capacity * 2 * B,
                tb_capacity(cfg.hit_capacity * 2 * B))
            return self.finish_host(
                batch, self._map_packed(jnp.asarray(batch.codes),
                                        jnp.asarray(batch.pwm_q),
                                        jnp.asarray(batch.lens)), stats)
        out, n_keep, n_valid = decoded
        t2 = time.perf_counter()
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += sum(1 for hh in out if hh)
            stats.n_multi += sum(1 for hh in out if len(hh) > 1)
            stats.n_candidates += n_valid
            rect, band = _cells_per_cand(cfg)
            stats.dp_cells += n_valid * cfg.max_read_len * rect
            stats.dp_cells_banded += n_valid * cfg.max_read_len * band
            stats.device_s += t1 - t0
            stats.host_s += t2 - t1
        return out

    def map_batch(self, batch: ReadBatch,
                  stats: Optional[BatchStats] = None) -> List[List[ReadHit]]:
        return self.finish(batch, self.submit(batch), stats)


def _window_np(g_codes: np.ndarray, start: int, width: int) -> np.ndarray:
    out = np.full(width, 4, dtype=np.int8)
    lo, hi = max(start, 0), min(start + width, len(g_codes))
    if hi > lo:
        out[lo - start:hi - start] = g_codes[lo:hi]
    return out


# ---------------------------------------------------------------------------
# Streaming driver: map a read stream, accumulate outputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapResult:
    coverage: Optional[np.ndarray]   # None when no output needs it
    tallies: Optional[np.ndarray]
    sam_lines: List[str]
    stats: BatchStats


def map_stream(mapper: TpuMapper, batches: Iterable[ReadBatch],
               collect_sam: bool = True, sam_file=None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 16,
               batch_callback=None) -> MapResult:
    """Map a batch stream.  With ``checkpoint_path``, stream state is saved
    every ``checkpoint_every`` batches and a restart resumes after the last
    checkpointed batch (SAM truncated to the recorded offset);
    ``batch_callback(idx, stats)`` fires after each batch (observability /
    fault-injection hook)."""
    from gnumap_tpu.pipeline import checkpoint as ckpt_mod
    cfg = mapper.cfg
    gen = mapper.genome
    # [FROZEN v5] device accumulation: coverage/tallies live on device
    # (mapper._cov_dev/_tal_dev) and are fetched only at checkpoints and
    # stream end — no host arrays, no per-batch scatter
    dev_acc = getattr(mapper, "accumulate", "host") == "device"
    # coverage RSS must be independent of genome length when nothing
    # consumes it: a SAM-only run of a 3 Gbp
    # genome must not allocate a 24 GB float64 array
    need_cov = (cfg.sgr_out or cfg.sgrex_out or cfg.snp_mode) \
        and not dev_acc
    coverage = (np.zeros(len(gen.codes), dtype=np.float64)
                if need_cov else None)
    tallies = (np.zeros((len(gen.codes), 4), dtype=np.float64)
               if cfg.snp_mode and not dev_acc else None)
    sam_lines: List[str] = []
    stats = BatchStats()
    start_batch = 0
    if checkpoint_path:
        state = ckpt_mod.load(checkpoint_path)
        if state is not None:
            if dev_acc:
                mapper.load_accumulators(state.coverage, state.tallies)
            else:
                if state.coverage is not None and coverage is not None:
                    coverage = state.coverage.astype(np.float64).copy()
                if state.tallies is not None and tallies is not None:
                    tallies = state.tallies.astype(np.float64).copy()
            stats = state.stats
            start_batch = state.batches_done
            if sam_file is not None and sam_file.seekable():
                sam_file.seek(state.sam_offset)
                sam_file.truncate()
        batches = (b for i, b in enumerate(batches) if i >= start_batch)

    def emit(line: str):
        if sam_file is not None:
            sam_file.write(line)
        elif collect_sam:
            sam_lines.append(line)

    def results(depth: int = 3):
        """Keep ``depth`` batches in flight: device round-trips overlap
        host finishing/parsing (the reference's SeqManager double-buffer,
        deepened — same scheme as bench.py)."""
        from collections import deque
        if not hasattr(mapper, "submit"):
            for batch in batches:
                yield batch, mapper.map_batch(batch, stats)
            return
        q = deque()
        for batch in batches:
            q.append((batch, mapper.submit(batch)))
            if len(q) > depth:
                pb, pf = q.popleft()
                yield pb, mapper.finish(pb, pf, stats)
        while q:
            pb, pf = q.popleft()
            yield pb, mapper.finish(pb, pf, stats)

    # Native batch SAM formatter: one C call per batch replaces the
    # per-read decode + f-string loop.
    # Byte-identical to the io/sam.py records (tests/test_native.py,
    # goldens).
    from gnumap_tpu.native import lib as native_lib
    use_native_sam = cfg.sam_out and native_lib.available()
    batch_idx = start_batch
    _ck_fut: list = [None]
    try:
        for batch, hits_per_read in results():
            # batch-level vectorized string prep (10M chr() calls per 100k
            # reads otherwise — a real CLI bottleneck)
            if cfg.sam_out and not use_native_sam:
                qbytes = (batch.quals[:batch.n] + 33).astype(np.uint8)
            # coverage/tally scatter-add is batched: the per-read loop only
            # collects (pos, ref_len, weight) rows; ONE ordered np.add.at per
            # batch then applies them bit-identically to the old per-hit
            # slice-add loop
            cov_rows: List[Tuple[int, int, float]] = []
            tally_rows: List[Tuple[int, bool, int, float, Optional[str]]] = []
            py_sam = cfg.sam_out and not use_native_sam
            # genome-partitioned multi-host SAM: the mapper decides, per read,
            # whether THIS host owns its records (segments.GlobalSegmentedMapper
            # sets gp_sam each batch)
            gp = (getattr(mapper, "gp_sam", None)
                  if cfg.sam_out and getattr(mapper, "num_hosts", 1) > 1
                  else None)
            gp_host = getattr(mapper, "host_id", 0)
            for b, hits in enumerate(hits_per_read):
                L = int(batch.lens[b])
                codes = batch.codes[b, :L]
                if py_sam:
                    seq = packing.decode(codes)
                    qual = qbytes[b, :L].tobytes().decode("ascii")
                else:
                    seq = qual = ""
                if not hits:
                    if py_sam and not (gp is not None
                                       and (bool(gp["mapped"][b])
                                            or gp_host != 0)):
                        emit(sam_io.unmapped_record(batch.names[b], seq, qual))
                    continue
                for hi, h in enumerate(hits):
                    if coverage is not None:
                        cov_rows.append((h.pos, h.ref_len, h.weight))
                    if tallies is not None:
                        pure = h.cigar == f"{L}M"
                        tally_rows.append((b, h.strand == "-", h.pos, h.weight,
                                           None if pure else h.cigar))
                    if py_sam:
                        ci, off = gen.locate(h.pos)
                        sec = ((hi > 0) if h.primary is None
                               else not h.primary)
                        flag = (16 if h.strand == "-" else 0) | (
                            256 if sec else 0)
                        if h.strand == "-":
                            oseq = packing.decode(packing.revcomp(codes))
                            oqual = qual[::-1]
                        else:
                            oseq, oqual = seq, qual
                        emit(sam_io.record(
                            batch.names[b], flag, gen.names[int(ci)], int(off),
                            sam_io.mapq_from_weight(h.weight), h.cigar,
                            oseq, oqual, h.score, h.weight))
            if use_native_sam:
                emit(format_sam_batch_native(gen, batch, hits_per_read,
                                             gp=gp, host_id=gp_host))
            if coverage is not None:
                _scatter_coverage(coverage, cov_rows)
            if tallies is not None and tally_rows:
                _scatter_tallies(tallies, batch, tally_rows)
            batch_idx += 1
            # callbacks run BEFORE the checkpoint: callback-written
            # artifacts (the CLI's SAM span / per-record indexes)
            # must be on disk before a checkpoint state that
            # references this batch can become visible (a crash
            # between the two would otherwise leave an index shorter
            # than batches_done)
            if batch_callback is not None:
                batch_callback(batch_idx, stats)
            if checkpoint_path and batch_idx % checkpoint_every == 0:
                # async checkpointing (a synchronous fetch + compress +
                # write would stall the stream): the
                # state is SNAPSHOTTED on the stream thread (array copies;
                # device fetch for dev_acc — the donated buffers can't be
                # read later), then serialized + written on a background
                # thread.  One write in flight max: the next checkpoint (or
                # stream end / unwind) joins the previous first, and save()'s
                # tmp+rename keeps every on-disk state complete.
                if _ck_fut[0] is not None:
                    _ck_fut[0].result()
                    _ck_fut[0] = None
                off = 0
                if sam_file is not None:
                    sam_file.flush()
                    off = sam_file.tell()
                if dev_acc:
                    cov_ck, tal_ck = mapper.fetch_accumulators()
                else:
                    cov_ck = None if coverage is None else coverage.copy()
                    tal_ck = None if tallies is None else tallies.copy()
                st_ck = ckpt_mod.StreamState(
                    batch_idx, cov_ck, tal_ck, dataclasses.replace(stats), off)
                _ck_fut[0] = _ck_pool().submit(
                    ckpt_mod.save, checkpoint_path, st_ck)
    finally:
        # join any in-flight checkpoint write so callers (and
        # the kill/restart tests) see a complete on-disk state
        if _ck_fut[0] is not None:
            _ck_fut[0].result()
    if dev_acc:
        coverage, tallies = mapper.fetch_accumulators()
        if not (cfg.sgr_out or cfg.sgrex_out or cfg.snp_mode):
            coverage = None
    return MapResult(coverage, tallies, sam_lines, stats)


def format_sam_batch_native(gen: Genome, batch: ReadBatch, hits_per_read,
                            gp=None, host_id: int = 0) -> str:
    """One batch of SAM records via the native formatter — byte-identical
    to the per-record io/sam.py path (tests/test_native.py, goldens).
    ``gp``: genome-partitioned multi-host metadata (segments.gp_sam) —
    a read with no LOCAL hits emits nothing when another host owns its
    records (globally mapped, or unmapped with host_id != 0)."""
    from gnumap_tpu.config import SCORE_ONE
    from gnumap_tpu.native import lib as native_lib
    n = batch.n
    lens = batch.lens
    b_idx: List[int] = []
    flags: List[int] = []
    pos_l: List[int] = []
    cigs: List[str] = []
    scores: List[int] = []
    weights: List[float] = []
    unmapped = np.zeros(n, np.uint8)
    skip = np.zeros(n, np.uint8) if gp is not None else None
    for b, hits in enumerate(hits_per_read):
        if not hits:
            if gp is not None and (bool(gp["mapped"][b]) or host_id != 0):
                skip[b] = 1
            else:
                unmapped[b] = 1
            continue
        pure = f"{int(lens[b])}M"
        for hi, h in enumerate(hits):
            sec = (hi > 0) if h.primary is None else not h.primary
            b_idx.append(b)
            flags.append((16 if h.strand == "-" else 0)
                         | (256 if sec else 0))
            pos_l.append(h.pos)
            cigs.append("" if h.cigar == pure else h.cigar)
            scores.append(h.score)
            weights.append(h.weight)
    pos_g = np.asarray(pos_l, np.int64)
    w = np.asarray(weights, np.float64)
    if len(b_idx):
        ci, off = gen.locate(pos_g)
        ci, off = np.atleast_1d(ci), np.atleast_1d(off)
        # frozen mapq formula (io/sam.py mapq_from_weight): np.round is
        # round-half-even, same as Python round()
        with np.errstate(divide="ignore"):
            mq = np.where(
                w >= 1.0 - 1e-12, 60,
                np.clip(np.round(-10.0 * np.log10(
                    np.maximum(1e-12, 1.0 - w))), 0, 60)).astype(np.int32)
    else:
        ci = off = mq = np.zeros(0, np.int32)
    sc = np.asarray(scores, np.int32)
    buf = native_lib.format_sam_batch(
        batch.codes[:n], batch.quals[:n], lens[:n], batch.names[:n],
        gen.names, np.asarray(b_idx, np.int32),
        np.asarray(flags, np.int32), ci.astype(np.int32),
        off.astype(np.int64), mq, cigs, sc,
        sc.astype(np.float64) / SCORE_ONE, w, unmapped, skip=skip)
    return buf.decode("ascii")


def _scatter_coverage(coverage: np.ndarray,
                      rows: List[Tuple[int, int, float]]) -> None:
    """One ordered scatter over all of a batch's hits.

    Ordered adds in hit order make this bit-identical to the old per-hit
    ``coverage[pos:pos+ref_len] += w`` loop (out-of-range/pad adds are
    exactly +0.0, an IEEE identity).  Native C++ when available (~100x
    np.add.at); NumPy ordered np.add.at fallback."""
    if not rows:
        return
    G = coverage.shape[0]
    pos = np.fromiter((r[0] for r in rows), np.int64, len(rows))
    rl = np.fromiter((r[1] for r in rows), np.int64, len(rows))
    w = np.fromiter((r[2] for r in rows), np.float64, len(rows))
    from gnumap_tpu.native import lib as native_lib
    if native_lib.available():
        native_lib.scatter_coverage(coverage, pos, rl, w)
        return
    ar = np.arange(int(rl.max()) if len(rl) else 0, dtype=np.int64)
    idx = pos[:, None] + ar[None, :]
    ok = (ar[None, :] < rl[:, None]) & (idx >= 0) & (idx < G)
    np.add.at(coverage, np.where(ok, idx, 0).ravel(),
              np.where(ok, w[:, None], 0.0).ravel())


def _scatter_tallies(tallies: np.ndarray, batch: ReadBatch,
                     rows: List[Tuple[int, bool, int, float, Optional[str]]]
                     ) -> None:
    """Batched SNP tally scatter-add (GNUMAP-SNP per-base fractional
    A/C/G/T counts, SURVEY.md §2).  rows = (read, minus, pos, weight,
    cigar-or-None) in hit order; None marks a pure-match hit.

    Pure-match hits (the overwhelming majority) are laid out fully
    vectorized; gapped hits fall back to per-run slices appended in the
    same hit order, so the single ordered np.add.at reproduces the old
    per-hit loop bit-for-bit (see _scatter_coverage)."""
    from gnumap_tpu.config import PWM_SCALE
    G = tallies.shape[0]
    pw = batch.pwm_q
    Lmax = pw.shape[1]
    ar = np.arange(Lmax, dtype=np.int64)
    lens = batch.lens.astype(np.int64)
    from gnumap_tpu.native import lib as native_lib
    if native_lib.available():
        native_lib.scatter_tallies(
            tallies, pw, batch.lens,
            np.fromiter((r[0] for r in rows), np.int32, len(rows)),
            np.fromiter((r[1] for r in rows), np.int8, len(rows)),
            np.fromiter((r[2] for r in rows), np.int64, len(rows)),
            np.fromiter((r[3] for r in rows), np.float64, len(rows)),
            [r[4] or "" for r in rows], PWM_SCALE)
        return
    if all(r[4] is None for r in rows):
        b_idx = np.fromiter((r[0] for r in rows), np.int64, len(rows))
        minus = np.fromiter((r[1] for r in rows), bool, len(rows))
        pos = np.fromiter((r[2] for r in rows), np.int64, len(rows))
        w = np.fromiter((r[3] for r in rows), np.float64, len(rows))
        ln = lens[b_idx]
        sel = pw[b_idx]                                      # (H, Lmax, 4)
        # minus hits use the reverse-complemented PWM of rows [0, len);
        # computed on the int32 view for only the minus subset (the
        # float64 intermediates dominated this path's cost)
        mrows = np.nonzero(minus)[0]
        if len(mrows):
            src = np.clip(ln[mrows, None] - 1 - ar[None, :], 0, Lmax - 1)
            sel[mrows] = np.take_along_axis(
                sel[mrows], src[:, :, None], axis=1)[:, :, ::-1]
        # value = w * (p / PWM_SCALE), masked positions contribute exactly
        # +0.0 — same floats as the per-hit loop, fewer full-array passes
        vals = sel.astype(np.float64)
        np.divide(vals, PWM_SCALE, out=vals)
        np.multiply(vals, w[:, None, None], out=vals)
        idx = pos[:, None] + ar[None, :]
        ok = (ar[None, :] < ln[:, None]) & (idx >= 0) & (idx < G)
        np.multiply(vals, ok[:, :, None], out=vals)
        np.add.at(tallies, np.where(ok, idx, 0).ravel(),
                  vals.reshape(-1, 4))
        return
    # mixed batch (rare: gapped CIGARs present): per-hit chunks, still one
    # ordered scatter
    idx_chunks: List[np.ndarray] = []
    val_chunks: List[np.ndarray] = []
    for b, minus, pos, w, cigar in rows:
        L = int(lens[b])
        p_np = pw[b, :L]
        p_s = (pwm_mod.pwm_revcomp(p_np) if minus else p_np)
        if cigar is None:
            cigar = f"{L}M"
        gp, i = pos, 0
        for num, op in oracle._iter_cigar(cigar):
            if op == "M":
                gi = np.arange(gp, gp + num, dtype=np.int64)
                ok = (gi >= 0) & (gi < G)
                v = w * (p_s[i:i + num].astype(np.float64) / PWM_SCALE)
                idx_chunks.append(np.where(ok, gi, 0))
                val_chunks.append(np.where(ok[:, None], v, 0.0))
                gp += num
                i += num
            elif op == "D":
                gp += num
            elif op == "I":
                i += num
    if idx_chunks:
        np.add.at(tallies, np.concatenate(idx_chunks),
                  np.concatenate(val_chunks))


def _traceback(emis_np, window, cfg):
    """Native C++ traceback when available (12x NumPy), bit-identical to
    oracle.nw_align (property-tested in tests/test_native.py)."""
    from gnumap_tpu.native import lib as native_lib
    if native_lib.available():
        return native_lib.nw_traceback(
            emis_np, window, cfg.gap_open_q(), cfg.gap_extend_q(), NEG_INF,
            band=cfg.band())
    return oracle.nw_align(emis_np, window, cfg, traceback=True)


def finish_read(genome: Genome, cfg: MapperConfig, strand_rows
                ) -> List[ReadHit]:
    """Threshold + traceback + dedupe + posterior for one read.

    strand_rows: {strand: (cands, valid, scores, max_sc, emis_np)}
    Frozen semantics identical to oracle.map_read.
    """
    retained: List[Tuple[str, int, int]] = []
    for strand, (cands, valid, scs, max_sc, _) in strand_rows.items():
        thr = cfg.threshold_for(int(max_sc))
        keep = valid & (scs >= thr) & (scs > 0)
        for c in np.nonzero(keep)[0]:
            retained.append((strand, int(cands[c]), int(scs[c])))
    if not retained:
        return []
    W = cfg.window_width()
    best: Dict[Tuple[str, int], ReadHit] = {}
    for strand, cand, score in retained:
        emis_np = strand_rows[strand][4]
        win_start = cfg.window_start(cand)
        window = _window_np(genome.codes, win_start, W)
        sc2, pos_in_w, cigar, ref_len = _traceback(emis_np, window, cfg)
        pos = win_start + pos_in_w
        key = (strand, pos)
        if key not in best or sc2 > best[key].score:
            best[key] = ReadHit(strand, pos, sc2, 0.0, cigar, ref_len)
    hits = list(best.values())
    total = float(sum(h.score for h in hits))
    for h in hits:
        h.weight = h.score / total
    hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
    return hits


_CK_POOL = None


def _ck_pool():
    """Single background writer for async stream checkpoints."""
    global _CK_POOL
    if _CK_POOL is None:
        import concurrent.futures
        _CK_POOL = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="gnumap-ckpt")
    return _CK_POOL


_FINISH_POOL = None


def _finish_pool():
    global _FINISH_POOL
    if _FINISH_POOL is None:
        import concurrent.futures
        n = min(4, max(1, (os.cpu_count() or 2)))
        _FINISH_POOL = concurrent.futures.ThreadPoolExecutor(n)
    return _FINISH_POOL


def host_finish(genome: Genome, S_plus_np, S_minus_np, cfg: MapperConfig,
                batch: ReadBatch, cands, valid, scores, max_sc
                ) -> List[List[ReadHit]]:
    """Per-read host finishing over canonical-layout device outputs
    (row b = '+' strand of read b, row b + B = '-' strand).

    Vectorized retention pre-pass (NumPy) selects the reads that need a
    traceback; those are finished on a thread pool (the native C++
    traceback releases the GIL) — the reference's worker-pthread analog
    for the host-side tail of the pipeline.
    """
    B = batch.codes.shape[0]
    n = batch.n
    # vectorized retention over the whole batch (exact integer rational,
    # same as MapperConfig.threshold_for)
    from gnumap_tpu.config import RATIO_BITS
    thr = (cfg.ratio_q() * max_sc.astype(np.int64)
           + (1 << RATIO_BITS) - 1) >> RATIO_BITS
    keep = valid & (scores >= thr[:, None]) & (scores > 0)
    any_keep = keep.any(axis=1)
    need = np.nonzero(any_keep[:B][:n] | any_keep[B:B + n])[0]

    out: List[List[ReadHit]] = [[] for _ in range(n)]

    from gnumap_tpu.native import lib as native_lib
    if len(need) > 16 and native_lib.available():
        rows_k, cols_k = np.nonzero(keep)
        sel = (rows_k % B) < n
        rows_k, cols_k = rows_k[sel], cols_k[sel]
        read_idx = (rows_k % B).astype(np.int32)
        strand = (rows_k >= B).astype(np.int8)
        cand_arr = cands[rows_k, cols_k].astype(np.int32)
        sc_arr = scores[rows_k, cols_k]
        scores2, pos_arr, rl_arr, cigars = native_lib.finish_hits(
            batch.pwm_q, batch.lens, genome.codes, S_plus_np, S_minus_np,
            read_idx, strand, cand_arr, cfg.max_read_len,
            cfg.window_width(), cfg.gap_slack, cfg.gap_open_q(),
            cfg.gap_extend_q(), NEG_INF, band=cfg.band())
        # group per read, dedupe by (strand, pos), normalize weights
        per_read: Dict[int, Dict[Tuple[str, int], ReadHit]] = {}
        for h in range(len(read_idx)):
            b = int(read_idx[h])
            st = "-" if strand[h] else "+"
            key = (st, int(pos_arr[h]))
            d = per_read.setdefault(b, {})
            sc2 = int(scores2[h])
            if key not in d or sc2 > d[key].score:
                d[key] = ReadHit(st, int(pos_arr[h]), sc2, 0.0,
                                 cigars[h], int(rl_arr[h]))
        for b, d in per_read.items():
            hits = list(d.values())
            total = float(sum(hh.score for hh in hits))
            for hh in hits:
                hh.weight = hh.score / total
            hits.sort(key=lambda hh: (hh.pos,
                                      0 if hh.strand == "+" else 1))
            out[b] = hits
        return out

    def work(b: int):
        L = int(batch.lens[b])
        p_np = batch.pwm_q[b, :L]
        rows = {}
        for si, strand in ((0, "+"), (1, "-")):
            r = b + si * B
            rows[strand] = (cands[r], valid[r], scores[r], max_sc[r],
                            scoring.emission_int(
                                p_np if strand == "+" else
                                pwm_mod.pwm_revcomp(p_np),
                                S_plus_np if strand == "+" else S_minus_np))
        return b, finish_read(genome, cfg, rows)

    if len(need) > 64:
        for b, hits in _finish_pool().map(work, need.tolist()):
            out[b] = hits
    else:
        for b in need.tolist():
            out[b] = work(b)[1]
    return out


def _update_stats(stats: BatchStats, cfg: MapperConfig, batch: ReadBatch,
                  out, valid, device_s: float, host_s: float) -> None:
    stats.n_reads += batch.n
    stats.n_mapped += sum(1 for h in out if h)
    stats.n_multi += sum(1 for h in out if len(h) > 1)
    stats.n_candidates += int(valid.sum())
    rect, band = _cells_per_cand(cfg)
    stats.dp_cells += int(valid.sum()) * cfg.max_read_len * rect
    stats.dp_cells_banded += int(valid.sum()) * cfg.max_read_len * band
    stats.device_s += device_s
    stats.host_s += host_s
