"""Device finish (align/nw_finish.py) vs the frozen oracle.

nw_finish.traceback must reproduce oracle.nw_align(traceback=True) —
(cigar, pos_in_window, ref_len) — exactly, for every hit the mapper would
retain (score > 0; the retention filter guarantees the walk never starts
from a NEG_INF-saturated cell), and nw_finish.pure_detect may only claim
hits whose oracle CIGAR is all-M.  Both are plain jnp/lax, so these tests
run the same code the GPU runs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnumap_tpu.align import band_kernel, nw_finish, scoring
from gnumap_tpu.config import SENTINEL as SENT, MapperConfig
from gnumap_tpu.core import pwm
from gnumap_tpu.oracle import oracle


def _mk_hits(rng, H, L, G, cfg, indel_rate=0.15):
    """Random (emission, candidate) pairs biased toward real alignments:
    half the candidates point at genome locations the read was copied from
    (with substitutions and occasional indels), so tracebacks exercise
    M/I/D transitions rather than garbage alignments."""
    genome = rng.integers(0, 5, G).astype(np.int8)
    emis = np.zeros((H, L, 5), np.int32)
    lens = rng.integers(max(4, L // 2), L + 1, H).astype(np.int32)
    cands = np.full(H, SENT, np.int32)
    S = scoring.normal_matrix(cfg)
    for h in range(H):
        lb = int(lens[h])
        if h % 8 == 7:
            continue  # leave a sentinel slot
        start = int(rng.integers(0, max(1, G - lb)))
        seq = genome[start:start + lb].copy()
        seq[seq == 4] = 0
        # substitutions
        nsub = rng.integers(0, 3)
        for _ in range(nsub):
            p = rng.integers(0, lb)
            seq[p] = rng.integers(0, 4)
        # occasional 1-2bp indel in the read copy
        if rng.random() < indel_rate and lb > 10:
            p = int(rng.integers(2, lb - 4))
            k = int(rng.integers(1, 3))
            if rng.random() < 0.5:
                seq = np.concatenate([seq[:p], seq[p + k:],
                                      rng.integers(0, 4, k).astype(np.int8)])
            else:
                seq = np.concatenate([rng.integers(0, 4, k).astype(np.int8),
                                      seq[:p], seq[p:lb - k]])
            seq = seq[:lb]
        pq = pwm.pwm_from_calls(seq, rng.integers(15, 41, lb))
        emis[h, :lb] = scoring.emission_int(pq, S)
        cands[h] = start
    return genome, emis, cands, lens


def _windows(cfg, genome, cands):
    """int32[H, W] genome windows (N outside the genome; slot 0 at
    SENTINEL slots)."""
    W = cfg.window_width()
    G = len(genome)
    out = np.full((len(cands), W), 4, np.int32)
    for h, c in enumerate(cands):
        ws = int(cfg.window_start(0 if c == SENT else int(c)))
        lo, hi = max(ws, 0), min(ws + W, G)
        if hi > lo:
            out[h, lo - ws:hi - ws] = genome[lo:hi]
    return out


def _check(cfg, H, L, G, seed):
    rng = np.random.default_rng(seed)
    genome, emis, cands, lens = _mk_hits(rng, H, L, G, cfg)
    W = cfg.window_width()
    lens_k = np.where(cands == SENT, 0, lens)
    ops, jfin = nw_finish.traceback(
        jnp.asarray(emis), jnp.asarray(_windows(cfg, genome, cands)),
        jnp.asarray(lens_k), open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), band=cfg.band())
    ops, jfin = np.asarray(ops), np.asarray(jfin)
    n_checked = n_indel = 0
    for h in range(H):
        if cands[h] == SENT:
            assert not ops[h].any() and jfin[h] == 0
            continue
        lb = int(lens[h])
        ws = int(cfg.window_start(int(cands[h])))
        window = np.full(W, 4, np.int8)
        lo, hi = max(ws, 0), min(ws + W, G)
        if hi > lo:
            window[lo - ws:hi - ws] = genome[lo:hi]
        sc, pos_w, cigar, ref_len = oracle.nw_align(
            emis[h, :lb], window, cfg, traceback=True)
        if sc <= 0:
            continue  # the mapper never tracebacks non-retained hits
        got_cigar, got_rl = nw_finish.decode_ops(ops[h], lb)
        assert got_cigar == cigar, (h, got_cigar, cigar)
        assert got_rl == ref_len, (h, got_rl, ref_len)
        assert int(jfin[h]) == pos_w, (h, int(jfin[h]), pos_w)
        n_checked += 1
        if "D" in cigar or "I" in cigar:
            n_indel += 1
    assert n_checked >= H // 2
    assert n_indel >= 1  # the workload must exercise indel tracebacks


def test_devtb_matches_oracle_interpret():
    _check(MapperConfig(max_read_len=16, gap_slack=4), H=64, L=16, G=300,
           seed=5)


def test_devtb_matches_oracle_interpret_longer():
    _check(MapperConfig(max_read_len=24, gap_open=2.0), H=128, L=24, G=900,
           seed=9)


def test_traceback_unbanded_matches_oracle():
    # gap_slack=16 -> band() is None: the traceback runs unbanded
    cfg = MapperConfig(max_read_len=24, gap_slack=16)
    assert cfg.band() is None
    _check(cfg, H=64, L=24, G=900, seed=3)


def test_traceback_real_width_indels_match_oracle():
    """The production widths (L = 104, W = 128, band 42) with 1-2bp
    indels in a third of the reads."""
    _check(MapperConfig(max_read_len=104), H=48, L=104, G=5000, seed=13)


def _check_pure(cfg, genome, emis, cands, lens, min_pure_frac=0.0):
    """Drive nw_finish.pure_detect against the oracle: every hit it
    declares pure must traceback to an all-M CIGAR with the oracle's exact
    pos_in_window (incl. the smallest-column tie-break).  Scores come from
    the banded kernel in the Pallas interpreter."""
    L = cfg.max_read_len
    W = cfg.window_width()
    G = len(genome)
    boff, bw = cfg.band()
    scores = np.asarray(band_kernel.nw_scores_banded(
        jnp.asarray(emis), jnp.asarray(cands[:, None]), jnp.asarray(lens),
        jnp.asarray(genome), W=W, slack=cfg.gap_slack, boff=boff, bw=bw,
        open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
        interpret=True))[:, 0]
    pure, jfin = nw_finish.pure_detect(
        jnp.asarray(emis), jnp.asarray(_windows(cfg, genome, cands)),
        jnp.asarray(np.where(cands == SENT, 0, lens)), jnp.asarray(scores),
        boff=boff, bw=bw, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    pure, jfin = np.asarray(pure), np.asarray(jfin)
    n_checked = n_pure = 0
    for h in range(len(cands)):
        if cands[h] == SENT:
            assert not pure[h]
            continue
        if scores[h] <= 0:
            continue
        lb = int(lens[h])
        ws = int(cfg.window_start(int(cands[h])))
        window = np.full(W, 4, np.int8)
        lo, hi = max(ws, 0), min(ws + W, G)
        if hi > lo:
            window[lo - ws:hi - ws] = genome[lo:hi]
        sc, pos_w, cigar, ref_len = oracle.nw_align(
            emis[h, :lb], window, cfg, traceback=True)
        assert sc == scores[h]
        n_checked += 1
        if pure[h]:
            n_pure += 1
            assert cigar == f"{lb}M", (h, cigar)
            assert int(jfin[h]) == pos_w, (h, int(jfin[h]), pos_w)
    assert n_checked >= len(cands) // 3
    assert n_pure >= min_pure_frac * n_checked
    return n_checked, n_pure


def test_pure_detection_matches_oracle_interpret():
    cfg = MapperConfig(max_read_len=24)
    rng = np.random.default_rng(31)
    genome, emis, cands, lens = _mk_hits(rng, 96, 24, 900, cfg,
                                         indel_rate=0.3)
    # most clean copies must be provably pure (the skip must actually skip)
    _check_pure(cfg, genome, emis, cands, lens, min_pure_frac=0.4)


def test_pure_detection_tandem_tie():
    """Period-4 tandem repeats: a window holds several perfect placements
    of the same read, so the pure path's smallest-lane choice must
    reproduce the oracle's smallest-column end-cell tie-break."""
    from gnumap_tpu.align import scoring
    from gnumap_tpu.core import pwm
    cfg = MapperConfig(max_read_len=24)
    rng = np.random.default_rng(7)
    L = 24
    unit = np.array([0, 1, 2, 3], np.int8)
    genome = np.concatenate([rng.integers(0, 4, 300).astype(np.int8),
                             np.tile(unit, 100),
                             rng.integers(0, 4, 300).astype(np.int8)])
    S = scoring.normal_matrix(cfg)
    H = 32
    emis = np.zeros((H, L, 5), np.int32)
    cands = np.full(H, SENT, np.int32)
    lens = np.full(H, L, np.int32)
    for h in range(H):
        pos = 300 + 4 * int(rng.integers(3, 90))
        seq = genome[pos:pos + L].copy()
        if h % 3 == 0:                      # a substitution now and then
            seq[int(rng.integers(0, L))] = int(rng.integers(0, 4))
        pq = pwm.pwm_from_calls(seq, rng.integers(20, 41, L))
        emis[h] = scoring.emission_int(pq, S)
        # anchor several periods into the repeat so earlier perfect
        # placements exist inside the window
        cands[h] = pos
    n_checked, n_pure = _check_pure(cfg, genome, emis, cands, lens,
                                    min_pure_frac=0.5)
    assert n_pure >= 8        # ties must be exercised, not skipped


def test_device_threshold_exact():
    from gnumap_tpu.pipeline.mapper import device_threshold
    rng = np.random.default_rng(2)
    ms = np.concatenate([
        rng.integers(0, 1 << 28, 500).astype(np.int32),
        np.array([0, 1, 2, (1 << 28) - 1, 1 << 20], np.int32)])
    for ratio in [0.9, 1.0, 0.5, 0.123456789, 0.999999, 1e-9, 0.93]:
        cfg = MapperConfig(align_score_ratio=ratio)
        got = np.asarray(device_threshold(jax.numpy.asarray(ms),
                                          cfg.ratio_q()))
        want = np.array([cfg.threshold_for(int(m)) for m in ms], np.int64)
        assert (got.astype(np.int64) == want).all(), ratio


def _pipeline_workload(seed, n_reads=60, glen=2000, rl=36, sub=0.02,
                       indel=0.01, repeats=False, ratio=0.9):
    from gnumap_tpu.utils import sim
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.core import packing, pwm as pwm_mod
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, max_candidates=16,
                       max_hits_per_seed=16, sam_out=False, sgr_out=False,
                       align_score_ratio=ratio)
    genome = sim.random_genome(glen, seed=seed)
    if repeats:
        genome = genome[:200] * (glen // 200)
    gen = builder.Genome.from_contigs([("g", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, n_reads, rl, seed=seed + 1,
                               sub_rate=sub, indel_rate=indel, contig="g")
    recs = []
    for r in reads:
        codes = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32) - 33
        recs.append(io_fastq.ReadRecord(
            r.name, codes, pwm_mod.pwm_from_calls(codes, q),
            q.astype(np.int16)))
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    return cfg, gen, idx, batches


def _hits_equal(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb)
        for x, y in zip(ha, hb):
            assert (x.strand, x.pos, x.score, x.cigar, x.ref_len) == \
                   (y.strand, y.pos, y.score, y.cigar, y.ref_len)
            assert abs(x.weight - y.weight) < 1e-12


def test_pwm_table_matches_pwm_from_calls():
    from gnumap_tpu.core import pwm as pwm_mod
    t = pwm_mod.pwm_table()
    for c in range(5):
        codes = np.full(pwm_mod.PWM_TABLE_QMAX + 1, c, np.int8)
        want = pwm_mod.pwm_from_calls(codes,
                                      np.arange(pwm_mod.PWM_TABLE_QMAX + 1))
        assert (t[:, c, :] == want).all()
    assert (t.sum(axis=-1) == 4096).all()


def test_lazy_pwm_batch_matches_explicit():
    """A batch with pwm_arr=None (device-built PWM) must map identically to
    the same batch with the host-materialized PWM."""
    from gnumap_tpu.pipeline import mapper as pl
    import dataclasses as dc
    cfg, gen, idx, batches = _pipeline_workload(41, indel=0.05)
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device")
    for b in batches:
        lazy = dc.replace(b, pwm_arr=None)
        explicit = dc.replace(b, pwm_arr=np.array(b.pwm_q))
        _hits_equal(m.map_batch(explicit), m.map_batch(lazy))


@pytest.mark.parametrize("seed,indel", [(21, 0.0), (22, 0.05)])
def test_device_finish_matches_host_finish(seed, indel):
    from gnumap_tpu.pipeline import mapper as pl
    cfg, gen, idx, batches = _pipeline_workload(seed, indel=indel)
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                          finish_impl="host")
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                         finish_impl="device")
    for b in batches:
        _hits_equal(m_host.map_batch(b), m_dev.map_batch(b))


def test_device_finish_with_jnp_scoring():
    """The device finish needs no kernel: with the jnp scan it equals the
    host finish too."""
    from gnumap_tpu.pipeline import mapper as pl
    cfg, gen, idx, batches = _pipeline_workload(23, indel=0.05)
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="jnp",
                          finish_impl="host")
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="jnp",
                         finish_impl="device")
    for b in batches:
        _hits_equal(m_host.map_batch(b), m_dev.map_batch(b))


def test_device_finish_indel_heavy():
    """Every read carries an indel: exercises the compacted-ops fetch and,
    when the traceback count exceeds K = tb_capacity(H), the
    fallback."""
    from gnumap_tpu.pipeline import mapper as pl
    cfg, gen, idx, batches = _pipeline_workload(55, n_reads=60, indel=1.0,
                                                ratio=0.6)
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                          finish_impl="host")
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                         finish_impl="device")
    n_indel_cigars = 0
    for b in batches:
        hh = m_host.map_batch(b)
        _hits_equal(hh, m_dev.map_batch(b))
        n_indel_cigars += sum(1 for hl in hh for h in hl
                              if "I" in h.cigar or "D" in h.cigar)
    assert n_indel_cigars > 20


def test_device_finish_overflow_fallback():
    """A tandem-repeat genome retains more hits than the device capacity
    (H = 2 * batch reads); the fallback path must still be exact."""
    from gnumap_tpu.pipeline import mapper as pl
    cfg, gen, idx, batches = _pipeline_workload(33, n_reads=24, glen=2000,
                                                repeats=True)
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                          finish_impl="host")
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                         finish_impl="device")
    saw_multi = False
    for b in batches:
        hh = m_host.map_batch(b)
        _hits_equal(hh, m_dev.map_batch(b))
        saw_multi = saw_multi or any(len(h) > 4 for h in hh)
    assert saw_multi  # workload must actually stress multi-mapping


def test_decode_ops_runs():
    # 3M 2D 2M 1I 1M  ->  rows: M M M(d=2) M M I M
    ops = np.array([0, 0, (2 << 1), 0, 0, 1, 0], np.int32)
    cigar, rl = nw_finish.decode_ops(ops, 7)
    assert cigar == "3M2D2M1I1M"
    assert rl == (7 - 1) + 2
