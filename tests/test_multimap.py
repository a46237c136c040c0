"""Multi-map stress correctness: repeat-family
workloads where reads retain many co-best loci — the defining GNUMAP
feature (SURVEY.md §0.5, fractional posterior across repeat loci).

Checks: weights sum to 1 across retained loci, the truth locus is among
the co-best hits, hit_capacity>1 blob decoding equals the host path, and
an oracle subsample agrees hit-for-hit.
"""

import numpy as np

from conftest import records_from_sim
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import packing, pwm as pwm_mod
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.oracle import oracle
from gnumap_tpu.pipeline import mapper as pl
from gnumap_tpu.utils import sim


def _family_workload(hit_capacity=4, n_reads=96):
    cfg = MapperConfig(mer_size=9, seed_jump=4, batch_size=64,
                       max_read_len=40, max_hits_per_seed=16,
                       max_candidates=32, sam_out=False, sgr_out=True,
                       hit_capacity=hit_capacity)
    genome, spots = sim.random_genome_families(
        60_000, seed=13, n_families=6, copies=8, unit_len=120)
    gen = builder.Genome.from_contigs([("t", genome)])
    idx = builder.build_index(gen, cfg)
    starts = (np.concatenate(spots)[:, None]
              + np.arange(0, 120 - 36, 12)[None, :]).ravel()
    reads = (sim.simulate_reads(genome, n_reads // 2, 36, seed=14,
                                sub_rate=0.0, contig="t")
             + sim.simulate_reads(genome, n_reads - n_reads // 2, 36,
                                  seed=15, sub_rate=0.0, contig="t",
                                  positions=starts))
    return cfg, gen, idx, reads


def test_multimap_weights_and_truth():
    cfg, gen, idx, reads = _family_workload()
    recs = records_from_sim(reads, cfg)
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device")
    stats = pl.BatchStats()
    n_multi_deep = n_checked = 0
    for b in io_fastq.batch_reads(iter(recs), cfg):
        for i, hits in enumerate(m.map_batch(b, stats)):
            if not hits:
                continue
            n_checked += 1
            total_w = sum(h.weight for h in hits)
            assert abs(total_w - 1.0) < 1e-9
            if len(hits) >= 4:
                n_multi_deep += 1
            # truth among the co-best weighted hits
            tc, tp, ts = sim.parse_truth(b.names[i])
            best_w = max(h.weight for h in hits)
            assert any(h.weight == best_w and abs(h.pos - tp) <= 3
                       and h.strand == ts for h in hits), \
                (b.names[i], [(h.pos, h.strand, h.weight) for h in hits])
    assert n_checked >= 90
    # the planted half actually multi-maps at depth
    assert n_multi_deep >= 30, n_multi_deep
    assert stats.n_multi >= 40


def test_hit_capacity_matches_host_path():
    """hit_capacity=4 device blob decode == exact host full-fetch path."""
    cfg, gen, idx, reads = _family_workload(hit_capacity=4)
    recs = records_from_sim(reads, cfg)
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                         finish_impl="device")
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                          finish_impl="host")
    key = lambda hh: [(h.strand, h.pos, h.score, h.cigar, h.weight)
                      for h in hh]
    for b in io_fastq.batch_reads(iter(recs), cfg):
        hd = m_dev.map_batch(b)
        hh = m_host.map_batch(b)
        assert list(map(key, hd)) == list(map(key, hh))


def test_capacity_overflow_falls_back_exact():
    """hit_capacity=1 with ~8 retained loci/read overflows the blob; the
    device-finish path must fall back to the host path bit-exactly."""
    cfg, gen, idx, reads = _family_workload(hit_capacity=1, n_reads=64)
    # all reads planted in repeats -> ~8 hits/read >> H/B = 2
    genome, spots = sim.random_genome_families(
        60_000, seed=13, n_families=6, copies=8, unit_len=120)
    starts = np.concatenate(spots)
    reads = sim.simulate_reads(genome, 64, 36, seed=16, sub_rate=0.0,
                               contig="t", positions=starts)
    recs = records_from_sim(reads, cfg)
    m_dev = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                         finish_impl="device")
    m_host = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                          finish_impl="host")
    key = lambda hh: [(h.strand, h.pos, h.score, h.cigar, h.weight)
                      for h in hh]
    b = next(io_fastq.batch_reads(iter(recs), cfg))
    hd = m_dev.map_batch(b)
    hh = m_host.map_batch(b)
    assert sum(len(x) for x in hh) > 2 * 64   # overflow really triggered
    assert list(map(key, hd)) == list(map(key, hh))


def test_multimap_oracle_subsample():
    """Repeat-family hits agree with the frozen oracle hit-for-hit."""
    cfg, gen, idx, reads = _family_workload()
    recs = records_from_sim(reads[:72], cfg)
    ogen = oracle.OracleGenome(gen.codes, gen.names, gen.starts,
                               gen.lengths)
    oidx = oracle.build_oracle_index(ogen, cfg)
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device")
    b = next(io_fastq.batch_reads(iter(recs), cfg))
    got = m.map_batch(b)
    for i in range(0, b.n, 7):            # every 7th read vs the oracle
        codes = b.codes[i, :b.lens[i]]
        pw = b.pwm_q[i, :b.lens[i]]
        exp = oracle.map_read(codes, pw, ogen, oidx, cfg)
        assert [(h.strand, h.pos, h.score, h.cigar) for h in got[i]] == \
               [(h.strand, h.pos, h.score, h.cigar) for h in exp], i


def test_repeat_coverage_fractional():
    """Coverage inside a repeat family's copies sums to the planted read
    mass (weights fractionally spread, not dropped or double-counted)."""
    cfg, gen, idx, _ = _family_workload()
    genome, spots = sim.random_genome_families(
        60_000, seed=13, n_families=6, copies=8, unit_len=120)
    fam = 0
    starts = spots[fam][:1]               # one specific copy
    reads = sim.simulate_reads(genome, 16, 36, seed=17, sub_rate=0.0,
                               contig="t", positions=starts + 30)
    recs = records_from_sim(reads, cfg)
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device")
    res = pl.map_stream(m, io_fastq.batch_reads(iter(recs), cfg),
                        collect_sam=False)
    # every read contributes total weight 1 x 36 bases of coverage mass
    assert abs(res.coverage.sum() - 16 * 36) < 1e-6
    # the copy the reads came from holds only ~1/n_surviving_copies of it
    own = res.coverage[spots[fam][0]:spots[fam][0] + 120].sum()
    assert own < 16 * 36 * 0.5
