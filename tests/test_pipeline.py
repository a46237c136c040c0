"""Integration: jnp pipeline vs frozen oracle, end to end (SURVEY.md §4.3).

The phiX-style config-1 workload: simulated reads carry their true origin in
the read name, so accuracy is self-checking; every retained hit must match
the oracle bit for bit (strand, pos, score, cigar) and in float64 weight.
"""

import numpy as np
import pytest

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.oracle import oracle
from gnumap_tpu.pipeline import mapper as pl
from gnumap_tpu.utils import sim

from conftest import records_from_sim


@pytest.fixture(scope="module")
def setup(small_cfg, phix_genome):
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    idx = builder.build_index(gen, small_cfg)
    ogen = oracle.OracleGenome.from_contigs([("phiX_sim", phix_genome)])
    oidx = oracle.build_oracle_index(ogen, small_cfg)
    m = pl.TpuMapper(gen, idx, small_cfg)
    return gen, idx, ogen, oidx, m


def test_csr_index_matches_dict(setup, small_cfg):
    gen, idx, ogen, oidx, _ = setup
    for km, lst in list(oidx.items())[::37]:
        assert list(idx.lookup(km)) == lst
    total = sum(len(v) for v in oidx.values())
    assert len(idx.positions) == total


def test_pipeline_matches_oracle(setup, small_cfg, phix_reads):
    gen, idx, ogen, oidx, m = setup
    recs = records_from_sim(phix_reads, small_cfg)
    stats = pl.BatchStats()
    n_checked = 0
    for batch in io_fastq.batch_reads(iter(recs), small_cfg):
        for b, phits in enumerate(m.map_batch(batch, stats)):
            L = int(batch.lens[b])
            ohits = oracle.map_read(batch.codes[b, :L], batch.pwm_q[b, :L],
                                    ogen, oidx, small_cfg)
            assert len(ohits) == len(phits), batch.names[b]
            for oh, ph in zip(ohits, phits):
                assert (oh.strand, oh.pos, oh.score, oh.cigar) == \
                    (ph.strand, ph.pos, ph.score, ph.cigar), batch.names[b]
                assert abs(oh.weight - ph.weight) < 1e-12
            n_checked += 1
    assert n_checked == len(phix_reads)
    assert stats.n_mapped > 0.9 * stats.n_reads


def test_pipeline_accuracy_self_check(setup, small_cfg, phix_reads):
    _, _, _, _, m = setup
    recs = records_from_sim(phix_reads, small_cfg)
    correct = total = 0
    for batch in io_fastq.batch_reads(iter(recs), small_cfg):
        for b, hits in enumerate(m.map_batch(batch)):
            if not hits:
                continue
            total += 1
            _, tpos, tstrand = sim.parse_truth(batch.names[b])
            best = max(hits, key=lambda h: h.weight)
            if best.strand == tstrand and abs(best.pos - tpos) <= 2:
                correct += 1
    assert total > 0
    assert correct / total > 0.95


def test_multimap_weights_sum_to_one(small_cfg):
    """Exact-repeat genome: every mapped read's weights sum to 1 and repeat
    reads split across loci (BASELINE.json config 3 semantics)."""
    base = sim.random_genome(1200, seed=11)
    rep = base[:300] + base[100:200] + base[300:600] + base[100:200]
    gen = builder.Genome.from_contigs([("rep", rep)])
    idx = builder.build_index(gen, small_cfg)
    m = pl.TpuMapper(gen, idx, small_cfg)
    reads = sim.simulate_reads(rep, 40, 36, seed=12, sub_rate=0.0,
                               contig="rep")
    recs = records_from_sim(reads, small_cfg)
    saw_multi = False
    for batch in io_fastq.batch_reads(iter(recs), small_cfg):
        for hits in m.map_batch(batch):
            if not hits:
                continue
            assert abs(sum(h.weight for h in hits) - 1.0) < 1e-9
            if len(hits) > 1:
                saw_multi = True
                ws = [h.weight for h in hits]
                assert max(ws) - min(ws) < 0.5  # near-equal split on repeats
    assert saw_multi


def test_map_stream_outputs(setup, small_cfg, phix_reads, tmp_path):
    gen, idx, ogen, oidx, m = setup
    recs = records_from_sim(phix_reads, small_cfg)
    res = pl.map_stream(m, io_fastq.batch_reads(iter(recs), small_cfg))
    # coverage mass == sum of weights * ref_len per mapped read
    assert res.coverage.sum() > 0
    # native batch formatting emits one chunk per batch; count records
    assert sum(ln.count("\n") for ln in res.sam_lines) >= res.stats.n_reads
    # SGR emission round-trip
    from gnumap_tpu.io import sgr
    with open(tmp_path / "out.sgr", "w") as f:
        sgr.write_sgr(f, gen, res.coverage)
    lines = open(tmp_path / "out.sgr").read().splitlines()
    assert lines and all(l.split("\t")[0] == "phiX_sim" for l in lines)
    tot = sum(float(l.split("\t")[2]) for l in lines)
    assert abs(tot - res.coverage.sum()) < 1.0  # rounding at 4 decimals


def test_element_gather_fallback_matches_rowgather(monkeypatch):
    """The huge-genome element-gather path of csr_hits must produce
    identical results to the row-gather path."""
    import numpy as np
    from gnumap_tpu.pipeline import mapper as pl

    from conftest import records_from_sim
    from gnumap_tpu.config import MapperConfig
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.utils import sim
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=64,
                       max_read_len=40, align_score_ratio=0.8)
    genome = sim.random_genome(20_000, seed=13, repeat_frac=0.05)
    gen = builder.Genome.from_contigs([("t", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 64, 36, seed=14, sub_rate=0.02,
                               indel_rate=0.1, contig="t")
    recs = records_from_sim(reads, cfg)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device")
    ref = m.map_batch(batches[0])
    monkeypatch.setattr(pl, "ROWGATHER_MAX", 0)
    m2 = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                      finish_impl="device")
    got = m2.map_batch(batches[0])
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert [(h.strand, h.pos, h.score, h.cigar, h.weight)
                for h in a] ==                [(h.strand, h.pos, h.score, h.cigar, h.weight) for h in b]
