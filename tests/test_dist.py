"""Distributed paths on the faked 8-device CPU mesh (SURVEY.md §4.4).

The sharded mapper must equal the single-device mapper EXACTLY — same
candidates, scores, hits — for every mesh shape, including sharded-index
mode (config 5 semantics).
"""

import numpy as np
import pytest

import jax

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.dist import collectives, mesh as mesh_mod
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as pl
from gnumap_tpu.utils import sim

from conftest import records_from_sim

@pytest.fixture(autouse=True)
def _eight_devices():
    # decided per test, not at import: every xdist worker must collect
    # the same tests
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 faked devices")


@pytest.fixture(scope="module")
def workload():
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, align_score_ratio=0.8,
                       max_candidates=32)
    genome = sim.random_genome(sim.PHIX_LEN, seed=0, repeat_frac=0.05,
                               repeat_unit=80)
    gen = builder.Genome.from_contigs([("phiX_sim", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=7, sub_rate=0.03,
                               contig="phiX_sim")
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg)), cfg))
    single = pl.TpuMapper(gen, idx, cfg)
    ref_hits = single.map_batch(batch)
    return cfg, gen, idx, batch, ref_hits


@pytest.mark.parametrize("R,S", [(8, 1), (4, 2), (2, 4)])
def test_dist_matches_single_device(workload, R, S):
    cfg, gen, idx, batch, ref_hits = workload
    mesh = mesh_mod.make_mesh(R, S)
    dm = collectives.DistMapper(gen, idx, cfg, mesh)
    hits = dm.map_batch(batch)
    assert len(hits) == len(ref_hits)
    for got, ref in zip(hits, ref_hits):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g.strand, g.pos, g.score, g.cigar) == \
                (r.strand, r.pos, r.score, r.cigar)
            assert abs(g.weight - r.weight) < 1e-12


@pytest.mark.parametrize("R,S", [(8, 1), (4, 2)])
def test_dist_device_finish_matches_single(R, S):
    """Device-finish on the sharded path (per-shard retention + traceback
    blob, decoded shard-by-shard) must equal the single-device mapper —
    indel reads exercise the compacted-ops decode."""
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, align_score_ratio=0.7,
                       max_candidates=32)
    genome = sim.random_genome(30_000, seed=5)
    gen = builder.Genome.from_contigs([("dd", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=11, sub_rate=0.02,
                               indel_rate=0.3, contig="dd")
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg)), cfg))
    ref_hits = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                            finish_impl="device").map_batch(batch)
    assert any("D" in h.cigar or "I" in h.cigar
               for hl in ref_hits for h in hl)
    mesh = mesh_mod.make_mesh(R, S)
    dm = collectives.DistMapper(gen, idx, cfg, mesh, align_impl="pallas",
                                interpret=True, finish_impl="device")
    stats = pl.BatchStats()
    hits = dm.map_batch(batch, stats)
    assert stats.n_mapped == sum(1 for h in ref_hits if h)
    for got, ref in zip(hits, ref_hits):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g.strand, g.pos, g.score, g.cigar, g.ref_len) == \
                (r.strand, r.pos, r.score, r.cigar, r.ref_len)
            assert abs(g.weight - r.weight) < 1e-12


@pytest.mark.parametrize("R,S", [(4, 2), (2, 4)])
def test_dist_bisulfite_matches_single_device(R, S):
    """Sharded bisulfite: both collapsed base-3 tables shard by k-mer
    range (odd 3^m bucket counts exercise the ceil-partition routing)."""
    cfg = MapperConfig(mer_size=9, seed_jump=3, batch_size=32,
                       max_read_len=40, align_score_ratio=0.7,
                       max_candidates=64, bisulfite=True)
    genome = sim.random_genome(20_000, seed=3)
    gen = builder.Genome.from_contigs([("bsd", genome)])
    idx = builder.build_bs_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=9, sub_rate=0.01,
                               contig="bsd", bisulfite=True)
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg)), cfg))
    ref_hits = pl.TpuMapper(gen, idx, cfg).map_batch(batch)
    assert sum(1 for h in ref_hits if h) >= 28  # converted reads do map
    mesh = mesh_mod.make_mesh(R, S)
    dm = collectives.DistMapper(gen, idx, cfg, mesh)
    hits = dm.map_batch(batch)
    for got, ref in zip(hits, ref_hits):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g.strand, g.pos, g.score, g.cigar) == \
                (r.strand, r.pos, r.score, r.cigar)
            assert abs(g.weight - r.weight) < 1e-12


def test_allreduce_coverage():
    mesh = mesh_mod.make_mesh(4, 2)
    rng = np.random.default_rng(0)
    stack = rng.random((8, 1000))
    out = collectives.allreduce_coverage(stack, mesh)
    np.testing.assert_allclose(out, stack.sum(axis=0), rtol=1e-6)


def test_mesh_shapes():
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(7, 3)
    m = mesh_mod.make_mesh(None, 2)
    assert m.shape[mesh_mod.READS_AXIS] == 4
    assert m.shape[mesh_mod.INDEX_AXIS] == 2
