"""[FROZEN v5] device accumulation vs the exact host path.

The device path (pipeline.mapper.device_accumulate) accumulates coverage /
SNP tallies in f32 on device, summing each accumulator row's contributions
in a fixed order before one unique-index scatter-add; the host path keeps
the frozen hit-ordered float64 contract.  Contract here:
same mapped/multi counts, coverage/tallies equal to f32 tolerance,
run-to-run determinism bit-exact, and SAM records byte-identical.
"""

import jax
import numpy as np

from conftest import records_from_sim
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as pl
from gnumap_tpu.utils import sim


def _workload(snp, lazy_pwm=False, n=96, sam=False):
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=64,
                       max_read_len=40, align_score_ratio=0.8,
                       sam_out=sam, sgr_out=True, snp_mode=snp)
    genome = sim.random_genome(20_000, seed=3, repeat_frac=0.05,
                               repeat_unit=60)
    gen = builder.Genome.from_contigs([("t", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, n, 36, seed=4, sub_rate=0.02,
                               indel_rate=0.15, contig="t")
    recs = records_from_sim(reads, cfg)
    if lazy_pwm:
        recs = [io_fastq.ReadRecord(r.name, r.codes, None, r.quals)
                for r in recs]
    return cfg, gen, idx, recs


def _run(cfg, gen, idx, recs, accumulate):
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device", accumulate=accumulate)
    res = pl.map_stream(m, io_fastq.batch_reads(iter(recs), cfg),
                        collect_sam=cfg.sam_out)
    return res


def test_scatter_add_rows_matches_host_f64():
    """_add_rows against a NumPy float64 scatter: overlapping per-hit row
    windows, a 50-hit pile-up on the same rows, invalid hits; the f32
    result is bit-identical from call to call."""
    rng = np.random.default_rng(5)
    R, H, nr = 64, 200, 3
    arr = rng.random((R, 128)).astype(np.float32)
    first = rng.integers(0, R - nr + 1, H).astype(np.int32)
    first[:50] = 10
    valid = rng.random(H) < 0.8
    delta = rng.random((H, nr, 128)).astype(np.float32)
    want = arr.astype(np.float64)
    for h in np.nonzero(valid)[0]:
        want[first[h]:first[h] + nr] += delta[h]
    f = jax.jit(pl._add_rows)
    got = np.asarray(f(arr, first, valid, delta))
    assert np.array_equal(got, np.asarray(f(arr, first, valid, delta)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_device_accum_matches_host_coverage():
    cfg, gen, idx, recs = _workload(snp=False)
    rh = _run(cfg, gen, idx, recs, "host")
    rd = _run(cfg, gen, idx, recs, "device")
    assert rd.stats.n_mapped == rh.stats.n_mapped
    assert rd.stats.n_multi == rh.stats.n_multi
    assert rd.stats.n_candidates == rh.stats.n_candidates
    np.testing.assert_allclose(rd.coverage, rh.coverage,
                               rtol=1e-5, atol=1e-5)


def test_device_accum_matches_host_snp_tallies():
    cfg, gen, idx, recs = _workload(snp=True, lazy_pwm=True)
    rh = _run(cfg, gen, idx, recs, "host")
    rd = _run(cfg, gen, idx, recs, "device")
    assert rd.stats.n_mapped == rh.stats.n_mapped
    np.testing.assert_allclose(rd.coverage, rh.coverage,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.tallies, rh.tallies,
                               rtol=1e-5, atol=1e-5)
    # every aligned base deposits PWM mass: total tally mass tracks the
    # per-base mass of coverage (ins/del hits shift it slightly)
    assert rd.tallies.sum() > 0.9 * rh.tallies.sum() > 0


def test_device_accum_deterministic():
    cfg, gen, idx, recs = _workload(snp=True)
    r1 = _run(cfg, gen, idx, recs, "device")
    r2 = _run(cfg, gen, idx, recs, "device")
    assert np.array_equal(r1.coverage, r2.coverage)
    assert np.array_equal(r1.tallies, r2.tallies)


def test_device_accum_checkpoint_resume(tmp_path):
    """Interrupt a device-accumulation stream mid-way, resume from the
    checkpoint (accumulators fetch f32->f64 at save, reload f64->f32):
    final coverage/tallies must equal the uninterrupted run exactly
    (resumed batches replay the identical kernel adds on the reloaded
    state)."""
    import itertools
    cfg, gen, idx, recs = _workload(snp=True)
    ck = str(tmp_path / "acc.ck.npz")

    # uninterrupted reference
    r_ref = _run(cfg, gen, idx, recs, "device")

    # interrupted: checkpoint every batch, stop after 1 of 2 batches
    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device", accumulate="device")
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    assert len(batches) >= 2
    pl.map_stream(m, iter(batches[:1]), collect_sam=False,
                  checkpoint_path=ck, checkpoint_every=1)
    # fresh mapper resumes from the checkpoint and finishes the stream
    m2 = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                      finish_impl="device", accumulate="device")
    r2 = pl.map_stream(m2, iter(batches), collect_sam=False,
                       checkpoint_path=ck, checkpoint_every=1)
    assert np.array_equal(r2.coverage, r_ref.coverage)
    assert np.array_equal(r2.tallies, r_ref.tallies)


def test_device_accum_checkpoint_resume_inflight(tmp_path):
    """[FROZEN v5.1] the r4 advisor's high-severity scenario: a checkpoint
    taken while LATER batches are already submitted (map_stream keeps
    depth=3 in flight) must reflect exactly ``batches_done`` batches —
    accumulation is applied at finish(), never at submit() — so a resume
    replays the in-flight batches without double counting."""
    cfg, gen, idx, recs = _workload(snp=True, n=320)
    ck = str(tmp_path / "acc2.ck.npz")
    r_ref = _run(cfg, gen, idx, recs, "device")

    class Boom(Exception):
        pass

    def cb(idx_b, s):
        if idx_b >= 2:          # interrupt with ~3 batches still in flight
            raise Boom()

    m = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                     finish_impl="device", accumulate="device")
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    assert len(batches) >= 5
    try:
        pl.map_stream(m, iter(batches), collect_sam=False,
                      checkpoint_path=ck, checkpoint_every=1,
                      batch_callback=cb)
        raise AssertionError("fault injection did not fire")
    except Boom:
        pass
    m2 = pl.TpuMapper(gen, idx, cfg, align_impl="pallas", interpret=True,
                      finish_impl="device", accumulate="device")
    r2 = pl.map_stream(m2, iter(batches), collect_sam=False,
                       checkpoint_path=ck, checkpoint_every=1)
    assert np.array_equal(r2.coverage, r_ref.coverage)
    assert np.array_equal(r2.tallies, r_ref.tallies)


def _overflow_workload(indels=False):
    """Workloads that overflow the device-finish capacities: a repeat
    family giving ~8 retained loci/read (n_keep > H = 2B) or an
    indel-heavy read set (n_indel > K = max(64, H//32))."""
    n = 128 if indels else 96
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=128,
                       max_read_len=40, align_score_ratio=0.8,
                       max_hits_per_seed=16, sam_out=False, sgr_out=True,
                       snp_mode=True)
    if indels:
        genome = sim.random_genome(20_000, seed=3)
        gen = builder.Genome.from_contigs([("t", genome)])
        reads = sim.simulate_reads(genome, n, 36, seed=4, sub_rate=0.0,
                                   indel_rate=1.0, contig="t")
    else:
        genome, spots = sim.random_genome_families(
            30_000, seed=3, n_families=1, copies=8, unit_len=200)
        gen = builder.Genome.from_contigs([("t", genome)])
        starts = (np.concatenate(spots)[:, None]
                  + np.arange(0, 160, 8)[None, :]).ravel()
        reads = sim.simulate_reads(genome, n, 36, seed=4, sub_rate=0.0,
                                   contig="t", positions=starts)
    idx = builder.build_index(gen, cfg)
    return cfg, gen, idx, records_from_sim(reads, cfg)


def test_device_accum_hit_overflow_falls_back(caplog):
    """n_keep > H: no mid-stream raise (the r4 footgun) — the batch is
    detected BEFORE any delta is applied and re-mapped on the exact host
    path; results match the host-accumulation run."""
    import logging
    cfg, gen, idx, recs = _overflow_workload(indels=False)
    rh = _run(cfg, gen, idx, recs, "host")
    with caplog.at_level(logging.WARNING, "gnumap_tpu.pipeline.mapper"):
        rd = _run(cfg, gen, idx, recs, "device")
    assert any("capacity overflow" in r.message for r in caplog.records)
    assert rd.stats.n_mapped == rh.stats.n_mapped
    assert rd.stats.n_multi == rh.stats.n_multi
    np.testing.assert_allclose(rd.coverage, rh.coverage,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.tallies, rh.tallies,
                               rtol=1e-5, atol=1e-5)


def test_device_accum_indel_overflow_falls_back(caplog):
    """n_indel > K: the r4 advisor's silent-corruption case — gapped hits
    beyond the compacted-ops capacity now trigger the same pre-apply
    detection + exact host fallback instead of keeping the wrong
    pure-match tally columns."""
    import logging
    cfg, gen, idx, recs = _overflow_workload(indels=True)
    rh = _run(cfg, gen, idx, recs, "host")
    with caplog.at_level(logging.WARNING, "gnumap_tpu.pipeline.mapper"):
        rd = _run(cfg, gen, idx, recs, "device")
    assert any("capacity overflow" in r.message for r in caplog.records)
    assert rd.stats.n_mapped == rh.stats.n_mapped
    np.testing.assert_allclose(rd.coverage, rh.coverage,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rd.tallies, rh.tallies,
                               rtol=1e-5, atol=1e-5)


def test_device_accum_sam_records_identical():
    cfg, gen, idx, recs = _workload(snp=False, sam=True)
    rh = _run(cfg, gen, idx, recs, "host")
    rd = _run(cfg, gen, idx, recs, "device")
    assert rh.sam_lines == rd.sam_lines
    np.testing.assert_allclose(rd.coverage, rh.coverage,
                               rtol=1e-5, atol=1e-5)
