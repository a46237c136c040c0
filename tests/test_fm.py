"""FM/BWT index backend vs the CSR index (gnumap_tpu/index/fm.py).

The FM index must return the exact candidate SET the CSR index returns for
every seed (same occurrence counts -> same max-hits skip decisions), so the
whole mapper output is bit-identical under either backend.
"""

import os
import numpy as np
import pytest

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import packing
from gnumap_tpu.index import builder, fm, store
from gnumap_tpu.utils import sim


def test_suffix_array_matches_naive():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, 200).astype(np.int8)
    sa = fm.suffix_array(codes)
    t = list(codes + 1) + [0]
    naive = sorted(range(len(t)), key=lambda i: t[i:])
    assert list(sa) == naive


def test_native_sais_matches_numpy_doubling():
    from gnumap_tpu.native import lib as native_lib
    if not native_lib.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(4)
    for n in [1, 2, 37, 1000, 5000]:
        codes = rng.integers(0, 5, n).astype(np.int8)
        # degenerate repeats stress the LMS naming recursion
        if n >= 1000:
            codes[: n // 2] = np.tile(codes[:25], n // 50)[: n // 2]
        got = native_lib.suffix_array(codes)
        # numpy prefix-doubling reference (the always-available path)
        t = np.concatenate([codes.astype(np.int64) + 1, [0]])
        nn = len(t)
        rank = t.copy()
        k = 1
        while True:
            key2 = np.full(nn, -1, np.int64)
            key2[:nn - k] = rank[k:]
            order = np.lexsort((key2, rank))
            r1, r2 = rank[order], key2[order]
            neq = np.ones(nn, bool)
            neq[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
            nr = np.cumsum(neq) - 1
            rank = np.empty(nn, np.int64)
            rank[order] = nr
            if nr[-1] == nn - 1:
                break
            k *= 2
        assert (got == order.astype(np.int32)).all(), n


def _mk(seed=1, glen=3000, m=6):
    cfg = MapperConfig(mer_size=m, seed_jump=3, batch_size=16,
                       max_read_len=24, max_candidates=16,
                       max_hits_per_seed=8)
    genome = sim.random_genome(glen, seed=seed)
    gen = builder.Genome.from_contigs([("g", genome)])
    return cfg, gen


def test_fm_lookup_matches_csr():
    cfg, gen = _mk()
    csr = builder.build_index(gen, cfg)
    fmi = fm.build_fm_index(gen, cfg)
    kmers, valid = packing.kmer_codes(gen.codes, cfg.mer_size)
    seen = sorted(set(int(k) for k, v in zip(kmers, valid) if v))
    rng = np.random.default_rng(3)
    for k in rng.choice(seen, size=min(200, len(seen)), replace=False):
        got = fmi.lookup(int(k))
        want = np.sort(csr.lookup(int(k)))
        assert (got == want).all(), int(k)
    # absent k-mer
    absent = next(k for k in range(4 ** cfg.mer_size)
                  if k not in set(seen))
    assert len(fmi.lookup(absent)) == 0


def test_fm_hits_device_matches_csr_hits():
    import jax.numpy as jnp
    from gnumap_tpu.pipeline import mapper as pl
    cfg, gen = _mk(seed=5)
    csr = builder.build_index(gen, cfg)
    fmi = fm.build_fm_index(gen, cfg)
    rng = np.random.default_rng(7)
    B2, L = 8, cfg.max_read_len
    codes2 = rng.integers(0, 4, (B2, L)).astype(np.int8)
    codes2[0, 3] = 4  # an N in a seed
    offsets = np.arange(0, L - cfg.mer_size + 1, cfg.seed_jump,
                        dtype=np.int32)
    km, bad = pl.seed_kmers(jnp.asarray(codes2), offsets, cfg.mer_size)
    a = np.asarray(pl.csr_hits(km, bad, jnp.asarray(csr.bucket_start),
                               jnp.asarray(csr.positions), offsets, cfg))
    b = np.asarray(fm.fm_hits(km, bad, jnp.asarray(fmi.sa),
                              jnp.asarray(fmi.bwt_words),
                              jnp.asarray(fmi.occ),
                              jnp.asarray(fmi.c_table), offsets, cfg))
    # same SET per seed (FM returns SA order, CSR ascending)
    assert (np.sort(a, axis=-1) == np.sort(b, axis=-1)).all()


@pytest.mark.parametrize("align_impl", ["jnp", "pallas"])
def test_fm_pipeline_matches_csr(align_impl):
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.core import pwm as pwm_mod
    cfg, gen = _mk(seed=9, glen=4000, m=7)
    csr = builder.build_index(gen, cfg)
    fmi = fm.build_fm_index(gen, cfg)
    reads = sim.simulate_reads(packing.decode(gen.codes[:3900]), 40, 20,
                               seed=2, sub_rate=0.03, indel_rate=0.05,
                               contig="g")
    recs = []
    for r in reads:
        c = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32) - 33
        recs.append(io_fastq.ReadRecord(r.name, c,
                                        pwm_mod.pwm_from_calls(c, q),
                                        q.astype(np.int16)))
    m_csr = pl.TpuMapper(gen, csr, cfg, align_impl=align_impl,
                            interpret=True)
    m_fm = pl.TpuMapper(gen, fmi, cfg, align_impl=align_impl,
                           interpret=True)
    for b in io_fastq.batch_reads(iter(recs), cfg):
        ha = m_csr.map_batch(b)
        hb = m_fm.map_batch(b)
        for x, y in zip(ha, hb):
            assert [(h.strand, h.pos, h.score, h.cigar) for h in x] == \
                   [(h.strand, h.pos, h.score, h.cigar) for h in y]


@pytest.mark.parametrize("align_impl", ["jnp", "pallas"])
def test_fm_bisulfite_matches_csr_pair(align_impl):
    """FM bisulfite pair (collapsed FM backward search) must map exactly
    like the collapsed CSR pair."""
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.core import pwm as pwm_mod
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=32,
                       max_hits_per_seed=16, align_score_ratio=0.7,
                       sam_out=False, sgr_out=False, bisulfite=True)
    genome = sim.random_genome(6000, seed=19)
    gen = builder.Genome.from_contigs([("g", genome)])
    csr_pair = builder.build_bs_index(gen, cfg)
    fm_pair = fm.build_bs_fm_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=6, sub_rate=0.02,
                               contig="g", bisulfite=True)
    recs = []
    for r in reads:
        c = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32) - 33
        recs.append(io_fastq.ReadRecord(r.name, c, None,
                                        q.astype(np.int16)))
    m_csr = pl.TpuMapper(gen, csr_pair, cfg, align_impl=align_impl,
                            interpret=True)
    m_fm = pl.TpuMapper(gen, fm_pair, cfg, align_impl=align_impl,
                           interpret=True)
    n_mapped = 0
    for b in io_fastq.batch_reads(iter(recs), cfg):
        ha = m_csr.map_batch(b)
        hb = m_fm.map_batch(b)
        n_mapped += sum(1 for h in ha if h)
        for x, y in zip(ha, hb):
            assert [(h.strand, h.pos, h.score, h.cigar) for h in x] == \
                   [(h.strand, h.pos, h.score, h.cigar) for h in y]
    assert n_mapped >= 28


def test_fm_save_load_roundtrip(tmp_path):
    cfg, gen = _mk(seed=11, glen=1000)
    fmi = fm.build_fm_index(gen, cfg)
    p = str(tmp_path / "idx.npz")
    store.save_index(p, gen, fmi)
    gen2, idx2 = store.load_index(p)
    assert isinstance(idx2, fm.FmIndex)
    assert (gen2.codes == gen.codes).all()
    assert (idx2.sa == fmi.sa).all()
    assert (idx2.occ == fmi.occ).all()
    assert (idx2.bwt_words == fmi.bwt_words).all()
    assert (idx2.c_table == fmi.c_table).all()
