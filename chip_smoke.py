#!/usr/bin/env python
"""Smoke run of the mapper on the GPU: the quickest proof that the system
still starts and maps correctly on the card.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --devices 4   # four GPUs: the multi-card phase only

Phases (one card):
  1. device       JAX runs on a GPU; no CPU fallback of any kind.
  2. conformance  at the real widths (L = 104, W = 128, band 42, C = 32):
                  the compiled banded kernel against nw_ref and the oracle,
                  the device pure-detect and traceback against the oracle's
                  CIGARs, strand_expand and device_pwm against NumPy.  All
                  integer equality: no tolerance applies.
  3. main path    the CLI on a chr21-scale genome (46,709,983 bases, 2%
                  repeats, mer 13) and 65,536 100 bp reads with indels,
                  writing SAM and SGR; truth accuracy; host finish == device
                  finish; 256 reads re-mapped by the oracle at E.coli scale.
  4. modes        bisulfite (-b) and SNP with --accumulate device (against
                  host accumulation at rtol = atol = 1e-5) at E.coli scale.
Phase 5 (--devices 4): DistMapper on 4x1 and 2x2 meshes (host and device
finish) against the one-card mapper, GlobalSegmentedMapper on the mesh,
allreduce_coverage, and the CLI's --num-hosts 4 as four processes (one card
each) whose SAM and SGR equal the one-process run byte for byte.

Every line but the last is a log line.  The last line of standard output is
one JSON object, printed only when every phase passed:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# workload sizes (reads); genome sizes are sim.CHR21_LEN and sim.ECOLI_LEN
MAIN_READS, MAIN_BATCH = 65_536, 16_384     # chr21-scale CLI run
SMALL_READS, SMALL_BATCH = 8192, 4096       # E.coli-scale runs


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


def run_phase(name, fn, *args):
    t = time.perf_counter()
    log(f"== phase {name}")
    out = fn(*args)
    log(f"== phase {name}: ok in {time.perf_counter() - t:.1f} s")
    return out


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def records(reads):
    """sim reads -> FASTQ-path records (PWM built on the device)."""
    from gnumap_tpu.core import packing
    from gnumap_tpu.io import fastq as io_fastq
    out = []
    for r in reads:
        codes = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int16) - 33
        out.append(io_fastq.ReadRecord(r.name, codes, None, q))
    return out


def hit_key(hits):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len) for h in hh]
            for hh in hits]


def same_hits(a, b, what):
    """Exact (strand, pos, score, CIGAR, ref_len); weights to 1e-12 (the
    two finishes sum the same float64 terms in different orders)."""
    check(hit_key(a) == hit_key(b), f"{what}: hits differ")
    for ha, hb in zip(a, b):
        for x, y in zip(ha, hb):
            check(abs(x.weight - y.weight) < 1e-12,
                  f"{what}: weights differ ({x.weight} vs {y.weight})")


def truth_accuracy(names, hits, genome):
    """Share of mapped reads whose true locus is among their co-best
    (highest-weight) hits; positions within 3 bases (indel reads)."""
    from gnumap_tpu.utils.sim import parse_truth
    n_mapped = n_ok = 0
    for name, hh in zip(names, hits):
        if not hh:
            continue
        n_mapped += 1
        tc, tp, ts = parse_truth(name)
        best = max(h.weight for h in hh)
        for h in hh:
            ci, off = genome.locate(h.pos)
            if (h.weight == best and genome.names[int(ci)] == tc
                    and abs(int(off) - tp) <= 3 and h.strand == ts):
                n_ok += 1
                break
    return n_ok / max(n_mapped, 1), n_mapped


def sam_accuracy(path):
    """Truth accuracy read off a SAM file: a read is right when a record
    of top XP weight sits at its true locus and strand."""
    from gnumap_tpu.utils.sim import parse_truth
    best = {}
    n_rec = 0
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            n_rec += 1
            t = line.rstrip("\n").split("\t")
            if int(t[1]) & 4:
                best.setdefault(t[0], (-1.0, False))
                continue
            w = float(t[-1].split(":")[-1])
            tc, tp, ts = parse_truth(t[0])
            ok = (t[2] == tc and abs(int(t[3]) - 1 - tp) <= 3
                  and ("-" if int(t[1]) & 16 else "+") == ts)
            bw, bok = best.get(t[0], (-1.0, False))
            if w > bw:
                best[t[0]] = (w, ok)
            elif w == bw:
                best[t[0]] = (w, bok or ok)
    mapped = [ok for w, ok in best.values() if w >= 0]
    return (sum(mapped) / max(len(mapped), 1), len(mapped), len(best),
            n_rec)


def cli(argv):
    """The user's entry point, in this process (one process per card)."""
    from gnumap_tpu.cli import main as cli_main
    rc = cli_main.main(argv)
    check(rc == 0, f"CLI exit {rc}: {argv}")


# ---------------------------------------------------------------------------
# phase 2: conformance at real widths
# ---------------------------------------------------------------------------

def phase_conformance(seed):
    import jax.numpy as jnp
    from gnumap_tpu.align import band_kernel, nw_finish, scoring
    from gnumap_tpu.config import NEG_INF, SENTINEL, MapperConfig
    from gnumap_tpu.core import packing, pwm as pwm_mod
    from gnumap_tpu.oracle import oracle
    from gnumap_tpu.pipeline import mapper as pl

    cfg = MapperConfig(max_read_len=104, max_candidates=32)
    L, W, C = cfg.max_read_len, cfg.window_width(), cfg.max_candidates
    boff, bw = cfg.band()
    check((W, bw) == (128, 42), f"widths W={W} bw={bw}")
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    rng = np.random.default_rng(seed)
    G = 300_000
    g = rng.integers(0, 4, G).astype(np.int8)
    g[rng.random(G) < 0.001] = 4                      # some N bases
    S = scoring.normal_matrix(cfg)
    B2 = 128
    emis = np.zeros((B2, L, 5), np.int32)
    lens = np.full(B2, L, np.int32)
    lens[B2 // 2:] = rng.integers(60, L, B2 - B2 // 2)  # padded reads
    cands = np.full((B2, C), SENTINEL, np.int32)
    n_indel_reads = 0
    for b in range(16, B2):                           # rows 0..15: SENTINEL
        lb = int(lens[b])
        pos = int(rng.integers(20, G - L - 40))
        frag = g[pos:pos + lb + 4].copy()
        if b % 3 == 0:                                # 1-3bp indel
            p, k = int(rng.integers(8, lb - 10)), int(rng.integers(1, 4))
            if b % 2:
                frag = np.concatenate([frag[:p], frag[p + k:]])
            else:
                frag = np.concatenate(
                    [frag[:p], rng.integers(0, 4, k).astype(np.int8),
                     frag[p:]])
            n_indel_reads += 1
        frag = frag[:lb]
        err = rng.random(lb) < 0.02
        frag = np.where(err, (frag + 1) % 4, frag)
        frag = np.where(frag == 4, 0, frag).astype(np.int8)
        pq = pwm_mod.pwm_from_calls(frag, rng.integers(5, 41, lb))
        emis[b, :lb] = scoring.emission_int(pq, S)
        k = int(rng.integers(1, C + 1))
        cs = [pos + int(rng.integers(-6, 7))]
        cs += [int(x) for x in rng.integers(-L, G, k - 1)]
        cands[b, :k] = np.sort(cs)
    valid = cands != SENTINEL
    log(f"conformance: {int(valid.sum())} valid pairs of {valid.size} "
        f"slots, {n_indel_reads} indel reads, L={L} W={W} bw={bw} C={C}; "
        f"checks are integer equality (no tolerance)")

    got = np.asarray(band_kernel.nw_scores_banded(
        jnp.asarray(emis), jnp.asarray(cands), jnp.asarray(lens),
        jnp.asarray(g), W=W, slack=cfg.gap_slack, boff=boff, bw=bw,
        open_q=open_q, ext_q=ext_q))
    check(bool((got[~valid] == NEG_INF).all()),
          "kernel: SENTINEL slots not NEG_INF")
    ref = np.asarray(pl.dp_scores(cfg, "jnp", jnp.asarray(emis),
                                  jnp.asarray(cands), jnp.asarray(lens),
                                  jnp.asarray(g)))
    n_bad = int((got[valid] != ref[valid]).sum())
    check(n_bad == 0, f"kernel vs nw_ref: {n_bad} scores differ")

    def window(cand):
        ws = int(cfg.window_start(int(cand)))
        out = np.full(W, 4, np.int8)
        lo, hi = max(ws, 0), min(ws + W, G)
        if hi > lo:
            out[lo - ws:hi - ws] = g[lo:hi]
        return out

    n_or = 0
    for b, c in zip(*np.nonzero(valid)):
        want = oracle.nw_align(emis[b, :lens[b]], window(cands[b, c]), cfg)
        check(int(got[b, c]) == want,
              f"kernel vs oracle: read {b} slot {c}: {got[b, c]} != {want}")
        n_or += 1
    log(f"kernel == nw_ref == oracle on {n_or} pairs")

    # device finish on the positive-score pairs (what retention keeps)
    hb, hc = np.nonzero(valid & (got > 0))
    H = len(hb)
    win_h = np.stack([window(cands[b, c]) for b, c in zip(hb, hc)])
    e_h, l_h = jnp.asarray(emis[hb]), jnp.asarray(lens[hb])
    w_h = jnp.asarray(win_h.astype(np.int32))
    ops, jfin = nw_finish.traceback(e_h, w_h, l_h, open_q=open_q,
                                    ext_q=ext_q, band=cfg.band())
    pure, pjf = nw_finish.pure_detect(e_h, w_h, l_h,
                                      jnp.asarray(got[hb, hc]), boff=boff,
                                      bw=bw, open_q=open_q, ext_q=ext_q)
    ops, jfin = np.asarray(ops), np.asarray(jfin)
    pure, pjf = np.asarray(pure), np.asarray(pjf)
    n_gapped = 0
    for h in range(H):
        lb = int(lens[hb[h]])
        _, pos_w, cigar, rl = oracle.nw_align(emis[hb[h], :lb], win_h[h],
                                              cfg, traceback=True)
        got_c, got_rl = nw_finish.decode_ops(ops[h], lb)
        check((got_c, got_rl, int(jfin[h])) == (cigar, rl, pos_w),
              f"traceback hit {h}: {(got_c, got_rl, int(jfin[h]))} != "
              f"{(cigar, rl, pos_w)}")
        if pure[h]:
            check(cigar == f"{lb}M" and int(pjf[h]) == pos_w,
                  f"pure-detect hit {h} claims {int(pjf[h])} vs {cigar}")
        n_gapped += cigar != f"{lb}M"
    check(n_gapped > 0, "no gapped traceback exercised")
    log(f"traceback == oracle on {H} hits ({n_gapped} gapped CIGARs); "
        f"pure-detect proved {int(pure.sum())} all-M")

    # strand expansion and device PWM against their NumPy forms
    B = 256
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    quals = rng.integers(0, 60, (B, L)).astype(np.int16)
    ln = rng.integers(30, L + 1, B).astype(np.int32)
    pad = np.arange(L)[None, :] >= ln[:, None]
    codes[pad], quals[pad] = 4, 0
    table = pwm_mod.pwm_table()
    want_pw = np.where(pad[:, :, None], 0,
                       pwm_mod.pwm_rows_from_table(codes, quals)
                       ).astype(np.int32)
    got_pw = np.asarray(pl.device_pwm(jnp.asarray(codes),
                                      jnp.asarray(quals), jnp.asarray(ln),
                                      jnp.asarray(table)))
    check(np.array_equal(got_pw, want_pw), "device_pwm != NumPy table")
    S_plus, S_minus = scoring.matrices_for_mode(cfg)
    c2, e2 = pl.strand_expand(jnp.asarray(codes), jnp.asarray(want_pw),
                              jnp.asarray(ln), jnp.asarray(S_plus),
                              jnp.asarray(S_minus))
    c2, e2 = np.asarray(c2), np.asarray(e2)
    for b in range(B):
        lb = int(ln[b])
        rc = packing.revcomp(codes[b, :lb])
        check(np.array_equal(c2[b], codes[b])
              and np.array_equal(c2[B + b, :lb], rc)
              and (c2[B + b, lb:] == 4).all(),
              f"strand_expand codes, read {b}")
        ep = scoring.emission_int(want_pw[b], S_plus)
        em = np.zeros_like(ep)
        em[:lb] = scoring.emission_int(
            pwm_mod.pwm_revcomp(want_pw[b, :lb]), S_minus)
        check(np.array_equal(e2[b], ep) and np.array_equal(e2[B + b], em),
              f"strand_expand emissions, read {b}")
    log(f"device_pwm and strand_expand == NumPy on {B} reads")


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI
# ---------------------------------------------------------------------------

def phase_main_path(tmp, seed):
    from gnumap_tpu.cli import main as cli_main
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.utils import sim

    t = time.perf_counter()
    genome = sim.random_genome(sim.CHR21_LEN, seed=seed, repeat_frac=0.02)
    fa, fq = os.path.join(tmp, "chr21.fa"), os.path.join(tmp, "reads.fq")
    sim.write_fasta(fa, [("chr21_sim", genome)])
    reads = sim.simulate_reads(genome, MAIN_READS, 100, seed=seed + 1,
                               sub_rate=0.01, indel_rate=0.05,
                               contig="chr21_sim")
    sim.write_fastq(fq, reads)
    del genome
    log(f"chr21-scale inputs written in {time.perf_counter() - t:.1f} s")
    out = os.path.join(tmp, "chr21")
    argv = ["-g", fa, "-o", out, "-m", "13", "-j", "5", "-k", "8",
            "-q", "32", "-L", "104", "-B", str(MAIN_BATCH), fq]
    t = time.perf_counter()
    cli(argv)
    log(f"CLI map of {MAIN_READS} reads: {time.perf_counter() - t:.1f} s "
        f"(index build and compilation included)")
    for ext in (".sam", ".sgr"):
        check(os.path.getsize(out + ext) > 0, f"no {ext} written")
    acc, n_mapped, n_reads, n_rec = sam_accuracy(out + ".sam")
    log(f"SAM: {n_rec} records, {n_mapped}/{n_reads} reads mapped, truth "
        f"accuracy {acc:.6f}")
    check(n_reads == MAIN_READS, f"SAM holds {n_reads} reads")
    check(acc >= 0.99, f"truth accuracy {acc} < 0.99")

    # host finish == device finish on the same batches, same config
    cfg = cli_main.config_from_args(cli_main.build_arg_parser()
                                    .parse_args(argv))
    gen = builder.Genome.from_fasta(fa)
    idx = builder.build_index(gen, cfg)
    m_dev = pl.TpuMapper(gen, idx, cfg, finish_impl="device")
    m_host = pl.TpuMapper(gen, idx, cfg, finish_impl="host")
    log(f"DP implementation: {m_dev.align_impl}; finishes compared: "
        f"{m_dev.finish_impl} vs {m_host.finish_impl}")
    names, dev_hits = [], []
    for b in io_fastq.batch_reads_native(fq, cfg):
        hd = m_dev.map_batch(b)
        same_hits(hd, m_host.map_batch(b), "host vs device finish")
        names += list(b.names[:b.n])
        dev_hits += hd
    acc2, n2 = truth_accuracy(names, dev_hits, gen)
    n_gap = sum(1 for hh in dev_hits for h in hh
                if "I" in h.cigar or "D" in h.cigar)
    log(f"host finish == device finish on {len(dev_hits)} reads "
        f"({n_gap} gapped hits); co-best truth accuracy {acc2:.6f}")
    check(n2 == n_mapped, f"library mapped {n2} vs CLI {n_mapped}")
    check(n_gap > 0, "no gapped hits in the main path")


def phase_oracle_sample(seed, n_sample=256):
    """256 reads at E.coli scale re-mapped by the frozen oracle."""
    from gnumap_tpu.config import MapperConfig
    from gnumap_tpu.core import pwm as pwm_mod
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.oracle import oracle
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.utils import sim

    cfg = MapperConfig(mer_size=12, seed_jump=5, max_hits_per_seed=8,
                       max_candidates=32, max_read_len=104,
                       batch_size=SMALL_BATCH)
    genome = sim.random_genome(sim.ECOLI_LEN, seed=seed + 2,
                               repeat_frac=0.02)
    reads = sim.simulate_reads(genome, SMALL_BATCH, 100, seed=seed + 3,
                               sub_rate=0.01, indel_rate=0.1,
                               contig="ecoli_sim")
    gen = builder.Genome.from_contigs([("ecoli_sim", genome)])
    m = pl.TpuMapper(gen, builder.build_index(gen, cfg), cfg)
    recs = records(reads)
    hits = m.map_batch(next(io_fastq.batch_reads(iter(recs), cfg)))
    t = time.perf_counter()
    og = oracle.OracleGenome.from_contigs([("ecoli_sim", genome)])
    oidx = oracle.build_oracle_index(og, cfg)
    log(f"oracle index built in {time.perf_counter() - t:.1f} s")
    n_hits = n_gap = 0
    for i in range(n_sample):
        r = recs[i]
        want = oracle.map_read(
            r.codes, pwm_mod.pwm_from_calls(r.codes, r.quals), og, oidx,
            cfg)
        got = hits[i]
        check([(h.strand, h.pos, h.score, h.cigar) for h in got]
              == [(h.strand, h.pos, h.score, h.cigar) for h in want],
              f"oracle read {i}: {hit_key([got])} vs "
              f"{[(h.strand, h.pos, h.score, h.cigar) for h in want]}")
        for x, y in zip(got, want):
            check(abs(x.weight - y.weight) < 1e-12, f"oracle read {i} weight")
        n_hits += len(got)
        n_gap += sum(1 for h in got if h.cigar != f"{len(r.codes)}M")
    log(f"oracle == mapper on {n_sample} reads ({n_hits} hits, {n_gap} "
        f"gapped; strand, pos, score, CIGAR exact, weight to 1e-12)")


# ---------------------------------------------------------------------------
# phase 4: modes at E.coli scale
# ---------------------------------------------------------------------------

def phase_modes(tmp, seed):
    from gnumap_tpu.cli import main as cli_main
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.utils import sim

    genome = sim.random_genome(sim.ECOLI_LEN, seed=seed + 4)
    fa = os.path.join(tmp, "ecoli.fa")
    sim.write_fasta(fa, [("ecoli_sim", genome)])
    common = ["-g", fa, "-j", "5", "-k", "8", "-q", "32", "-L", "104",
              "-B", str(SMALL_BATCH)]

    # bisulfite
    bs_fq = os.path.join(tmp, "bs.fq")
    sim.write_fastq(bs_fq, sim.simulate_reads(
        genome, SMALL_READS, 100, seed=seed + 5, sub_rate=0.01,
        indel_rate=0.02,
        contig="ecoli_sim", bisulfite=True))
    out = os.path.join(tmp, "bs")
    cli(common + ["-m", "16", "-b", "-o", out, bs_fq])
    acc, n_mapped, n_reads, _ = sam_accuracy(out + ".sam")
    log(f"bisulfite: {n_mapped}/{n_reads} mapped, truth accuracy "
        f"{acc:.6f}")
    check(n_mapped >= 0.9 * n_reads and acc >= 0.97,
          f"bisulfite mapped {n_mapped}/{n_reads}, accuracy {acc}")

    # SNP with device accumulation, through the CLI and against host
    snp_fq = os.path.join(tmp, "snp.fq")
    sim.write_fastq(snp_fq, sim.simulate_reads(
        genome, SMALL_READS, 100, seed=seed + 6, sub_rate=0.01,
        indel_rate=0.05,
        contig="ecoli_sim"))
    argv = common + ["-m", "12", "--snp", "--accumulate", "device",
                     "-o", os.path.join(tmp, "snp"), snp_fq]
    cli(argv)
    for ext in (".sam", ".sgr", ".sgrex"):
        check(os.path.getsize(os.path.join(tmp, "snp" + ext)) > 0,
              f"SNP run wrote no {ext}")
    cfg = cli_main.config_from_args(cli_main.build_arg_parser()
                                    .parse_args(argv))
    gen = builder.Genome.from_fasta(fa)
    idx = builder.build_index(gen, cfg)
    res = {}
    for acc_impl in ("host", "device"):
        m = pl.TpuMapper(gen, idx, cfg, finish_impl="device",
                         accumulate=acc_impl)
        res[acc_impl] = pl.map_stream(
            m, io_fastq.batch_reads_native(snp_fq, cfg), collect_sam=False)
    h, d = res["host"], res["device"]
    check(h.tallies is not None and h.tallies.sum() > 0, "no SNP tallies")
    for name, a, b in (("coverage", h.coverage, d.coverage),
                       ("tallies", h.tallies, d.tallies)):
        err = float(np.max(np.abs(a - b)))
        check(np.allclose(b, a, rtol=1e-5, atol=1e-5),
              f"device {name} vs host: max abs diff {err}")
        log(f"SNP {name}: device f32 vs host f64 max abs diff {err:.3g} "
            f"(rtol = atol = 1e-5)")


# ---------------------------------------------------------------------------
# phase 5: four cards
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_multihost_cli(tmp, seed, n_hosts):
    """--num-hosts N as N processes, one card each, against one process.
    Runs before this process touches the GPU."""
    from gnumap_tpu.utils import sim
    genome = sim.random_genome(sim.ECOLI_LEN, seed=seed + 7,
                               repeat_frac=0.02)
    fa, fq = os.path.join(tmp, "mh.fa"), os.path.join(tmp, "mh.fq")
    sim.write_fasta(fa, [("ecoli_sim", genome)])
    sim.write_fastq(fq, sim.simulate_reads(
        genome, 2 * SMALL_READS, 100, seed=seed + 8, sub_rate=0.01,
        indel_rate=0.05, contig="ecoli_sim"))
    common = ["-g", fa, fq, "-m", "12", "-j", "5", "-k", "8", "-q", "32",
              "-L", "104", "-B", str(SMALL_BATCH // 2), "--snp"]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")

    def run(argv_list):
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gnumap_tpu.cli.main"] + a, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for a in argv_list]
        outs = [p.communicate(timeout=900) for p in procs]
        for p, (o, e) in zip(procs, outs):
            check(p.returncode == 0, f"CLI process failed: {e[-3000:]}")

    t = time.perf_counter()
    run([["-o", os.path.join(tmp, "one")] + common])
    t1 = time.perf_counter()
    coord = f"localhost:{_free_port()}"
    run([["-o", os.path.join(tmp, "multi"), "--num-hosts", str(n_hosts),
          "--host-id", str(h), "--coordinator", coord] + common
         for h in range(n_hosts)])
    t2 = time.perf_counter()

    def body(p):
        with open(p, "rb") as f:
            return [ln for ln in f if not ln.startswith(b"@PG")]

    one, multi = os.path.join(tmp, "one"), os.path.join(tmp, "multi")
    check(body(one + ".sam") == body(multi + ".sam"),
          "SAM differs between 1 and N processes")
    for ext in (".sgr", ".sgrex"):
        with open(one + ext, "rb") as a, open(multi + ext, "rb") as b:
            check(a.read() == b.read(), f"{ext} differs")
    log(f"--num-hosts {n_hosts}: SAM (bar @PG), SGR and SGREX byte-identical "
        f"to one process ({t1 - t:.1f} s one process, {t2 - t1:.1f} s "
        f"{n_hosts} processes)")


def phase_mesh(seed, n_dev):
    import jax
    from gnumap_tpu.config import MapperConfig
    from gnumap_tpu.dist import collectives, mesh as mesh_mod
    from gnumap_tpu.dist.segments import GlobalSegmentedMapper
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.pipeline import mapper as pl
    from gnumap_tpu.utils import sim

    cfg = MapperConfig(mer_size=12, seed_jump=5, max_hits_per_seed=8,
                       max_candidates=32, max_read_len=104,
                       batch_size=SMALL_BATCH)
    genome = sim.random_genome(sim.ECOLI_LEN, seed=seed + 9,
                               repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("ecoli_sim", genome)])
    idx = builder.build_index(gen, cfg)
    batch = next(io_fastq.batch_reads(iter(records(sim.simulate_reads(
        genome, SMALL_BATCH, 100, seed=seed + 10, sub_rate=0.01,
        indel_rate=0.05, contig="ecoli_sim"))), cfg))
    ref = pl.TpuMapper(gen, idx, cfg, finish_impl="host").map_batch(batch)
    for R, S in ((n_dev, 1), (n_dev // 2, 2)):
        mesh = mesh_mod.make_mesh(R, S)
        for fin in ("host", "device"):
            dm = collectives.DistMapper(gen, idx, cfg, mesh, finish_impl=fin)
            same_hits(dm.map_batch(batch), ref,
                      f"DistMapper {R}x{S} {fin} finish")
            log(f"DistMapper {R}x{S} ({dm.align_impl}, {fin} finish) == "
                f"one-card mapper on {batch.n} reads")
    # segmented (genome-partitioned) mapper on the mesh == flat on the
    # mesh, on a 2%-repeat genome.  max_hits_per_seed and max_candidates
    # apply per segment, so both are set above the repeat unit's copy
    # count (an indel read anchors up to two candidates per copy): then
    # no seed or candidate is capped in either layout
    repeat_frac, unit = 0.02, 500
    n_copies = int(sim.ECOLI_LEN * repeat_frac) // unit
    cap = 1 << (2 * n_copies).bit_length()
    cfg2 = MapperConfig(mer_size=12, seed_jump=5, max_hits_per_seed=cap,
                        max_candidates=cap, max_read_len=104,
                        batch_size=SMALL_BATCH)
    g2 = sim.random_genome(sim.ECOLI_LEN, seed=seed + 11,
                           repeat_frac=repeat_frac, repeat_unit=unit)
    half = sim.ECOLI_LEN // 2
    gen2 = builder.Genome.from_contigs([("s0", g2[:half]),
                                        ("s1", g2[half:])])
    batch2 = next(io_fastq.batch_reads(iter(records(sim.simulate_reads(
        g2, SMALL_BATCH, 100, seed=seed + 12, sub_rate=0.01,
        indel_rate=0.05, contig="s"))), cfg2))
    mesh = mesh_mod.make_mesh(n_dev // 2, 2)
    flat = collectives.DistMapper(gen2, builder.build_index(gen2, cfg2),
                                  cfg2, mesh).map_batch(batch2)
    gsm = GlobalSegmentedMapper(gen2, cfg2, n_segments=2, mesh=mesh)
    seg = gsm.map_batch(batch2)
    check([[(h.strand, h.pos, h.score, h.cigar, h.weight) for h in hh]
           for hh in seg]
          == [[(h.strand, h.pos, h.score, h.cigar, h.weight) for h in hh]
              for hh in flat], "segmented-on-mesh hits != flat-on-mesh")
    n_rep = sum(len(hh) > 8 for hh in flat)
    check(n_rep > 0, "no repeat read with more than 8 hits")
    log(f"GlobalSegmentedMapper (2 segments) on the mesh == flat DistMapper "
        f"on {batch2.n} reads of a 2%-repeat genome ({n_copies} copies, "
        f"caps {cap}; {n_rep} reads with more than 8 hits, up to "
        f"{max(len(hh) for hh in flat)})")
    stack = np.random.default_rng(seed).random((n_dev, 1 << 20))
    merged = collectives.allreduce_coverage(stack, mesh)
    check(np.allclose(merged, stack.sum(axis=0), rtol=1e-6),
          "allreduce_coverage")
    log(f"allreduce_coverage over {n_dev} cards ok")
    check(len(jax.devices()) == n_dev, "device count changed")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4 = run only the multi-card phase on four GPUs")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated genome and read set")
    args = ap.parse_args()
    t0 = time.perf_counter()
    sys.path.insert(0, HERE)
    smi = nvidia_smi()
    with tempfile.TemporaryDirectory(prefix="gnumap_smoke_") as tmp:
        if args.devices == 4:
            # the CLI processes take the cards before this process does
            run_phase("multihost-cli", phase_multihost_cli, tmp, args.seed,
                      4)
        import jax
        from gnumap_tpu.align.select import resolve_align_impl
        from gnumap_tpu.native import lib as native_lib
        from gnumap_tpu.utils import jaxcache

        def phase_device():
            devs = jax.devices()
            check(devs[0].platform == "gpu",
                  f"JAX platform {devs[0].platform!r}, not a GPU")
            check(len(devs) >= args.devices,
                  f"{len(devs)} GPUs, need {args.devices}")
            check(native_lib.available(), "native host library not loaded")
            log(f"devices: {len(devs)} x {devs[0].device_kind}; "
                f"compile cache: {jaxcache.enable()}; "
                f"DP implementation: {resolve_align_impl('auto')}; "
                f"native host library loaded")
            return devs

        devs = run_phase("device", phase_device)
        if args.devices == 4:
            run_phase("mesh", phase_mesh, args.seed, 4)
        else:
            run_phase("conformance", phase_conformance, args.seed)
            run_phase("main-path", phase_main_path, tmp, args.seed)
            run_phase("oracle-sample", phase_oracle_sample, args.seed)
            run_phase("modes", phase_modes, tmp, args.seed)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:            # any failed phase: no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
