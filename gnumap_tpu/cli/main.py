"""CLI driver — the ``gnumap`` command-line equivalent (SURVEY.md §1 L7).

Mirrors the reference's semantic knobs (getopt flags catalogued in SURVEY.md
§5 "Config / flag system": ``-g`` genome, ``-o`` output, ``-a`` align-score
ratio, ``-m`` mer size, ``-j`` seed jump, gap penalties, substitution file,
bisulfite/SNP toggles, max hits cap).  Exact reference flag letters were
unverifiable (empty mount); semantics are preserved, letters chosen to match
the published descriptions.

Usage:
    python -m gnumap_tpu.cli.main -g genome.fa -o out reads.fastq [reads2 ...]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder, store
from gnumap_tpu.io import fastq as io_fastq, sam as sam_io, sgr as sgr_io
from gnumap_tpu.pipeline import mapper as pl


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnumap-tpu",
        description="Probabilistic short-read mapper "
                    "(GNUMAP-capability) on JAX")
    p.add_argument("reads", nargs="*",
                   help="FASTQ/FASTA/_prb.txt read files")
    p.add_argument("-g", "--genome", required=True,
                   help="reference genome FASTA (or prebuilt .npz index)")
    p.add_argument("-o", "--output", help="output prefix")
    p.add_argument("-a", "--align-score", type=float, default=0.9,
                   help="retain loci scoring >= a * max score (ref -a)")
    p.add_argument("-m", "--mer-size", type=int, default=10,
                   help="seed k-mer length (ref -m)")
    p.add_argument("-j", "--jump", type=int, default=5,
                   help="seed stride along the read (ref -j)")
    p.add_argument("-k", "--max-hits", type=int, default=64,
                   help="skip seeds with more index hits than this")
    p.add_argument("-q", "--max-candidates", type=int, default=128,
                   help="candidate loci cap per read+strand")
    p.add_argument("--sort-sam", action="store_true",
                   help="coordinate-sort the SAM output (samtools order)")
    p.add_argument("--index-type", choices=["csr", "fm"], default="csr",
                   help="seed index backend: dense CSR table (default) or "
                        "BWT/FM (the reference's GenomeBwt variant)")
    p.add_argument("--gap-open", type=float, default=4.0)
    p.add_argument("--gap-extend", type=float, default=1.0)
    p.add_argument("--match", type=float, default=1.0)
    p.add_argument("--mismatch", type=float, default=-1.0)
    p.add_argument("-S", "--subst-file", default=None,
                   help="4x4 whitespace substitution matrix file (ref -S)")
    p.add_argument("--adaptor", default=None,
                   help="3' adaptor sequence to trim (ref adaptor flag)")
    p.add_argument("-b", "--bisulfite", action="store_true",
                   help="bisulfite C->T asymmetric scoring (GNUMAP-bs)")
    p.add_argument("--snp", action="store_true",
                   help="per-base tallies + SNP p-values (GNUMAP-SNP)")
    p.add_argument("-B", "--batch-size", type=int, default=4096)
    p.add_argument("-L", "--max-read-len", type=int, default=128)
    p.add_argument("--no-sam", action="store_true")
    p.add_argument("--no-sgr", action="store_true")
    p.add_argument("--save-index", default=None,
                   help="write the built index to this .npz and exit")
    p.add_argument("--align-impl", choices=["jnp", "pallas", "auto"],
                   default="auto",
                   help="DP scoring: the banded Pallas kernel on a GPU, "
                        "the jnp scan elsewhere (auto)")
    p.add_argument("--accumulate", choices=["host", "device"],
                   default="host",
                   help="coverage/SNP-tally accumulation: 'host' = exact "
                        "hit-ordered float64 (default, the golden "
                        "semantics; fastest for sparse-uniform hits); "
                        "'device' = [FROZEN v5] on-device f32 "
                        "accumulation with the device finish, fetched "
                        "only at checkpoints/end (keeps the host idle "
                        "per batch).  Single-device path only; "
                        "capacity-overflow batches fall back to the "
                        "exact host path automatically")
    p.add_argument("--checkpoint", default=None,
                   help="stream-state checkpoint file; resumes if present")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="checkpoint every N batches")
    p.add_argument("--fail-after", type=int, default=0,
                   help="fault injection: crash after N batches (CI "
                        "kill/restart recovery tests, SURVEY.md §5)")
    p.add_argument("-c", "--read-shards", type=int, default=0,
                   help="data-parallel read shards over devices "
                        "(0 = single-device; ref -c threads / mpirun -np)")
    p.add_argument("--index-shards", type=int, default=1,
                   help="shard the k-mer index over this many devices "
                        "(genome-partitioned mode)")
    p.add_argument("--segments", default="auto",
                   help="position-partition the genome into N contig-"
                        "aligned segments, each with its own int32 index "
                        "(genomes > 2^31 bases, BASELINE config 5); "
                        "'auto' (default) segments only when required, "
                        "an integer forces that many segments")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-batch JSONL stats on stderr (ref -v)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host run: total jax.distributed processes "
                        "(the reference's mpirun -np R)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this process's rank in [0, num-hosts)")
    p.add_argument("--coordinator", default="localhost:29500",
                   help="jax.distributed coordinator address (rank 0)")
    return p


def load_subst(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(tuple(float(x) for x in line.split()))
    if len(rows) != 4 or any(len(r) != 4 for r in rows):
        raise SystemExit("substitution file must be a 4x4 matrix")
    return tuple(rows)


def config_from_args(args) -> MapperConfig:
    return MapperConfig(
        mer_size=args.mer_size, seed_jump=args.jump,
        max_hits_per_seed=args.max_hits, max_candidates=args.max_candidates,
        match_score=args.match, mismatch_score=args.mismatch,
        gap_open=args.gap_open, gap_extend=args.gap_extend,
        align_score_ratio=args.align_score,
        bisulfite=args.bisulfite, snp_mode=args.snp,
        subst_matrix=load_subst(args.subst_file) if args.subst_file else None,
        max_read_len=args.max_read_len, batch_size=args.batch_size,
        sam_out=not args.no_sam, sgr_out=not args.no_sgr,
        sgrex_out=args.snp)


def read_stream(paths, cfg, adaptor=None):
    its = []
    for path in paths:
        if path.endswith(("_prb.txt", ".prb")):
            its.append(io_fastq.iter_prb(path, cfg))
        elif path.endswith(("_int.txt", ".int")):
            its.append(io_fastq.iter_int(path, cfg))
        elif path.endswith((".fa", ".fasta")):
            its.append(io_fastq.iter_fasta_reads(path, cfg))
        else:
            its.append(io_fastq.iter_fastq(path, cfg))
    stream = itertools.chain(*its)
    if adaptor:
        stream = io_fastq.apply_adaptor_trim(stream, cfg, adaptor)
    return stream


def batch_stream(paths, cfg, adaptor=None):
    """Batches, using the native C++ FASTQ fast path where possible;
    adaptor trimming runs vectorized on the whole batch on that path."""
    fastqs = [p for p in paths
              if not p.endswith(("_prb.txt", ".prb", "_int.txt", ".int",
                                 ".fa", ".fasta"))]
    if len(fastqs) == len(paths):
        from gnumap_tpu.core import packing
        ad = packing.encode(adaptor) if adaptor else None
        for path in paths:
            for b in io_fastq.batch_reads_native(path, cfg):
                yield (io_fastq.trim_adaptor_batch(b, ad)
                       if ad is not None else b)
    else:
        yield from io_fastq.batch_reads(read_stream(paths, cfg, adaptor),
                                        cfg)


def main(argv=None) -> int:
    from gnumap_tpu.utils import jaxcache
    jaxcache.enable()
    import logging
    logging.basicConfig(
        level=logging.WARNING, stream=sys.stderr,
        format="%(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    if not args.save_index and (not args.reads or not args.output):
        raise SystemExit("reads and -o/--output are required unless "
                         "--save-index is given")
    multi = args.num_hosts > 1
    if multi:
        from gnumap_tpu.dist import multihost
        multihost.initialize(args.coordinator, args.num_hosts, args.host_id)
        if args.checkpoint:
            # per-host stream state; every host resumes its own partition
            args.checkpoint = f"{args.checkpoint}.h{args.host_id}" 
    cfg = config_from_args(args)
    from gnumap_tpu.dist.segments import SEG_LIMIT
    n_segments = 0 if args.segments == "auto" else int(args.segments)
    t0 = time.perf_counter()
    index = None
    if args.genome.endswith(".npz"):
        genome, index = store.load_index(args.genome)
        if index.mer_size != cfg.mer_size:
            raise SystemExit(
                f"index mer_size {index.mer_size} != -m {cfg.mer_size}")
        if n_segments > 1:
            raise SystemExit("--segments needs a FASTA genome (per-segment "
                             "indexes are built contig-aligned)")
    else:
        genome = builder.Genome.from_fasta(args.genome)
        segmented = (n_segments > 1
                     or len(genome.codes) > SEG_LIMIT)
        if segmented and args.index_type == "fm":
            raise SystemExit("--segments requires --index-type csr")
        if not segmented:
            if cfg.bisulfite:
                if args.index_type == "fm":
                    from gnumap_tpu.index import fm
                    index = fm.build_bs_fm_index(genome, cfg)
                else:
                    index = builder.build_bs_index(genome, cfg)
            elif args.index_type == "fm":
                from gnumap_tpu.index import fm
                index = fm.build_fm_index(genome, cfg)
            else:
                index = builder.build_index(genome, cfg)
    t_index = time.perf_counter() - t0
    if args.save_index:
        if index is None:
            raise SystemExit("--save-index is per-genome; segmented "
                             "genomes rebuild per-segment indexes at "
                             "map time")
        store.save_index(args.save_index, genome, index)
        print(json.dumps({"event": "index_saved", "path": args.save_index,
                          "seconds": round(t_index, 3)}))
        return 0

    from gnumap_tpu.align.select import resolve_align_impl
    impl = resolve_align_impl(args.align_impl)
    mesh = None
    if args.read_shards or args.index_shards > 1:
        from gnumap_tpu.index.fm import FmIndex
        if isinstance(index, FmIndex):
            raise SystemExit("--index-type fm is single-device; the "
                             "sharded path shards the CSR table "
                             "(use --index-type csr)")
        from gnumap_tpu.dist import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(args.read_shards or None,
                                  args.index_shards)
    if args.accumulate == "device" and (index is None or mesh is not None):
        raise SystemExit("--accumulate device is the single-device "
                         "path; segmented and sharded runs use host "
                         "accumulation")
    if index is None:
        # segmented path (genome > int32 or --segments N): per-segment
        # int32 indexes, global int64 coordinates, union posteriors.
        # With --num-hosts R this becomes the GENOME-PARTITIONED mode
        # (the reference's RAM-bound MPI layout): host h owns segments
        # h, h+R, ... and maps EVERY read batch against them; posterior
        # denominators reduce across hosts per batch and the coverage
        # tracks merge bit-exactly (dist/segments.py docstring).
        from gnumap_tpu.dist.segments import GlobalSegmentedMapper
        t0 = time.perf_counter()
        m = GlobalSegmentedMapper(genome, cfg, align_impl=impl,
                                  n_segments=n_segments, mesh=mesh,
                                  num_hosts=args.num_hosts,
                                  host_id=args.host_id)
        t_index += time.perf_counter() - t0
    elif mesh is not None:
        from gnumap_tpu.dist import collectives
        m = collectives.DistMapper(genome, index, cfg, mesh,
                                   align_impl=impl)
    else:
        m = pl.TpuMapper(genome, index, cfg, align_impl=impl,
                         finish_impl=("device" if args.accumulate == "device"
                                      else None),
                         accumulate=args.accumulate)
    sam_path = args.output + ".sam"
    sam_f = sam_bin = None
    spans: list = []
    if cfg.sam_out and multi:
        # per-host headerless SAM shard + per-batch byte spans (merged by
        # global batch index at host 0 — the reference's rank-0 gather)
        import io as _io
        body_path, _ = multihost.shard_paths(args.output, args.host_id)
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint)
                        and os.path.exists(body_path))
        sam_bin = open(body_path, "r+b" if resuming else "wb")
        sam_f = _io.TextIOWrapper(sam_bin, encoding="ascii", newline="")
    elif cfg.sam_out:
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint))
        sam_f = open(sam_path, "r+" if resuming and
                     os.path.exists(sam_path) else "w+")
        if not resuming or sam_f.seek(0, 2) == 0:
            sam_f.seek(0)
            sam_io.write_header(sam_f, genome.names, genome.lengths,
                                cmd=" ".join(sys.argv))
    genome_partitioned = multi and index is None
    callbacks = []
    if args.verbose:
        def _vcb(idx, s):
            print(json.dumps({
                "event": "batch", "batch": idx, "reads": s.n_reads,
                "mapped": s.n_mapped, "multi": s.n_multi,
                "candidates_per_read": round(
                    s.n_candidates / max(1, s.n_reads), 2),
                "dp_cells": s.dp_cells,
                "device_s": round(s.device_s, 3),
                "host_s": round(s.host_s, 3)}), file=sys.stderr)
        callbacks.append(_vcb)
    if multi and sam_bin is not None and genome_partitioned:
        # per-RECORD index rows (batch, read, key) aligned with the shard
        # lines; host 0 interleaves them (multihost.merge_sam_shards_gp)
        _gp_rows: list = []
        _, idx_path = multihost.shard_paths(args.output, args.host_id)
        if args.checkpoint and os.path.exists(args.checkpoint):
            from gnumap_tpu.pipeline import checkpoint as _ckpt
            st = _ckpt.load(args.checkpoint)
            if st is not None and os.path.exists(idx_path):
                for line in open(idx_path).read().splitlines():
                    row = tuple(json.loads(line))
                    if row[0] < st.batches_done:
                        _gp_rows.append(row)
        if args.checkpoint:
            # truncate to the kept rows once; per-batch writes APPEND
            # (rewriting the whole per-record index each batch is
            # O(records x batches) at 10M-read scale)
            multihost.write_shard_index(idx_path, _gp_rows)

        def _gp_cb(idx, s):
            gp = getattr(m, "gp_sam", None)
            new_rows = [(idx - 1, rd, key)
                        for rd, key in (gp["records"] if gp else [])]
            _gp_rows.extend(new_rows)
            if args.checkpoint and new_rows:
                sam_f.flush()
                with open(idx_path, "a") as f:
                    for row in new_rows:
                        f.write(json.dumps(row) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
        callbacks.append(_gp_cb)
    elif multi and sam_bin is not None:
        _prev = [0]
        _k = [0]
        _, idx_path = multihost.shard_paths(args.output, args.host_id)
        if args.checkpoint and os.path.exists(args.checkpoint):
            # resume: keep the spans of already-checkpointed batches
            from gnumap_tpu.pipeline import checkpoint as _ckpt
            st = _ckpt.load(args.checkpoint)
            if st is not None and os.path.exists(idx_path):
                kept = open(idx_path).read().splitlines()[:st.batches_done]
                for line in kept:
                    spans.append(tuple(json.loads(line)))
                _k[0] = len(kept)
                _prev[0] = st.sam_offset

        def _span_cb(idx, s):
            sam_f.flush()
            end = sam_bin.tell()
            if byte_range_mode:
                key = (args.host_id, _k[0])      # host-contiguous reads
            else:
                key = (_k[0] * args.num_hosts + args.host_id, 0)  # strided
            spans.append((key[0], key[1], _prev[0], end))
            _prev[0] = end
            _k[0] += 1
            if args.checkpoint:
                multihost.write_shard_index(idx_path, spans)
        callbacks.append(_span_cb)
    if args.fail_after:
        def _fail_cb(idx, s):
            if idx - (_resume_base or 0) >= args.fail_after:
                print(json.dumps({"event": "fault_injected",
                                  "batch": idx}), file=sys.stderr)
                os._exit(3)
        _resume_base = 0
        callbacks.append(_fail_cb)
    cb = None
    if callbacks:
        def cb(idx, s):
            for c in callbacks:
                c(idx, s)
    # multi-host read partition: byte ranges for a plain single FASTQ
    # (each host parses only ~1/R of the file); batch stride otherwise.
    # Genome-partitioned mode BROADCASTS reads instead (every host maps
    # every batch against its own segments — SURVEY.md §3.5 RAM-bound).
    byte_range_mode = (
        multi and not genome_partitioned and len(args.reads) == 1
        and not args.reads[0].endswith(("_prb.txt", ".prb", "_int.txt",
                                        ".int", ".fa", ".fasta", ".gz")))
    if byte_range_mode:
        lo, hi = multihost.fastq_ranges(args.reads[0],
                                        args.num_hosts)[args.host_id]
        from gnumap_tpu.core import packing as _packing
        ad = _packing.encode(args.adaptor) if args.adaptor else None

        def _range_batches():
            for bb in io_fastq.batch_reads_native(args.reads[0], cfg,
                                                  start=lo, stop=hi):
                yield (io_fastq.trim_adaptor_batch(bb, ad)
                       if ad is not None else bb)
        batches = _range_batches()
    else:
        batches = batch_stream(args.reads, cfg, args.adaptor)
        if multi and not genome_partitioned:
            batches = multihost.strided(batches, args.num_hosts,
                                        args.host_id)
    t1 = time.perf_counter()
    res = pl.map_stream(
        m, batches,
        collect_sam=False, sam_file=sam_f,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        batch_callback=cb)
    t_map = time.perf_counter() - t1
    if multi:
        # cross-host merge: coverage/tallies by deterministic bit-exact
        # all-gather + host-ordered sum (the MPI_Reduce analog); SAM by
        # rank-0 interleave of per-batch shard chunks
        if res.coverage is not None:
            res.coverage = multihost.allreduce_f64(res.coverage)
        if res.tallies is not None:
            res.tallies = multihost.allreduce_f64(res.tallies)
        if sam_f:
            sam_f.close()
            _, idx_path = multihost.shard_paths(args.output, args.host_id)
            multihost.write_shard_index(
                idx_path, _gp_rows if genome_partitioned else spans)
        multihost.barrier("gnumap_sam_shards")
        if sam_f and args.host_id == 0:
            import io as _io
            hdr = _io.StringIO()
            sam_io.write_header(hdr, genome.names, genome.lengths,
                                cmd=" ".join(sys.argv))
            if genome_partitioned:
                multihost.merge_sam_shards_gp(args.output, args.num_hosts,
                                              hdr.getvalue())
            else:
                multihost.merge_sam_shards(args.output, args.num_hosts,
                                           hdr.getvalue())
            if args.sort_sam:
                sam_io.sort_sam_file(sam_path, genome.names)
    elif sam_f:
        sam_f.close()
        if args.sort_sam:
            sam_io.sort_sam_file(sam_path, genome.names)
    if cfg.sgr_out and args.host_id == 0:
        with open(args.output + ".sgr", "w") as f:
            sgr_io.write_sgr(f, genome, res.coverage, cfg.min_coverage_emit)
    if cfg.sgrex_out and res.tallies is not None and args.host_id == 0:
        from gnumap_tpu.posterior import snp
        pvals = snp.snp_pvalues(genome.codes, res.coverage, res.tallies)
        with open(args.output + ".sgrex", "w") as f:
            sgr_io.write_sgrex(f, genome, res.coverage, res.tallies, pvals,
                               cfg.min_coverage_emit)
    if multi:
        multihost.barrier("gnumap_outputs")
    s = res.stats
    print(json.dumps({
        "event": "done", "reads": s.n_reads, "mapped": s.n_mapped,
        "segments": getattr(m, "n_segments", 1),
        "multi_mapped": s.n_multi, "candidates": s.n_candidates,
        "dp_cells": s.dp_cells, "index_s": round(t_index, 3),
        "map_s": round(t_map, 3),
        "reads_per_s": round(s.n_reads / max(t_map, 1e-9), 1),
        "dp_cells_per_s": round(s.dp_cells / max(t_map, 1e-9), 1),
        "device_s": round(s.device_s, 3), "host_s": round(s.host_s, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
