"""Position-partitioned genome segments — the reference's genome-partitioned
MPI mode at the segment level (SURVEY.md §3.5), and the path to genomes
beyond the int32 position limit (full human genome, BASELINE.json config 5).

Each segment is an independent (genome, CSR index) pair small enough for
int32 positions.  A read batch maps against every segment (on one host) or
against the local host's segment (multi-host; each host holds 1/R of the
genome and all reads — exactly the reference's RAM-bound MPI layout).
Retained hits are then merged per read and the posterior weights
renormalized over the union: w_i = s_i / sum over ALL segments' retained
loci — the same frozen semantics as a single unsegmented genome, because
retention thresholds depend only on the read, never on the genome.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder
from gnumap_tpu.io.fastq import ReadBatch
from gnumap_tpu.pipeline import mapper as pl


@dataclasses.dataclass
class SegmentHit:
    segment: int
    strand: str
    pos: int            # segment-local global offset
    score: int
    weight: float
    cigar: str
    ref_len: int


def merge_segment_hits(per_segment: Sequence[List[List[pl.ReadHit]]]
                       ) -> List[List[SegmentHit]]:
    """Union per-read hits from S segments and renormalize weights over the
    union (scores are comparable across segments — same read, same scoring).
    Output order: (segment, pos, strand) ascending [FROZEN]."""
    n_reads = len(per_segment[0])
    out: List[List[SegmentHit]] = []
    for b in range(n_reads):
        hits: List[SegmentHit] = []
        for s, seg_hits in enumerate(per_segment):
            for h in seg_hits[b]:
                hits.append(SegmentHit(s, h.strand, h.pos, h.score, 0.0,
                                       h.cigar, h.ref_len))
        total = float(sum(h.score for h in hits))
        for h in hits:
            h.weight = h.score / total if total else 0.0
        hits.sort(key=lambda h: (h.segment, h.pos,
                                 0 if h.strand == "+" else 1))
        out.append(hits)
    return out


class SegmentedMapper:
    """Map against a genome split into contig groups (each < 2^31 bases)."""

    def __init__(self, contig_groups: Sequence[Sequence[Tuple[str, str]]],
                 cfg: MapperConfig, align_impl: str = "jnp"):
        self.cfg = cfg
        self.mappers: List[pl.TpuMapper] = []
        for group in contig_groups:
            genome = builder.Genome.from_contigs(list(group))
            index = (builder.build_bs_index(genome, cfg) if cfg.bisulfite
                     else builder.build_index(genome, cfg))
            self.mappers.append(pl.TpuMapper(genome, index, cfg,
                                             align_impl=align_impl))

    @property
    def n_segments(self) -> int:
        return len(self.mappers)

    def map_batch(self, batch: ReadBatch,
                  stats: pl.BatchStats | None = None
                  ) -> List[List[SegmentHit]]:
        per_segment = [m.map_batch(batch, stats) for m in self.mappers]
        return merge_segment_hits(per_segment)

    def locate(self, hit: SegmentHit) -> Tuple[str, int]:
        """Segment-local offset -> (contig name, contig-local offset)."""
        gen = self.mappers[hit.segment].genome
        ci, off = gen.locate(hit.pos)
        return gen.names[int(ci)], int(off)

    def accumulate_coverage(self, hits_per_read, coverages=None):
        """Per-segment coverage arrays (create on first use)."""
        if coverages is None:
            coverages = [np.zeros(len(m.genome.codes)) for m in self.mappers]
        for hits in hits_per_read:
            for h in hits:
                coverages[h.segment][h.pos:h.pos + h.ref_len] += h.weight
        return coverages


def split_contigs(contigs: Sequence[Tuple[str, str]],
                  max_bases: int = (1 << 31) - (1 << 20)
                  ) -> List[List[Tuple[str, str]]]:
    """Greedy partition of contigs into segments under the int32 limit."""
    groups: List[List[Tuple[str, str]]] = [[]]
    size = 0
    for name, seq in contigs:
        if len(seq) > max_bases:
            raise ValueError(f"contig {name} alone exceeds the segment "
                             f"limit ({len(seq)} > {max_bases})")
        if size + len(seq) > max_bases and groups[-1]:
            groups.append([])
            size = 0
        groups[-1].append((name, seq))
        size += len(seq)
    return groups


# default per-segment size: int32-safe with headroom for window padding
# and index offsets
SEG_LIMIT = (1 << 31) - (1 << 24)


def segment_bounds(genome: builder.Genome,
                   max_bases: int = SEG_LIMIT,
                   n_segments: int = 0) -> List[Tuple[int, int]]:
    """Greedy CONTIG-ALIGNED partition of a global genome: returns
    [(ci_lo, ci_hi), ...) contig-index ranges whose concatenated codes
    (incl. trailing N spacers) each stay under ``max_bases``.  With
    ``n_segments`` > 0, targets that many segments instead (still
    contig-aligned, still capped at max_bases)."""
    n = len(genome.names)
    total = len(genome.codes)
    if n_segments > 0:
        max_bases = min(max_bases, max(-(-total // n_segments), 1))
    ends = np.concatenate([genome.starts[1:], [total]]).astype(np.int64)
    groups: List[Tuple[int, int]] = []
    lo = 0
    for ci in range(n):
        seg_len = int(ends[ci] - genome.starts[lo])
        if seg_len > max_bases and ci > lo:
            groups.append((lo, ci))
            lo = ci
        if int(ends[ci] - genome.starts[lo]) > SEG_LIMIT:
            raise ValueError(
                f"contig {genome.names[ci]} alone exceeds the int32 "
                f"segment limit")
    groups.append((lo, n))
    return groups


class GlobalSegmentedMapper:
    """Genome-of-any-size mapper (incl. > 2^31 bases — BASELINE.json
    config 5): the global genome is split into contig-aligned segments,
    each with its own int32 CSR index (the reference's genome-partitioned
    MPI mode, SURVEY.md §3.5), and per-segment hits merge back into GLOBAL
    int64 coordinates with union-renormalized posterior weights — the same
    frozen semantics as one unsegmented genome, because the retention
    threshold depends only on the read (tests/test_segments.py).

    Presents the TpuMapper ``submit``/``finish``/``map_batch``/``genome``
    surface, so ``pipeline.map_stream`` (SAM/SGR/SNP/checkpoints) and the
    CLI drive it unchanged.  Segment codes are VIEWS of the global codes
    array (no copies); each segment's mapper may itself be a sharded
    DistMapper (``mesh=``), composing genome partitioning with the
    reads x index device mesh.

    **Genome-partitioned multi-host mode** (``num_hosts`` > 1, the
    reference's RAM-bound MPI layout — SURVEY.md §3.5: genome partitioned
    across ranks, reads broadcast): host h builds mappers ONLY for the
    segments it owns (round-robin ``s % num_hosts == host_id``) and maps
    EVERY read batch against them.  Posterior weights stay globally exact:
    per-batch, each host's per-read retained-score sums allreduce
    (dist.multihost.allreduce_f64 — exact, the scores are integers far
    below 2^53) and every host normalizes its local hits by the GLOBAL
    total, so coverage contributions are bit-identical to the
    single-process segmented run; the final cross-host coverage reduce
    (each genome position is owned by exactly one host, peers contribute
    exact zeros) reproduces it byte-for-byte (tests/test_multihost.py).
    """

    def __init__(self, genome: builder.Genome, cfg: MapperConfig,
                 align_impl: str = "auto", max_bases: int = SEG_LIMIT,
                 n_segments: int = 0, mesh=None, finish_impl=None,
                 num_hosts: int = 1, host_id: int = 0,
                 interpret: bool = False):
        self.genome = genome
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.bounds = segment_bounds(genome, max_bases, n_segments)
        total = len(genome.codes)
        ends = np.concatenate([genome.starts[1:], [total]]).astype(np.int64)
        self.mappers = []
        self.bases: List[int] = []
        self.owned: List[int] = []
        for si, (ci_lo, ci_hi) in enumerate(self.bounds):
            if si % num_hosts != host_id:
                continue
            lo = int(genome.starts[ci_lo])
            hi = int(ends[ci_hi - 1])
            sub = builder.Genome(
                codes=genome.codes[lo:hi],
                names=list(genome.names[ci_lo:ci_hi]),
                starts=genome.starts[ci_lo:ci_hi] - lo,
                lengths=genome.lengths[ci_lo:ci_hi])
            index = (builder.build_bs_index(sub, cfg) if cfg.bisulfite
                     else builder.build_index(sub, cfg))
            if mesh is not None:
                from gnumap_tpu.dist.collectives import DistMapper
                m = DistMapper(sub, index, cfg, mesh, align_impl=align_impl,
                               finish_impl=finish_impl or "host",
                               interpret=interpret)
            else:
                m = pl.TpuMapper(sub, index, cfg, align_impl=align_impl,
                                 finish_impl=finish_impl,
                                 interpret=interpret)
            self.mappers.append(m)
            self.bases.append(lo)
            self.owned.append(si)

    @property
    def n_segments(self) -> int:
        """Total segments in the partition (across all hosts)."""
        return len(self.bounds)

    # -- TpuMapper-compatible surface (map_stream pipelines through it) --
    def submit(self, batch: ReadBatch):
        if not self.mappers or not hasattr(self.mappers[0], "submit"):
            return None                       # DistMapper: sync map_batch
        return [m.submit(batch) for m in self.mappers]

    def finish(self, batch: ReadBatch, futs,
               stats: "pl.BatchStats | None" = None):
        seg_stats = pl.BatchStats()
        if futs is None:
            per = [m.map_batch(batch, seg_stats) for m in self.mappers]
        else:
            per = [m.finish(batch, f, seg_stats)
                   for m, f in zip(self.mappers, futs)]
        totals = None
        g_mapped = g_multi = None
        if self.num_hosts > 1:
            # global per-read posterior denominators: exact f64 sums of
            # integer scores, reduced across hosts (see class docstring).
            # Per-read hit counts ride in the same allreduce so each
            # host's n_mapped/n_multi report GLOBAL reality, not just its
            # own segments' hits (r4 advisor: local-only counts understate
            # the mapped rate in genome-partitioned mode).  Counts need no
            # cross-host dedupe: segments partition the coordinate space,
            # so no two hosts can hold the same (pos, strand) hit.  A
            # third reduce (min) carries each read's smallest global
            # (pos, strand) key, deciding which host owns the PRIMARY SAM
            # record — the single-host rule "first hit in merged order"
            # made global.  Keys are exact in f64 (2*pos + strand << 2^53).
            from gnumap_tpu.dist import multihost
            BIGK = float(1 << 62)
            sam = self.cfg.sam_out
            loc = np.zeros((2, batch.n), np.float64)
            mk = np.full(batch.n, BIGK, np.float64)
            for base, seg_hits in zip(self.bases, per):
                for b, hits in enumerate(seg_hits):
                    for h in hits:
                        loc[0, b] += h.score
                        loc[1, b] += 1.0
                        if sam:
                            key = float(2 * (base + h.pos)
                                        + (h.strand == "-"))
                            if key < mk[b]:
                                mk[b] = key
            red = multihost.allreduce_f64(loc)
            # the min-key reduce decides SAM primary flags; skip it (and
            # the per-hit record assembly below) on coverage-only runs
            minkey = (multihost.allreduce_f64(mk, op="min") if sam
                      else None)
            totals = red[0]
            g_mapped = int((red[1] >= 1.0).sum())
            g_multi = int((red[1] >= 2.0).sum())
        out = self._merge_global(per, totals=totals, n=batch.n)
        if self.num_hosts > 1 and self.cfg.sam_out:
            # explicit primacy + the per-batch SAM metadata map_stream and
            # the CLI's genome-partitioned record merge consume (gp_sam is
            # re-set every batch; records are (read, key) in this host's
            # emission order; key -1 = the unmapped record host 0 emits
            # for globally-unmapped reads)
            mapped_g = red[1] >= 1.0
            recs: List[Tuple[int, int]] = []
            for b, hits in enumerate(out):
                for h in hits:
                    k = 2 * h.pos + (h.strand == "-")
                    h.primary = (k == int(minkey[b]))
                    recs.append((b, k))
                if not hits and not mapped_g[b] and self.host_id == 0:
                    recs.append((b, -1))
            self.gp_sam = {"mapped": mapped_g, "records": recs}
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += (g_mapped if g_mapped is not None
                               else sum(1 for hh in out if hh))
            stats.n_multi += (g_multi if g_multi is not None
                              else sum(1 for hh in out if len(hh) > 1))
            stats.n_candidates += seg_stats.n_candidates
            stats.dp_cells += seg_stats.dp_cells
            stats.dp_cells_banded += seg_stats.dp_cells_banded
            stats.device_s += seg_stats.device_s
            stats.host_s += seg_stats.host_s
        return out

    def map_batch(self, batch: ReadBatch,
                  stats: "pl.BatchStats | None" = None):
        return self.finish(batch, self.submit(batch), stats)

    def _merge_global(self, per_segment, totals=None,
                      n: "int | None" = None) -> List[List[pl.ReadHit]]:
        """Union per-read hits across (locally owned) segments in GLOBAL
        coordinates and renormalize weights over the union (frozen
        posterior semantics: w_i = s_i / sum over ALL retained loci).
        ``totals`` carries the cross-host global denominators in
        genome-partitioned multi-host mode."""
        if n is None:
            n = len(per_segment[0])
        out: List[List[pl.ReadHit]] = []
        for b in range(n):
            hits: List[pl.ReadHit] = []
            for base, seg_hits in zip(self.bases, per_segment):
                for h in seg_hits[b]:
                    hits.append(pl.ReadHit(h.strand, base + h.pos, h.score,
                                           0.0, h.cigar, h.ref_len))
            total = (float(totals[b]) if totals is not None
                     else float(sum(h.score for h in hits)))
            for h in hits:
                h.weight = h.score / total if total else 0.0
            hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
            out.append(hits)
        return out
