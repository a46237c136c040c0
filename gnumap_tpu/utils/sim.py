"""Deterministic workload simulator: synthetic genomes + simulated reads.

The reference shipped small test genomes + simulated reads for its README
walkthroughs (SURVEY.md §4 [REPO?]; exact contents unverifiable — empty
mount), and the papers validate accuracy on simulated reads whose true origin
is known.  With no network egress we synthesize equivalent workloads: seeded
random genomes at phiX / E. coli / chr21 scale and reads that carry their
true origin in the read name (self-checking accuracy, SURVEY.md §4.3).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from gnumap_tpu.core import packing

_BASES = "ACGT"

# Scale stand-ins for the BASELINE.json workload ladder (no egress => no real
# phiX/E.coli/chr21 FASTA; sizes match, content is seeded-random).
PHIX_LEN = 5_386          # phiX-174 genome length
ECOLI_LEN = 4_641_652     # E. coli K-12 MG1655 length
CHR21_LEN = 46_709_983    # human chr21 length


def random_genome(length: int, seed: int = 0, repeat_frac: float = 0.0,
                  repeat_unit: int = 500) -> str:
    """Random DNA; optionally overwrite a fraction with tandem copies of one
    unit to exercise multi-map posterior weighting (BASELINE.json config 3)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.int8)
    if repeat_frac > 0:
        unit = rng.integers(0, 4, size=repeat_unit, dtype=np.int8)
        n_copies = int(length * repeat_frac) // repeat_unit
        spots = rng.integers(0, max(1, length - repeat_unit),
                             size=n_copies)
        for s in spots:
            codes[s:s + repeat_unit] = unit[:max(0, min(repeat_unit,
                                                        length - s))]
    return packing.decode(codes)


def random_genome_families(length: int, seed: int = 0,
                           n_families: int = 40, copies: int = 20,
                           unit_len: int = 300):
    """Random genome with moderate-multiplicity repeat FAMILIES: each
    family's unit is stamped ``copies`` times at random spots — the 5-50
    copy regime (within a sane max_hits_per_seed) where reads from a
    repeat retain every copy as a co-best locus and the fractional
    posterior actually exercises (a tandem repeat of thousands of copies
    only exceeds the seed cap).

    Returns (genome_str, spots) where spots[f] = sorted int array of
    family f's copy start positions (later stamps may overwrite earlier
    ones; reads sampled at a recorded spot still carry correct truth)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.int8)
    spots_all = []
    for _ in range(n_families):
        unit = rng.integers(0, 4, size=unit_len, dtype=np.int8)
        spots = rng.integers(0, max(1, length - unit_len), size=copies)
        for s in spots:
            codes[s:s + unit_len] = unit
        spots_all.append(np.sort(spots))
    return packing.decode(codes), spots_all


@dataclasses.dataclass
class SimRead:
    name: str       # encodes truth: sim_<idx>_<contig>_<pos0>_<strand>
    seq: str
    qual: str       # Phred+33
    true_pos: int   # 0-based position in contig
    true_strand: str


def simulate_reads(genome: str, n_reads: int, read_len: int, seed: int = 1,
                   sub_rate: float = 0.01, contig: str = "chr",
                   qual_lo: int = 20, qual_hi: int = 40,
                   indel_rate: float = 0.0,
                   bisulfite: bool = False,
                   methylation_rate: float = 0.2,
                   positions=None) -> List[SimRead]:
    """Uniform sampling of both strands with quality-correlated base errors;
    ``indel_rate`` = per-read probability of one 1-2bp insertion or deletion
    (exercises gapped-alignment CIGARs end to end).  ``bisulfite`` converts
    unmethylated fragment Cs to T before strand flip (the GNUMAP-bs
    workload: read T over genome C on +, read A over genome G on -);
    ``methylation_rate`` of Cs stay protected.  ``positions`` (optional
    int array) restricts start-position sampling to those values — used
    to plant reads inside repeat-family copies (multi-map stress)."""
    rng = np.random.default_rng(seed)
    g = packing.encode(genome)
    G = len(g)
    assert G >= read_len
    reads: List[SimRead] = []
    for idx in range(n_reads):
        if positions is not None:
            pos = int(positions[int(rng.integers(0, len(positions)))])
            pos = min(pos, G - read_len - 4)
        else:
            pos = int(rng.integers(0, G - read_len - 4 + 1))
        strand = "+" if rng.random() < 0.5 else "-"
        frag = g[pos:pos + read_len].copy()
        if indel_rate > 0 and rng.random() < indel_rate and read_len > 12:
            p = int(rng.integers(4, read_len - 6))
            k = int(rng.integers(1, 3))
            if rng.random() < 0.5:    # deletion from the read's genome copy
                ext = g[pos + read_len:pos + read_len + k]
                frag = np.concatenate([frag[:p], frag[p + k:], ext])
            else:                     # insertion of random bases
                ins = rng.integers(0, 4, size=k).astype(np.int8)
                frag = np.concatenate([frag[:p], ins, frag[p:]])[:read_len]
        if bisulfite:
            # '+' reads come from the converted + template (C->T); '-'
            # reads from the converted - template, which in + coordinates
            # is G->A (the read itself is the revcomp of that)
            if strand == "+":
                src, dst = np.int8(1), np.int8(3)
            else:
                src, dst = np.int8(2), np.int8(0)
            convert = (frag == src) & (rng.random(len(frag))
                                       >= methylation_rate)
            frag = np.where(convert, dst, frag)
        if strand == "-":
            frag = packing.revcomp(frag)
        quals = rng.integers(qual_lo, qual_hi + 1, size=read_len)
        # substitution errors, biased to low-quality positions
        err = rng.random(read_len) < sub_rate * (qual_hi + 1 - quals) / (
            qual_hi + 1 - qual_lo)
        shift = rng.integers(1, 4, size=read_len)
        frag = np.where(err, (frag + shift) % 4, frag).astype(np.int8)
        reads.append(SimRead(
            name=f"sim_{idx}_{contig}_{pos}_{strand}",
            seq=packing.decode(frag),
            qual="".join(chr(33 + int(q)) for q in quals),
            true_pos=pos, true_strand=strand))
    return reads


def write_fasta(path: str, contigs: List[Tuple[str, str]], width: int = 70):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


def write_fastq(path: str, reads: List[SimRead]):
    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")


def parse_truth(name: str) -> Tuple[str, int, str]:
    """Read name -> (contig, true_pos, strand) for self-checking accuracy."""
    parts = name.split("_")
    # contig names may themselves contain underscores; parse from the right
    return "_".join(parts[2:-2]), int(parts[-2]), parts[-1]
