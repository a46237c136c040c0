#!/usr/bin/env python
""">2^31-base genome demonstration (BASELINE.json:11): build a ~2.6 Gbp
multi-contig synthetic genome, map reads through the CLI's
GlobalSegmentedMapper path on the device, and record per-segment index
build time, device residency, host RSS, accuracy and throughput to a JSON
file (--out, default scale3g.json in the work directory).

The genome deliberately exceeds int32 addressing (2.6e9 > 2^31), so the
run only works through the contig-aligned segment machinery
(dist/segments.py): per-segment int32 CSR indexes, global int64
coordinates, union-renormalized posteriors.

Usage:  python tools/scale3g.py [--gbases 2.6] [--reads 200000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LUT = np.frombuffer(b"ACGT", np.uint8)


def gen_genome(fa_path: str, total: int, n_contigs: int, seed: int = 0):
    """Chunked FASTA generation (no multi-GB Python strings)."""
    rng = np.random.default_rng(seed)
    clen = total // n_contigs
    lens = [clen] * (n_contigs - 1) + [total - clen * (n_contigs - 1)]
    with open(fa_path, "wb") as f:
        for ci, L in enumerate(lens):
            f.write(b">ctg%02d\n" % ci)
            done = 0
            while done < L:
                n = min(70 * 1_000_000, L - done)
                codes = rng.integers(0, 4, size=n, dtype=np.int8)
                block = LUT[codes]
                # 70-column wrapping via a padded reshape
                pad = (-len(block)) % 70
                if pad:
                    block = np.concatenate(
                        [block, np.full(pad, ord(" "), np.uint8)])
                wrapped = np.concatenate(
                    [block.reshape(-1, 70),
                     np.full((len(block) // 70, 1), ord("\n"), np.uint8)],
                    axis=1).tobytes().replace(b" ", b"")
                f.write(wrapped)
                done += n
    return lens


def gen_reads(fa_path: str, fq_path: str, lens, n_reads: int,
              read_len: int, seed: int = 9):
    """Vectorized FASTQ with contig-local truth in the names.  Re-derives
    each contig's codes from the same RNG stream used by gen_genome."""
    rng = np.random.default_rng(seed)
    # per-contig read counts proportional to length
    tot = sum(lens)
    counts = [int(n_reads * L / tot) for L in lens]
    counts[-1] += n_reads - sum(counts)
    grng = np.random.default_rng(0)          # regenerate contig codes
    idx = 0
    with open(fq_path, "wb") as f:
        for ci, (L, cnt) in enumerate(zip(lens, counts)):
            # rebuild this contig's codes chunk-aligned with gen_genome
            parts = []
            done = 0
            while done < L:
                n = min(70 * 1_000_000, L - done)
                parts.append(grng.integers(0, 4, size=n, dtype=np.int8))
                done += n
            g = np.concatenate(parts) if len(parts) > 1 else parts[0]
            pos = rng.integers(0, L - read_len - 4, size=cnt)
            minus = rng.random(cnt) < 0.5
            frag = g[pos[:, None] + np.arange(read_len)[None, :]]
            rc = 3 - frag[:, ::-1]
            frag = np.where(minus[:, None], rc, frag)
            err = rng.random((cnt, read_len)) < 0.01
            shift = rng.integers(1, 4, size=(cnt, read_len))
            frag = np.where(err, (frag + shift) % 4, frag)
            quals = (33 + rng.integers(20, 41,
                                       size=(cnt, read_len))).astype(np.uint8)
            sv = LUT[frag].view("S%d" % read_len)[:, 0]
            qv = quals.view("S%d" % read_len)[:, 0]
            rows = []
            for i in range(cnt):
                st = b"-" if minus[i] else b"+"
                rows.append(b"@sim_%d_ctg%02d_%d_%s\n%s\n+\n%s\n"
                            % (idx + i, ci, pos[i], st, sv[i], qv[i]))
            f.write(b"".join(rows))
            idx += cnt
            del g


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbases", type=float, default=2.6)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--contigs", type=int, default=26)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--mer", type=int, default=13)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "gnumap_3g"),
                    help="inputs and outputs (default: TMPDIR/gnumap_3g)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default: WORKDIR/scale3g.json)")
    args = ap.parse_args()

    from tools.scale_run import run_cli  # noqa: E402  (RSS-sampling runner)

    os.makedirs(args.workdir, exist_ok=True)
    if args.out is None:
        args.out = os.path.join(args.workdir, "scale3g.json")
    total = int(args.gbases * 1e9)
    if total <= (1 << 31) and not os.environ.get("SCALE3G_SMOKE"):
        raise SystemExit("the point is to exceed int32 addressing "
                         "(set SCALE3G_SMOKE=1 for CI-scale smoke runs)")
    fa = os.path.join(args.workdir, "genome3g.fa")
    fq = os.path.join(args.workdir, "reads3g.fq")
    t0 = time.perf_counter()
    if not (os.path.exists(fa)
            and os.path.getsize(fa) > total):
        lens = gen_genome(fa, total, args.contigs)
        gen_reads(fa, fq, lens, args.reads, args.read_len)
    gen_s = time.perf_counter() - t0

    rss = [0]
    t1 = time.perf_counter()
    done = run_cli(["-g", fa, fq, "-o", os.path.join(args.workdir, "out"),
                    "-m", str(args.mer), "-j", "5", "-L", "104",
                    "-B", str(args.batch_size), "-q", "32", "-k", "64",
                    "--segments", str(args.segments), "--no-sgr",
                    "-v"], rss)
    wall = time.perf_counter() - t1

    # accuracy: SAM primary records vs the truth encoded in read names
    ok = tot = 0
    with open(os.path.join(args.workdir, "out.sam")) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.split("\t", 6)
            flag = int(fld[1])
            if flag & 4 or flag & 256:
                continue
            tot += 1
            name = fld[0].split("_")
            tc, tp, ts = "_".join(name[2:-2]), int(name[-2]), name[-1]
            strand = "-" if flag & 16 else "+"
            if (fld[2] == tc and abs(int(fld[3]) - 1 - tp) <= 3
                    and strand == ts):
                ok += 1

    # device residency estimate: per-segment CSR + int8 genome
    seg = total // args.segments
    residency = {
        "positions_bytes_total": total * 4,
        "bucket_start_bytes_per_segment": (4 ** args.mer + 1) * 4,
        "genome_bytes_total": total,
        "est_total_gb": round((total * 4 + total
                               + args.segments * (4 ** args.mer + 1) * 4)
                              / 1e9, 2),
    }
    result = {
        "workload": {"genome_bases": total, "contigs": args.contigs,
                     "segments": args.segments, "reads": args.reads,
                     "read_len": args.read_len, "gen_s": round(gen_s, 1),
                     "fastq_bytes": os.path.getsize(fq),
                     "fasta_bytes": os.path.getsize(fa)},
        "cli": done,
        "wall_s": round(wall, 1),
        "index_s": done.get("index_s"),
        "peak_rss_mb": rss[0] // 1024,
        "accuracy_primary": round(ok / max(tot, 1), 4),
        "primaries": tot,
        "device_residency": residency,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
