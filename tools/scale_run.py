#!/usr/bin/env python
"""Sustained-scale run (BASELINE.json:8): one config-2-scale run with N
reads (default 1M) through the REAL CLI with SAM output and checkpoints on,
recording sustained reads/s, peak RSS, and checkpoint overhead to a JSON
artifact (default: scale.json in the work directory).

Usage:  python tools/scale_run.py [--reads 1000000] [--out PATH]

The workload is generated streaming to disk (FASTA + FASTQ), then the CLI
runs as a subprocess whose /proc RSS is sampled — one CLI child at a time,
so it alone holds the accelerator; reads/s is end-to-end
mapping wall (the CLI's own map_s, which excludes index build), and
checkpoint overhead is measured as (checkpointed run wall - plain run
map_s) on the same process' steady state -- both runs' stats are recorded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def gen_workload(td: str, n_reads: int, genome_len: int, read_len: int):
    """Vectorized streaming FASTQ generation (10M reads ~ 2.5 GB in ~1-2
    min; the old per-read loop cost ~50 us/read — 8+ min at 10M)."""
    from gnumap_tpu.core import packing
    from gnumap_tpu.utils import sim

    genome = sim.random_genome(genome_len, seed=0)
    fa = os.path.join(td, "genome.fa")
    fq = os.path.join(td, "reads.fq")
    sim.write_fasta(fa, [("ref_sim", genome)])
    g = packing.encode(genome)
    G = len(g)
    rng = np.random.default_rng(7)
    chunk = 131072
    lut = np.frombuffer(b"ACGTN", np.uint8)
    rl = read_len
    with open(fq, "wb") as f:
        done = 0
        while done < n_reads:
            n = min(chunk, n_reads - done)
            pos = rng.integers(0, G - rl - 4, size=n)
            minus = rng.random(n) < 0.5
            frag = g[pos[:, None] + np.arange(rl)[None, :]]
            rc = 3 - frag[:, ::-1]
            frag = np.where(minus[:, None], rc, frag)
            err = rng.random((n, rl)) < 0.01
            shift = rng.integers(1, 4, size=(n, rl))
            frag = np.where(err, (frag + shift) % 4, frag)
            quals = rng.integers(20, 41, size=(n, rl))
            seq_b = lut[frag]                       # (n, rl) uint8
            qual_b = (33 + quals).astype(np.uint8)
            rows = []
            sv = seq_b.view("S%d" % rl)[:, 0]
            qv = qual_b.view("S%d" % rl)[:, 0]
            for i in range(n):
                st = "+" if not minus[i] else "-"
                rows.append(b"@sim_%d_ref_sim_%d_%s\n%s\n+\n%s\n"
                            % (done + i, pos[i], st.encode(),
                               sv[i], qv[i]))
            f.write(b"".join(rows))
            done += n
    return fa, fq


def run_cli(argv, rss_holder):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m", "gnumap_tpu.cli.main"]
                         + argv, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)

    def sample():
        peak = 0
        while p.poll() is None:
            try:
                with open(f"/proc/{p.pid}/status") as f:
                    for line in f:
                        if line.startswith("VmRSS:"):
                            peak = max(peak, int(line.split()[1]))
            except OSError:
                break
            time.sleep(0.5)
        rss_holder[0] = max(rss_holder[0], peak)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    out, err = p.communicate()
    th.join(timeout=5)
    if p.returncode != 0:
        sys.stderr.write(err[-3000:])
        raise SystemExit(f"CLI failed rc={p.returncode}")
    done = [json.loads(l) for l in out.splitlines()
            if l.startswith("{")][-1]
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--genome-len", type=int, default=4_641_652)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--out", default=None,
                    help="result JSON (default: WORKDIR/scale.json)")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "gnumap_scale"),
                    help="inputs and outputs (default: TMPDIR/gnumap_scale)")
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--mer", type=int, default=12)
    ap.add_argument("--sgr", action="store_true",
                    help="emit the SGR coverage track (BASELINE config 3)")
    ap.add_argument("--checkpoint-every", type=int, default=16)
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    if args.out is None:
        args.out = os.path.join(args.workdir, "scale.json")
    t0 = time.perf_counter()
    fa = os.path.join(args.workdir, "genome.fa")
    fq = os.path.join(args.workdir, "reads.fq")
    if not (os.path.exists(fq)
            and os.path.getsize(fq) > args.reads * 100 * 2):
        fa, fq = gen_workload(args.workdir, args.reads, args.genome_len,
                              args.read_len)
    gen_s = time.perf_counter() - t0

    common_opts = ["-m", str(args.mer), "-j", "5", "-L", "104",
                   "-B", str(args.batch_size), "-q", "32", "-k", "8"]
    if not args.sgr:
        common_opts.append("--no-sgr")
    common = ["-g", fa, fq] + common_opts

    # warmup: a 16k-read slice through the same program shapes, so the
    # timed runs hit the terminal's compile cache instead of paying the
    # multi-minute remote compile inside map_s
    warm_fq = os.path.join(args.workdir, "warm.fq")
    with open(fq) as src, open(warm_fq, "w") as dst:
        for i, line in enumerate(src):
            if i >= 4 * 16384:
                break
            dst.write(line)
    run_cli(["-g", fa, warm_fq, "-o", os.path.join(args.workdir, "warm")]
            + common_opts, [0])

    # run 1: SAM on, no checkpoints (the end-to-end number)
    rss1 = [0]
    t1 = time.perf_counter()
    done1 = run_cli(["-o", os.path.join(args.workdir, "plain")] + common,
                    rss1)
    wall1 = time.perf_counter() - t1

    # run 2: SAM + checkpoints every 16 batches (checkpoint overhead)
    rss2 = [0]
    ck = os.path.join(args.workdir, "ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    t2 = time.perf_counter()
    done2 = run_cli(["-o", os.path.join(args.workdir, "ckpt"),
                     "--checkpoint", ck,
                     "--checkpoint-every", str(args.checkpoint_every)]
                    + common, rss2)
    wall2 = time.perf_counter() - t2

    sam_bytes = os.path.getsize(os.path.join(args.workdir, "plain.sam"))
    result = {
        "workload": {"reads": args.reads, "read_len": args.read_len,
                     "genome_len": args.genome_len,
                     "fastq_bytes": os.path.getsize(fq),
                     "gen_s": round(gen_s, 1)},
        "plain": {**done1, "wall_s": round(wall1, 1),
                  "peak_rss_mb": rss1[0] // 1024,
                  "sam_bytes": sam_bytes},
        "checkpointed": {**done2, "wall_s": round(wall2, 1),
                         "peak_rss_mb": rss2[0] // 1024},
        "sustained_reads_per_s": done1["reads_per_s"],
        "checkpoint_overhead_pct": round(
            100.0 * (done2["map_s"] - done1["map_s"])
            / max(done1["map_s"], 1e-9), 1),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
