"""Multi-host CI without a cluster: two REAL ``jax.distributed`` CPU
processes on localhost (Gloo), asserting the merged outputs are
byte-identical to the single-process run (SURVEY.md §3.5 MPI analog)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gnumap_tpu.utils import sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cli(argv, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one local CPU device per process keeps the Gloo mesh simple
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "gnumap_tpu.cli.main"] + argv,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_matches_single(tmp_path):
    g = sim.random_genome(9000, seed=71, repeat_frac=0.03)
    sim.write_fasta(str(tmp_path / "g.fa"), [("chrM", g)])
    reads = sim.simulate_reads(g, 96, 40, seed=72, contig="chrM",
                               indel_rate=0.05)
    sim.write_fastq(str(tmp_path / "r.fq"), reads)

    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp"]

    # single-process reference
    p = _run_cli(["-o", str(tmp_path / "single")] + common)
    out, err = p.communicate(timeout=420)
    assert p.returncode == 0, err[-2000:]

    # two jax.distributed processes; 96 reads / B16 = 6 global batches,
    # 3 per host
    coord = f"localhost:{_free_port()}"
    procs = [
        _run_cli(["-o", str(tmp_path / "multi"), "--num-hosts", "2",
                  "--host-id", str(h), "--coordinator", coord] + common)
        for h in range(2)
    ]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]

    def body(p):
        return [l for l in open(p) if not l.startswith("@PG")]

    assert body(tmp_path / "single.sam") == body(tmp_path / "multi.sam")
    assert (tmp_path / "single.sgr").read_text() == \
           (tmp_path / "multi.sgr").read_text()
    assert (tmp_path / "single.sgrex").read_text() == \
           (tmp_path / "multi.sgrex").read_text()
    # shard temporaries are cleaned up by the merge
    assert not list(tmp_path.glob("multi.sam.host*"))


def test_two_process_segmented_matches_single(tmp_path):
    """Genome-partitioned multi-host mode (the
    reference's RAM-bound MPI layout, SURVEY.md §3.5): host h owns
    segment h, reads broadcast; per-read posterior denominators reduce
    across hosts.  Coverage/SNP tracks must be byte-identical to the
    single-process segmented run."""
    g = sim.random_genome(12_000, seed=91, repeat_frac=0.04)
    # two contigs so --segments 2 splits contig-aligned; reads simulated
    # per contig with contig-local truth
    sim.write_fasta(str(tmp_path / "g.fa"),
                    [("cA", g[:6000]), ("cB", g[6000:])])
    reads = (sim.simulate_reads(g[:6000], 48, 40, seed=92, contig="cA",
                                indel_rate=0.05)
             + sim.simulate_reads(g[6000:], 48, 40, seed=93, contig="cB"))
    sim.write_fastq(str(tmp_path / "r.fq"), reads)

    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp",
              "--segments", "2"]

    p = _run_cli(["-o", str(tmp_path / "single")] + common)
    out, err = p.communicate(timeout=420)
    assert p.returncode == 0, err[-2000:]

    coord = f"localhost:{_free_port()}"
    procs = [
        _run_cli(["-o", str(tmp_path / "multi"), "--num-hosts", "2",
                  "--host-id", str(h), "--coordinator", coord] + common)
        for h in range(2)
    ]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]

    def body(p):
        return [l for l in open(p) if not l.startswith("@PG")]

    # per-read SAM records are split across hosts in this mode; the
    # record-level merge must reproduce the single-process emission
    # byte-for-byte
    assert body(tmp_path / "single.sam") == body(tmp_path / "multi.sam")
    assert not list(tmp_path.glob("multi.sam.host*"))
    assert (tmp_path / "single.sgr").read_text() == \
           (tmp_path / "multi.sgr").read_text()
    assert (tmp_path / "single.sgrex").read_text() == \
           (tmp_path / "multi.sgrex").read_text()
    assert (tmp_path / "single.sgr").read_text().strip()


def test_two_process_checkpoint_restart(tmp_path):
    """Kill both hosts mid-run (fault injection), restart from per-host
    checkpoints: merged outputs byte-identical to the uninterrupted
    2-process run."""
    g = sim.random_genome(9000, seed=81, repeat_frac=0.03)
    sim.write_fasta(str(tmp_path / "g.fa"), [("chrR", g)])
    reads = sim.simulate_reads(g, 128, 40, seed=82, contig="chrR")
    sim.write_fastq(str(tmp_path / "r.fq"), reads)

    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp"]

    def run2(out, extra):
        coord = f"localhost:{_free_port()}"
        procs = [
            _run_cli(["-o", str(tmp_path / out), "--num-hosts", "2",
                      "--host-id", str(h), "--coordinator", coord]
                     + common + extra)
            for h in range(2)
        ]
        outs = [p.communicate(timeout=420) for p in procs]
        return [(p.returncode, err) for p, (_, err) in zip(procs, outs)]

    # uninterrupted 2-process reference
    for rc, err in run2("ref", []):
        assert rc == 0, err[-2000:]

    # interrupted: both hosts crash after 2 batches (each has 4)
    ck = str(tmp_path / "ck.npz")
    rcs = run2("out", ["--checkpoint", ck, "--checkpoint-every", "1",
                       "--fail-after", "2"])
    # the injected host exits 3; its peer dies on the broken coordination
    # channel — any nonzero exit counts as "killed mid-run"
    assert all(rc != 0 for rc, _ in rcs), rcs
    assert (tmp_path / "ck.npz.h0").exists() or         (tmp_path / "ck.npz.h1").exists()

    # restart: resume from checkpoints, run to completion
    for rc, err in run2("out", ["--checkpoint", ck,
                                "--checkpoint-every", "1"]):
        assert rc == 0, err[-2000:]

    def body(p):
        return [l for l in open(p) if not l.startswith("@PG")]

    assert body(tmp_path / "ref.sam") == body(tmp_path / "out.sam")
    assert (tmp_path / "ref.sgr").read_text() == \
           (tmp_path / "out.sgr").read_text()
    assert (tmp_path / "ref.sgrex").read_text() == \
           (tmp_path / "out.sgrex").read_text()
