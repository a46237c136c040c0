"""Multi-host execution: the reference's MPI layer on jax.distributed.

Reference analog (SURVEY.md §3.5, [PAPER-parallel]): ``mpirun -np R gnumap``
— each rank loads the genome, maps its 1/R of the reads, coverage arrays
``MPI_Reduce`` to rank 0, SAM chunks gathered and merged at rank 0.

Re-design:

  * process groups come from ``jax.distributed.initialize()`` (the
    coordination service; collectives between processes);
  * reads partition by FILE BYTE RANGE for plain single-FASTQ input: host
    h parses only bytes [h/R, (h+1)/R) of the file (record-aligned by
    fastq_ranges), so per-host parse cost is size/R — the reference's MPI
    read partitioning without a splitting step.  Multi-file or prb/int
    inputs fall back to BATCH-stride partitioning (host h keeps global
    batches h, h+R, ...), which parses everything everywhere but needs no
    byte math;
  * the coverage/tally merge is a CHUNKED XLA ``all_gather`` of the float64
    BIT PATTERN (uint32 view — no arithmetic on the wire) followed by a
    host-ordered summation per chunk at every host: bit-reproducible
    regardless of reduction topology, peak extra RSS bounded by
    R x chunk (not R x genome), and
    byte-identical to a single-process run whenever the per-position
    weight sums are exactly representable (the deterministic MPI_Reduce
    analog);
  * SAM shards are written per host with per-batch byte offsets and merged
    by GLOBAL batch index at host 0 over the shared filesystem (the
    reference's per-thread-buffer merge, rank-0 gather).

CI: tests/test_multihost.py runs two ``jax.distributed`` CPU processes on
localhost and asserts SAM + SGR byte-identical to the single-process run.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, List, Tuple

import numpy as np


def initialize(coordinator: str, num_hosts: int, host_id: int) -> None:
    """jax.distributed process-group init (call before any device use).

    With a localhost coordinator every process runs on this machine, so
    process h takes local device h alone (one card per process; without
    this every process would reserve memory on every card).  A remote
    coordinator means one process per machine, using all its devices."""
    import jax
    host = coordinator.rsplit(":", 1)[0]
    local = host in ("localhost", "127.0.0.1", "::1", "[::1]")
    jax.distributed.initialize(coordinator, num_processes=num_hosts,
                               process_id=host_id,
                               local_device_ids=[host_id] if local else None)


def strided(batches: Iterable, num_hosts: int, host_id: int) -> Iterator:
    """Host h's read partition: global batches h, h+R, h+2R, ..."""
    for i, b in enumerate(batches):
        if i % num_hosts == host_id:
            yield b


def allreduce_f64(local: np.ndarray,
                  chunk_elems: int = 8 << 20,
                  op: str = "sum") -> np.ndarray:
    """Deterministic cross-host float64 reduce (the MPI_Reduce analog);
    ``op`` = "sum" or "min".

    Chunked all_gather of the uint32 bit view (exact), then an explicitly
    host-ordered reduction per chunk — every host computes the identical
    result, and peak transient memory is R x chunk (64 MiB per peer at
    the default chunk), independent of array size.  Chunking cannot change
    any bit: each element is still reduced host 0..R-1 in order."""
    from jax.experimental import multihost_utils
    shape = local.shape
    flat = np.ascontiguousarray(local, dtype=np.float64).reshape(-1)
    out = np.empty_like(flat)
    for lo in range(0, max(flat.size, 1), chunk_elems):
        part = flat[lo:lo + chunk_elems]
        if part.size == 0:
            break
        bits = part.view(np.uint32)[None]
        g = np.asarray(multihost_utils.process_allgather(bits))
        parts = np.ascontiguousarray(
            g.reshape(g.shape[0], -1)).view(np.float64)
        acc = parts[0].copy()
        for r in range(1, parts.shape[0]):
            if op == "min":
                np.minimum(acc, parts[r], out=acc)
            else:
                acc += parts[r]
        out[lo:lo + chunk_elems] = acc
    return out.reshape(shape)


def _next_record_start(f, off: int, limit: int = 1 << 20) -> int:
    """Byte offset of the first FASTQ record starting at or after ``off``.

    A record start is a line beginning with '@' whose line+2 begins with
    '+' (quality lines that begin with '@' fail that check because two
    lines later is the NEXT record's sequence line, never '+')."""
    f.seek(off)
    win = f.read(limit)
    lines = win.split(b"\n")
    # byte offset of each line start within the window
    pos = 0
    starts = []
    for ln in lines:
        starts.append(pos)
        pos += len(ln) + 1
    first = 0 if off == 0 else 1          # skip the partial first line
    for i in range(first, len(lines) - 2):
        if lines[i].startswith(b"@") and lines[i + 2].startswith(b"+"):
            return off + starts[i]
    return off + len(win)                  # no record in window (EOF tail)


def fastq_ranges(path: str, num_hosts: int) -> List[Tuple[int, int]]:
    """Record-aligned byte ranges partitioning one FASTQ file across hosts.

    Every byte belongs to exactly one host (all hosts compute the same
    boundaries), and host ranges are contiguous in file order, so the
    host-major merge reproduces the single-process read order."""
    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for h in range(1, num_hosts):
            cuts.append(min(size, _next_record_start(
                f, h * size // num_hosts)))
    cuts.append(size)
    return [(cuts[h], cuts[h + 1]) for h in range(num_hosts)]


def barrier(name: str) -> None:
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def shard_paths(output: str, host_id: int) -> Tuple[str, str]:
    return (f"{output}.sam.host{host_id}",
            f"{output}.sam.host{host_id}.idx")


def write_shard_index(idx_path: str,
                      spans: List[Tuple[int, int, int, int]]) -> None:
    """spans: (order_major, order_minor, byte_start, byte_end) per batch.
    Stride partitioning orders by (global_batch=k*R+h,); byte-range
    partitioning by (host, local_batch) — both encoded as (major, minor)."""
    with open(idx_path, "w") as f:
        for row in spans:
            f.write(json.dumps(row) + "\n")


def merge_sam_shards_gp(output: str, num_hosts: int, header: str) -> None:
    """Host-0 SAM merge for the GENOME-PARTITIONED mode: a read's records
    are split across hosts (host h owns segments h, h+R, ...), so the
    merge interleaves at RECORD granularity.  Each host's shard holds its
    records in (global batch, read, (2*pos + strand) key) order and its
    index file carries one (batch, read, key) row per record, aligned 1:1
    with the shard's lines; coordinates partition across hosts, so keys
    never tie and the merged order is exactly the single-process
    segmented emission order (read-ascending, hits by (pos, strand)).
    Whole shards are held in memory — fine for the RAM-bound mode this
    serves (records ~ reads, and reads already fit every host's RAM by
    assumption)."""
    per_host_lines = []
    rows = []
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        with open(body, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        with open(idx) as f:
            meta = [json.loads(line) for line in f]
        if len(lines) != len(meta):
            raise RuntimeError(
                f"gp shard {h}: {len(lines)} records vs "
                f"{len(meta)} index rows")
        for i, (bt, rd, key) in enumerate(meta):
            rows.append((bt, rd, key, h, i))
        per_host_lines.append(lines)
    rows.sort()
    with open(output + ".sam", "wb") as out:
        out.write(header.encode())
        for bt, rd, key, h, i in rows:
            out.write(per_host_lines[h][i])
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        os.remove(body)
        os.remove(idx)


def merge_sam_shards(output: str, num_hosts: int, header: str) -> None:
    """Host-0 merge: interleave per-batch shard chunks by their global
    order key, producing the same record order as a single-process run."""
    chunks = []   # (major, minor, host, start, end)
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        with open(idx) as f:
            for line in f:
                maj, mino, s, e = json.loads(line)
                chunks.append((maj, mino, h, s, e))
    chunks.sort()
    handles = [open(shard_paths(output, h)[0], "rb")
               for h in range(num_hosts)]
    try:
        with open(output + ".sam", "wb") as out:
            out.write(header.encode())
            for maj, mino, h, s, e in chunks:
                handles[h].seek(s)
                out.write(handles[h].read(e - s))
    finally:
        for f in handles:
            f.close()
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        os.remove(body)
        os.remove(idx)
