"""Sharded mapper step + coverage all-reduce (SURVEY.md §2 / §5
"Distributed communication backend").

The reference's MPI layer (read partitioning, genome-partitioned index,
final MPI_Reduce of coverage — SURVEY.md §3.5) re-designed as XLA
collectives inside one shard_map'd device program:

  * reads sharded over axis "reads": seeding + DP are embarrassingly
    parallel per shard (no communication), exactly like the reference's
    default read-partitioned mode;
  * index sharded by k-mer range over axis "index" (config 5): every device
    in an index group holds the same reads block and one CSR shard.  Each
    device looks up only the k-mers it owns (one integer divide routes a
    query — k-mer codes are range-partitioned, no hashing) and the hit
    tables are merged with ONE psum over "index" (+1 encoding so missing
    hits are the additive identity).  Candidate slots are then split
    round-robin across the index group so the DP cost is divided by the
    number of index shards, and scores are re-joined with a tiled
    all_gather;
  * coverage arrays merge with psum over both axes (the MPI_Reduce analog,
    BASELINE.json:5 "cross-host posterior merge").
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gnumap_tpu.align import nw_ref, scoring
from gnumap_tpu.align.select import resolve_align_impl
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.dist.mesh import INDEX_AXIS, READS_AXIS
from gnumap_tpu.index import store
from gnumap_tpu.index.builder import CsrIndex, Genome
from gnumap_tpu.pipeline import mapper as pipeline_mapper
from gnumap_tpu.pipeline.mapper import (SENTINEL, csr_hits, dedupe_cap,
                                        seed_kmers, strand_expand)

P = jax.sharding.PartitionSpec


class DistMapper:
    """Sharded device map: reads over "reads", CSR index over "index".

    Host finishing (threshold/traceback/posterior/SAM) reuses
    TpuMapper.finish logic per reads-shard; in a multi-host deployment each
    host finishes its own shard and coverage merges via
    ``allreduce_coverage``.
    """

    def __init__(self, genome: Genome, index, cfg: MapperConfig,
                 mesh: jax.sharding.Mesh, align_impl: str = "auto",
                 finish_impl: str = "host", interpret: bool = False):
        from gnumap_tpu.index.builder import BsIndexPair
        self.bisulfite = isinstance(index, BsIndexPair)
        if cfg.bisulfite != self.bisulfite:
            raise ValueError("bisulfite mode requires (exactly) the "
                             "builder.build_bs_index collapsed pair")
        self.cfg = cfg
        self.mesh = mesh
        self.align_impl = resolve_align_impl(align_impl, interpret)
        self._interpret = interpret
        self.genome = genome
        R = mesh.shape[READS_AXIS]
        S = mesh.shape[INDEX_AXIS]
        self.S = S
        if cfg.max_candidates % (S * 8):
            raise ValueError("max_candidates must divide by 8*index_shards")
        L, m = cfg.max_read_len, cfg.mer_size
        self.offsets = np.arange(0, L - m + 1, cfg.seed_jump, dtype=np.int32)
        S_plus, S_minus = scoring.matrices_for_mode(cfg)
        tables = [index.plus, index.minus] if self.bisulfite else [index]
        self.n_buckets = tables[0].n_buckets

        repl = jax.sharding.NamedSharding(mesh, P())
        idx_shard0 = jax.sharding.NamedSharding(mesh, P(INDEX_AXIS))
        self._idx_dev = []
        for tab in tables:
            if S > 1:
                shards = store.shard_index(tab, S)
                pmax = max(len(sh.positions) for sh in shards)
                bs = np.stack([sh.bucket_start for sh in shards])
                ps = np.stack([np.pad(sh.positions,
                                      (0, pmax - len(sh.positions)))
                               for sh in shards])
                self._idx_dev += [jax.device_put(bs, idx_shard0),
                                  jax.device_put(ps, idx_shard0)]
            else:
                self._idx_dev += [
                    jax.device_put(tab.bucket_start[None], repl),
                    jax.device_put(tab.positions[None], repl)]
        self.bucket_start, self.positions = self._idx_dev[:2]
        self.S_plus = jax.device_put(S_plus, repl)
        self.S_minus = jax.device_put(S_minus, repl)
        # the int8 genome, passed as a shard_map ARGUMENT (replicated)
        self._g_args = (jax.device_put(genome.codes, repl),)

        self.finish_impl = finish_impl
        idx_specs = (P(INDEX_AXIS), P(INDEX_AXIS)) * len(tables)
        in_specs = (P(READS_AXIS), P(READS_AXIS), P(READS_AXIS),
                    *idx_specs, P(), P(), *((P(),) * len(self._g_args)))
        out_specs = (P(READS_AXIS), P(READS_AXIS), P(READS_AXIS),
                     P(READS_AXIS))
        fn = jax.shard_map(self._shard_fn, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        self._step = jax.jit(fn)
        # device-finish variant: the whole single-chip device tail
        # (retention + compaction + traceback + flat blob) runs
        # inside each reads-shard; every host then decodes only its own
        # shard's blob — no DP on any host (multi-host parity with
        # TpuMapper's finish_impl='device')
        fn_tb = jax.shard_map(self._shard_fn_tb, mesh=mesh,
                              in_specs=in_specs,
                              out_specs=P(READS_AXIS), check_vma=False)
        self._step_tb = jax.jit(fn_tb)

    # ------------------------------------------------------------------
    def _dp_scores(self, emis2, cands, lens2, g_args):
        """Local DP over this device's candidate slots.  ``g_args`` are
        this shard's (replicated) genome arrays, threaded as arguments —
        never captured at trace time."""
        return pipeline_mapper.dp_scores(self.cfg, self.align_impl, emis2,
                                         cands, lens2, g_args[0],
                                         self._interpret)

    def _route_hits(self, km, bad, bucket_start, positions):
        """Seed lookup on the (possibly k-mer-range-sharded) CSR table;
        with index shards, each device looks up only the codes it owns and
        the hit tables merge with one psum (+offset encoding: SENTINEL ->
        0, the additive identity)."""
        cfg = self.cfg
        if self.S > 1:
            s_idx = jax.lax.axis_index(INDEX_AXIS)
            Q = -(-self.n_buckets // self.S)
            owned = (km // Q == s_idx) & (~bad)
            km_local = jnp.where(owned, km - s_idx * Q, 0)
            cand = csr_hits(km_local, ~owned, bucket_start[0], positions[0],
                            self.offsets, cfg)
            off = cfg.max_read_len + 1
            enc = jnp.where(cand == SENTINEL, 0, cand + off)
            enc = jax.lax.psum(enc, INDEX_AXIS)
            return jnp.where(enc == 0, SENTINEL, enc - off)
        return csr_hits(km, bad, bucket_start[0], positions[0],
                        self.offsets, cfg)

    def _shard_fn(self, codes, pwm_q, lens, *rest):
        cands, valid, scores, max_sc, _, _ = self._shard_core(
            codes, pwm_q, lens, *rest)
        return cands, valid, scores, max_sc

    def _shard_fn_tb(self, codes, pwm_q, lens, *rest):
        from gnumap_tpu.pipeline.mapper import device_tb_tail
        n_idx = 4 if self.bisulfite else 2
        g_codes = rest[n_idx + 2]
        cands, valid, scores, max_sc, emis2, lens2 = self._shard_core(
            codes, pwm_q, lens, *rest)
        return device_tb_tail(self.cfg, cands, valid, scores, max_sc,
                              emis2, lens2, g_codes)

    def _shard_core(self, codes, pwm_q, lens, *rest):
        cfg = self.cfg
        S = self.S
        n_idx = 4 if self.bisulfite else 2
        idx_arrs = rest[:n_idx]
        S_plus, S_minus, *g_args = rest[n_idx:]
        codes2, emis2 = strand_expand(codes, pwm_q, lens, S_plus, S_minus)
        lens2 = jnp.concatenate([lens, lens], axis=0)
        max_sc = nw_ref.max_read_scores(emis2)
        if self.bisulfite:
            # per-strand collapsed base-3 seeding (GNUMAP-bs [FROZEN]),
            # each half routed on its own sharded collapsed table
            from gnumap_tpu.index.builder import BS_DIGITS
            from gnumap_tpu.pipeline.mapper import seed_kmers_b3
            B = codes.shape[0]
            kmp, badp = seed_kmers_b3(
                codes2[:B], self.offsets, cfg.mer_size,
                jnp.asarray(BS_DIGITS["ct"], jnp.int32))
            kmm, badm = seed_kmers_b3(
                codes2[B:], self.offsets, cfg.mer_size,
                jnp.asarray(BS_DIGITS["ga"], jnp.int32))
            cand = jnp.concatenate([
                self._route_hits(kmp, badp, idx_arrs[0], idx_arrs[1]),
                self._route_hits(kmm, badm, idx_arrs[2], idx_arrs[3])],
                axis=0)
        else:
            km, bad = seed_kmers(codes2, self.offsets, cfg.mer_size)
            cand = self._route_hits(km, bad, idx_arrs[0], idx_arrs[1])
        cands = dedupe_cap(cand, cfg.max_candidates)
        if S > 1:
            # split candidate slots across the index group: DP cost / S
            s_idx = jax.lax.axis_index(INDEX_AXIS)
            Cs = cfg.max_candidates // S
            my = jax.lax.dynamic_slice_in_dim(cands, s_idx * Cs, Cs, axis=1)
            sc = self._dp_scores(emis2, my, lens2, g_args)
            scores = jax.lax.all_gather(sc, INDEX_AXIS, axis=1, tiled=True)
        else:
            scores = self._dp_scores(emis2, cands, lens2, g_args)
        valid = cands != SENTINEL
        scores = jnp.where(valid, scores, NEG_INF)
        return cands, valid, scores, max_sc, emis2, lens2

    # ------------------------------------------------------------------
    def map_batch_arrays(self, codes, pwm_q, lens) -> Tuple:
        """Global batch (host-resident ok) -> global outputs.  The batch
        axis is sharded over "reads" by the jitted shard_map."""
        return self._step(codes, pwm_q, lens, *self._idx_dev,
                          self.S_plus, self.S_minus, *self._g_args)

    def _canonical_perm(self, B: int) -> np.ndarray:
        """shard_map stacks each shard's [+ block, - block]; build the
        permutation to the canonical layout (all + rows, then all -)."""
        R = self.mesh.shape[READS_AXIS]
        Bloc = B // R
        perm = np.empty(2 * B, np.int64)
        for r in range(R):
            base = r * 2 * Bloc
            perm[r * Bloc:(r + 1) * Bloc] = np.arange(base, base + Bloc)
            perm[B + r * Bloc:B + (r + 1) * Bloc] = np.arange(
                base + Bloc, base + 2 * Bloc)
        return perm

    def _map_batch_devtb(self, batch, stats=None):
        """Device-finish path: each reads-shard emits the compact blob
        (retention + traceback already done on device); the host decodes
        shard-by-shard.  Returns None on any shard's capacity overflow."""
        import time as _time
        from gnumap_tpu.pipeline.mapper import decode_tb_blob, tb_blob_len
        cfg = self.cfg
        B = batch.codes.shape[0]
        R = self.mesh.shape[READS_AXIS]
        Bloc = B // R
        blen = tb_blob_len(cfg, Bloc)
        t0 = _time.perf_counter()
        blob_all = np.asarray(self._step_tb(
            batch.codes, batch.pwm_q, batch.lens, *self._idx_dev,
            self.S_plus, self.S_minus, *self._g_args))
        t1 = _time.perf_counter()
        assert blob_all.shape[0] == R * blen
        out = [[] for _ in range(batch.n)]
        n_valid_tot = 0
        for r in range(R):
            lo = r * Bloc
            n_loc = max(0, min(batch.n - lo, Bloc))
            dec = decode_tb_blob(cfg, Bloc, n_loc,
                                 batch.lens[lo:lo + Bloc],
                                 blob_all[r * blen:(r + 1) * blen])
            if dec is None:
                return None
            part, _, n_valid = dec
            n_valid_tot += n_valid
            for b, hits in enumerate(part):
                out[lo + b] = hits
        t2 = _time.perf_counter()
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += sum(1 for hh in out if hh)
            stats.n_multi += sum(1 for hh in out if len(hh) > 1)
            stats.n_candidates += n_valid_tot
            rect, bandw = pipeline_mapper._cells_per_cand(cfg)
            stats.dp_cells += n_valid_tot * cfg.max_read_len * rect
            stats.dp_cells_banded += n_valid_tot * cfg.max_read_len * bandw
            stats.device_s += t1 - t0
            stats.host_s += t2 - t1
        return out

    def map_batch(self, batch, stats=None):
        """ReadBatch -> per-read hits, identical semantics to
        TpuMapper.map_batch (tested)."""
        import time as _time
        from gnumap_tpu.pipeline.mapper import (_update_stats, host_finish)
        cfg = self.cfg
        B = batch.codes.shape[0]
        R = self.mesh.shape[READS_AXIS]
        if B % R:
            raise ValueError(f"batch_size {B} must divide by read "
                             f"shards {R}")
        if self.finish_impl == "device":
            out = self._map_batch_devtb(batch, stats)
            if out is not None:
                return out
            # capacity overflow in some shard: exact full-fetch fallback
        t0 = _time.perf_counter()
        outs = jax.device_get(self.map_batch_arrays(
            batch.codes, batch.pwm_q, batch.lens))
        t1 = _time.perf_counter()
        perm = self._canonical_perm(B)
        cands, valid, scores, max_sc = (a[perm] for a in outs)
        S_plus = np.asarray(self.S_plus)
        S_minus = np.asarray(self.S_minus)
        out = host_finish(self.genome, S_plus, S_minus, cfg, batch,
                          cands, valid, scores, max_sc)
        t2 = _time.perf_counter()
        if stats is not None:
            _update_stats(stats, cfg, batch, out, valid, t1 - t0, t2 - t1)
        return out


def allreduce_coverage(cov_stack: np.ndarray,
                       mesh: jax.sharding.Mesh) -> np.ndarray:
    """Merge per-shard coverage arrays: (n_dev, G) -> (G,) summed.

    The MPI_Reduce analog: psum over both mesh axes.  In a real multi-host
    run each host contributes its local row; here the stacked layout also
    serves the faked-multi-device CI (SURVEY.md §4.4).
    """
    n = mesh.devices.size
    assert cov_stack.shape[0] == n

    def f(c):
        return jax.lax.psum(c, (READS_AXIS, INDEX_AXIS))

    fn = jax.shard_map(
        f, mesh=mesh,
        in_specs=P((READS_AXIS, INDEX_AXIS)),
        out_specs=P(),
        check_vma=False)
    arr = cov_stack.reshape(n, -1) if cov_stack.ndim == 2 else cov_stack
    out = jax.jit(fn)(arr)
    return np.asarray(out)[0] if np.asarray(out).ndim == 2 else np.asarray(out)
