"""Banded GPU scoring kernel (align/band_kernel.py) tests.

The kernel's DP semantics are frozen by oracle.nw_align and covered on CPU
by tests/test_align.py (nw_ref).  Here the kernel runs in the Pallas
interpreter (``interpret=True``, passed explicitly) against the oracle and
nw_ref; its lowering to Triton is checked by exporting it for CUDA.  The
compiled kernel runs on the card in chip_smoke.py phase 2 (the ``gpu``
tests below skip without one).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnumap_tpu.align import band_kernel, nw_ref, scoring
from gnumap_tpu.align.select import resolve_align_impl
from gnumap_tpu.config import NEG_INF, SENTINEL as SENT, WINDOW_ALIGN, \
    MapperConfig
from gnumap_tpu.core import packing, pwm
from gnumap_tpu.oracle import oracle


def test_pack_4bit_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, 1000).astype(np.int8)
    w = packing.pack_4bit(codes)
    got = [(int(w[i // 8]) >> ((i % 8) * 4)) & 0xF for i in range(1000)]
    assert got == list(codes)


def test_window_rule_alignment():
    cfg = MapperConfig(max_read_len=104)
    assert cfg.window_width() % WINDOW_ALIGN == 0
    # floor behavior incl. negatives
    assert cfg.window_start(-3) <= -3 - cfg.gap_slack
    assert cfg.window_start(-3) % 8 == 0
    assert cfg.window_start(100) == ((100 - cfg.gap_slack) // 8) * 8


def _setup(rng, B2, C, L, G, cfg, empty_rows=0):
    genome = rng.integers(0, 5, G).astype(np.int8)
    emis = np.zeros((B2, L, 5), np.int32)
    lens = rng.integers(L // 2, L + 1, B2).astype(np.int32)
    for b in range(B2):
        lb = lens[b]
        codes = rng.integers(0, 4, lb).astype(np.int8)
        pq = pwm.pwm_from_calls(codes, rng.integers(5, 41, lb))
        emis[b, :lb] = scoring.emission_int(pq, scoring.normal_matrix(cfg))
    W = cfg.window_width()
    cands = np.full((B2, C), SENT, np.int32)
    for b in range(empty_rows, B2):
        k = rng.integers(0, C + 1)
        cands[b, :k] = np.sort(rng.integers(-L // 2, G - 1, k))
    return genome, emis, cands, lens, W


def _kernel(cfg, emis, cands, lens, genome, interpret=True):
    boff, bw = cfg.band()
    return np.asarray(band_kernel.nw_scores_banded(
        jnp.asarray(emis), jnp.asarray(cands), jnp.asarray(lens),
        jnp.asarray(genome), W=cfg.window_width(), slack=cfg.gap_slack,
        boff=boff, bw=bw, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
        interpret=interpret))


def _check_banded_vs_oracle(cfg, L, C, B2, G, seed, interpret=True,
                            empty_rows=0):
    rng = np.random.default_rng(seed)
    genome, emis, cands, lens, W = _setup(rng, B2, C, L, G, cfg, empty_rows)
    got = _kernel(cfg, emis, cands, lens, genome, interpret)
    n = 0
    for b in range(B2):
        lb = int(lens[b])
        for c in range(C):
            if cands[b, c] == SENT:
                assert got[b, c] == NEG_INF
                continue
            ws = int(cfg.window_start(int(cands[b, c])))
            window = np.full(W, 4, np.int8)
            lo, hi = max(ws, 0), min(ws + W, G)
            if hi > lo:
                window[lo - ws:hi - ws] = genome[lo:hi]
            expect = oracle.nw_align(emis[b, :lb], window, cfg)
            assert got[b, c] == expect, (b, c, got[b, c], expect)
            n += 1
    return n


def test_banded_matches_oracle_interpret():
    _check_banded_vs_oracle(MapperConfig(max_read_len=16), L=16, C=8, B2=4,
                            G=200, seed=3)


def test_banded_matches_oracle_interpret_long():
    # L=104 exercises real band clipping (W=128 > band start spread)
    _check_banded_vs_oracle(MapperConfig(max_read_len=104), L=104, C=4,
                            B2=6, G=2500, seed=11)


def test_banded_all_sentinel_blocks_and_padded_rows():
    """Several kernel blocks, half the read-strands all SENTINEL (the
    compacted valid pairs fill fewer blocks; the rest exit at once), and
    read lengths below L (padded emission rows)."""
    cfg = MapperConfig(max_read_len=24)
    B2, C = 80, 8
    n = _check_banded_vs_oracle(cfg, L=24, C=C, B2=B2, G=700, seed=17,
                                empty_rows=40)
    assert B2 * C > 2 * band_kernel.BLOCK and n > 0


def test_banded_matches_nw_ref_banded():
    # jnp path with band must agree with the kernel cell-for-cell
    cfg = MapperConfig(max_read_len=48)
    rng = np.random.default_rng(9)
    genome, emis, cands, lens, W = _setup(rng, 10, 8, 48, 900, cfg)
    got = _kernel(cfg, emis, cands, lens, genome)
    wins = np.zeros((10, 8, W), np.int32)
    for b in range(10):
        for c in range(8):
            cd = 0 if cands[b, c] == SENT else int(cands[b, c])
            ws = int(cfg.window_start(cd))
            window = np.full(W, 4, np.int8)
            lo, hi = max(ws, 0), min(ws + W, len(genome))
            if hi > lo:
                window[lo - ws:hi - ws] = genome[lo:hi]
            wins[b, c] = window
    ref = np.asarray(nw_ref.nw_scores_multi(
        emis, wins, lens, cfg.gap_open_q(), cfg.gap_extend_q(),
        band=cfg.band()))
    valid = cands != SENT
    assert np.array_equal(got[valid], ref[valid])


def test_band_kernel_lowers_for_cuda():
    """The kernel lowers to a Triton custom call at the real widths
    (L = 104, W = 128, bw = 42) without a card: jax.export runs the
    Pallas Triton lowering for the 'cuda' platform."""
    cfg = MapperConfig(max_read_len=104)
    boff, bw = cfg.band()

    def f(e, c, ln, g):
        return band_kernel.nw_scores_banded(
            e, c, ln, g, W=cfg.window_width(), slack=cfg.gap_slack,
            boff=boff, bw=bw, open_q=cfg.gap_open_q(),
            ext_q=cfg.gap_extend_q())

    B2, C = 256, 32
    args = (jax.ShapeDtypeStruct((B2, 104, 5), jnp.int32),
            jax.ShapeDtypeStruct((B2, C), jnp.int32),
            jax.ShapeDtypeStruct((B2,), jnp.int32),
            jax.ShapeDtypeStruct((100_000,), jnp.int8))
    exp = jax.export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


def test_resolve_align_impl_auto_on_cpu_is_jnp():
    assert jax.default_backend() == "cpu"
    assert resolve_align_impl("auto") == "jnp"
    assert resolve_align_impl("jnp") == "jnp"


def test_resolve_align_impl_interpret_only_when_asked():
    with pytest.raises(ValueError, match="interpret"):
        resolve_align_impl("pallas")
    assert resolve_align_impl("pallas", interpret=True) == "pallas"
    with pytest.raises(ValueError):
        resolve_align_impl("cuda")


@pytest.mark.gpu
def test_banded_matches_oracle_gpu(gpu):
    _check_banded_vs_oracle(MapperConfig(max_read_len=32), L=32, C=16,
                            B2=12, G=800, seed=42, interpret=False)
