"""Bench-harness truth accounting guard.

Round 3 shipped a 0.4939 "accuracy" for the segmented config that was a
bench bug, not a mapper bug: truth positions were sampled from the unsplit
genome string while Genome.from_contigs inserts a 64-N spacer between
contigs, shifting every second-contig position by exactly 64.  This test
runs the bench's own workload builder + accounting on a small 2-contig
segmented workload and requires near-perfect accuracy, so any future
spacer/coordinate accounting drift fails CI instead of shipping a wrong
number in the round record.
"""

import bench


def test_two_contig_segmented_truth_accuracy():
    cfg, gen, idx, recs = bench.build_workload(
        n_reads=256, genome_len=200_000, batch_size=128, config=7)
    assert len(gen.names) == 2            # the spacer-bearing split genome
    dt, stats, n_hits, acc = bench.run_pipeline(
        cfg, gen, idx, recs, "jnp", depth=1,
        n_segments=bench.CONFIGS[7]["segments"])
    assert stats.n_mapped >= 250
    assert acc >= 0.999, (
        f"segmented bench accuracy {acc}: truth-coordinate accounting "
        f"is broken again (64-N contig spacer?)")


def test_single_contig_truth_accuracy_unchanged():
    """The locate-based accounting must not change single-contig results."""
    cfg, gen, idx, recs = bench.build_workload(
        n_reads=256, genome_len=100_000, batch_size=128, config=2)
    dt, stats, n_hits, acc = bench.run_pipeline(cfg, gen, idx, recs, "jnp",
                                                depth=1)
    assert stats.n_mapped >= 250
    assert acc >= 0.999
