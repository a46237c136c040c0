"""Test env: force CPU JAX with 8 virtual devices BEFORE jax import.

SURVEY.md §4.4: distributed paths are tested without a cluster via
``--xla_force_host_platform_device_count`` (the JAX multi-device fake).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags +
                               " --xla_force_host_platform_device_count=8")

import jax

# pin CPU in the config too, so no test reaches an accelerator
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.utils import sim


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu`` compile a
    kernel for the card; chip_smoke.py phase 2 runs those checks there)."""
    if jax.default_backend() != "gpu":
        pytest.skip("compiles for a GPU; run on the card by chip_smoke.py")


@pytest.fixture(scope="session")
def small_cfg():
    return MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                        max_read_len=40, align_score_ratio=0.8)


@pytest.fixture(scope="session")
def phix_genome():
    return sim.random_genome(sim.PHIX_LEN, seed=0, repeat_frac=0.05,
                             repeat_unit=80)


@pytest.fixture(scope="session")
def phix_reads(phix_genome):
    return sim.simulate_reads(phix_genome, 64, 36, seed=7, sub_rate=0.03,
                              contig="phiX_sim")


def records_from_sim(reads, cfg):
    from gnumap_tpu.core import packing, pwm
    from gnumap_tpu.io.fastq import ReadRecord
    out = []
    for r in reads:
        codes = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), dtype=np.uint8).astype(
            np.int32) - 33
        out.append(ReadRecord(r.name, codes, pwm.pwm_from_calls(codes, q),
                              q.astype(np.int16)))
    return out
