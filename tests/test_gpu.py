"""Kernels compiled for the card against their host references at real
widths. Marked `gpu`: they skip on any other platform, and
`python chip_smoke.py` runs them on the card."""

import functools

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@functools.lru_cache(maxsize=1)
def _genome():
    """A 4 Mbp smoke genome and its index (built on first use only)."""
    import chip_smoke as cs
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu.index.fasta import join_references

    text, units, _rng = cs.make_genome(4.0, 7)
    joined, refmap = join_references([cs.REF_NAME], [text.copy()])
    return text, units, build_index_from_text(joined, refmap)


def test_dp_kernels_match_oracle(gpu):
    import chip_smoke as cs

    times = cs.compare_dp_kernels(n=512)
    for key, t in sorted(times.items()):
        print(f"{gpu.device_kind} {key}: {1e3 * t:.3f} ms/call")


def test_seed_search_matches_host(gpu):
    import chip_smoke as cs

    text, units, fm = _genome()
    _t, cnt = cs.compare_seed_search(fm, text, units, n=2048)
    assert cnt["wide"] > 0


def test_rank_frame_matches_host_path(gpu):
    import chip_smoke as cs
    from scripts.profile_genome import synth_reads

    text, _units, fm = _genome()
    reads = synth_reads(text, 2048, 100, np.random.default_rng(3))
    assert cs.compare_rank_frame(fm, reads) > 0
