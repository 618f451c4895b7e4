"""Runtime set-up and the smoke harness, on the CPU: the compile-cache
rule, the DeviceIndex pytree, device errors reaching the caller, and
chip_smoke.py's platform guard and phase functions at tiny sizes."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from omp_bowtie2_prime_tpu.utils import jaxcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py(code, env_extra=None, drop=(), cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


_CACHE_PROBE = (
    "import jax\n"
    "from omp_bowtie2_prime_tpu.utils import jaxcfg\n"
    "jaxcfg.enable_compile_cache()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(jaxcfg.cache_dir())\n"
)


def test_compile_cache_honours_env(tmp_path):
    r = _py(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_default_compile_cache_fixed_inside_checkout():
    r = _py(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(ROOT, ".jax_cache")
    assert r.stdout.split() == [want, want]
    assert jaxcfg.DEFAULT_CACHE_DIR == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _tiny_index(ftab_k=4, srate=16):
    from omp_bowtie2_prime_tpu.index.format import DeviceIndex

    return DeviceIndex(
        blocks=np.arange(256, dtype=np.uint32).reshape(2, 128),
        fchr=np.arange(5, dtype=np.int32),
        ftab=np.zeros((1, 128), np.uint32),
        sa_sample=np.ones((1, 128), np.uint32),
        ref_words=np.zeros(4, np.uint32), zoff=np.int32(0),
        nrows=np.int32(3), ftab_k=ftab_k, srate=srate)


def test_device_index_pytree_roundtrip_without_flax():
    idx = _tiny_index()
    leaves, tree = jax.tree_util.tree_flatten(idx)
    assert len(leaves) == 7  # the arrays; ftab_k/srate/tp are static
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert (back.ftab_k, back.srate, back.tp) == (4, 16, None)
    np.testing.assert_array_equal(back.blocks, idx.blocks)
    moved = dataclasses.replace(idx, srate=8)
    assert moved.srate == 8 and idx.srate == 16
    r = _py("import sys\n"
            "import omp_bowtie2_prime_tpu.models.aligner\n"
            "import omp_bowtie2_prime_tpu.parallel.tp_index\n"
            "print('flax' in sys.modules)\n")
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stderr


def test_device_index_static_fields_rekey_jit():
    traces = []

    @jax.jit
    def f(idx):
        traces.append(idx.ftab_k)
        return idx.blocks.sum() + idx.ftab_k

    a, b = _tiny_index(ftab_k=4), _tiny_index(ftab_k=6)
    assert int(f(a)) - int(f(b)) == -2
    f(_tiny_index(ftab_k=4))  # same static fields: cached
    assert traces == [4, 6]


@pytest.fixture(scope="module")
def tiny_fm():
    from omp_bowtie2_prime_tpu.index.builder import build_index_from_text
    from omp_bowtie2_prime_tpu.index.fasta import join_references

    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 20_000).astype(np.int8)
    joined, refmap = join_references(["t"], [text.copy()])
    return text, build_index_from_text(joined, refmap, ftab_k=6)


@pytest.mark.parametrize("mesh,method", [
    (False, "_rank_frame_device_grid"),  # single device: grid mega
    (True, "_rank_frame_device"),        # data mesh: lane mega
])
def test_device_error_propagates_from_align_batch(tiny_fm, mesh, method):
    """A failing device dispatch must reach the caller; there is no
    silent switch to the host path."""
    from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
    from omp_bowtie2_prime_tpu.parallel.mesh import make_mesh
    from scripts.profile_genome import synth_reads

    text, fm = tiny_fm
    al = TPUAligner(fm, mesh=make_mesh(2) if mesh else None)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    setattr(al, method, boom)
    reads = synth_reads(text, 8, 60, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="device fault"):
        al.align_batch(reads)
    assert al._use_fused_rank


def test_chip_smoke_refuses_cpu(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, tmp_path):  # in the repo, and with the script alone
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    """chip_smoke's data and index phases at a tiny genome size."""
    import chip_smoke as cs
    from omp_bowtie2_prime_tpu.index.format import FMIndex

    wd = str(tmp_path_factory.mktemp("smoke"))
    text, units, p = cs.make_data(wd, 0.4, 3, n_unpaired=300, n_pairs=60,
                                  n_local=60)
    cs.run_cli(["build", p["fa"], p["idx"]])
    return cs, wd, text, units, p, FMIndex.load(p["idx"])


@pytest.mark.parametrize("run", ["a", "b", "c"])
def test_chip_smoke_align_runs_agree_with_oracle(smoke_data, run):
    cs, wd, text, _units, p, _fm = smoke_data
    argv, n, local = {
        "a": (["-U", p["a"]], 300, False),
        "b": (["-1", p["b1"], "-2", p["b2"]], 120, False),
        "c": (["-U", p["c"], "--local"], 60, True),
    }[run]
    sam = os.path.join(wd, f"{run}.sam")
    cs.align_run(run, ["align", "-x", p["idx"], *argv], sam, text, n,
                 "cpu", local=local, min_aligned=0.5)
    res = cs.check_sam_output(sam, text, local=local, nsamp=50)
    assert res["records"] == n and res["oracle_ok"] == 50


def test_chip_smoke_dp_kernels_agree_with_oracle():
    import chip_smoke as cs

    times = cs.compare_dp_kernels(n=24, widths=(200,), timing_batch=8)
    assert set(times) == {(m, rl, 200) for m in ("e2e", "local")
                          for rl in (100, 150)}


def test_chip_smoke_seed_search_agrees_with_host(smoke_data):
    cs, _wd, text, units, _p, fm = smoke_data
    _t, cnt = cs.compare_seed_search(fm, text, units, n=96,
                                     timing_lanes=64)
    assert cnt["nonempty"] > 0 and cnt["wide"] > 0 and cnt["offsets"] > 0


def test_host_backward_search_matches_naive(tiny_fm):
    import chip_smoke as cs
    from fm_naive import fm_backward_search

    text, fm = tiny_fm
    rng = np.random.default_rng(9)
    seeds = np.stack([text[q : q + 12] for q in
                      rng.integers(0, len(text) - 12, 24)])
    seeds[::3, 4] = (seeds[::3, 4] + 1) % 4
    top, bot = cs.host_backward_search(fm, seeds.astype(np.int64))
    for s in range(len(seeds)):
        t, b = fm_backward_search(fm, seeds[s])
        assert bot[s] - top[s] == b - t
        if b > t:
            assert top[s] == t
