#!/usr/bin/env python3
"""Smoke run of the aligner's main path on NVIDIA GPUs.

    python chip_smoke.py                 # one card: the whole main path
    python chip_smoke.py --four-cards    # the data mesh on four cards only

One card: builds a ~100 Mbp genome (the size of the C. elegans reference,
WBcel235) with 50- and 500-copy repeat families from --seed, indexes it
through `bt2tpu build`, and aligns three read sets through `bt2tpu align`
(FASTQ file in, SAM file out): (a) 200K x 100 bp unpaired, (b) 50K pairs
of 2 x 150 bp, (c) 20K adapter read-through reads under --local. Every
record is checked with utils/samcheck, a sample with the numpy DP oracle
(scripts/oracle_check.py), and the first reads of (a) and (b) byte for
byte against the CPU backend (one child process with JAX_PLATFORMS=cpu,
which never opens the card). Then the DP and seed-search kernels are
compared with their host references at real widths, and the gpu-marked
tests run.

Four cards: run (a)'s reads on a 4-device data mesh and on one device in
the same process, compare the SAM text, and dry-run
__graft_entry__.dryrun_multichip(4).

Any failed phase ends the run with a non-zero exit and no result line.
JAX must find a GPU: there is no CPU fallback. The last line of stdout is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

REF_NAME = "chrS"
READ_LEN, PAIR_LEN, LOCAL_LEN = 100, 150, 100
N_UNPAIRED, N_PAIRS, N_LOCAL = 200_000, 50_000, 20_000
CPU_UNPAIRED, CPU_PAIRS = 5_000, 2_000  # subsets re-aligned on the CPU
ORACLE_SAMPLE = 500


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception:
        print(f"== FAILED: {name}", flush=True)
        raise
    print(f"== done: {name} ({time.perf_counter() - t0:.1f} s)", flush=True)


def require_gpu():
    """The visible JAX devices; exits non-zero unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r});"
            " this smoke runs on the card only\n")
        raise SystemExit(2)
    return devs


def card_lines():
    """`name, power limit` of each card, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------- data


def make_genome(genome_mbp: float, seed: int):
    """Random genome with 50- and 500-copy repeat families (the families
    of scripts/deep_repeat_differential.py). Returns (text int8, the
    repeat units, rng)."""
    from scripts.deep_repeat_differential import repeat_genome

    rng = np.random.default_rng(seed)
    text, units, _copies = repeat_genome(int(genome_mbp * 1e6), 300, rng)
    return text, list(units.values()), rng


def write_fasta(path, text):
    from omp_bowtie2_prime_tpu.utils import dna

    s = dna.decode(text)
    with open(path, "w") as f:
        f.write(f">{REF_NAME}\n")
        for i in range(0, len(s), 80):
            f.write(s[i : i + 80] + "\n")


def write_fastq(path, reads):
    from omp_bowtie2_prime_tpu.utils import dna

    with open(path, "w") as f:
        for rd in reads:
            q = (rd.qual.astype(np.uint8) + 33).tobytes().decode("ascii")
            f.write(f"@{rd.name}\n{dna.decode(rd.seq)}\n+\n{q}\n")


def make_data(workdir, genome_mbp, seed, n_unpaired=N_UNPAIRED,
              n_pairs=N_PAIRS, n_local=N_LOCAL):
    """Genome FASTA and the three FASTQ read sets, all from `seed`.
    Returns (text, repeat units, {name: path})."""
    from scripts.profile_genome import synth_pairs, synth_reads
    from scripts.randargs_differential import write_adapter_reads

    os.makedirs(workdir, exist_ok=True)
    text, units, rng = make_genome(genome_mbp, seed)
    p = {k: os.path.join(workdir, v) for k, v in (
        ("fa", "genome.fa"), ("idx", "genome.npz"), ("a", "a.fq"),
        ("b1", "b_1.fq"), ("b2", "b_2.fq"), ("c", "c.fq"))}
    write_fasta(p["fa"], text)
    write_fastq(p["a"], synth_reads(text, n_unpaired, READ_LEN, rng))
    pairs = synth_pairs(text, n_pairs, PAIR_LEN, rng)
    write_fastq(p["b1"], [m1 for m1, _ in pairs])
    write_fastq(p["b2"], [m2 for _, m2 in pairs])
    with open(p["c"], "w") as f:
        write_adapter_reads(f, text, n_local, LOCAL_LEN, rng)
    return text, units, p


def device_index_bytes(fm):
    """Bytes of the device-resident index arrays."""
    import jax

    from omp_bowtie2_prime_tpu.index.format import DeviceIndex

    idx = DeviceIndex.from_host(fm)
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(idx))


# ---------------------------------------------------------------- align


def run_cli(argv):
    """cli.main(argv) in this process; returns (wall seconds, stderr)."""
    from omp_bowtie2_prime_tpu.cli import main as climain

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        climain(argv)
    return time.perf_counter() - t0, buf.getvalue()


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def check_sam_output(sam, text, local=False, nsamp=ORACLE_SAMPLE):
    """samcheck over every aligned record plus the numpy DP oracle on a
    sample. Returns a dict of counts; raises on any inconsistency."""
    from scripts.oracle_check import build_scoring, check_sam
    from omp_bowtie2_prime_tpu.utils.samcheck import check_record

    sc = build_scoring(local=local)
    refs = {REF_NAME: text}
    n_prim = n_al = 0
    bad = []
    for ln in sam_records(sam):
        f = ln.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x100:
            continue
        n_prim += 1
        if flag & 4:
            continue
        n_al += 1
        errs = check_record(f, refs, sc)
        if errs:
            bad.append((f[0], errs))
    check(n_prim > 0, f"{sam}: no records")
    check(not bad, f"{sam}: samcheck found {len(bad)} inconsistent "
                   f"records, e.g. {bad[:3]}")
    msgs = io.StringIO()
    n_ok, n_bad = check_sam(refs, sam, nsamp, local=local, sc=sc, out=msgs)
    check(n_bad == 0, f"{sam}: oracle found {n_bad} suboptimal records:\n"
                      + msgs.getvalue())
    check(n_ok >= min(nsamp, n_al),
          f"{sam}: oracle checked {n_ok} records, want {min(nsamp, n_al)}")
    return {"records": n_prim, "aligned": n_al, "oracle_ok": n_ok}


def align_run(label, argv, sam, text, n_reads, card, local=False,
              min_aligned=0.9, warm=False):
    """One `bt2tpu align -t` run plus its output checks; prints the
    numbers this smoke reports for it. warm: a repeat in the same process
    (programs already compiled), reported apart from first runs."""
    wall, err = run_cli(argv + ["-S", sam, "-t"])
    print(err, end="" if err.endswith("\n") else "\n")
    m = re.search(r"rf_overflow=(\d+)", err)
    check(m is not None, "no Metrics line in the -t output")
    res = check_sam_output(sam, text, local=local)
    share = res["aligned"] / res["records"]
    kind = ("warm repeat" if warm else "first run") + f" on {card}"
    kind += "" if warm else ", includes compile"
    print(f"[{label}] {kind}: {n_reads} reads in {wall:.2f} s = "
          f"{n_reads / wall:.1f} reads/s")
    print(f"[{label}] aligned {res['aligned']}/{res['records']} "
          f"({100 * share:.2f}%); samcheck clean; oracle "
          f"{res['oracle_ok']}/{res['oracle_ok']} optimal; host rank/frame"
          f" reruns after table overflow: {m.group(1)}; peak device bytes "
          f"{peak_bytes()}", flush=True)
    check(share >= min_aligned,
          f"{label}: aligned share {share:.4f} < {min_aligned}")
    return wall


def cpu_identity(p, sam_a, sam_b, workdir, n_unpaired=CPU_UNPAIRED,
                 n_pairs=CPU_PAIRS):
    """Re-align the first reads of (a) and pairs of (b) in ONE child
    process on the CPU backend; their SAM records must equal the GPU
    run's byte for byte (the pipeline is integer-only, tie-breaks seeded)."""
    cpu_a = os.path.join(workdir, "a_cpu.sam")
    cpu_b = os.path.join(workdir, "b_cpu.sam")
    runs = [
        ["align", "-x", p["idx"], "-U", p["a"], "-u", str(n_unpaired),
         "-S", cpu_a],
        ["align", "-x", p["idx"], "-1", p["b1"], "-2", p["b2"],
         "-u", str(n_pairs), "-S", cpu_b],
    ]
    code = ("from omp_bowtie2_prime_tpu.cli import main\n"
            f"for argv in {runs!r}: main(argv)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    check(r.returncode == 0, f"CPU child failed:\n{r.stderr[-4000:]}")
    out = {}
    for name, gpu_sam, cpu_sam, want in (("a", sam_a, cpu_a, n_unpaired),
                                         ("b", sam_b, cpu_b, 2 * n_pairs)):
        c = sam_records(cpu_sam)
        g = sam_records(gpu_sam)[: len(c)]
        check(len(c) >= want, f"({name}) CPU run wrote {len(c)} records")
        diff = [i for i, (x, y) in enumerate(zip(c, g)) if x != y]
        if diff:
            raise SmokeError(
                f"({name}) {len(diff)} of {len(c)} records differ between "
                f"GPU and CPU; first:\nGPU {g[diff[0]]}CPU {c[diff[0]]}")
        out[name] = len(c)
    return out


# ---------------------------------------------------------------- kernels


def time_call(fn, *args, reps=5):
    """Median wall seconds of fn(*args) after one warm call, each ending
    in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def dp_problems(rng, n, rdlen, L, C):
    """n DP problems with reads of rdlen (padded to L) against windows of
    C columns: each read is planted in its window with 0-4 substitutions
    and maybe one indel, or (one problem in 8) is unrelated to it."""
    reads = np.full((n, L), 4, np.int8)
    pens = rng.integers(2, 7, (n, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (n, C)).astype(np.int8)
    wlens = rng.integers(rdlen + 8, C + 1, n).astype(np.int32)
    for b in range(n):
        off = int(rng.integers(0, wlens[b] - rdlen - 4))
        s = refs[b, off : off + rdlen + 4].copy()
        if rng.integers(0, 3) == 0:  # one indel
            j = int(rng.integers(10, rdlen - 10))
            s = (np.delete(s, j) if rng.integers(0, 2)
                 else np.insert(s, j, rng.integers(0, 4)))
        s = s[:rdlen]
        for _ in range(int(rng.integers(0, 5))):
            j = int(rng.integers(0, rdlen))
            s[j] = (s[j] + 1) % 4
        if b % 8 == 7:
            s = rng.integers(0, 4, rdlen).astype(np.int8)
        reads[b, :rdlen] = s
    return reads, pens, np.full(n, rdlen, np.int32), refs, wlens


def compare_dp_kernels(n=512, rdlens=(100, 150), widths=(200, 224), L=160,
                       seed=0, timing_batch=4096):
    """sw_e2e_backtrace_batch and sw_local_backtrace_batch against the
    numpy oracles (tolerance 0): e2e best score, best column and the full
    backtrace CIGAR; local best score, best row and best column. Returns
    {(mode, rdlen, C): seconds per call at timing_batch problems}."""
    import jax

    from omp_bowtie2_prime_tpu.ops import sw

    p_e2e = sw.SWParams()
    p_loc = sw.SWParams(ma=2)
    e2e = jax.jit(sw.sw_e2e_backtrace_batch, static_argnums=5)
    loc = jax.jit(sw.sw_local_backtrace_batch, static_argnums=5)
    rng = np.random.default_rng(seed)
    times = {}
    for rdlen in rdlens:
        for C in widths:
            args = dp_problems(rng, n, rdlen, L, C)
            reads, pens, rl, refs, wl = args
            best, bcol, opsp, _stc = (np.asarray(x)
                                      for x in e2e(*args, p_e2e))
            ops = sw.unpack_ops2(opsp)
            lbest, lrow, lcol = (np.asarray(x)
                                 for x in loc(*args, p_loc)[:3])
            for b in range(n):
                rd, pn, rf = reads[b, :rdlen], pens[b, :rdlen], \
                    refs[b, : wl[b]]
                H, E, F = sw.sw_e2e_full_numpy(rd, pn, rf, p_e2e)
                want = int(H[rdlen].max())
                wcol = int(np.argmax(H[rdlen]))
                check((best[b], bcol[b]) == (want, wcol),
                      f"e2e L={rdlen} C={C} problem {b}: device "
                      f"({best[b]}, {bcol[b]}) != oracle ({want}, {wcol})")
                aln = sw.backtrace_numpy(rd, pn, rf, p_e2e, H, E, F, wcol)
                got = sw.ops_to_cigar(ops[b])
                check(got == aln.cigar,
                      f"e2e L={rdlen} C={C} problem {b}: device CIGAR "
                      f"{got} != oracle {aln.cigar}")
                Hl = sw.sw_local_full_numpy(rd, pn, rf, p_loc)[0][1:]
                m = int(Hl.max())
                if m > 0:
                    r = int(np.argmax(Hl.max(axis=1)))
                    want_l = (m, r + 1, int(np.argmax(Hl[r])))
                else:
                    want_l = (0, 0, 0)
                check((lbest[b], lrow[b], lcol[b]) == want_l,
                      f"local L={rdlen} C={C} problem {b}: device "
                      f"({lbest[b]}, {lrow[b]}, {lcol[b]}) != oracle "
                      f"{want_l}")
            targs = dp_problems(rng, timing_batch, rdlen, L, C)
            times[("e2e", rdlen, C)] = time_call(e2e, *targs, p_e2e)
            times[("local", rdlen, C)] = time_call(loc, *targs, p_loc)
    return times


def host_backward_search(fm, seeds):
    """Exact backward search of [B, L] base codes (0-3) over the HOST
    index (128-row occ checkpoints + 2-bit BWT words, dummy row at zoff
    counted as code 0): numpy, independent of the device record layout.
    Returns (top, bot) int64 [B]; empty ranges have top == bot."""
    from omp_bowtie2_prime_tpu.index.format import OCC_BLOCK

    words = fm.bwt_words.reshape(-1, OCC_BLOCK // 16)
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    pos = np.arange(OCC_BLOCK)
    last = fm.nblocks - 1

    def occ(c, i):
        b = np.minimum(i // OCC_BLOCK, last)
        k = i - b * OCC_BLOCK
        codes = ((words[b][:, :, None] >> shifts) & 3).reshape(len(i), -1)
        n = ((codes == c[:, None]) & (pos[None, :] < k[:, None])).sum(1)
        n = n + fm.occ_cp[b, c]
        return n - ((c == 0) & (fm.zoff < i))

    B, L = seeds.shape
    top = np.zeros(B, np.int64)
    bot = np.full(B, fm.nrows, np.int64)
    for j in range(L - 1, -1, -1):
        c = seeds[:, j].astype(np.int64)
        live = bot > top
        nt = fm.fchr[c] + occ(c, top)
        nb = fm.fchr[c] + occ(c, bot)
        top = np.where(live, nt, top)
        bot = np.where(live, nb, top)
    return top, np.maximum(top, bot)


def compare_seed_search(fm, text, units=(), n=2048, seed_len=22, cap=16,
                        seed=0, timing_lanes=1 << 16):
    """seed_search.search_resolve_seeds on the device against the host
    backward search (exact range widths, and tops of non-empty ranges)
    and the text (every resolved offset is a true occurrence; ranges no
    wider than cap resolve to all of their occurrences). One seed in 8 is
    cut from a repeat unit, so its range is wider than cap. Returns
    (seconds per call at timing_lanes seeds, counts)."""
    import jax
    import jax.numpy as jnp

    from omp_bowtie2_prime_tpu.index.format import DeviceIndex
    from omp_bowtie2_prime_tpu.ops import seed_search

    rng = np.random.default_rng(seed)
    pos = rng.integers(0, len(text) - seed_len, n)
    seeds = np.stack([text[q : q + seed_len] for q in pos]).astype(np.int8)
    mut = rng.random(n) < 0.25  # some seeds mismatch: mostly empty ranges
    seeds[mut, seed_len // 2] = (seeds[mut, seed_len // 2] + 1) % 4
    for s in range(0, n, 8) if len(units) else ():
        u = units[(s // 8) % len(units)]
        q = int(rng.integers(0, len(u) - seed_len))
        seeds[s] = u[q : q + seed_len]
    idx = DeviceIndex.from_host(fm)
    fn = jax.jit(seed_search.search_resolve_seeds,
                 static_argnums=(3, 4, 5, 6))
    # expand = cap: the offset buffer holds every seed's rows (no spill)
    top, bot, starts, offs = (np.asarray(x) for x in fn(
        idx, jnp.asarray(seeds), jnp.ones(n, bool), cap, float(cap), 0,
        False))
    htop, hbot = host_backward_search(fm, seeds.astype(np.int64))
    w, hw = bot - top, hbot - htop
    check(np.array_equal(w, hw), f"seed range widths differ at "
          f"{np.flatnonzero(w != hw)[:8]}")
    nz = hw > 0
    check(np.array_equal(top[nz], htop[nz]), "seed range tops differ")
    n_off = 0
    for s in np.flatnonzero(nz):
        k = min(int(hw[s]), cap)
        o = offs[starts[s] : starts[s] + k].astype(np.int64)
        check(len(set(o.tolist())) == k and (o >= 0).all(),
              f"seed {s}: offsets {o} not {k} distinct resolved rows")
        for q in o:
            check(np.array_equal(text[q : q + seed_len], seeds[s]),
                  f"seed {s}: offset {q} is not an occurrence")
        n_off += k
    tseeds = np.stack([text[q : q + seed_len] for q in
                       rng.integers(0, len(text) - seed_len, timing_lanes)])
    t = time_call(fn, idx, jnp.asarray(tseeds.astype(np.int8)),
                  jnp.ones(timing_lanes, bool), cap, 1.0, 0, False)
    return t, {"seeds": n, "nonempty": int(nz.sum()), "offsets": n_off,
               "wide": int((hw > cap).sum())}


def compare_rank_frame(fm, reads):
    """The fused device rank/frame path against the host numpy path on
    one batch (tests/test_rank_frame.py's comparison): identical hit
    statistics and candidates. Returns the candidate count."""
    from omp_bowtie2_prime_tpu.models.aligner import TPUAligner

    al_f = TPUAligner(fm)
    al_h = TPUAligner(fm, share=al_f)
    al_h._use_fused_rank = False
    minscs = al_f.min_scores(reads)
    al_f.build_read_matrices(reads)
    al_h.build_read_matrices(reads)
    active = list(range(len(reads)))
    cf = al_f.collect_candidates(reads, minscs, active, 0)
    hn, he = al_f._hit_nonz.copy(), al_f._hit_elts.copy()
    ch = al_h.collect_candidates(reads, minscs, active, 0)
    check(np.array_equal(hn, al_h._hit_nonz)
          and np.array_equal(he, al_h._hit_elts), "hit statistics differ")
    check(al_f.metrics.rf_overflow == 0, "fused table overflowed")
    n = 0
    for df, dh in zip(cf, ch):
        check(df.keys() == dh.keys(), "candidate sets differ")
        for k in df:
            a, b = df[k], dh[k]
            check((a.score, a.fw, a.endj, a.problem["wstart"],
                   a.problem["wlen"]) == (b.score, b.fw, b.endj,
                                          b.problem["wstart"],
                                          b.problem["wlen"]),
                  f"candidate {k} differs")
            n += 1
    return n


def run_gpu_tests():
    """The gpu-marked tests, in this process (so on this card)."""
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome == "skipped":
                self.outcomes.append(report.outcome)

    c = Count()
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[c])
    check(rc == 0 and c.outcomes and set(c.outcomes) == {"passed"},
          f"gpu-marked tests: exit {rc}, outcomes {c.outcomes}")
    return len(c.outcomes)


# ---------------------------------------------------------------- modes


def one_card(args, card):
    from omp_bowtie2_prime_tpu.index.format import FMIndex
    from scripts.profile_genome import synth_reads

    wd = args.workdir
    with phase("data"):
        t0 = time.perf_counter()
        text, units, p = make_data(wd, args.genome_mbp, args.seed)
        print(f"genome {len(text)} bp + reads made in "
              f"{time.perf_counter() - t0:.1f} s (host)")
    with phase("index build (bt2tpu build)"):
        wall, err = run_cli(["build", p["fa"], p["idx"]])
        print(err, end="")
        fm = FMIndex.load(p["idx"])
        print(f"host build {wall:.1f} s; device index "
              f"{device_index_bytes(fm)} bytes")
    sam = {k: os.path.join(wd, f"{k}.sam") for k in "abc"}
    with phase("align (a): 200K x 100 bp unpaired, --sensitive"):
        align_run("a", ["align", "-x", p["idx"], "-U", p["a"]], sam["a"],
                  text, N_UNPAIRED, card)
    with phase("align (b): 50K pairs of 2 x 150 bp"):
        align_run("b", ["align", "-x", p["idx"], "-1", p["b1"], "-2",
                        p["b2"]], sam["b"], text, 2 * N_PAIRS, card)
    with phase("align (c): 20K adapter read-through reads, --local"):
        align_run("c", ["align", "-x", p["idx"], "-U", p["c"], "--local"],
                  sam["c"], text, N_LOCAL, card, local=True)
    with phase("align (a) again, warm"):
        warm_sam = os.path.join(wd, "a_warm.sam")
        align_run("a", ["align", "-x", p["idx"], "-U", p["a"]], warm_sam,
                  text, N_UNPAIRED, card, warm=True)
        check(sam_records(warm_sam) == sam_records(sam["a"]),
              "warm repeat of (a) wrote different records")
    with phase("byte identity against the CPU backend"):
        n = cpu_identity(p, sam["a"], sam["b"], wd)
        print(f"identical SAM records: (a) first {n['a']}, (b) first "
              f"{n['b']} (JAX_PLATFORMS=cpu child)")
    with phase("DP kernels vs numpy oracle"):
        times = compare_dp_kernels()
        for (mode, rl, C), t in times.items():
            print(f"sw_{mode}_backtrace_batch B=4096 L=160 (reads {rl}) "
                  f"C={C}: {1e3 * t:.3f} ms/call (unsteady, first-PR "
                  f"reading)")
    with phase("seed search vs host backward search"):
        t, cnt = compare_seed_search(fm, text, units)
        print(f"ranges and offsets exact over {cnt}; search_resolve_seeds "
              f"65536 lanes x 22: {1e3 * t:.3f} ms/call (unsteady, "
              f"first-PR reading)")
    with phase("fused rank/frame vs host path"):
        rng = np.random.default_rng(args.seed + 1)
        n = compare_rank_frame(fm, synth_reads(text, 4096, READ_LEN, rng))
        print(f"{n} candidates identical")
    with phase("gpu-marked tests"):
        print(f"{run_gpu_tests()} passed")


def emit_sam(w, batch, results):
    for rd, res in zip(batch, results):
        if res.status != "aligned":
            w.write_unaligned(rd, yf=res.filt)
            continue
        for i, r in enumerate([res] + list(res.extra)):
            w.write_aligned(rd, r.fw, w.refnames[r.refid], r.refoff,
                            r.mapq, w.cigar_str(r), r.score, r.secbest,
                            r.stats, nhits_for_summary=res.nhits,
                            secondary=i > 0)


def four_cards(args, n_unpaired=N_UNPAIRED):
    import jax

    from omp_bowtie2_prime_tpu.index.format import FMIndex
    from omp_bowtie2_prime_tpu.io.fastq import batch_iterator, open_reads
    from omp_bowtie2_prime_tpu.io.sam import SamWriter
    from omp_bowtie2_prime_tpu.models.aligner import TPUAligner
    from omp_bowtie2_prime_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, found "
                                   f"{len(jax.devices())}")
    wd = args.workdir
    with phase("data + index"):
        _text, _units, p = make_data(wd, args.genome_mbp, args.seed,
                                     n_unpaired, n_pairs=1, n_local=1)
        run_cli(["build", p["fa"], p["idx"]])
        fm = FMIndex.load(p["idx"])
    with phase("(a) reads: 4-card data mesh vs one card"):
        al1 = TPUAligner(fm)
        al4 = TPUAligner(fm, mesh=make_mesh(4))
        outs = {}
        for name, al in (("one", al1), ("mesh4", al4)):
            buf = io.StringIO()
            w = SamWriter(buf, fm.refmap.refnames, fm.refmap.reflens)
            t0 = time.perf_counter()
            for batch in batch_iterator(open_reads(p["a"]), 8192):
                emit_sam(w, batch, al.align_batch(batch))
            dt = time.perf_counter() - t0
            outs[name] = buf.getvalue()
            print(f"{name}: {n_unpaired} reads in {dt:.2f} s (first run, "
                  f"includes compile)")
        a, b = outs["one"].splitlines(), outs["mesh4"].splitlines()
        check(len(a) == len(b) == n_unpaired,
              f"record counts {len(a)} / {len(b)}")
        diff = sum(x != y for x, y in zip(a, b))
        check(diff == 0, f"{diff} records differ between 4 cards and one")
        print(f"byte-identical: {len(a)} SAM records, 4-card mesh == one card")
    with phase("dryrun_multichip(4)"):
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mbp", type=float, default=100.0,
                    help=argparse.SUPPRESS)  # CPU tests call phases small
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data mesh and its one-card "
                         "comparison")
    args = ap.parse_args(argv)
    args.workdir = os.path.join(ROOT, ".smoke")

    devs = require_gpu()
    import jax

    from omp_bowtie2_prime_tpu.utils.jaxcfg import cache_dir, \
        enable_compile_cache

    enable_compile_cache()
    cards = card_lines()
    for ln in cards:
        print(ln)
    print(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
          f"{len(devs)} device(s); compile cache {cache_dir()}", flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)
    try:
        if args.four_cards:
            four_cards(args)
        else:
            one_card(args, cards[0])
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
