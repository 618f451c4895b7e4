"""Command-line interface: build / align / inspect.

Mirrors the reference tool surface (bowtie2-build, bowtie2, bowtie2-inspect;
ref: bt2_build.cpp, bt2_search.cpp:685-885 usage + parseOption 982-1577,
bt2_inspect.cpp) on the JAX device engine. Index files use the .npz
container from index/format.py; existing .bt2 indexes load through
index/bt2io.py when given.

Option surface implemented (reference file:line in parseOption):
input: -U/-1/-2/--interleaved/--tab5/--tab6, -f/-q, -u/-s, -5/-3,
--trim-to, --phred33/--phred64/--int-quals; policy: presets, -L, -i, -N
(exact seeds only, like the fork), -D, -R, --mp, --np, --rdg, --rfg,
--score-min, --n-ceil, --ignore-quals, --nofw/--norc, -I/-X,
--fr/--rf/--ff, --no-mixed/--no-discordant, --dovetail/--no-contain/
--no-overlap; reporting: -k, -a, --no-unal, --un/--al; output: --rg-id,
--rg, --no-hd, --no-sq, -p/--threads (accepted; batching replaces thread
parallelism), --reorder (output is always in input order), -t/--time,
--local/--ma/-local presets (soft-clipping local alignment — restored
beyond the fork, which removed its local kernels and prints "not
supported", bt2_search.cpp:1345-1348).
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np


def _load_index(path: str):
    from .index.format import FMIndex

    if path.endswith(".npz"):
        return FMIndex.load(path)
    import os

    if os.path.exists(path + ".npz"):
        return FMIndex.load(path + ".npz")
    if os.path.exists(path + ".1.bt2") or os.path.exists(path + ".1.bt2l"):
        from .index.bt2io import load_bt2_index

        return load_bt2_index(path)
    raise SystemExit(f"error: index not found: {path}(.npz/.1.bt2)")


def cmd_build(args):
    from .index.builder import build_index

    if getattr(args, "ntoa", False):
        # --ntoa rewrites ambiguous reference chars to A (ref_read.h) and
        # would change index content; unsupported rather than silently
        # diverging
        print("WARNING: --ntoa not supported (ambiguous characters are "
              "excluded from the index, the bowtie2 default)",
              file=sys.stderr)
    t0 = time.time()
    if args.bt2:
        # emit a bowtie2-compatible .bt2 index set instead of .npz
        from .index.bt2io import save_bt2
        from .index.fasta import parse_fasta, join_references

        names, seqs = parse_fasta(args.fasta)
        joined, refmap = join_references(names, seqs)
        base = args.out[:-4] if args.out.endswith(".npz") else args.out
        large = args.large_index or len(joined) >= (1 << 32) - 1
        save_bt2(joined, refmap, base, large=large,
                 off_rate=4 if args.offrate is None else args.offrate,
                 ftab_chars=10 if args.ftab_chars is None
                 else args.ftab_chars)
        ext = "bt2l" if large else "bt2"
        print(f"wrote {base}.[1234].{ext} + .rev.[12].{ext} "
              f"({len(joined)} bases) in {time.time()-t0:.1f}s",
              file=sys.stderr)
        return
    srate = args.sa_rate if args.offrate is None else (1 << args.offrate)
    fm = build_index(args.fasta, ftab_k=args.ftab_chars, srate=srate,
                     bmax=args.bmax, bmaxdivn=args.bmaxdivn, dcv=args.dcv)
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    fm.save(out)
    print(
        f"built index: {fm.n} bases, {fm.nrows} rows, "
        f"{len(fm.refmap.refnames)} refs in {time.time()-t0:.1f}s",
        file=sys.stderr,
    )


def _int_prefix(s: str) -> int:
    """C++ istringstream>>int semantics: parse the leading integer and
    stop at the first non-digit (the reference's policy parser reads
    fractional RDG/RFG/MMP values this way, truncating at the '.')."""
    m = re.match(r"\s*[+-]?\d+", s)
    return int(m.group()) if m else 0


def _parse_fasta_cont(spec: str) -> tuple[int, int]:
    """-F <len>,<freq> — the reference parses a bare comma pair
    (parsePair, bt2_search.cpp:1031-1033; its usage text's
    "k:<int>,i:<int>" spelling is also accepted here)."""
    k, freq = None, 1
    for pos, tok in enumerate(spec.split(",")):
        key, colon, val = tok.partition(":")
        if not colon:
            if pos == 0:
                k = int(tok)
            else:
                freq = int(tok)
        elif key == "k":
            k = int(val)
        elif key == "i":
            freq = int(val)
    if not k or k < 1:
        raise SystemExit("-F requires k:<int> (window length)")
    return k, max(1, freq)


def _transform_reads(src, args, paired: bool):
    """Input transforms: -u/-s skip/stop, -5/-3 trims, --trim-to
    (bt2_search.cpp parseOption: -u ARG_UPTO, -s ARG_SKIP, ARG_TRIM5/3,
    ARG_TRIM_TO)."""
    def trim(rd):
        if args.phred64:
            rd.qual = np.maximum(rd.qual.astype(np.int16) - 31, 0).astype(np.uint8)
        elif args.solexa_quals:
            # Solexa 64-offset log-odds -> phred (solexaToP/solToPhred,
            # qual.h): phred = round(10*log10(1 + 10^(sol/10)))
            sol = np.maximum(rd.qual.astype(np.float64) - 31.0, -10.0)
            rd.qual = np.round(
                10.0 * np.log10(1.0 + np.power(10.0, sol / 10.0))
            ).astype(np.uint8)
        t5, t3 = args.trim5, args.trim3
        if args.trim_to is not None and len(rd.seq) > args.trim_to[1]:
            side, n = args.trim_to
            if side == 5:
                t5 = max(t5, len(rd.seq) - n)
            else:
                t3 = max(t3, len(rd.seq) - n)
        if t5 or t3:
            end = len(rd.seq) - t3
            rd.seq = rd.seq[t5:end]
            rd.qual = rd.qual[t5:end]
        return rd

    skipped = 0
    taken = 0
    for item in src:
        if skipped < args.skip_reads:
            skipped += 1
            continue
        if args.upto is not None and taken >= args.upto:
            return
        taken += 1
        p = isinstance(item, tuple) if paired == "auto" else paired
        if p:
            yield (trim(item[0]), trim(item[1]))
        else:
            yield trim(item)


def cmd_align(args):
    from .io.fastq import (
        open_reads, open_paired_reads, read_interleaved, read_tab5,
        read_tab6, batch_iterator,
    )
    from .io.sam import SamWriter
    from .models.aligner import TPUAligner, AlignOpts
    from .models.paired import PairedAligner
    from .models.pipeline import run_pipeline
    from .utils.cigar import cigar_string
    from .utils.pe import PEPolicy, policy_from_flags
    from .utils.presets import PRESETS, PRESETS_LOCAL, DEFAULT_PRESET
    from .utils.scoring import Scoring, SimpleFunc

    # --local / -local presets: soft-clipping local alignment. The fork
    # warns "not supported" (bt2_search.cpp:1345-1348); we restore
    # upstream bowtie2's local mode (match bonus 2, --score-min G,20,8,
    # -local presets, local MAPQ table) on the sw_local_* kernels.
    if getattr(args, "preset_local", None):
        args.local = True
        args.preset = args.preset_local
    if args.M is not None:
        print("Warning: -M is deprecated.  Use -D and -R to adjust "
              "effort instead.", file=sys.stderr)
    if args.N and args.N != 0:
        print("warning: only -N 0 (exact seeds) is supported; using 0",
              file=sys.stderr)
    if args.non_deterministic:
        # the fork rejects it the same way (bt2_search.cpp:1112)
        print("WARNING: arbitraryRandom not supported", file=sys.stderr)
    if args.met_read:
        # bt2_search.cpp:1270-1272
        print("WARNING: metricsPerRead not supported", file=sys.stderr)
    if args.no_sse8:
        # bt2_search.cpp:1351-1357 (no ENABLE_I16 in the default build)
        print("WARNING: no-sse8 not supported", file=sys.stderr)
    if args.sample:
        # bt2_search.cpp:1291-1293
        print("WARNING: sampleFrac not supported", file=sys.stderr)
    # the fork's other warn-and-ignore cases, with its exact text
    # (bt2_search.cpp:1036,1060,1095,1144,1308). Where the fork warns on
    # capabilities we DO implement (-a, -u, -s, --local, --met*), ours
    # work instead — documented capability supersets.
    for flagval, msg in (
        (getattr(args, "bwa_sw_like", False), "BWA_SW_LIKE"),
        (getattr(args, "seed_summ", False)
         or getattr(args, "seed_summary", False), "seedSumm"),
        (getattr(args, "cache", False), "USE_CACHE"),
        (getattr(args, "thread_piddir", None), "THREAD_PIDDIR"),
        (getattr(args, "read_times", False), "Read_Times"),
    ):
        if flagval:
            print(f"WARNING: {msg} not supported", file=sys.stderr)
    if args.sra_acc:
        print("WARNING: this build does not support SRA accessions "
              "(reference: USE_SRA builds only)", file=sys.stderr)
        sys.exit(1)
    if args.multiseed:
        # --multiseed mms,len[,F[,a[,b]]] expands to a policy string
        # (bt2_search.cpp:1455-1474)
        f = args.multiseed.split(",")
        if len(f) > 5 or not f[0]:
            print("Error: expected 5 or fewer comma-separated arguments "
                  f"to --multiseed option, got {len(f)}", file=sys.stderr)
            sys.exit(1)
        pol = f"SEED={f[0]}"
        if len(f) > 1:
            pol += f";SEEDLEN={f[1]}"
        if len(f) > 2:
            pol += f";IVAL={','.join(f[2:5])}"
        args.policy = (args.policy or []) + [pol]

    fm = _load_index(args.index)
    if getattr(args, "offrate", None) is not None:
        # -o at align time: SPARSER SA sample than built (offrate
        # override, bt2_io.cpp:220-235); smaller resident sample,
        # longer walks. Only overrides upward, like the reference.
        new_rate = 1 << args.offrate
        if new_rate > fm.srate:
            fm = fm.subsample_sa(new_rate)

    # -P/--preset <name>: preset by name; the last one wins (applyPreset
    # composition, bt2_search.cpp:1632-1638)
    for nm in args.preset_by_name or []:
        base = nm[:-6] if nm.endswith("-local") else nm
        if base not in PRESETS:
            print(f"Unknown preset: {nm}", file=sys.stderr)
            sys.exit(1)
        if nm.endswith("-local"):
            args.preset_local = nm
        else:
            args.preset = nm
    if getattr(args, "preset_local", None) and not args.local:
        args.local = True
        args.preset = args.preset_local

    # --policy: ';'-separated NAME=VAL policy-string overrides
    # (SeedAlignmentPolicy::parsePolicy token set, aligner_seed_policy.cpp:
    # MA MMP NP RDG RFG MIN NCEIL SEED SEEDLEN IVAL ROUNDS DPS). Applied
    # over the preset; an explicit flag for the same knob wins.
    for pol in args.policy or []:
        for tok in pol.split(";"):
            tok = tok.strip()
            if not tok:
                continue
            name, _, val = tok.partition("=")
            name = name.upper()
            if name == "SEED":
                # only exact seeds are supported (like the fork); a
                # nonzero SEED= reuses the -N warning path
                args.N = args.N or int(val.split(",")[0])
            elif name == "SEEDLEN":
                if args.seed_len is None:
                    args.seed_len = int(val)
            elif name == "IVAL":
                args.ival = args.ival or val
            elif name == "ROUNDS":
                if args.reseed is None:
                    args.reseed = int(val)
            elif name == "DPS":
                if args.dps is None:
                    args.dps = int(val)
            elif name == "MMP":
                # MMP={Cxx|Q[,mx[,mn]]|R} (parsePolicy,
                # aligner_seed_policy.cpp:368-440): Cxx = constant
                # attached to the 'C', Q = qual-scaled, R = maq-rounded
                if not args.mp:
                    f = val.split(",")
                    if f[0][:1] == "C":
                        cval = _int_prefix(f[0][1:] or (
                            f[1] if len(f) > 1 else "6"))
                        args.mp = f"{cval},{cval}"
                    elif f[0][:1] == "Q":
                        mx = _int_prefix(f[1]) if len(f) > 1 else 6
                        mn = _int_prefix(f[2]) if len(f) > 2 else 2
                        args.mp = f"{mx},{mn}"
                    elif f[0][:1] == "R":
                        args.mp = "R"  # COST_MODEL_ROUNDED_QUAL
            elif name == "MA":
                if args.ma is None:
                    args.ma = int(val)
            elif name == "NP":
                # NP={Cxx|Q|R}: Q keeps the constant (initPens with
                # consMin==consMax is constant anyway, scoring.h:170);
                # R = maq-rounded qual (aligner_seed_policy.cpp:448-478)
                if val[:1] == "C":
                    args.np = (_int_prefix(val[1:])
                               if args.np == 1 else args.np)
                elif val[:1] == "R":
                    args.np_rounded = True
            elif name == "RDG":
                args.rdg = args.rdg or val
            elif name == "RFG":
                args.rfg = args.rfg or val
            elif name == "MIN":
                args.score_min = args.score_min or val
            elif name == "NCEIL":
                args.n_ceil = args.n_ceil or val
            else:
                print(f"warning: unknown policy token '{name}' ignored",
                      file=sys.stderr)

    # ---- policy: preset then explicit overrides (presets.cpp order) ----
    if args.local:
        # --local remaps plain preset names to their -local variants
        # (%LOCAL% substitution in the reference's preset cases)
        base = args.preset or "sensitive"
        if not base.endswith("-local"):
            base += "-local"
        preset = PRESETS_LOCAL[base]
    else:
        preset = PRESETS[args.preset or DEFAULT_PRESET]
    seed_len = args.seed_len if args.seed_len is not None else preset.seed_len
    ival = SimpleFunc.parse(args.ival) if args.ival else preset.ival
    nrounds = args.reseed if args.reseed is not None else preset.nrounds
    dps = args.dps if args.dps is not None else preset.dps

    mmp_rounded = args.mp == "R"
    mp = args.mp.split(",") if args.mp and not mmp_rounded else ["6", "2"]
    # gap penalty components parse with istringstream>>int semantics —
    # a numeric PREFIX, so fractional policy values truncate
    # (aligner_seed_policy.cpp:484-530; corpus regressions use doubles)
    rdg = args.rdg.split(",") if args.rdg else ["5", "3"]
    rfg = args.rfg.split(",") if args.rfg else ["5", "3"]
    sc_kwargs = dict(
        mmp_max=_int_prefix(mp[0]),
        mmp_min=_int_prefix(mp[1] if len(mp) > 1 else mp[0]),
        mmp_rounded=mmp_rounded,
        npen=args.np, np_rounded=getattr(args, "np_rounded", False),
        rdg_const=_int_prefix(rdg[0]),
        rdg_linear=_int_prefix(rdg[1]) if len(rdg) > 1 else 3,
        rfg_const=_int_prefix(rfg[0]),
        rfg_linear=_int_prefix(rfg[1]) if len(rfg) > 1 else 3,
        ignore_quals=args.ignore_quals,
        gap_barrier=args.gbar,
    )
    if args.score_min:
        sc_kwargs["score_min"] = SimpleFunc.parse(args.score_min)
    elif args.local:
        # DEFAULT_MIN_CONST_LOCAL/LINEAR_LOCAL = G,20,8 (scoring.h:54-55)
        sc_kwargs["score_min"] = SimpleFunc.parse("G,20,8")
    if args.ma is not None:
        sc_kwargs["match_bonus"] = args.ma
    elif args.local:
        sc_kwargs["match_bonus"] = 2  # DEFAULT_MATCH_BONUS_LOCAL
    if args.n_ceil:
        sc_kwargs["n_ceil"] = SimpleFunc.parse(args.n_ceil)
    sc = Scoring(**sc_kwargs)

    opts = AlignOpts(
        seed_len=seed_len, ival=ival, nrounds=nrounds, dps=dps,
        nofw=args.nofw, norc=args.norc, local=args.local,
        khits=args.khits, allhits=args.allhits,
        mapqv=args.mapqv, maxhalf=args.dpad,
        seed_boost=args.seed_boost, rng_seed=args.seed,
        tighten=args.tighten,
        overhang=args.overhang,
        upfront_rescue=not args.no_1mm_upfront,
    )
    aligner = TPUAligner(fm, sc, opts)
    # -p 2+: a second aligner instance (sharing the device-resident
    # index) feeds a second pipeline align worker, so one batch's host
    # phases overlap the other's device waits (models/pipeline.py).
    # More than 2 never helps on this single host core.
    aligner2 = (TPUAligner(fm, sc, opts)
                if getattr(args, "threads", 1) >= 2 else None)

    fmt = ("fasta" if args.fmt_fasta else
           "raw" if args.fmt_raw else
           "qseq" if args.fmt_qseq else
           "fastq" if args.fmt_fastq else None)
    paired_src = None
    mixed_src = None
    if args.m1 and args.m2:
        if args.cmdline:
            from .io.fastq import cmdline_reads

            paired_src = zip(cmdline_reads(args.m1),
                             cmdline_reads(args.m2))
        else:
            paired_src = open_paired_reads(args.m1, args.m2, fmt=fmt,
                                           int_quals=args.int_quals)
    elif args.interleaved:
        paired_src = read_interleaved(args.interleaved)
    elif args.tab6:
        paired_src = read_tab6(args.tab6)
    elif args.tab5:
        # --tab5/--12 muxes 3-field (unpaired) and 5-field (paired)
        # records PER LINE (TabbedPatternSource / PatternComposer,
        # pat.h:961-1071, pat.cpp:1530-1700): the mixed drive below
        # routes each batch's pairs through the paired policy and its
        # singles through the unpaired engine, emitting in line order
        mixed_src = read_tab5(args.tab5)
    elif args.bam and args.bam_paired:
        from .io.bam import read_bam_pairs

        paired_src = read_bam_pairs(
            args.bam, preserve_tags=args.preserve_tags)
    elif args.cmdline and args.reads:
        pass
    elif not args.reads and not args.bam:
        print("error: no input reads (-U, -1/-2, --interleaved, --tab5/6, "
              "-b, -c)", file=sys.stderr)
        sys.exit(1)

    out = open(args.sam, "w") if args.sam != "-" else sys.stdout
    cl = " ".join(sys.argv)
    if args.qualities and not args.fmt_fasta:
        # bt2_search.cpp:1704-1708
        print("Error: one or more quality files were specified with -Q but "
              "-f was not\nenabled.  -Q works only in combination with -f "
              "and -C.", file=sys.stderr)
        sys.exit(1)
    if args.sam_append_comment and (
        args.bam or args.tab5 or args.tab6 or args.fmt_raw or args.fmt_qseq
        or args.cmdline
    ):
        # bt2_search.cpp:1700-1703
        print("Error --sam-append-comment only works with FASTA (-f) and "
              "FASTQ (-q) formats. ", file=sys.stderr)
        sys.exit(1)
    w = SamWriter(
        out, fm.refmap.refnames, fm.refmap.reflens, prog_args=cl,
        rg_id=args.rg_id, rg_fields=args.rg or [],
        no_hd=args.no_hd, no_sq=args.no_sq, xeq=args.xeq,
        no_qname_trunc=args.sam_no_qname_trunc,
        omit_sec_seq=args.omit_sec_seq,
        append_comment=args.sam_append_comment,
        refidx=args.refidx, fullref=args.fullref,
    )
    w.write_header()
    def _wopen(path, force=None):
        """--un/--al family writer; -gz/-bz2 option variants (or file
        extensions) compress (bt2_search.cpp:828 usage)."""
        if force == "gz" or (force is None and path.endswith(".gz")):
            import gzip as _gz

            return _gz.open(path, "wt")
        if force == "bz2" or (force is None and path.endswith(".bz2")):
            import bz2 as _bz2

            return _bz2.open(path, "wt")
        return open(path, "w")

    # --un-gz/--un-bz2 (etc.) are the same dumps with forced compression
    for base in ("un", "al", "un_conc", "al_conc", "un_mates"):
        for comp in ("gz", "bz2"):
            v = getattr(args, f"{base}_{comp}", None)
            if v:
                setattr(args, base, v)
                setattr(args, f"{base}_force", comp)

    un_out = _wopen(args.un, getattr(args, "un_force", None)) if args.un else None
    al_out = _wopen(args.al, getattr(args, "al_force", None)) if args.al else None

    def _conc_pair(base, force):
        """Mate-file naming per the bowtie2 wrapper (bowtie2:519-536):
        % substitutes the mate number; otherwise .1/.2 goes BEFORE the
        final extension (un.fq -> un.1.fq), or is appended if none."""
        if "%" in base:
            return (_wopen(base.replace("%", "1"), force),
                    _wopen(base.replace("%", "2"), force))
        root, dot, ext = base.rpartition(".")
        if dot and "/" not in ext:
            return (_wopen(f"{root}.1.{ext}", force),
                    _wopen(f"{root}.2.{ext}", force))
        return _wopen(base + ".1", force), _wopen(base + ".2", force)

    unc_out = (_conc_pair(args.un_conc, getattr(args, "un_conc_force", None))
               if args.un_conc else None)
    alc_out = (_conc_pair(args.al_conc, getattr(args, "al_conc_force", None))
               if args.al_conc else None)
    # --un-mates: unaligned mates of pairs that aligned neither
    # concordantly nor discordantly, one file per mate (bowtie2:612-618)
    unm_out = (_conc_pair(args.un_mates, getattr(args, "un_mates_force",
                                                 None))
               if args.un_mates else None)

    def fq_dump(f, rd):
        f.write(f"@{rd.name}\n{_dec(rd.seq)}\n+\n{w.qual_str(rd.qual)}\n")

    from .utils.dna import decode as _dec

    # --met N: periodic in-flight metrics lines (reference emits every N
    # seconds to --met-file / --met-stderr, bt2_search.cpp ARG_METRIC_IVAL)
    emitter = None
    if args.met_file or args.met_stderr:
        from .utils.metrics import PeriodicMetrics

        srcs = [aligner.metrics] + (
            [aligner2.metrics] if aligner2 is not None else []
        )
        emitter = PeriodicMetrics(
            srcs, interval=args.met, path=args.met_file,
            stderr=args.met_stderr,
        ).start()

    def emit_unpaired(batch, results):
        for rd, res in zip(batch, results):
            if res.status == "aligned":
                if al_out:
                    fq_dump(al_out, rd)
                w.write_aligned(
                    rd, res.fw, w.refnames[res.refid],
                    res.refoff, res.mapq, w.cigar_str(res),
                    res.score, res.secbest, res.stats,
                    nhits_for_summary=res.nhits,
                )
                for ex in res.extra:
                    w.write_aligned(
                        rd, ex.fw, w.refnames[ex.refid],
                        ex.refoff, ex.mapq, w.cigar_str(ex),
                        ex.score, ex.secbest, ex.stats, secondary=True,
                    )
            else:
                if un_out:
                    fq_dump(un_out, rd)
                if not args.no_unal:
                    w.write_unaligned(rd, yf=res.filt)
                else:
                    w.summary.add(0)

    def _qc_wrap(fn):
        # --qc-filter: qseq filter-field-0 reads never align
        # (qcfilt, bt2_search.cpp:2517-2520; YF:Z:QC)
        if not args.qc_filter:
            return fn

        def wrapped(batch):
            from .models.aligner import AlnResult

            keep = [rd for rd in batch if not rd.qcfail]
            sub = iter(fn(keep) if keep else [])
            return [AlnResult(status="unaligned", filt="QC")
                    if rd.qcfail else next(sub) for rd in batch]

        return wrapped

    t0 = time.time()
    if paired_src is not None or mixed_src is not None:
        m1fw, m2fw = {"fr": (True, False), "rf": (False, True),
                      "ff": (True, True)}[args.orient]
        pe = PEPolicy(
            pol=policy_from_flags(m1fw, m2fw),
            minfrag=args.minins,
            maxfrag=args.maxins,
            dovetail_ok=args.dovetail,
            contain_ok=not args.no_contain,
            olap_ok=not args.no_overlap,
        )
        pal = PairedAligner(aligner, pe, mixed=not args.no_mixed,
                            discord=not args.no_discordant,
                            qc_filter=args.qc_filter)
        src = _transform_reads(paired_src, args, True)

        def emit_pairs(batch, results):
            for (rd1, rd2), pres in zip(batch, results):
                both_unal = (pres.m1.status != "aligned"
                             and pres.m2.status != "aligned")
                if unc_out and pres.cat != "concord":
                    fq_dump(unc_out[0], rd1)
                    fq_dump(unc_out[1], rd2)
                if alc_out and pres.cat == "concord":
                    fq_dump(alc_out[0], rd1)
                    fq_dump(alc_out[1], rd2)
                if unm_out and pres.cat == "mixed":
                    if pres.m1.status != "aligned":
                        fq_dump(unm_out[0], rd1)
                    if pres.m2.status != "aligned":
                        fq_dump(unm_out[1], rd2)
                if not (args.no_unal and both_unal):
                    w.write_pair(rd1, rd2, pres.m1, pres.m2, pres.cat,
                                 pres.tlen1, pres.tlen2,
                                 unique=not pres.extras)
                    for em1, em2, et1, et2 in pres.extras:
                        w.write_pair(rd1, rd2, em1, em2, pres.cat,
                                     et1, et2, secondary=True)
                else:
                    w.summary.add_pair(pres.cat, 0, 0)

        pal_fns = None
        if aligner2 is not None:
            pal2 = PairedAligner(aligner2, pe, mixed=not args.no_mixed,
                                 discord=not args.no_discordant,
                                 qc_filter=args.qc_filter)
            pal_fns = [pal.align_pairs, pal2.align_pairs]
        if mixed_src is not None:
            # --tab5/--12 mixed drive: each batch's 5-field lines run
            # through the paired policy and its 3-field lines through
            # the unpaired engine; emission preserves line order (the
            # reference's PatternComposer contract, pat.h:961-1071)
            src = _transform_reads(mixed_src, args, "auto")
            up_fn = _qc_wrap(aligner.align_batch)

            def align_mixed(batch, _pal=pal, _up=up_fn):
                pi = [i for i, x in enumerate(batch)
                      if isinstance(x, tuple)]
                si = [i for i, x in enumerate(batch)
                      if not isinstance(x, tuple)]
                out = [None] * len(batch)
                if pi:
                    for i, r in zip(pi, _pal.align_pairs(
                            [batch[i] for i in pi])):
                        out[i] = r
                if si:
                    for i, r in zip(si, _up([batch[i] for i in si])):
                        out[i] = r
                return out

            def emit_mixed(batch, results):
                for item, res in zip(batch, results):
                    if isinstance(item, tuple):
                        emit_pairs([item], [res])
                    else:
                        emit_unpaired([item], [res])

            mix_fns = None
            if aligner2 is not None:
                up2 = _qc_wrap(aligner2.align_batch)
                mix_fns = [
                    align_mixed,
                    lambda b: align_mixed(b, _pal=pal2, _up=up2),
                ]
            nreads = run_pipeline(
                batch_iterator(src, args.batch), align_mixed, emit_mixed,
                align_fns=mix_fns,
            )
        else:
            nreads = 2 * run_pipeline(
                batch_iterator(src, args.batch), pal.align_pairs,
                emit_pairs, align_fns=pal_fns,
            )
    else:
        if args.cmdline:
            from .io.fastq import cmdline_reads

            rsrc = cmdline_reads(args.reads)
        elif args.bam:
            from .io.bam import read_bam

            rsrc = read_bam(args.bam, preserve_tags=args.preserve_tags)
        elif args.fasta_cont:
            from .io.fastq import read_fasta_continuous

            k, freq = _parse_fasta_cont(args.fasta_cont)
            rsrc = read_fasta_continuous(args.reads, k, freq)
        else:
            rsrc = open_reads(args.reads, fmt=fmt,
                              int_quals=args.int_quals)
        src = _transform_reads(rsrc, args, False)

        nreads = run_pipeline(
            batch_iterator(src, args.batch), _qc_wrap(aligner.align_batch),
            emit_unpaired,
            align_fns=([_qc_wrap(aligner.align_batch),
                        _qc_wrap(aligner2.align_batch)]
                       if aligner2 is not None else None),
        )
    dt = time.time() - t0
    if emitter is not None:
        emitter.stop()  # final metrics line + file close
    print(w.summary.render(), file=sys.stderr)
    if args.time or args.met_stderr:
        # phase profile (MyTimer analog) + pipeline counters
        aligner.timers.report()
        aligner.metrics.report()
        if aligner2 is not None:
            aligner2.timers.report()
            aligner2.metrics.report()
    if args.time:
        print(f"Time searching: {dt:.2f}s "
              f"({nreads/max(dt,1e-9):.1f} reads/s)", file=sys.stderr)
    for f in (un_out, al_out):
        if f:
            f.close()
    for pairf in (unc_out, alc_out):
        if pairf:
            pairf[0].close()
            pairf[1].close()
    if out is not sys.stdout:
        out.close()


def cmd_inspect(args):
    from .utils import dna

    fm = _load_index(args.index)
    if args.summary:
        # field names/order pinned against bowtie2-inspect-s -s output
        # (bt2_inspect.cpp print_index_summary); the flag words are what
        # bowtie2-build writes for every index it produces
        print("Flags\t1")
        print("Reverse flags\t5")
        print("2.0-compatible\t1")
        print(f"SA-Sample\t1 in {fm.srate}")
        print(f"FTab-Chars\t{fm.ftab_k}")
        for i, (name, ln) in enumerate(
            zip(fm.refmap.refnames, fm.refmap.reflens), 1
        ):
            print(f"Sequence-{i}\t{name}\t{ln}")
    elif args.names:
        for name in fm.refmap.refnames:
            print(name)
    else:
        # reconstruct reference sequences from the stored 2-bit text + map
        rm = fm.refmap
        text = dna.unpack_2bit(fm.ref_words, fm.n)
        for rid, name in enumerate(rm.refnames):
            seq = np.full(rm.reflens[rid], 4, np.int8)
            for fi in range(len(rm.frag_joined)):
                if rm.frag_refid[fi] != rid:
                    continue
                s, r, l = rm.frag_joined[fi], rm.frag_ref[fi], rm.frag_len[fi]
                seq[r : r + l] = text[s : s + l]
            print(f">{name}")
            s = dna.decode(seq)
            w = max(1, args.across)
            for i in range(0, len(s), w):
                print(s[i : i + w])


def _parse_trim_to(s: str):
    """--trim-to [3:|5:]<int>; side must be 3 or 5 and the count
    positive (bt2_search.cpp ARG_TRIM_TO validation aborts on both)."""
    side, n = 3, s
    if ":" in s:
        side_s, n = s.split(":")
        side = int(side_s)
    if side not in (3, 5):
        raise SystemExit(
            "error: trim-to position must be either 3 or 5"
        )
    if int(n) < 0:
        raise SystemExit("error: the number of bases to trim must be "
                         "a positive value")
    return (side, int(n))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bt2tpu")
    ap.add_argument("--version", action="version",
                    version="bt2tpu 0.1 (bowtie2 2.5.4-compatible, JAX)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build FM index from FASTA")
    b.add_argument("fasta", nargs="+")
    b.add_argument("out")
    b.add_argument("-t", "--ftabchars", "--ftab-chars", type=int,
                   default=None, dest="ftab_chars",
                   help="ftab k-mer length (bowtie2-build -t; default "
                        "auto: 12 for genomes >= 1 Mbp, 10 below)")
    b.add_argument("--sa-rate", type=int, default=8,
                   help="text-position SA sample rate (native .npz layout)")
    b.add_argument("-o", "--offrate", type=int, default=None,
                   help="bowtie2-build -o: SA sample every 2^o rows; for"
                        " .npz this maps to --sa-rate 2^o")
    b.add_argument("--large-index", action="store_true",
                   help="force the 64-bit .bt2l format (bt2_idx.cpp:29-37)")
    b.add_argument("--bt2", action="store_true",
                   help="write a bowtie2-compatible .bt2 index set")
    # bowtie2-build tuning knobs for its blockwise Kärkkäinen sorter,
    # accepted for drop-in compatibility: SA-IS is linear-time and
    # in-memory, so bucket/diff-cover/threading knobs have no analog
    b.add_argument("-f", action="store_true", help=argparse.SUPPRESS)
    b.add_argument("-a", "--noauto", action="store_true",
                   help=argparse.SUPPRESS)
    b.add_argument("-p", "--packed", action="store_true",
                   help=argparse.SUPPRESS)
    b.add_argument("--bmax", type=int, help=argparse.SUPPRESS)
    b.add_argument("--bmaxdivn", type=int, help=argparse.SUPPRESS)
    b.add_argument("--dcv", type=int, help=argparse.SUPPRESS)
    b.add_argument("--nodc", action="store_true", help=argparse.SUPPRESS)
    b.add_argument("-r", "--noref", action="store_true",
                   help=argparse.SUPPRESS)
    b.add_argument("--threads", type=int, help=argparse.SUPPRESS)
    b.add_argument("--seed", type=int, help=argparse.SUPPRESS)
    b.add_argument("-q", "--quiet", action="store_true",
                   help=argparse.SUPPRESS)
    b.add_argument("-v", "--verbose", action="store_true",
                   help=argparse.SUPPRESS)
    # remaining bowtie2-build table entries (endianness/layout knobs of
    # its on-disk side format, debug switches): accepted, no analog in
    # the blocked .npz layout; --ntoa warns (it changes index content)
    for _flag in ("--big", "--little", "--entiresa", "--noblocks",
                  "--reverse-each", "--sa", "--justref", "--wrapper-basic",
                  "-3"):
        b.add_argument(_flag, action="store_true", help=argparse.SUPPRESS)
    b.add_argument("--bmaxmultsqrt", type=int, help=argparse.SUPPRESS)
    b.add_argument("--linerate", type=int, help=argparse.SUPPRESS)
    b.add_argument("--linesperside", type=int, help=argparse.SUPPRESS)
    b.add_argument("--wrapper", help=argparse.SUPPRESS)
    b.add_argument("--ntoa", action="store_true", help=argparse.SUPPRESS)
    b.add_argument("--usage", action="help")
    b.set_defaults(fn=cmd_build)

    a = sub.add_parser("align", help="align reads, emit SAM")
    a.add_argument("-x", "--index", required=True)
    # input
    a.add_argument("-U", "--reads", default=None)
    a.add_argument("-1", "--m1", dest="m1", default=None)
    a.add_argument("-2", "--m2", dest="m2", default=None)
    a.add_argument("--interleaved", default=None)
    a.add_argument("--tab5", default=None)
    a.add_argument("--tab6", default=None)
    a.add_argument("-q", dest="fmt_fastq", action="store_true")
    a.add_argument("-f", dest="fmt_fasta", action="store_true")
    a.add_argument("-r", dest="fmt_raw", action="store_true")
    a.add_argument("--qseq", dest="fmt_qseq", action="store_true")
    # -c is a FLAG (as in bowtie2): -U/-1/-2 then hold the sequences
    # themselves, comma-separated, each optionally SEQ:QUALS
    a.add_argument("-c", "--cmdline", action="store_true")
    a.add_argument("-b", "--bam", default=None)
    a.add_argument("--align-paired-reads", dest="bam_paired",
                   action="store_true")
    a.add_argument("--preserve-tags", dest="preserve_tags",
                   action="store_true",
                   help="keep BAM input's aux tags on output records "
                        "(sam.cpp printPreservedOptFlags)")
    a.add_argument("--sam-append-comment", dest="sam_append_comment",
                   action="store_true",
                   help="append the read name's comment to each record "
                        "(BC:Z: prefixed for CASAVA comments, sam.h)")
    # -Q/--Q1/--Q2: legacy FASTA+separate-quality-file inputs. The
    # reference fork parses and VALIDATES these (must combine with -f,
    # bt2_search.cpp:1704-1708) but never consumes them — no
    # FastaQualPatternSource exists in pat.cpp, so quals stay 'I'.
    # Reproduced exactly: accepted, validated, ignored.
    a.add_argument("-Q", "--qualities", dest="qualities", default=None)
    a.add_argument("--Q1", dest="qualities1", default=None)
    a.add_argument("--Q2", dest="qualities2", default=None)
    a.add_argument("-u", "--upto", "--qupto", type=int, default=None)
    a.add_argument("-s", "--skip", dest="skip_reads", type=int, default=0)
    a.add_argument("-5", "--trim5", type=int, default=0)
    a.add_argument("-3", "--trim3", type=int, default=0)
    a.add_argument("--trim-to", type=_parse_trim_to, default=None)
    a.add_argument("--phred33", action="store_true")
    a.add_argument("--phred64", action="store_true")
    a.add_argument("--solexa-quals", action="store_true",
                   help="quals are Solexa 64-offset log-odds (qual.h)")
    a.add_argument("-F", "--fasta-cont", default=None, metavar="k:N,i:N",
                   help="sample k-length windows every i bases from FASTA"
                        " (FastaContinuousPatternSource, pat.h:690)")
    a.add_argument("--gbar", type=int, default=4,
                   help="disallow gaps within this many positions of read"
                        " ends (gGapBarrier, scoring.h)")
    a.add_argument("--int-quals", action="store_true")
    # output
    a.add_argument("-S", "--sam", default="-")
    a.add_argument("--un", default=None)
    a.add_argument("--al", default=None)
    a.add_argument("--un-conc", default=None)
    a.add_argument("--al-conc", default=None)
    a.add_argument("--un-mates", default=None,
                   help="write unaligned mates of non-conc/disc pairs, "
                        "one file per mate (bowtie2 wrapper :612-618)")
    for _b in ("un", "al", "un-conc", "al-conc", "un-mates"):
        for _c in ("gz", "bz2"):
            a.add_argument(f"--{_b}-{_c}", default=None,
                           dest=f"{_b.replace('-', '_')}_{_c}")
    a.add_argument("--no-unal", action="store_true")
    a.add_argument("--rg-id", default=None)
    a.add_argument("--rg", action="append", default=None)
    a.add_argument("--no-hd", action="store_true")
    a.add_argument("--no-sq", action="store_true")
    a.add_argument("--xeq", action="store_true")
    a.add_argument("-t", "--time", action="store_true")
    a.add_argument("--qc-filter", action="store_true",
                   help="discard reads whose qseq filter field is 0 "
                        "(YF:Z:QC; qcfilt bt2_search.cpp:2517-2520)")
    a.add_argument("--met-stderr", "--metrics-stderr", action="store_true",
                   dest="met_stderr")
    a.add_argument("--met-file", "--metrics-file", default=None,
                   dest="met_file")
    a.add_argument("--met", "--metrics", type=int, default=1, dest="met",
                   help="metrics reporting interval in seconds "
                        "(ARG_METRIC_IVAL; ours emits per batch)")
    a.add_argument("--sam-no-qname-trunc", action="store_true",
                   help="keep full QNAMEs (default truncates at first "
                        "whitespace / 255 chars; truncQname sam.h:320-326)")
    a.add_argument("--omit-sec-seq", action="store_true",
                   help="print * for SEQ/QUAL on secondary alignments")
    a.add_argument("--mapq-v", dest="mapqv", type=int, default=2)
    a.add_argument("--reorder", action="store_true")  # always ordered
    a.add_argument("--seed", type=int, default=0,
                   help="global seed folded into every per-read RNG seed "
                        "(genRandSeed, pat.cpp:45-82)")
    # accepted no-ops for surface compatibility (behavior already default
    # or not applicable to the deterministic batched engine)
    a.add_argument("--non-deterministic", action="store_true")
    a.add_argument("--no-1mm-upfront", action="store_true")
    a.add_argument("--mm", action="store_true")
    a.add_argument("-p", "--threads", type=int, default=1,
                   help="2+ adds a second pipelined align worker (host "
                        "phases of one batch overlap device waits of the "
                        "other; output order unchanged)")
    a.add_argument("--batch", type=int, default=8192)
    # presets / policy
    a.add_argument("--very-fast", dest="preset", action="store_const", const="very-fast")
    a.add_argument("--fast", dest="preset", action="store_const", const="fast")
    a.add_argument("--sensitive", dest="preset", action="store_const", const="sensitive")
    a.add_argument("--very-sensitive", dest="preset", action="store_const", const="very-sensitive")
    a.add_argument("--end-to-end", action="store_true", default=True)
    a.add_argument("--local", action="store_true", default=False)
    # the -local preset names imply --local (bt2_search.cpp preset cases)
    for _p in ("very-fast", "fast", "sensitive", "very-sensitive"):
        a.add_argument(
            f"--{_p}-local", dest="preset_local", action="store_const",
            const=f"{_p}-local",
        )
    a.add_argument("--ma", type=int, default=None,
                   help="match bonus (local default 2, e2e 0)")
    a.add_argument("-L", "--seed-len", type=int, default=None)
    a.add_argument("-i", "--ival", default=None)
    a.add_argument("-N", type=int, default=0)
    a.add_argument("-D", "--dps", type=int, default=None)
    a.add_argument("-R", "--reseed", type=int, default=None)
    a.add_argument("--seed-boost", type=int, default=300)
    # --tighten: -M minsc raising mode (bt2_search.cpp:233,431,1372)
    a.add_argument("--tighten", type=int, default=3)
    a.add_argument("--mp", default=None)
    a.add_argument("--np", type=int, default=1)
    a.add_argument("--rdg", default=None)
    a.add_argument("--rfg", default=None)
    a.add_argument("--score-min", default=None)
    a.add_argument("--n-ceil", default=None)
    a.add_argument("--ignore-quals", action="store_true")
    a.add_argument("--dpad", type=int, default=15)
    # -o at align time: override (sparsify) the SA sample rate
    # (bt2_io.cpp:220-235)
    a.add_argument("-o", "--offrate", type=int, default=None)
    # --overhang: report alignments that hang off the reference ends —
    # off-end positions align against N and get soft-clipped in the
    # record (gReportOverhangs, bt2_search.cpp:1092)
    a.add_argument("--overhang", action="store_true")
    a.add_argument("--nofw", action="store_true")
    a.add_argument("--norc", action="store_true")
    # reporting
    a.add_argument("-k", "--khits", type=int, default=1)
    a.add_argument("-a", "--all", dest="allhits", action="store_true")
    a.add_argument("-M", type=int, default=None,
                   help="deprecated search-effort knob (bt2_search.cpp:"
                        "1177-1190); the batched engine always finds best"
                        " and second-best within -D/-R budgets")
    # paired-end policy (ref defaults bt2_search.cpp:303-313)
    a.add_argument("-I", "--minins", type=int, default=0)
    a.add_argument("-X", "--maxins", type=int, default=500)
    a.add_argument("--fr", dest="orient", action="store_const", const="fr", default="fr")
    a.add_argument("--rf", dest="orient", action="store_const", const="rf")
    a.add_argument("--ff", dest="orient", action="store_const", const="ff")
    a.add_argument("--no-mixed", action="store_true")
    a.add_argument("--no-discordant", action="store_true")
    a.add_argument("--dovetail", action="store_true")
    a.add_argument("--no-contain", action="store_true")
    a.add_argument("--no-overlap", action="store_true")
    # -P/--preset <name>: apply a preset by name (bt2_search.cpp:1406,
    # applyPreset; the last one given wins, matching the reference's
    # prepend-then-override composition at :1632-1638)
    a.add_argument("-P", "--preset", dest="preset_by_name",
                   action="append", default=None)
    # --policy: ';'-separated NAME=VAL overrides — the raw parsePolicy
    # token surface (internally what --multiseed/--mp/... expand to);
    # exposed directly as an extension
    a.add_argument("--policy", action="append", default=None)
    # output-naming behavior flags (sam.cpp printRefName / printHeader)
    a.add_argument("--refidx", action="store_true",
                   help="refer to reference sequences by 0-based index "
                        "rather than name in RNAME/@SQ")
    a.add_argument("--fullref", action="store_true",
                   help="print the whole reference name (no whitespace "
                        "truncation) in RNAME/@SQ")
    # ---- long-option aliases from the reference's getopt table ----
    _alias = a.add_argument
    _alias("--sam-no-hd", "--sam-noHD", "--sam-nohead", "--sam-no-head",
           "--no-HD", "--no-head", dest="no_hd", action="store_true")
    _alias("--sam-no-sq", "--sam-noSQ", "--sam-nosq", "--no-SQ",
           dest="no_sq", action="store_true")
    _alias("--sam-RG", "--sam-rg", dest="rg", action="append")
    _alias("--sam-rg-id", dest="rg_id")
    _alias("--sam-omit-sec-seq", dest="omit_sec_seq", action="store_true")
    _alias("--integer-quals", dest="int_quals", action="store_true")
    _alias("--phred33-quals", dest="phred33", action="store_true")
    # solexa1.3+ pipelines emit phred64 (qual.h sol 1.3 == phred64)
    _alias("--phred64-quals", "--solexa1.3-quals", dest="phred64",
           action="store_true")
    _alias("--seedlen", dest="seed_len", type=int)
    _alias("--seedival", dest="ival")
    _alias("--seedmms", dest="N", type=int)
    _alias("--seed-rounds", dest="reseed", type=int)
    _alias("--min-score", dest="score_min")
    _alias("--nondeterministic", dest="non_deterministic",
           action="store_true")
    _alias("--quals", dest="qualities")
    _alias("--usage", action="help")
    # --12: bowtie's tab-delimited mate format (name\tseq1\tqual1\tseq2\t
    # qual2 per line) == tab5
    _alias("--12", dest="tab5")
    _alias("--RG", dest="rg", action="append")
    _alias("--output", dest="sam")  # legacy name for -S
    # positive forms of the paired-geometry defaults (already the default)
    a.add_argument("--contain", action="store_true", help=argparse.SUPPRESS)
    a.add_argument("--overlap", action="store_true", help=argparse.SUPPRESS)
    # --shmem: SysV shared-memory index sharing; the analog here is one
    # device copy per process + the persistent compile cache
    a.add_argument("--shmem", action="store_true", help=argparse.SUPPRESS)
    # the fork warns-and-ignores --sample (bt2_search.cpp:1291-1293);
    # SRA accessions need its USE_SRA build
    a.add_argument("--sample", default=None, help=argparse.SUPPRESS)
    a.add_argument("--sra-acc", default=None, help=argparse.SUPPRESS)
    # --multiseed <mms>,<len>[,<ival fn>]: legacy combined seed spec
    a.add_argument("--multiseed", default=None, help=argparse.SUPPRESS)
    # ---- accepted-and-ignored: the reference's dormant/debug/internal
    # knobs (descent params unused by its batched engine, cache sizing for
    # the per-read cache we supersede, logging/sanity toggles); accepting
    # them keeps existing bowtie2 command lines running ----
    for _flag in ("--1mm-upfront", "--exact-upfront", "--no-exact-upfront",
                  "--ungapped", "--no-ungapped", "--no-extend", "--sse8",
                  "--no-cache", "--cache", "--mmsweep", "--read-times",
                  "--mapq-extra", "--mapq-print-inputs", "--scan-narrowed",
                  "--seed-summ", "--seed-summary", "--show-rand-seed",
                  "--startverbose", "--sanity", "--tri", "--unpaired",
                  "--454", "--ion-torrent", "--bwa-sw-like", "--filepar",
                  "--arg-desc", "--pause", "--passthrough", "--hadoopout",
                  "--no-dovetail", "--soft-clipped-unmapped-tlen"):
        a.add_argument(_flag, action="store_true", help=argparse.SUPPRESS)
    for _flag in ("--1mm-minlen", "--dp-fails", "--ug-fails", "--extends",
                  "--dp-fail-streak", "--ee-fail-streak", "--ug-fail-streak",
                  "--fail-streak", "--cachelim", "--cachesz",
                  "--seed-cache-sz", "--local-seed-cache-sz", "--cp-ival",
                  "--cp-min", "--desc-exp", "--desc-fmops", "--desc-kb",
                  "--desc-landing", "--desc-prioritize",
                  "--partition", "--reads-per-batch", "--thread-ceiling",
                  "--snpphred", "--test-25"):  # --tighten is live now
        a.add_argument(_flag, type=int, help=argparse.SUPPRESS)
    for _flag in ("--log-dp", "--log-dp-opp", "--orig", "--thread-piddir",
                  "--wrapper", "--snpfrac", "--seed-off",
                  "--sam-opt-config"):
        a.add_argument(_flag, help=argparse.SUPPRESS)
    # the fork itself warns-and-ignores these (bt2_search.cpp:1257-1272,
    # 1351-1357); mirror its exact behavior in cmd_align
    a.add_argument("--met-read", "--metrics-per-read", dest="met_read",
                   action="store_true", help=argparse.SUPPRESS)
    a.add_argument("--no-sse8", dest="no_sse8", action="store_true",
                   help=argparse.SUPPRESS)
    a.set_defaults(fn=cmd_align)

    i = sub.add_parser("inspect", help="inspect index")
    i.add_argument("index")
    i.add_argument("-s", "--summary", action="store_true")
    i.add_argument("-n", "--names", action="store_true")
    i.add_argument("-a", "--across", type=int, default=60,
                   help="bases per FASTA line (bt2_inspect.cpp)")
    # -e/--ebwt-ref: the reference reconstructs from the BWT instead of
    # the .3/.4 bitpair files; our container always stores the 2-bit text
    # (import from .bt2 runs the inverse-BWT at load), so both paths
    # print the same FASTA. -v accepted for CLI parity.
    i.add_argument("-e", "--ebwt-ref", action="store_true",
                   dest="ebwt_ref")
    i.add_argument("-v", "--verbose", action="store_true")
    i.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    args.fn(args)


def main_align(argv=None):
    """`bt2tpu-align` / the `bowtie2` wrapper analog: align-mode args
    directly (bowtie2 -x idx -U reads.fq -S out.sam)."""
    main(["align", *(sys.argv[1:] if argv is None else argv)])


def main_build(argv=None):
    """`bt2tpu-build` / bowtie2-build analog: REF.fa OUT positionals."""
    main(["build", *(sys.argv[1:] if argv is None else argv)])


def main_inspect(argv=None):
    """`bt2tpu-inspect` / bowtie2-inspect analog."""
    main(["inspect", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
