"""Async host pipeline: input read-ahead + ordered output writer.

The analog of the reference's dedicated parser thread + lock-free ready
queue (PatternSourceReadAheadFactory, pat.h:1283-1402, readAsync :1380)
and its input-order OutputQueue writer (outq.h:31-160). Three stages
overlap: a producer thread parses FASTQ batches ahead, align worker(s)
drive device alignment, and a writer thread formats/emits SAM in strict
input order. Device waits release the GIL, so parsing and emission hide
behind them.

With two align workers (``align_fns`` of length 2, each a distinct
aligner instance so per-batch state never races), batch B's host phases
(rank, candidate collection, finish) run while batch A blocks on the
device — the single-core analog of the fork's phase-barrier OpenMP pool:
device executions serialize on the device either way, so the overlap
converts device wait into host progress. Output stays input-ordered via
sequence-numbered batches reassembled at the writer.
"""

from __future__ import annotations

import heapq
import queue
import threading

_DONE = object()


def align_stream(als, batches, emit_fn=None):
    """Single-thread cross-batch software pipeline: batch k+1's round-0
    mega is QUEUED on the device before batch k's host phases run, so
    the device chews the next batch's seed search while the host frames,
    packs DP problems and finishes reads for the current one — the
    single-stream analog of the fork's resident-batch refill that never
    lets hardware wait (bt2_search.cpp:2297-2888, pat.h:1283-1402), with
    no GIL contention because there is only one host thread (a 1-core
    host fights itself in the 2-worker thread overlap; measured round 3:
    -p2 at genome scale INFLATED Python phases 3x and lost to serial).

    als: >= 2 TPUAligner instances over the SAME index (share=);
    batches: list of read batches; emit_fn(k, results) optional, called
    in input order. Returns the per-batch results list."""
    nals = len(als)
    assert nals >= 2, "align_stream needs two aligner instances"
    batches = list(batches)
    nb = len(batches)
    results = [None] * nb
    state = [None] * nb  # k -> (aligner, minscs, mega handle)

    def _build(k):
        a = als[k % nals]
        with a.timers.phase("buildMatrices"):
            a.build_read_matrices(batches[k])
        minscs = a.min_scores(batches[k])
        state[k] = (a, minscs, None)

    def _mega(k):
        a, minscs, _ = state[k]
        state[k] = (a, minscs, a.dispatch_round0(batches[k], minscs))

    if nb:
        _build(0)
        _mega(0)
    for k in range(nb):
        a, minscs, h = state[k]
        state[k] = None
        # two-phase chaining inside batch k's align (see align_batch
        # _next_cb): build(k+1) fires right after batch k's main DP
        # problems are dispatched (host work overlapping the DP
        # execution); mega(k+1)'s dispatch fires after the escalation
        # dispatch, so the device FIFO holds [wide(k), mega(k+1)] and
        # the mega executes under batch k's host tail
        cb = ((lambda kk=k + 1: _build(kk)),
              (lambda kk=k + 1: _mega(kk))) if k + 1 < nb else None
        results[k] = a.align_batch(
            batches[k], _prebuilt=True, _predisp=h, _minscs=minscs,
            _next_cb=cb,
        )
        if emit_fn is not None:
            emit_fn(k, results[k])
    return results


def run_pipeline(batches, align_fn, emit_fn, depth: int = 2,
                 align_fns=None):
    """batches: iterator of input batches; align_fn(batch) -> results;
    emit_fn(batch, results) -> None (called in input order).

    align_fns: optional list of align callables, one per align worker
    (each must own its per-batch state); align_fn is ignored when given.
    """
    fns = list(align_fns) if align_fns else [align_fn]
    in_q: queue.Queue = queue.Queue(maxsize=depth)
    out_q: queue.Queue = queue.Queue(maxsize=depth + len(fns))
    errs: list = []

    def put_checked(q, item):
        # bounded put that never deadlocks on a dead consumer: bail as
        # soon as any stage recorded an error
        while not errs:
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for seq, b in enumerate(batches):
                if not put_checked(in_q, (seq, b)):
                    break
        except BaseException as e:  # surface parse errors in the main thread
            errs.append(e)
        finally:
            for _ in fns:
                put_checked(in_q, _DONE)

    def writer():
        next_seq = 0
        held: list = []  # (seq, batch, results) min-heap
        done_workers = 0
        while not errs:
            try:
                item = out_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is _DONE:
                done_workers += 1
                if done_workers == len(fns):
                    return
                continue
            heapq.heappush(held, item)
            try:
                while held and held[0][0] == next_seq:
                    _, b, results = heapq.heappop(held)
                    emit_fn(b, results)
                    next_seq += 1
            except BaseException as e:
                errs.append(e)
                return

    def align_worker(fn):
        try:
            while not errs:
                try:
                    item = in_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is _DONE:
                    return
                seq, b = item
                results = fn(b)
                if not put_checked(out_q, (seq, b, results)):
                    return
                counts.append(len(b))
        except BaseException as e:
            errs.append(e)
        finally:
            put_checked(out_q, _DONE)

    counts: list = []
    pt = threading.Thread(target=producer, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    pt.start()
    wt.start()
    if len(fns) == 1:
        # single worker runs inline (no extra thread hop on the hot path)
        align_worker(fns[0])
    else:
        ats = [threading.Thread(target=align_worker, args=(fn,),
                                daemon=True)
               for fn in fns]
        for t in ats:
            t.start()
        for t in ats:
            t.join()
    wt.join()
    if errs:
        raise errs[0]
    return sum(counts)
