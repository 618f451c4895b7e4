"""Multi-host scale-out: process initialization and deterministic read
sharding.

The reference is single-node; its cross-process story is shared-memory
index reuse (--mm/--shmem, mm.h/shmem.h:20-50) and its determinism
contract is the OutputQueue's input-order emission (outq.h:31-45). The
multi-host design (SURVEY §2.4 / §5):

  - jax.distributed initializes the processes; the FM index is replicated
    per host (each host builds/loads its own copy into device memory);
  - the FASTQ stream is sharded per host by contiguous read-id blocks, so
    host h aligns reads [h*B, (h+1)*B) of each superbatch — pure data
    parallelism with no cross-host collectives;
  - per-read determinism (same alignment regardless of placement) makes
    the merge a trivial rdid-ordered concatenation of per-host SAM shards.
"""

from __future__ import annotations

import jax


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed when running multi-host; returns
    (process_id, num_processes). Single-process if no coordinator given."""
    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def host_shard(reads_iter, process_id: int, num_processes: int,
               block: int = 4096):
    """Deterministic per-host read sharding: contiguous blocks of `block`
    reads round-robin across hosts. Yields this host's reads; rdids are
    preserved so per-host SAM shards merge in input order."""
    buf = []
    blk_idx = 0
    for rd in reads_iter:
        buf.append(rd)
        if len(buf) == block:
            if blk_idx % num_processes == process_id:
                yield from buf
            buf = []
            blk_idx += 1
    if buf and blk_idx % num_processes == process_id:
        yield from buf


class _ShardReader:
    """Streaming read-unit cursor over one SAM shard: yields blocks of
    consecutive-QNAME units without ever holding more than one block."""

    def __init__(self, path: str, want_headers: bool):
        self.f = open(path)
        self.headers: list[str] = []
        self.pending: str | None = None
        for line in self.f:
            if line.startswith("@"):
                if want_headers:
                    self.headers.append(line)
                continue
            self.pending = line
            break

    def take_units(self, n_units: int, out) -> int:
        """Write up to n_units read units (consecutive records sharing a
        QNAME — mates and secondaries stay together) to `out`; returns
        the number of units written (0 = exhausted)."""
        done = 0
        while done < n_units and self.pending is not None:
            name = self.pending.split("\t", 1)[0]
            out.write(self.pending)
            self.pending = None
            for line in self.f:
                if line.split("\t", 1)[0] != name:
                    self.pending = line
                    break
                out.write(line)
            done += 1
        if self.pending is None:
            self.f.close()
        return done


def merge_sam_shards(shard_paths: list[str], out_path: str,
                     block: int = 4096) -> None:
    """rdid-ordered merge of per-host SAM shards produced with host_shard
    (the OutputQueue reorder contract, outq.h:31-45): headers come from
    shard 0; record "read units" interleave block-round-robin, undoing
    host_shard's block assignment.  Fully streaming — memory stays
    constant regardless of shard size (the 100M-read multi-host configs
    this exists for cannot be slurped)."""
    readers = [_ShardReader(p, want_headers=(i == 0))
               for i, p in enumerate(shard_paths)]
    n = len(readers)
    live = [True] * n
    with open(out_path, "w") as out:
        out.writelines(readers[0].headers)
        src = 0
        while any(live):
            if live[src]:
                live[src] = readers[src].take_units(block, out) > 0
            src = (src + 1) % n
