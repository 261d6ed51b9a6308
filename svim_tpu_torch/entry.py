"""Entry points of the port: the fused COLLECT pass on one device,
and a dry run of the sharded pipeline on tiny shapes.

Counterpart of the JAX package's __graft_entry__.py, through the port's
functions.  Both run on the card unless SVIM_TORCH_DEVICE=cpu asks for the
CPU (utils.device.select_device).
"""

from __future__ import annotations

import numpy as np
import torch

from svim_tpu_torch.utils.device import select_device


def entry():
    """(fn, example_args): the flagship forward step, the fused COLLECT pass
    (geometry + CIGAR indel scan + event compaction into a table of 1024
    entries, the first bound of svim_tpu's dispatch for these 64 rows, with
    the true count) over a packed read batch; the example tensors live on
    the selected device."""
    from svim_tpu_torch.ops.cigar_kernel import collect_scan, event_bound

    device = select_device()
    n, k = 64, 128

    def fn(cigar_words, ref_start):
        return collect_scan(cigar_words, ref_start, 40, event_bound(n))

    rng = np.random.default_rng(0)
    ops = rng.integers(0, 3, size=(n, k), dtype=np.int32)
    lens = rng.integers(1, 100, size=(n, k), dtype=np.int32)
    cigar_words = (lens << 4) | ops
    ref_start = rng.integers(0, 1_000_000, size=(n,), dtype=np.int32)
    return fn, (torch.from_numpy(cigar_words).to(device),
                torch.from_numpy(ref_start).to(device))


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded pipeline over `n_devices` shards on tiny shapes:
    sharded COLLECT (local scan, event merge in global row order, depth
    summed over shards), host gap-cut partitioning over the merged events,
    and the batched agglomeration sharded over the partition axis: the same
    functions the CLI's --num_shards path uses.  Shards wrap round the
    visible cards.  Launched as one rank of a multi-process job
    (SVIM_COORDINATOR / SVIM_NUM_PROCESSES / SVIM_PROCESS_ID set), it joins
    the group first, so the event merge crosses real process boundaries."""
    from svim_tpu_torch.ops.linkage_kernel import (
        span_position_agglomerate_batched,
    )
    from svim_tpu_torch.parallel import multihost
    from svim_tpu_torch.parallel.mesh import (
        gather_shards,
        run_collect_step,
        shard_batch,
        shard_devices,
    )
    from svim_tpu_torch.state import to_host

    joined = multihost.env_process_info() is not None
    device = select_device(distributed=joined)
    multihost.initialize_from_env()
    try:
        devices = shard_devices(n_devices, device)

        rng = np.random.default_rng(1)
        n = 8 * n_devices
        k = 128
        # every read: 50M 60D 50M (one deletion signature each), BAM word
        # encoding; reads pile onto 4 loci so partitions span several shards
        cigar_words = np.zeros((n, k), dtype=np.int32)
        cigar_words[:, 0] = (50 << 4) | 0
        cigar_words[:, 1] = (60 << 4) | 2
        cigar_words[:, 2] = (50 << 4) | 0
        loci_pos = np.asarray([2_000, 14_000, 26_000, 38_000], dtype=np.int32)
        ref_start = np.sort(loci_pos[rng.integers(0, 4, size=n)]
                            + rng.integers(-200, 200, size=n)).astype(np.int32)
        ref_end = ref_start + 160
        loci = np.asarray([[0, 60_000], [5_000, 6_000]], dtype=np.int32)

        # stage 1: sharded COLLECT + merge + depth
        starts, lengths, _is_ins, rows, depth, counts = run_collect_step(
            devices, cigar_words, ref_start, ref_end, loci)
        assert len(starts) == n and rows.tolist() == sorted(rows.tolist())
        assert counts.tolist() == [8] * n_devices
        assert int(depth[0]) == n  # every read overlaps the wide locus

        # stage 2: host gap-cut over the merged (globally ordered) events
        # (merge-then-cut: the partition scan sees the serial order)
        ends = starts + lengths
        cuts = np.nonzero(np.diff(starts) > 1000)[0] + 1
        partitions = np.split(np.arange(n), cuts)
        assert len(partitions) == 4

        # stage 3: batched agglomeration sharded over the partition axis
        pad, batch = 128, 8
        p_starts = np.zeros((batch, pad), dtype=np.int32)
        p_ends = np.zeros((batch, pad), dtype=np.int32)
        p_reads = np.full((batch, pad), -1, dtype=np.int32)
        p_valid = np.zeros((batch, pad), dtype=bool)
        for b, part in enumerate(partitions):
            m = len(part)
            p_starts[b, :m] = starts[part]
            p_ends[b, :m] = ends[part]
            p_reads[b, :m] = np.arange(m)
            p_valid[b, :m] = True
        p_dest = np.zeros((batch, pad), dtype=np.int32)
        wall = np.ones(batch, dtype=bool)
        kind = np.zeros(batch, dtype=np.int32)   # span-position distance
        merges_lo, _merges_hi, heights, *_flags = to_host(gather_shards([
            span_position_agglomerate_batched(
                s_starts, s_ends, s_reads, s_valid, 900.0, 0.5, s_wall,
                dest=s_dest, kind=s_kind)
            for (s_starts, s_ends, s_reads, s_valid, s_wall, s_dest,
                 s_kind) in shard_batch(
                     n_devices, device, p_starts, p_ends, p_reads, p_valid,
                     wall, p_dest, kind)], device))
        assert merges_lo.shape == (batch, pad - 1)
        # each real partition's reads share one locus: they agglomerate fully
        for b, part in enumerate(partitions):
            real = heights[b][heights[b] < 1.0e30]
            assert len(real) == len(part) - 1
    finally:
        if joined:
            multihost.shutdown()
