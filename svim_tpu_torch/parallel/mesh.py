"""--num_shards: the batched ops' leading axis cut over the visible devices.

Counterpart of svim_tpu/parallel/mesh.py.  svim_tpu lays the leading axis
of its batched kernels over a device mesh and lets the compiler split them;
every one of those ops is independent along that axis, so the port does the
same by hand, in one process: `shard_batch` cuts the leading axis into
contiguous blocks and uploads block i to `shard_devices(...)[i]`, the caller
runs the op once per block, and `gather_shards` concatenates the outputs on
the run's device in shard order.  Shards that share a card run one after
another on the current stream.

Shard-boundary reconciliation is merge-then-cut, as in svim_tpu: COLLECT is
per-read independent, the per-shard event tables are merged in global row
order BEFORE the host forms partitions, and clustering then shards over
whole partitions (batch axis), so the gap-cut always sees the serial order
and boundary partitions are never split.

`run_collect_step` is the explicit sharded COLLECT + merge + depth step
(events in global row order, per-locus depth summed over shards); under a
process group with more than one rank each rank computes its own row blocks
and the tables travel as host bytes (multihost.allgather_arrays).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from svim_tpu_torch.ops.cigar_kernel import collect_scan


def shard_devices(num_shards: int, device: torch.device):
    """The device of each of `num_shards` shards: shard i lives on
    cuda:(i % torch.cuda.device_count()) when `device` is a card (so a
    machine with fewer cards than shards wraps round), on the CPU when the
    run is on the CPU."""
    num_shards = max(1, int(num_shards))
    if device.type != "cuda":
        return [device] * num_shards
    cards = torch.cuda.device_count()
    return [torch.device("cuda", index % cards) for index in range(num_shards)]


def log_layout(num_shards: int, device: torch.device) -> None:
    logging.info("{0} shards over {1} device(s)".format(
        num_shards, len(set(shard_devices(num_shards, device)))))


def _put(values, device):
    if not torch.is_tensor(values):
        values = torch.from_numpy(np.ascontiguousarray(values))
    return values.to(device)


def shard_batch(num_shards: int, device: torch.device, *arrays):
    """Cut batch-leading arrays (numpy or tensors) into `num_shards`
    contiguous blocks along the leading axis, block i on shard i's device.

    Returns one tuple of tensors per shard.  When the leading axis does not
    divide over the shards (or num_shards <= 1) the batch stays whole: one
    tuple, on `device`."""
    rows = arrays[0].shape[0]
    if num_shards <= 1 or rows == 0 or rows % num_shards != 0:
        return [tuple(_put(array, device) for array in arrays)]
    block = rows // num_shards
    return [tuple(_put(array[index * block:(index + 1) * block], target)
                  for array in arrays)
            for index, target in enumerate(shard_devices(num_shards, device))]


def gather_shards(outputs, device: torch.device):
    """Concatenate per-shard output tuples (batch-leading tensors) on
    `device` in shard order; a single shard's outputs pass through."""
    if len(outputs) == 1:
        return outputs[0]
    return tuple(torch.cat([part.to(device) for part in parts])
                 for parts in zip(*outputs))


def collect_scan_sharded(num_shards: int, device: torch.device, cigar_words,
                         ref_start, min_sv_size: int):
    """ops.cigar_kernel.collect_scan over row shards: each shard compacts its
    own events in (row, op) order; the merge adds the shard's row offset and
    concatenates in shard order, so the outputs equal the unsharded scan's."""
    shards = shard_batch(num_shards, device, cigar_words, ref_start)
    parts = [collect_scan(words, starts, min_sv_size)
             for words, starts in shards]
    if len(parts) == 1:
        return parts[0]
    block = shards[0][0].shape[0]
    geometry = gather_shards([part[:5] for part in parts], device)
    rows = torch.cat([(part[5] + index * block).to(device)
                      for index, part in enumerate(parts)])
    events = gather_shards([part[6:10] for part in parts], device)
    count = torch.stack([part[10] for part in parts]).sum().to(torch.int32)
    return geometry + (rows.to(torch.int32),) + events + (count,)


def _local_collect(device, cigar_words, ref_start, ref_end, loci,
                   min_sv_size: int):
    """One shard's COLLECT on `device`: (starts, lengths, is_ins, local rows,
    per-locus depth), events in (row, op) order."""
    words = _put(cigar_words, device)
    starts = _put(ref_start, device).to(torch.int32)
    ends = _put(ref_end, device).to(torch.int32)
    loci = _put(loci, device).to(torch.int32)
    (_ref_end, _read_len, _qa_start, _qa_end, _has_hard, rows, pos_ref,
     _pos_read, lengths, is_ins, _count) = collect_scan(words, starts,
                                                        min_sv_size)
    overlaps = ((starts[None, :] < loci[:, 1][:, None])
                & (ends[None, :] > loci[:, 0][:, None]))
    depth = overlaps.sum(dim=1, dtype=torch.int32)
    return starts[rows.long()] + pos_ref, lengths, is_ins, rows, depth


def run_collect_step(devices, cigar_words, ref_start, ref_end, loci,
                     min_sv_size: int = 40):
    """The sharded COLLECT + merge + depth step over `devices` (one shard
    each, as shard_devices gives them).

    Inputs (global shapes, the same host arrays on every rank): cigar_words
    (N, K) int32 in the raw BAM encoding, ref_start and ref_end (N,) int32,
    loci (L, 2) int32 genotyping windows.  Shard i scans row block i.

    Returns numpy arrays (starts, lengths, is_ins, rows, depth, counts):
    the events of all shards in global row order with GLOBAL row indices,
    the per-locus alignment depth summed over shards, and the true number
    of events per shard.  Tensor shapes are dynamic, so there is no event
    table to overflow.  Under a process group with W > 1 ranks, rank r
    computes shards [r * len(devices) / W, (r + 1) * len(devices) / W) and
    the tables are exchanged, so every rank returns the same arrays."""
    from svim_tpu_torch.parallel.multihost import (
        allgather_arrays,
        process_count,
        process_index,
    )

    n_shards = len(devices)
    rows_total = cigar_words.shape[0]
    if rows_total % n_shards != 0:
        raise ValueError("rows ({0}) must divide over {1} shards — pad the "
                         "batch first".format(rows_total, n_shards))
    world, rank = process_count(), process_index()
    if n_shards % world != 0:
        raise ValueError("{0} shards must divide over {1} processes".format(
            n_shards, world))
    block = rows_total // n_shards
    per_rank = n_shards // world
    tables = {"starts": [], "lengths": [], "is_ins": [], "rows": []}
    counts = []
    depth = np.zeros(len(loci), dtype=np.int32)
    for shard in range(rank * per_rank, (rank + 1) * per_rank):
        lo, hi = shard * block, (shard + 1) * block
        starts, lengths, is_ins, rows, shard_depth = _local_collect(
            devices[shard], cigar_words[lo:hi], ref_start[lo:hi],
            ref_end[lo:hi], loci, min_sv_size)
        tables["starts"].append(starts.cpu().numpy())
        tables["lengths"].append(lengths.cpu().numpy())
        tables["is_ins"].append(is_ins.cpu().numpy())
        tables["rows"].append((rows + lo).to(torch.int32).cpu().numpy())
        counts.append(len(tables["rows"][-1]))
        depth += shard_depth.cpu().numpy()
    local = {name: np.concatenate(parts) for name, parts in tables.items()}
    local["counts"] = np.asarray(counts, dtype=np.int32)
    local["depth"] = depth
    if world > 1:
        gathered = allgather_arrays(local)
        local = {name: np.concatenate([part[name] for part in gathered])
                 for name in ("starts", "lengths", "is_ins", "rows", "counts")}
        local["depth"] = np.sum([part["depth"] for part in gathered], axis=0,
                                dtype=np.int32)
    return (local["starts"], local["lengths"], local["is_ins"], local["rows"],
            local["depth"], local["counts"])
