"""The agglomeration kernel's share of its roofline: over every call of
agglomerate_batched and span_position_agglomerate_batched that CLUSTER
made in the traced jobs, the least time each call's partitions need
(yardstick.agglomerate_bound_ms on its valid slots) summed, over the
calls' device time summed (CUDA events around each call).  Nothing to read
where no call ran."""

from svbench import yardstick

UNIT = "%"
NAME = "agglomerate_roofline"
# the entries timed, in the module where CLUSTER looks them up
TIMED = {"svim_tpu_torch.cluster.device_cluster":
         ("agglomerate_batched", "span_position_agglomerate_batched")}


def keep(entry, arguments, result):
    """What the bound reads of one call, taken on the device without a
    wait: its valid slots, and whether the entry builds the matrix."""
    return (arguments["valid"].clone(),
            entry == "span_position_agglomerate_batched")


def bound_ms(kept):
    valid, fused = kept
    return yardstick.agglomerate_bound_ms(valid.sum(dim=1).tolist(),
                                          int(valid.shape[1]), fused)[0]


def read(trace):
    calls = trace["calls"].get(NAME)
    if not calls:
        return None
    return 100.0 * sum(bound for _, bound in calls) / sum(ms for ms, _ in calls)
