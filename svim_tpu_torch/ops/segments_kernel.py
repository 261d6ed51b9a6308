"""Vectorized split-read (inter-alignment) pair classification (PyTorch).

Counterpart of svim_tpu/ops/segments_kernel.py::classify_groups_fused and
_classify_core: gather slot geometry from the COLLECT outputs, sort each
group's segments along the read, and classify every adjacent pair into
INS / DEL / INV / tandem-dup / BND evidence.  Event encoding is the JAX
module's.

Three layers, on the pattern of ops/linkage_kernel.py:
  * `classify_groups_fused_plain` - the plain PyTorch version: two stable
    argsorts and branchless masked selects; it equals the JAX program on
    the CPU.
  * `classify_groups_fused_cuda` - the wrapper of the hand-written CUDA
    kernel (csrc/classify_segments.cu: at S <= 32 a warp takes 32 / S
    groups, a lane a slot, and sorts by ranks exchanged by shuffles; above
    that a CTA a group sorts in shared memory; then a lane a pair runs the
    decision chain), equal to the plain version bit for bit, one launch
    without a host synchronisation; counted in `LAUNCHES`.
  * `classify_groups_fused` - the dispatcher: CPU tensors take the plain
    version, CUDA tensors the kernel.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from svim_tpu_torch.ops._build import check_launch, check_tensors

LAUNCHES = 0   # launches by classify_groups_fused_cuda
KERNELS_PER_CALL = 1   # device kernels such a launch is

LEFT_FWD, LEFT_REV, RIGHT_FWD, RIGHT_REV = 0, 1, 2, 3
INT32_MAX = 2**31 - 1


def classify_groups_fused_plain(slot_row, q_start_h, q_end_h, ref_id_h,
                                ref_start_h, ref_end_h, is_reverse_h, valid,
                                hard_gate_row, ref_id_all, ref_start_all,
                                is_reverse_all, ref_end_dev, read_len_dev,
                                qa_start_dev, qa_end_dev, has_hard_dev,
                                min_sv_size: int, max_sv_size: int,
                                segment_gap_tolerance: int,
                                segment_overlap_tolerance: int,
                                max_segments: int = 64):
    """Sort per-group segments and classify adjacent pairs.

    slot_row: (G, S) packed row per slot, -1 where the *_h arrays supply
    host-parsed SA-tag geometry.  hard_gate_row: (G,) packed row whose
    hard-clip flag disables the whole group, or -1.  Returns the
    _classify_core outputs plus the sorted per-pair current-segment strand
    and ref id."""
    rows = torch.clamp(slot_row, min=0).long()
    from_row = slot_row >= 0
    rev_row = is_reverse_all[rows]
    read_len = read_len_dev[rows]
    q0_row = torch.where(rev_row, read_len - qa_end_dev[rows],
                         qa_start_dev[rows])
    q1_row = torch.where(rev_row, read_len - qa_start_dev[rows],
                         qa_end_dev[rows])
    q_start = torch.where(from_row, q0_row, q_start_h)
    q_end = torch.where(from_row, q1_row, q_end_h)
    ref_id = torch.where(from_row, ref_id_all[rows], ref_id_h)
    ref_start = torch.where(from_row, ref_start_all[rows], ref_start_h)
    ref_end = torch.where(from_row, ref_end_dev[rows], ref_end_h)
    is_reverse = torch.where(from_row, rev_row, is_reverse_h)

    # stable sort by (q_start, q_end): two stable passes, least key first —
    # ties keep slot order (primary first, then SA/supplementary order),
    # matching the host's list.sort
    big = torch.full_like(q_end, INT32_MAX)
    perm1 = torch.argsort(torch.where(valid, q_end, big), dim=1, stable=True)
    key_start = torch.gather(torch.where(valid, q_start, big), 1, perm1)
    perm2 = torch.argsort(key_start, dim=1, stable=True)
    perm = torch.gather(perm1, 1, perm2)

    def sort_field(field):
        return torch.gather(field, 1, perm)

    q_start = sort_field(q_start)
    q_end = sort_field(q_end)
    ref_id = sort_field(ref_id)
    ref_start = sort_field(ref_start)
    ref_end = sort_field(ref_end)
    is_reverse = sort_field(is_reverse)
    valid_sorted = sort_field(valid)
    # truncate to the first max_segments sorted segments (host behavior)
    slot_index = torch.arange(q_start.shape[1], device=q_start.device)[None, :]
    valid_sorted = valid_sorted & (slot_index < max_segments)
    gate_rows = torch.clamp(hard_gate_row, min=0).long()
    enabled = torch.where(hard_gate_row >= 0, ~has_hard_dev[gate_rows],
                          torch.ones_like(hard_gate_row, dtype=torch.bool))
    valid_sorted = valid_sorted & enabled[:, None]

    outputs = _classify_core(q_start, q_end, ref_id, ref_start, ref_end,
                             is_reverse, valid_sorted, min_sv_size,
                             max_sv_size, segment_gap_tolerance,
                             segment_overlap_tolerance)
    return outputs + (is_reverse[:, :-1], ref_id[:, :-1])


def _classify_core(q_start, q_end, ref_id, ref_start, ref_end, is_reverse,
                   valid, min_sv_size, max_sv_size, segment_gap_tolerance,
                   segment_overlap_tolerance):
    def where(mask, a, b):
        # integer selects with python-int branches broadcast as int32
        if not torch.is_tensor(a):
            a = torch.full_like(b if torch.is_tensor(b) else q_start[:, 1:], a)
        if not torch.is_tensor(b):
            b = torch.full_like(a, b)
        return torch.where(mask, a, b)

    pair_valid = valid[:, :-1] & valid[:, 1:]
    d_read = q_start[:, 1:] - q_end[:, :-1]
    same_ref = ref_id[:, :-1] == ref_id[:, 1:]
    rev_cur = is_reverse[:, :-1]
    rev_nxt = is_reverse[:, 1:]
    same_orient = rev_cur == rev_nxt

    rs_cur, re_cur = ref_start[:, :-1], ref_end[:, :-1]
    rs_nxt, re_nxt = ref_start[:, 1:], ref_end[:, 1:]

    d_ref = where(rev_cur, rs_cur - re_nxt, rs_nxt - re_cur)
    deviation = d_read - d_ref

    read_no_overlap = d_read >= -segment_overlap_tolerance
    read_no_gap = d_read <= segment_gap_tolerance
    read_window = read_no_overlap & read_no_gap

    state = {"code": torch.zeros_like(d_read), "p1": torch.zeros_like(d_read),
             "p2": torch.zeros_like(d_read), "aux": torch.zeros_like(d_read),
             "twin_mask": torch.zeros_like(pair_valid),
             "twin_p1": torch.zeros_like(d_read),
             "twin_p2": torch.zeros_like(d_read),
             "twin_aux": torch.zeros_like(d_read)}
    contig2 = ref_id[:, :-1]
    qpos = where(rev_cur, q_start[:, 1:], q_end[:, :-1])

    def setwhere(mask, new_code, new_p1, new_p2, new_aux):
        mask = mask & (state["code"] == 0) & pair_valid
        state["code"] = where(mask, new_code, state["code"])
        state["p1"] = where(mask, new_p1, state["p1"])
        state["p2"] = where(mask, new_p2, state["p2"])
        state["aux"] = where(mask, new_aux, state["aux"])
        return mask

    def set_twin(mask, tp1, tp2, taux):
        state["twin_mask"] = state["twin_mask"] | mask
        state["twin_p1"] = where(mask, tp1, state["twin_p1"])
        state["twin_p2"] = where(mask, tp2, state["twin_p2"])
        state["twin_aux"] = where(mask, taux, state["twin_aux"])

    # ---- same contig, same orientation (SVIM_inter.py:68-150) -------------
    colinear = same_ref & same_orient
    no_ref_overlap = d_ref >= -segment_overlap_tolerance

    ins_mask = (colinear & read_no_overlap & no_ref_overlap
                & (deviation >= min_sv_size)
                & (d_ref <= segment_gap_tolerance))
    setwhere(ins_mask, 1, where(rev_cur, rs_cur, re_cur), deviation, 0)

    del_anchor = where(rev_cur, re_nxt, re_cur)
    del_mask = (colinear & read_no_overlap & no_ref_overlap
                & (deviation <= -min_sv_size) & (deviation >= -max_sv_size)
                & read_no_gap)
    del_mask = setwhere(del_mask, 2, del_anchor, -deviation, 0)
    set_twin(del_mask, del_anchor - 1, del_anchor - deviation, 0)  # fwd/fwd

    huge_del = (colinear & read_no_overlap & no_ref_overlap
                & (deviation < -max_sv_size) & read_no_gap)
    setwhere(huge_del, 5, where(rev_cur, rs_cur, re_cur - 1),
             where(rev_cur, re_nxt - 1, rs_nxt), where(rev_cur, 3, 0))

    # reference overlap -> tandem duplication evidence
    overlap_branch = (colinear & read_no_overlap & ~no_ref_overlap
                      & (d_ref <= -min_sv_size))
    tan_near = where(rev_cur, rs_nxt < re_cur, re_nxt > rs_cur)
    tan_far = ~tan_near & (d_ref >= -max_sv_size)
    tan_start = where(rev_cur, rs_cur, rs_nxt)
    tan_end = where(rev_cur, re_nxt, re_cur)
    tan_fwd_bit = where(rev_cur, 0, 2)
    tan_mask1 = setwhere(overlap_branch & tan_near, 4, tan_start, tan_end,
                         1 + tan_fwd_bit)
    tan_mask2 = setwhere(overlap_branch & tan_far, 4, tan_start, tan_end,
                         0 + tan_fwd_bit)
    tan_twin_p1 = where(rev_cur, rs_cur, re_cur - 1)
    tan_twin_p2 = where(rev_cur, re_nxt - 1, rs_nxt)
    tan_twin_aux = where(rev_cur, 3, 0)
    set_twin(tan_mask1 | tan_mask2, tan_twin_p1, tan_twin_p2, tan_twin_aux)
    huge_tan = overlap_branch & ~tan_near & ~tan_far
    setwhere(huge_tan, 5, tan_twin_p1, tan_twin_p2, tan_twin_aux)

    # ---- same contig, opposite orientations (SVIM_inter.py:152-204) -------
    inverted = same_ref & ~same_orient & read_window
    fwd_rev = inverted & ~rev_cur
    rev_fwd = inverted & rev_cur
    case_near = rs_nxt - re_cur >= -segment_overlap_tolerance
    case_far = ~case_near & (rs_cur - re_nxt >= -segment_overlap_tolerance)

    span_1 = re_nxt - re_cur   # case 1 (left_fwd)
    span_3 = re_cur - re_nxt   # case 3 (left_rev)
    span_2 = rs_nxt - rs_cur   # case 2 (right_fwd)
    span_4 = rs_cur - rs_nxt   # case 4 (right_rev)
    span = where(fwd_rev, where(case_near, span_1, span_3),
                 where(case_near, span_2, span_4))
    inv_case = ((fwd_rev & case_near) | (fwd_rev & case_far)
                | (rev_fwd & case_near) | (rev_fwd & case_far))
    inv_dir = where(fwd_rev, where(case_near, LEFT_FWD, LEFT_REV),
                    where(case_near, RIGHT_FWD, RIGHT_REV))
    inv_start = where(fwd_rev, where(case_near, re_cur, re_nxt),
                      where(case_near, rs_cur, rs_nxt))
    inv_end = inv_start + span
    inv_twin_p1 = where(fwd_rev, re_cur - 1, rs_cur)
    inv_twin_p2 = where(fwd_rev, re_nxt - 1, rs_nxt)
    inv_twin_aux = where(fwd_rev, 2, 1)  # fwd/rev vs rev/fwd
    inv_mask = setwhere(inv_case & (span >= min_sv_size)
                        & (span <= max_sv_size),
                        3, inv_start, inv_end, inv_dir)
    set_twin(inv_mask, inv_twin_p1, inv_twin_p2, inv_twin_aux)
    setwhere(inv_case & (span > max_sv_size), 5, inv_twin_p1, inv_twin_p2,
             inv_twin_aux)

    # ---- different contigs (SVIM_inter.py:206-240) ------------------------
    cross = ~same_ref & read_window
    cross_p1 = where(rev_cur, rs_cur, re_cur - 1)
    cross_p2 = where(same_orient, where(rev_cur, re_nxt - 1, rs_nxt),
                     where(rev_cur, rs_nxt, re_nxt - 1))
    cross_aux = where(same_orient, where(rev_cur, 3, 0),
                      where(rev_cur, 1, 2))
    cross_mask = setwhere(cross, 5, cross_p1, cross_p2, cross_aux)
    contig2 = where(cross_mask | (state["code"] == 5), ref_id[:, 1:], contig2)

    return (state["code"], state["p1"], state["p2"], state["aux"], contig2,
            qpos, state["twin_mask"], state["twin_p1"], state["twin_p2"],
            state["twin_aux"])


_library = None


def _kernel_library():
    global _library
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("classify_segments")
        pointer = ctypes.c_void_p
        library.classify_max_slots.argtypes = []
        library.classify_max_slots.restype = ctypes.c_int
        library.classify_segments.argtypes = (
            [pointer] * 17 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
            + [pointer] * 13)
        library.classify_segments.restype = ctypes.c_int
        _library = library
    return _library


def classify_groups_fused_cuda(slot_row, q_start_h, q_end_h, ref_id_h,
                               ref_start_h, ref_end_h, is_reverse_h, valid,
                               hard_gate_row, ref_id_all, ref_start_all,
                               is_reverse_all, ref_end_dev, read_len_dev,
                               qa_start_dev, qa_end_dev, has_hard_dev,
                               min_sv_size: int, max_sv_size: int,
                               segment_gap_tolerance: int,
                               segment_overlap_tolerance: int,
                               max_segments: int = 64):
    """classify_groups_fused on the card through csrc/classify_segments.cu.

    The (G, S) and (G,) group columns and the (N,) row columns are
    contiguous CUDA tensors of one device (int32; bool for the strands,
    `valid` and the hard-clip flags).  Returns the twelve outputs of
    classify_groups_fused_plain, bit for bit.  One launch on the current
    stream, no host synchronisation; none when G = 0 or S < 2."""
    global LAUNCHES
    device = slot_row.device
    if device.type != "cuda":
        raise ValueError("classify_groups_fused_cuda needs CUDA tensors")
    if slot_row.dim() != 2:
        raise ValueError("slot_row must be (G, S), got {0}".format(
            tuple(slot_row.shape)))
    groups, slots = slot_row.shape
    rows = ref_id_all.shape[0]
    group_columns = (("slot_row", slot_row), ("q_start_h", q_start_h),
                     ("q_end_h", q_end_h), ("ref_id_h", ref_id_h),
                     ("ref_start_h", ref_start_h), ("ref_end_h", ref_end_h))
    row_columns = (("ref_id_all", ref_id_all),
                   ("ref_start_all", ref_start_all),
                   ("ref_end_dev", ref_end_dev),
                   ("read_len_dev", read_len_dev),
                   ("qa_start_dev", qa_start_dev),
                   ("qa_end_dev", qa_end_dev))
    check_tensors(
        [(name, tensor, torch.int32, (groups, slots))
         for name, tensor in group_columns]
        + [("is_reverse_h", is_reverse_h, torch.bool, (groups, slots)),
           ("valid", valid, torch.bool, (groups, slots)),
           ("hard_gate_row", hard_gate_row, torch.int32, (groups,)),
           ("is_reverse_all", is_reverse_all, torch.bool, (rows,)),
           ("has_hard_dev", has_hard_dev, torch.bool, (rows,))]
        + [(name, tensor, torch.int32, (rows,))
           for name, tensor in row_columns], device)
    for name, value in (("min_sv_size", min_sv_size),
                        ("max_sv_size", max_sv_size),
                        ("segment_gap_tolerance", segment_gap_tolerance),
                        ("segment_overlap_tolerance",
                         segment_overlap_tolerance),
                        ("max_segments", max_segments)):
        if not -2**31 < value < 2**31:
            raise ValueError("{0} = {1} is outside int32".format(name, value))
    library = _kernel_library()
    if slots > library.classify_max_slots():
        raise ValueError("the classify kernel takes S <= {0} slots (a group "
                         "sorts in one CTA's shared memory), got S={1}"
                         .format(library.classify_max_slots(), slots))
    pairs = max(slots - 1, 0)
    # code, p1, p2, aux, contig2, qpos, twin_mask, twin_p1, twin_p2,
    # twin_aux, the sorted strand and ref_id
    dtypes = [torch.int32] * 6 + [torch.bool] + [torch.int32] * 3 + [
        torch.bool, torch.int32]
    outputs = tuple(torch.empty((groups, pairs), dtype=dtype, device=device)
                    for dtype in dtypes)
    if groups == 0 or slots < 2:
        return outputs
    with torch.cuda.device(device):
        check_launch("classify_segments", library.classify_segments(
            *(tensor.data_ptr() for tensor in (
                slot_row, q_start_h, q_end_h, ref_id_h, ref_start_h,
                ref_end_h, is_reverse_h, valid, hard_gate_row, ref_id_all,
                ref_start_all, is_reverse_all, ref_end_dev, read_len_dev,
                qa_start_dev, qa_end_dev, has_hard_dev)),
            groups, slots, int(max_segments), int(min_sv_size),
            int(max_sv_size), int(segment_gap_tolerance),
            int(segment_overlap_tolerance),
            *(tensor.data_ptr() for tensor in outputs),
            torch.cuda.current_stream(device).cuda_stream))
    LAUNCHES += 1
    return outputs


def classify_groups_fused(*args, **kwargs):
    """Dispatcher: CPU tensors -> classify_groups_fused_plain, CUDA tensors
    -> classify_groups_fused_cuda (same arguments and outputs; see the plain
    version)."""
    slot_row = args[0] if args else kwargs["slot_row"]
    if slot_row.device.type == "cpu":
        return classify_groups_fused_plain(*args, **kwargs)
    if slot_row.device.type == "cuda":
        return classify_groups_fused_cuda(*args, **kwargs)
    raise ValueError("no classify kernel for device {0}".format(
        slot_row.device))
