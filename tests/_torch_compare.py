"""Shared checks for the differential tests of the PyTorch port."""
import numpy as np
import pytest
import torch


def to_torch(a) -> torch.Tensor:
    """A numpy operand as a CPU tensor (uint32 key words as int64 values,
    as the port's seed operands take them)."""
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else np.ascontiguousarray(a))


def cuda_or_skip() -> torch.device:
    """The first CUDA device, or skip the calling test when there is none
    (decided at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_*.py`")
    return torch.device("cuda", 0)


def assert_same_result(ref, port, tag=""):
    """Bitwise equality of a reference FastSimResult and the port's."""
    for k in ("delivery", "flow_completion", "a_used", "c_used"):
        a, b = np.asarray(getattr(ref, k)), np.asarray(getattr(port, k))
        assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")
    assert ref.cct == port.cct, (tag, ref.cct, port.cct)
    assert ref.max_queue == port.max_queue, (tag, ref.max_queue,
                                             port.max_queue)
    assert list(ref.layers) == list(port.layers)
    for name, la in ref.layers.items():
        lb = port.layers[name]
        ca, cb = np.asarray(la.counts), np.asarray(lb.counts)
        assert ca.dtype == cb.dtype, (tag, name, ca.dtype, cb.dtype)
        np.testing.assert_array_equal(ca, cb, err_msg=f"{tag} {name}")
        assert la.max_queue == lb.max_queue, (tag, name, la.max_queue,
                                              lb.max_queue)
        assert la.avg_wait == lb.avg_wait, (tag, name, la.avg_wait,
                                            lb.avg_wait)
    assert (ref.probe is None) == (port.probe is None), tag
    if ref.probe is not None:
        assert ref.probe.stride == port.probe.stride
        np.testing.assert_array_equal(np.asarray(ref.probe.series),
                                      port.probe.series, err_msg=tag)


LOOP_SCALARS = ("cct_slots", "cct_acked_slots", "drops", "retransmissions",
                "max_queue", "avg_queue", "finished", "mean_cwnd")


def assert_same_loop_result(ref, port, tag=""):
    """Bitwise equality of two LoopSimResults (reference or port)."""
    for k in ("delivered_slot", "flow_complete_slot", "flow_data_done_slot"):
        a, b = np.asarray(getattr(ref, k)), np.asarray(getattr(port, k))
        assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")
    for k in LOOP_SCALARS:
        a, b = getattr(ref, k), getattr(port, k)
        assert type(a) is type(b) and a == b, (tag, k, a, b)
    assert (ref.probe is None) == (port.probe is None), tag
    if ref.probe is not None:
        assert ref.probe.stride == port.probe.stride
        np.testing.assert_array_equal(np.asarray(ref.probe.series),
                                      port.probe.series, err_msg=tag)


# Enqueue operands at the edges of its domain: (rows, lanes, queues, cap)
# and how the lanes pick their targets.  The CPU tests hold the plain
# version to the reference on them, the card tests the CUDA kernel to the
# plain version.
ENQUEUE_CASES = {
    # every lane on one queue, more arrivals than room
    "hot_queue": (2, 64, 40, 12, "hot"),
    # keys -1, nq, -nq (wraps to queue 0), below -nq and past nq (dropped),
    # and q - nq beside q (two lanes on one ring cell, the later wins)
    "out_of_range": (3, 80, 40, 12, "oob"),
    # half the queues dead: their arrivals are black-holed
    "dead_queues": (2, 64, 40, 12, "dead"),
    # one row of 1,280 lanes and queues, 195-packet buffers
    "wide_row": (1, 1280, 1280, 195, "engine"),
    # the k=8 slot's sizes
    "cap_195": (2, 640, 640, 195, "engine"),
    # a buffer size that is not a multiple of 4 (the ring copy's vectors)
    "cap_13": (2, 100, 300, 13, "engine"),
    # no lane targets the queues past the first 32
    "idle_tiles": (2, 64, 160, 12, "low"),
    # no more queues than a CTA owns (16): one CTA a row is the first and
    # the last tile at once, and counts the keys of both sides of [0, NQ)
    "one_tile": (2, 64, 12, 12, "oob"),
    # 17 queues: the last tile owns one queue
    "tail_tile": (2, 64, 17, 12, "oob"),
}


def enqueue_operands(case, seed=0, rows=None, size=None):
    """numpy operands ``(qbuf, qhead, qcnt, alive, apk, aq, avalid)`` of an
    ``ENQUEUE_CASES`` entry, and its ``cap``; ``rows`` overrides its row
    count and ``size`` its ``(lanes, queues, cap)``."""
    B, M, NQ, cap, kind = ENQUEUE_CASES[case]
    B = B if rows is None else rows
    M, NQ, cap = (M, NQ, cap) if size is None else size
    r = np.random.default_rng(seed)
    qcnt = r.integers(0, cap, (B, NQ)).astype(np.int32)
    alive = r.random((B, NQ)) < (0.5 if kind == "dead" else 0.95)
    if kind == "hot":
        aq = np.full((B, M), NQ // 3, np.int32)
        qcnt[:, NQ // 3] = cap // 4
    elif kind == "oob":
        keys = np.array([-1, NQ, -NQ, -NQ - 3, NQ + 7, NQ - 1, 0, 5,
                         5 - NQ, -2 * NQ], np.int32)
        aq = keys[r.integers(0, len(keys), (B, M))]
        alive[:, [0, 5, NQ - 1]] = True
    elif kind == "low":
        aq = r.integers(0, 32, (B, M)).astype(np.int32)
    else:
        aq = (r.integers(0, max(NQ // 4, 1), (B, M)) * 4).astype(np.int32)
    apk = np.where(r.random((B, M)) < 0.9, r.integers(0, 1 << 20, (B, M)),
                   -1).astype(np.int32)
    return (r.integers(-1, 1 << 20, (B, NQ, cap)).astype(np.int32),
            r.integers(0, cap, (B, NQ)).astype(np.int32), qcnt, alive, apk,
            aq, apk >= 0), cap


AGG_OOB_KW = dict(site=4, quanta=None, cap=12, ecn_thresh=6, off1=8, h=4)


def agg_oob_operands(seed, rows=3, m=96, nq=40, n_aggs=4):
    """numpy operands of ``agg_jsq_enqueue`` (``(qbuf, qhead, qcnt, alive,
    apk, aq, to_agg, asw, dead, pad_pen, seed_lo, seed_hi)`` and the slot
    ``t``) whose lanes that are not agg-bound target keys outside ``[0,
    NQ)``: -1, -NQ (wraps to queue 0), 5 - NQ beside 5 (two keys on one
    ring: queues 0 and 5 start empty at one head, so their lanes of equal
    rank write one cell and the later wins), NQ and beyond, below -NQ.
    Agg-bound lanes pick among ``AGG_OOB_KW``'s ports as the engine's do.
    Use with ``AGG_OOB_KW``."""
    kw = AGG_OOB_KW
    h, cap = kw["h"], kw["cap"]
    assert kw["off1"] + n_aggs * h <= nq
    r = np.random.default_rng(seed)
    keys = np.array([-1, -nq, 5 - nq, 5, nq, nq + 7, -nq - 3, nq - 1, 0,
                     30], np.int32)
    qcnt = r.integers(0, cap, (rows, nq)).astype(np.int32)
    qhead = r.integers(0, cap, (rows, nq)).astype(np.int32)
    qcnt[:, [0, 5]] = 0
    qhead[:, 0] = qhead[:, 5]
    alive = r.random((rows, nq)) < 0.9
    alive[:, [0, 5, 30, nq - 1]] = True
    apk = np.where(r.random((rows, m)) < 0.9, r.integers(0, 600, (rows, m)),
                   -1).astype(np.int32)
    avalid = apk >= 0
    return (r.integers(-1, 600, (rows, nq, cap)).astype(np.int32), qhead,
            qcnt, alive, apk, keys[r.integers(0, len(keys), (rows, m))],
            avalid & (r.random((rows, m)) < 0.3),
            r.integers(0, n_aggs, (rows, m)).astype(np.int32),
            r.random((rows, m, h)) < 0.2, np.zeros((rows, h), np.float32),
            r.integers(0, 2**32, rows).astype(np.uint32),
            r.integers(0, 2**32, rows).astype(np.uint32),
            int(r.integers(0, 4000)))


def pick_fault_operands():
    """The JSQ pick whose occupancy gather leaves the row on both sides
    (numpy ``(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi)`` of one
    row, and the slot ``t``; use with ``site=3, quanta=None, cap=12``): 12
    queues, 4 ports, ``qbase = [10, -1, -3, 17]``.  The reference reads
    ``qcnt[qbase + l]`` by JAX's gather rule (a negative index wraps once,
    then the index clamps to the row) and picks ``[0, 1, 3, 3]``."""
    nq, h = 12, 4
    return ((np.arange(nq) * 3 % 7).astype(np.int32)[None],
            np.array([[10, -1, -3, 17]], np.int32),
            np.arange(4, dtype=np.int32)[None], np.zeros((1, 4, h), bool),
            np.zeros((1, h), np.float32), np.array([1], np.uint32),
            np.array([2], np.uint32), 5)


PICK_FAULT_KW = dict(site=3, quanta=None, cap=12)


def pick_oob_operands(seed, rows=3, m=64, nq=40, h=4):
    """numpy ``jsq_pick`` operands (as :func:`pick_fault_operands`) whose
    ``qbase`` lies anywhere in ``[-2 nq, 2 nq)``: below ``-nq`` (wraps, then
    clamps to 0), in ``[-nq, 0)`` (wraps), and past ``nq - h`` (clamps)."""
    r = np.random.default_rng(seed)
    return (r.integers(0, 12, (rows, nq)).astype(np.int32),
            r.integers(-2 * nq, 2 * nq, (rows, m)).astype(np.int32),
            r.integers(0, 600, (rows, m)).astype(np.int32),
            r.random((rows, m, h)) < 0.2, np.zeros((rows, h), np.float32),
            r.integers(0, 2**32, rows).astype(np.uint32),
            r.integers(0, 2**32, rows).astype(np.uint32),
            int(r.integers(0, 4000)))


# agg_jsq_enqueue whose agg-bound lanes' first ports qb = off1 + asw * h lie
# below -NQ, in [-NQ, 0) and past NQ - h (asw in [0, 30), off1 = -50, NQ =
# 40): the pick's gather wraps and clamps, and the rewritten keys qb + c
# wrap, clip and drop in the enqueue.
AGG_PICK_OOB_KW = dict(AGG_OOB_KW, off1=-50)


def agg_pick_oob_operands(seed):
    """numpy ``agg_jsq_enqueue`` operands and slot ``t`` (as
    :func:`agg_oob_operands`) for ``AGG_PICK_OOB_KW``."""
    *ops, t = agg_oob_operands(seed)
    r = np.random.default_rng(seed + 100)
    ops[7] = r.integers(0, 30, ops[7].shape).astype(np.int32)
    ops[6] = (ops[4] >= 0) & (r.random(ops[6].shape) < 0.7)
    return (*ops, t)


def sack_fault_operands():
    """The SACK update whose delivering lanes target ``pk = [-1, 3, -10,
    -11]`` in a 10-packet row (numpy ``(p_recv, pk, deliv, f_cum, fsize,
    pbase)`` of one row, one flow of 10 packets from 0): the reference wraps
    -1 and -10 once (packets 9 and 0) and drops -11, so bits 0, 3 and 9 are
    set and the flow's first missing packet is 1."""
    return (np.zeros((1, 10), bool), np.array([[-1, 3, -10, -11]], np.int32),
            np.ones((1, 4), bool), np.zeros((1, 1), np.int32),
            np.full((1, 1), 10, np.int32), np.zeros((1, 1), np.int32))


def sack_oob_operands(seed, rows=3, f=24, m=50, max_flow=90):
    """numpy SACK operands (as :func:`sack_fault_operands`) outside the
    engine's domain: lanes whose ``pk`` lies in ``[-P, -1]`` (wraps once),
    below ``-P`` and at or past ``P`` (dropped), and flows whose windows
    leave the row: ``pbase`` negative (reads wrap once), below ``-P``
    (wrap, then clamp to 0) and near ``P`` (clamp to ``P - 1``)."""
    r = np.random.default_rng(seed)
    fsize = r.integers(1, max_flow + 1, (rows, f)).astype(np.int32)
    fsize[:, ::5] = 0
    pbase = (np.cumsum(fsize, axis=1) - fsize).astype(np.int32)
    p = int(fsize.sum(axis=1).max()) + 7
    pbase[:, 1] = -3
    pbase[:, 2] = -p - 20
    pbase[:, 3] = p - 5
    pbase[:, 4] = p + 30
    fsize[:, 1:5] = 80
    f_cum = (r.random((rows, f)) * (fsize + 1)).astype(np.int32)
    f_cum[:, 1:5] = r.integers(0, 3, (rows, 4))
    p_recv = r.random((rows, p)) < 0.7
    p_recv[:, :4] = True
    p_recv[:, -4:] = True
    pk = r.integers(-2 * p, 2 * p, (rows, m)).astype(np.int32)
    pk[:, :4] = [-1, -p, -p - 1, p]
    deliv = r.random((rows, m)) < 0.8
    deliv[:, :4] = True
    return p_recv, pk, deliv, f_cum, fsize, pbase


# SACK counters outside the engine's domain (sack_edge_operands): a flow of
# size <= 0 whose window starts below its last candidate (f_cum < fsize - 1
# <= -1), an ack past the flow's end (f_cum > fsize), and acks within 64 of
# INT_MAX (the candidates f_cum + w and the reads pbase + cand wrap in int32).
SACK_EDGE_CASES = ("zero_size", "below_size", "past_size", "int_max")


def sack_edge_operands(case, seed=0, rows=3, f=24, m=50, p=200):
    """numpy SACK operands (as :func:`sack_fault_operands`) of a
    ``SACK_EDGE_CASES`` entry.  ``zero_size`` is one row: P = 10, bits 0, 1
    and 2 set, no delivery, flows ``f_cum = [-3, -5, 0, -2]``, ``fsize =
    [0, -2, 0, 0]``, ``pbase = [5, 4, 5, 3]``; the reference's first missing
    packets are ``[-2, -5, -1, -2]`` and its advanced acks ``[-2, -5, 0,
    0]``.  The others draw ``rows`` rows of ``p`` packets."""
    if case == "zero_size":
        p_recv = np.zeros((1, 10), bool)
        p_recv[0, :3] = True
        return (p_recv, np.array([[4, -2]], np.int32), np.zeros((1, 2), bool),
                np.array([[-3, -5, 0, -2]], np.int32),
                np.array([[0, -2, 0, 0]], np.int32),
                np.array([[5, 4, 5, 3]], np.int32))
    i32 = np.iinfo(np.int32)
    r = np.random.default_rng(seed)
    p_recv = r.random((rows, p)) < 0.8
    p_recv[:, :4] = True
    pk = r.integers(-p - 3, p + 3, (rows, m))
    deliv = r.random((rows, m)) < 0.5
    pbase = r.integers(-p, 2 * p, (rows, f))
    if case == "below_size":
        fsize = r.integers(-70, 1, (rows, f))
        f_cum = fsize - r.integers(2, 90, (rows, f))
    elif case == "past_size":
        fsize = r.integers(0, 90, (rows, f))
        f_cum = fsize + r.integers(1, 70, (rows, f))
    elif case == "int_max":
        f_cum = i32.max - r.integers(0, 65, (rows, f))
        fsize = r.choice(np.array([i32.max, i32.max - 3, i32.min, 5, -7, 0]),
                         (rows, f))
        pbase[:, 0::3] = i32.max - r.integers(0, 80, (rows, (f + 2) // 3))
        pbase[:, 1::3] = i32.min + r.integers(0, 80, (rows, (f + 1) // 3))
    else:
        raise ValueError(case)
    i = lambda a: a.astype(np.int32)                    # noqa: E731
    return p_recv, i(pk), deliv, i(f_cum), i(fsize), i(pbase)


# Shapes at the edges of sack_update_scan's grid: (rows, packets P, flows F,
# lanes M).  A row gets a CTA per 2,048-byte tile (more bytes a tile where
# it would take over 64), and more CTAs, up to 64, where its flows need them
# (a warp a flow, 8 a CTA); the delivered set is a bitset of the row or a
# table of the lanes' targets, in shared memory or, where neither fits 48
# KB, the table in a global scratch (kernel.py:sack_layout).
SACK_TILE_CASES = {
    "below_tile": (3, 1000, 16, 40),         # a row shorter than a tile
    "one_tile": (3, 2048, 24, 64),           # exactly one tile
    "two_tiles": (2, 4096, 8, 64),           # two tiles, a CTA each
    "tile_plus_one": (3, 2049, 24, 64),      # a last tile of one byte
    "odd_rows": (16, 8199, 40, 100),         # rows at every alignment mod 16
    "no_lanes": (2, 9000, 30, 0),            # M = 0
    "no_flows": (2, 9000, 0, 50),            # F = 0
    "many_flows": (2, 20_000, 700, 300),     # more flows than 64 CTAs' warps
    "table_shared": (2, 300_000, 64, 64),    # the table in shared memory
    "table_global": (1, 400_003, 96, 7000),  # the table in global memory
    "wide_tiles": (1, 1_000_003, 128, 640),  # tiles of P / 64 bytes
}


def sack_tile_operands(case, seed=0):
    """numpy SACK operands (as :func:`sack_fault_operands`) of a
    ``SACK_TILE_CASES`` entry: windows that straddle a boundary of the
    kernel's ``SACK_TILE``-byte tiles (from up to 63 entries before it),
    start before the row (wrap once) or run past its end (clamp), and
    delivering lanes that fill holes in the windows (so the delivered set
    decides the scan) besides random ones in ``[-P - 5, P + 5)``; 90 % of
    the bitmap set, so windows run deep."""
    from repro_torch.kernels.slot_step.kernel import SACK_TILE
    B, P, F, M = SACK_TILE_CASES[case]
    r = np.random.default_rng(seed)
    p_recv = r.random((B, P)) < 0.9
    edges = np.arange(0, P + SACK_TILE, SACK_TILE)
    kind = r.integers(0, 4, (B, F))
    pbase = np.select(
        [kind == 0, kind == 1, kind == 2],
        [edges[r.integers(0, len(edges), (B, F))] - r.integers(0, 64, (B, F)),
         r.integers(-70, 0, (B, F)), P - r.integers(1, 70, (B, F))],
        r.integers(0, P, (B, F)))
    fsize = r.integers(0, 300, (B, F))
    f_cum = np.where(kind == 0, 0, (r.random((B, F)) * (fsize + 1)).astype(
        np.int64))
    pk = r.integers(-P - 5, P + 5, (B, M))
    deliv = r.random((B, M)) < 0.7
    if F and M:
        fl = r.integers(0, F, (B, M))
        rows = np.arange(B)[:, None]
        hole = (pbase[rows, fl] + f_cum[rows, fl]
                + r.integers(0, 64, (B, M)))
        into = (r.random((B, M)) < 0.5) & (hole >= 0) & (hole < P)
        pk = np.where(into, hole, pk)
        p_recv[np.broadcast_to(rows, (B, M))[into], hole[into]] = False
    i = lambda a: a.astype(np.int32)                    # noqa: E731
    return p_recv, i(pk), deliv, i(f_cum), i(fsize), i(pbase)


def agg_case_operands(case, seed=0, rows=None, size=None, h=4):
    """numpy ``agg_jsq_enqueue`` operands and slot ``t`` built on an
    ``ENQUEUE_CASES`` entry (as :func:`enqueue_operands`), and the keyword
    arguments to call it with: about half the valid lanes agg-bound, picking
    among ``h`` ports of ``n_aggs`` switches from ``off1``; the others keep
    the case's targets (outside ``[0, NQ)`` on both sides for the ``oob``
    cases).  Odd rows' last port carries the pad penalty."""
    (qbuf, qhead, qcnt, alive, apk, aq, avalid), cap = enqueue_operands(
        case, seed=seed, rows=rows, size=size)
    B, M = aq.shape
    NQ = qcnt.shape[1]
    off1 = NQ // 5 if NQ // 5 + h <= NQ else 0
    n_aggs = max(1, (NQ - off1) // h)
    r = np.random.default_rng(seed + 1)
    pad_pen = np.where((np.arange(h) == h - 1)
                       & (np.arange(B)[:, None] % 2 == 1),
                       np.float32(1e9), np.float32(0.0)).astype(np.float32)
    to_agg = avalid & (r.random((B, M)) < 0.5)
    ops = (qbuf, qhead, qcnt, alive, apk, aq, to_agg,
           r.integers(0, n_aggs, (B, M)).astype(np.int32),
           r.random((B, M, h)) < 0.2, pad_pen,
           r.integers(0, 2**32, B).astype(np.uint32),
           r.integers(0, 2**32, B).astype(np.uint32), int(r.integers(0, 4000)))
    kw = dict(site=4, quanta=None, cap=cap, ecn_thresh=cap // 2, off1=off1,
              h=h)
    return ops, kw


def jsq_walk_grid(seed, B, S, pad, h, quanta=None):
    """CPU operands ``(t_grid, ok_grid, noise, port_pen, thresholds)`` of the
    JSQ scan at the edges of its walk: row (0, 0) holds no packet, row (0,
    1) a packet in every cell, and every other row packets that are not a
    prefix (a hole before its last packet, stray packets after a long empty
    run); half the empty cells carry a finite time (a hand-made grid, not
    the engine's ``-1e9``).  Odd batch rows pad their last port."""
    from repro_torch.net._batching import port_pad_penalty
    r = np.random.default_rng(seed)
    ok = r.random((B, S, pad)) < 0.6
    ok[..., pad // 4:pad // 2] = False
    ok[..., 3 * pad // 4:] = r.random((B, S, pad - 3 * pad // 4)) < 0.05
    ok[0, 0] = False
    if S > 1:
        ok[0, 1] = True
    t = (r.integers(0, max(pad // 2, 1), (B, S, pad))
         + r.random((B, S, pad))).astype(np.float32)
    t = np.where(ok | (r.random((B, S, pad)) < 0.5), t, np.float32(-1e9))
    pen = port_pad_penalty(h, torch.tensor([h - (b % 2) if h > 1 else 1
                                            for b in range(B)],
                                           dtype=torch.int32))
    return (torch.from_numpy(t), torch.from_numpy(ok),
            torch.from_numpy(r.random((B, S, pad, h)).astype(np.float32)),
            pen, None if quanta is None
            else torch.tensor(quanta, dtype=torch.float32) * 40)


# The JSQ picks at the edges of their domain: (rows, choosers, queues,
# ports) and what the case sets.  Every case draws its occupancy in [0, 30)
# and its first ports in [0, NQ - h]; "t" sets the slot (the counter word of
# Threefry wraps as uint32), "quanta" the bin edges (cap 30), "pen" the pad
# penalty row by row, "dead" every port dead (True) or none (False; else
# 20 % of them).  The CPU tests hold the plain
# versions to the reference on them, the card tests the CUDA picks to the
# plain versions.
PICK_CASES = {
    "edges_0": (3, 64, 40, 4, dict(quanta=())),      # quantized, no edge
    "edges_10": (3, 64, 40, 4,
                 dict(quanta=tuple(np.linspace(0.05, 0.95, 10).tolist()))),
    "edges_16": (3, 64, 40, 4,
                 dict(quanta=tuple(np.linspace(0.02, 0.98, 16).tolist()))),
    # far more edges than the 8 a kernel takes by value (the rest are read
    # from device memory)
    "edges_1100": (2, 64, 40, 4,
                   dict(quanta=tuple(np.linspace(0.0, 1.0, 1100).tolist()))),
    "t_minus_1": (3, 64, 40, 4, dict(t=-1)),
    "t_int_min": (3, 64, 40, 4, dict(t=-2**31)),
    "t_past_int_max": (3, 64, 40, 4, dict(t=2**31 + 5)),
    # row 0 a NaN at port 1, row 1 at ports 2 and 3, row 2 at the last
    "nan_score": (3, 64, 40, 4, dict(pen=[[0, np.nan, 0, 0],
                                          [0, 0, np.nan, np.nan],
                                          [0, 0, 0, np.nan]])),
    # +inf and -inf penalties: every port +inf, ties at -inf
    "inf_score": (3, 64, 40, 4, dict(pen=[[np.inf, 0, -np.inf, 0],
                                          [np.inf] * 4,
                                          [-np.inf, -np.inf, 0, 0]])),
    # every score 1e9 (the noise and the bins round away): port 0
    "all_tied": (2, 64, 40, 4, dict(pen=[[1e9] * 4] * 2, dead=False,
                                    quanta=(0.05, 0.10, 0.20))),
    "all_dead": (2, 64, 40, 4, dict(dead=True)),
    **{f"ports_{h}": (2, 96, 8 * h + 40, h, {})
       for h in (1, 2, 3, 5, 8, 31, 32, 33, 64, 100)},
    # choosers not a multiple of a CTA's tile (32 at h = 3: 77 = 2 x 32 +
    # 13)
    "ragged_tile": (3, 77, 40, 3, {}),
    # rows far wider than their choosers' reads: 2,000 queues for 64
    # choosers, and rows of about 48 KB of int32 (12,285 and 12,300 queues)
    # under 9 choosers of 400 ports
    "sparse_row": (2, 64, 2_000, 4, {}),
    "wide_row": (2, 9, 12_285, 400, {}),
    "wider_row": (2, 9, 12_300, 400, {}),
}


def _pick_case(case, seed):
    B, M, NQ, h, o = PICK_CASES[case]
    r = np.random.default_rng(seed)
    dead = r.random((B, M, h)) < 0.2
    if "dead" in o:
        dead[:] = o["dead"]
    pen = np.asarray(o.get("pen", np.zeros((B, h))), np.float32)
    kw = dict(site=3, quanta=o.get("quanta"), cap=30)
    t = o.get("t", int(r.integers(0, 4000)))
    return B, M, NQ, h, r, dead, pen, kw, t


def pick_case_operands(case, seed=0):
    """numpy ``jsq_pick`` operands of a ``PICK_CASES`` entry (as
    :func:`pick_fault_operands`), its slot ``t`` and the keyword arguments
    to call it with."""
    B, M, NQ, h, r, dead, pen, kw, t = _pick_case(case, seed)
    ops = (r.integers(0, 30, (B, NQ)).astype(np.int32),
           r.integers(0, NQ - h + 1, (B, M)).astype(np.int32),
           r.integers(0, 1 << 20, (B, M)).astype(np.int32), dead, pen,
           r.integers(0, 2**32, B).astype(np.uint32),
           r.integers(0, 2**32, B).astype(np.uint32))
    return (*ops, t), kw


def agg_pick_case_operands(case, seed=0):
    """numpy ``agg_jsq_enqueue`` operands of a ``PICK_CASES`` entry (as
    :func:`agg_case_operands`, 30-packet buffers, about half the valid lanes
    agg-bound), its slot ``t`` and the keyword arguments to call it with."""
    B, M, NQ, h, r, dead, pen, kw, t = _pick_case(case, seed)
    (*ops, _), akw = agg_case_operands("cap_13", seed=seed, rows=B,
                                       size=(M, NQ, 30), h=h)
    ops[8], ops[9] = dead, pen
    return (*ops, t), dict(akw, site=4, quanta=kw["quanta"])
