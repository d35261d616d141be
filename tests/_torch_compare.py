"""Shared checks for the differential tests of the PyTorch port."""
import numpy as np
import pytest
import torch


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
