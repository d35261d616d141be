"""The plain slot-step versions of the port (``kernels/slot_step/ref.py``)
against the JAX reference's oracles and its interpret-mode Pallas kernels,
bitwise, on random engine-shaped operands with several rows; and where the
reference rounds its float mul-adds once (XLA on the CPU contracts them)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import entropy as r_ent
from repro.kernels.slot_step import kernel as qk, ref as qr

from repro_torch.kernels.slot_step import ops as t_ops, ref as t_ref
from repro_torch.kernels.slot_step import kernel as t_kernel
from repro_torch.kernels.jsq_scan.ref import fma32

from _torch_compare import (AGG_OOB_KW, AGG_PICK_OOB_KW, ENQUEUE_CASES,
                            PICK_CASES, PICK_FAULT_KW, SACK_EDGE_CASES,
                            SACK_TILE_CASES, agg_case_operands,
                            agg_oob_operands, agg_pick_case_operands,
                            agg_pick_oob_operands, enqueue_operands,
                            pick_case_operands, pick_fault_operands,
                            pick_oob_operands, sack_edge_operands, sack_fault_operands,
                            sack_oob_operands, sack_tile_operands, to_torch)

ROWS = 3
QUANTA = (0.05, 0.10, 0.20)
# More bin edges than the CUDA picks take by value (8), and none at all
# (a quantized score of noise alone).
QUANTA_10 = PICK_CASES["edges_10"][4]["quanta"]
QUANTA_16 = PICK_CASES["edges_16"][4]["quanta"]
PICK_QUANTA = [None, QUANTA, QUANTA_10, QUANTA_16, ()]


def _operands(seed, m=40, h=4, nq=120, cap=12, n_aggs=8, pad_ports=1):
    """Random engine-shaped operands for one slot step, ``ROWS`` rows; the
    last ``pad_ports`` port columns of odd rows carry the pad penalty."""
    r = np.random.default_rng(seed)
    p = 600
    o = dict(
        qcnt=r.integers(0, cap, (ROWS, nq)).astype(np.int32),
        qbuf=r.integers(-1, p, (ROWS, nq, cap)).astype(np.int32),
        qhead=r.integers(0, cap, (ROWS, nq)).astype(np.int32),
        qbase=r.integers(0, nq - h, (ROWS, m)).astype(np.int32),
        ids=r.integers(0, p, (ROWS, m)).astype(np.int32),
        dead=r.random((ROWS, m, h)) < 0.2,
        pad_pen=np.where((np.arange(h) >= h - pad_ports)
                         & (np.arange(ROWS)[:, None] % 2 == 1),
                         np.float32(1e9), np.float32(0.0)),
        alive=r.random((ROWS, nq)) < 0.9,
        apk=np.where(r.random((ROWS, m)) < 0.8,
                     r.integers(0, p, (ROWS, m)), -1).astype(np.int32),
        # few distinct queues, so same-queue arrivals rank and overflow
        aq=r.integers(0, nq // 8, (ROWS, m)).astype(np.int32) * 8,
        asw=r.integers(0, n_aggs, (ROWS, m)).astype(np.int32),
        seed_lo=r.integers(0, 2**32, ROWS).astype(np.uint32),
        seed_hi=r.integers(0, 2**32, ROWS).astype(np.uint32),
        t=int(r.integers(0, 4000)))
    o["avalid"] = o["apk"] >= 0
    o["to_agg"] = o["avalid"] & (r.random((ROWS, m)) < 0.5)
    return o


def _t(o, k):
    v = o[k]
    if k in ("seed_lo", "seed_hi"):
        return torch.from_numpy(v.astype(np.int64))
    return torch.from_numpy(np.ascontiguousarray(v))


def _row(o, k, b):
    return jnp.asarray(o[k][b])


PICK = ("qcnt", "qbase", "ids", "dead", "pad_pen", "seed_lo", "seed_hi")
ENQ = ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "avalid")
AGG = ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "to_agg", "asw", "dead",
       "pad_pen", "seed_lo", "seed_hi")


def _same(port_outs, ref_outs, b):
    for p, r in zip(port_outs, ref_outs):
        r = np.asarray(r)
        got = p[b].numpy()
        assert got.dtype == r.dtype, (got.dtype, r.dtype)
        np.testing.assert_array_equal(got, r)


@pytest.mark.parametrize("quanta", PICK_QUANTA)
def test_jsq_pick_matches_oracle_and_interpret_kernel(quanta):
    o = _operands(1)
    kw = dict(site=r_ent.SITE_EDGE_JSQ, quanta=quanta, cap=12)
    got = t_ops.jsq_pick(*[_t(o, k) for k in PICK], o["t"], **kw)
    score = t_ref.jsq_score(*[_t(o, k) for k in PICK], o["t"], **kw)
    for b in range(ROWS):
        args = [_row(o, k, b) for k in PICK] + [o["t"]]
        _same([got], [qr.jsq_pick(*args, **kw)], b)
        _same([got], [qk.jsq_pick(*args, interpret=True, **kw)], b)
        _same([score], [jax.jit(lambda *a: qr.jsq_score(*a, **kw))(*args)],
              b)
    # the padded column of odd rows is never elected
    assert (got[1::2] < 3).all()


def test_enqueue_matches_oracle_and_interpret_kernel():
    o = _operands(3)
    kw = dict(cap=12, ecn_thresh=7)
    got = t_ops.enqueue(*[_t(o, k) for k in ENQ], **kw)
    assert int(got[2].sum()) > int(got[3].sum()) > 0   # capacity drops
    for b in range(ROWS):
        args = [_row(o, k, b) for k in ENQ]
        _same(got, qr.enqueue(*args, **kw), b)
        _same(got, qk.enqueue(*args, interpret=True, **kw), b)


@pytest.mark.parametrize("case", sorted(ENQUEUE_CASES))
def test_enqueue_cases_match_oracle_and_interpret_kernel(case):
    """The enqueue at the edges of its domain (``ENQUEUE_CASES``: a hot
    queue past ``cap``, targets outside ``[0, NQ)`` on both sides, dead
    queues, a row of 1,280 lanes, ``cap = 195`` and 13, queues no lane
    targets, 12 and 17 queues): the plain version against the reference's oracle and its
    interpret-mode Pallas kernel, bit for bit.  A negative target wraps
    once and the later of two lanes on one cell wins, as in the
    reference's scatters."""
    ops, cap = enqueue_operands(case, seed=len(case))
    kw = dict(cap=cap, ecn_thresh=cap // 2)
    got = t_ops.enqueue(*[torch.from_numpy(a) for a in ops], **kw)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops]
        _same(got, qr.enqueue(*args, **kw), b)
        _same(got, qk.enqueue(*args, interpret=True, **kw), b)
    enq_try, do_enq = got[2], got[3]
    if case == "hot_queue":
        assert int(enq_try.sum()) > int(do_enq.sum()) > 0
    if case == "dead_queues":
        assert bool((torch.from_numpy(ops[6]) & ~enq_try).any())
    if case == "out_of_range":
        aq = torch.from_numpy(ops[5])
        assert bool((do_enq & (aq < 0) & (aq >= -40)).any())


@pytest.mark.parametrize("quanta", PICK_QUANTA)
def test_agg_jsq_enqueue_matches_oracle_and_interpret_kernel(quanta):
    o = _operands(4)
    kw = dict(site=r_ent.SITE_AGG_JSQ, quanta=quanta, cap=12, ecn_thresh=7,
              off1=24, h=4)
    got = t_ops.agg_jsq_enqueue(*[_t(o, k) for k in AGG], o["t"], **kw)
    for b in range(ROWS):
        args = [_row(o, k, b) for k in AGG] + [o["t"]]
        _same(got, qr.agg_jsq_enqueue(*args, **kw), b)
        _same(got, qk.agg_jsq_enqueue(*args, interpret=True, **kw), b)


@pytest.mark.parametrize("seed", [0, 1])
def test_agg_jsq_enqueue_out_of_range_keys_match_oracle_and_interpret_kernel(
        seed):
    """The fused pick + enqueue where the lanes that are not agg-bound
    target keys outside ``[0, NQ)`` (``agg_oob_operands``): a negative key
    wraps once, and where it shares a ring cell with a key in range the
    later lane wins, as in the reference's scatters; bit for bit against
    the reference's oracle and its interpret-mode Pallas kernel."""
    *ops, t = agg_oob_operands(seed)
    got = t_ops.agg_jsq_enqueue(
        *[torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
          for a in ops], t, **AGG_OOB_KW)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        _same(got, qr.agg_jsq_enqueue(*args, **AGG_OOB_KW), b)
        _same(got, qk.agg_jsq_enqueue(*args, interpret=True, **AGG_OOB_KW),
              b)
    aq, to_agg = torch.from_numpy(ops[5]), torch.from_numpy(ops[6])
    nq, do_enq = ops[2].shape[1], got[4]
    wraps = do_enq & ~to_agg & (aq < 0) & (aq >= -nq)
    assert bool(wraps.any())
    # lanes of keys 5 - NQ and 5 enqueued: those of equal rank share a cell
    assert bool((wraps & (aq == 5 - nq)).any())
    assert bool((do_enq & ~to_agg & (aq == 5)).any())


@pytest.mark.parametrize("quanta", [None, QUANTA])
@pytest.mark.parametrize("h", [33, 64])
def test_wide_ports_match_oracle_and_interpret_kernel(h, quanta):
    """More ports than a warp has lanes (the CUDA kernels take any h): the
    pick and the fused agg pick + enqueue against the reference's oracles
    and its interpret-mode kernels, and the enqueue on the same operands."""
    off1, n_aggs = 24, 8
    o = _operands(10 + h, h=h, nq=off1 + n_aggs * h + 16, n_aggs=n_aggs,
                  pad_ports=3)
    kw = dict(site=r_ent.SITE_EDGE_JSQ, quanta=quanta, cap=12)
    got = t_ops.jsq_pick(*[_t(o, k) for k in PICK], o["t"], **kw)
    akw = dict(site=r_ent.SITE_AGG_JSQ, quanta=quanta, cap=12, ecn_thresh=7,
               off1=off1, h=h)
    agg = t_ops.agg_jsq_enqueue(*[_t(o, k) for k in AGG], o["t"], **akw)
    ekw = dict(cap=12, ecn_thresh=7)
    enq = t_ops.enqueue(*[_t(o, k) for k in ENQ], **ekw)
    for b in range(ROWS):
        args = [_row(o, k, b) for k in PICK] + [o["t"]]
        _same([got], [qr.jsq_pick(*args, **kw)], b)
        _same([got], [qk.jsq_pick(*args, interpret=True, **kw)], b)
        args = [_row(o, k, b) for k in AGG] + [o["t"]]
        _same(agg, qr.agg_jsq_enqueue(*args, **akw), b)
        _same(agg, qk.agg_jsq_enqueue(*args, interpret=True, **akw), b)
        _same(enq, qk.enqueue(*[_row(o, k, b) for k in ENQ],
                              interpret=True, **ekw), b)
    assert int(got.max()) >= 32                # a port past the first 32
    assert (got[1::2] < h - 3).all()           # padded ports never elected


def test_wrappers_validate_backend():
    o = _operands(6)
    with pytest.raises(ValueError):
        t_ops.jsq_pick(*[_t(o, k) for k in PICK], 0, site=3, quanta=None,
                       cap=12, backend="pallas")
    with pytest.raises(ValueError):
        t_ops.sack_advance(*[_t(_sack_operands(6), k) for k in SACK_ADV],
                           backend="cuda")
    plain = t_ops.jsq_pick(*[_t(o, k) for k in PICK], 0, site=3, quanta=None,
                           cap=12, backend="torch")
    assert torch.equal(plain, t_ops.jsq_pick(*[_t(o, k) for k in PICK], 0,
                                             site=3, quanta=None, cap=12))


def _sack_operands(seed, f=24, m=50):
    """Random SACK scoreboard operands, ``ROWS`` rows: flows of 0-90
    packets laid out back to back (every 5th flow empty), received bitmaps
    with some flows complete (full 64-windows), cumulative acks anywhere in
    ``[0, fsize]`` (some at ``fsize - 1`` and ``fsize``), and deliveries
    whose targets repeat (two copies of one packet in one slot)."""
    r = np.random.default_rng(seed)
    fsize = r.integers(1, 91, (ROWS, f)).astype(np.int32)
    fsize[:, ::5] = 0
    pbase = (np.cumsum(fsize, axis=1) - fsize).astype(np.int32)
    p = int(fsize.sum(axis=1).max()) + 7
    f_cum = (r.random((ROWS, f)) * (fsize + 1)).astype(np.int32)
    f_cum[:, 1::6] = np.maximum(fsize[:, 1::6] - 1, 0)
    f_cum[:, 2::6] = fsize[:, 2::6]
    p_recv = r.random((ROWS, p)) < 0.7
    for b in range(ROWS):
        for fl in range(3, f, 4):          # whole flows received
            p_recv[b, pbase[b, fl]:pbase[b, fl] + fsize[b, fl]] = True
    pk = r.integers(0, p, (ROWS, m)).astype(np.int32)
    pk[:, 1] = pk[:, 0]
    pk[:, 7] = pk[:, 3]
    deliv = r.random((ROWS, m)) < 0.6
    deliv[:, [0, 1, 3, 7]] = True
    pk = np.where(deliv | (r.random((ROWS, m)) < 0.5), pk, -1)
    return dict(p_recv=p_recv, pk=pk, deliv=deliv, f_cum=f_cum,
                fsize=fsize, pbase=pbase)


SACK_UPD = ("p_recv", "pk", "deliv", "f_cum", "fsize", "pbase")
SACK_ADV = ("p_recv", "f_cum", "fsize", "pbase")


@pytest.mark.parametrize("seed", [7, 8])
def test_sack_update_scan_matches_oracle_and_interpret_kernel(seed):
    o = _sack_operands(seed)
    got = t_ops.sack_update_scan(*[_t(o, k) for k in SACK_UPD])
    fm = got[1].numpy()
    assert (fm[:, ::5] == -1).all()                 # zero-size flows
    assert (fm[:, 2::6] == o["fsize"][:, 2::6] - 1).all()
    full = np.zeros(fm.shape, bool)
    full[:, 3::4] = o["fsize"][:, 3::4] - o["f_cum"][:, 3::4] >= 64
    assert full.any()                               # whole 64-windows set
    np.testing.assert_array_equal(fm[full], o["f_cum"][full])
    for b in range(ROWS):
        args = [_row(o, k, b) for k in SACK_UPD]
        _same(got, qr.sack_update_scan(*args), b)
        _same(got, qk.sack_update_scan(*args, interpret=True), b)


@pytest.mark.parametrize("seed", [9, 10])
def test_sack_advance_matches_oracle_and_interpret_kernel(seed):
    o = _sack_operands(seed)
    got = t_ops.sack_advance(*[_t(o, k) for k in SACK_ADV])
    adv = got.numpy() - o["f_cum"]
    assert adv.min() >= 0 and adv.max() == 8        # two rounds of four
    assert (got.numpy() <= o["fsize"]).all()
    for b in range(ROWS):
        args = [_row(o, k, b) for k in SACK_ADV]
        _same([got], [qr.sack_advance(*args)], b)
        _same([got], [qk.sack_advance(*args, interpret=True)], b)


def test_jsq_score_is_one_rounding_like_xla():
    """``lens + nz * 1e-3`` (reference ``slot_step/ref.py:35``, the
    engine's ``loopsim.py:1230, 1310``): the jitted oracle equals an exact
    FMA on 2**20 elements and differs from separate rounding; the plain
    version matches it bitwise."""
    rng = np.random.default_rng(0)
    m, h, nq = 1 << 18, 4, 1 << 12
    qcnt = rng.integers(0, 8, nq).astype(np.int32)
    qbase = rng.integers(0, nq - h, m).astype(np.int32)
    ids = np.arange(m, dtype=np.int32)
    lo, hi = r_ent.key_words(5)
    args = (qcnt, qbase, ids, np.zeros((m, h), bool), np.zeros(h, np.float32),
            lo, hi, 17)
    kw = dict(site=r_ent.SITE_EDGE_JSQ, quanta=None, cap=195)
    xla = np.asarray(jax.jit(lambda *a: qr.jsq_score(*a, **kw))(*args))
    port = t_ref.jsq_score(
        torch.from_numpy(qcnt)[None], torch.from_numpy(qbase)[None],
        torch.from_numpy(ids)[None], torch.zeros((1, m, h), dtype=torch.bool),
        torch.zeros((1, h)), torch.tensor([int(lo)]), torch.tensor([int(hi)]),
        17, **kw)[0].numpy()
    np.testing.assert_array_equal(port, xla)
    lens = qcnt[qbase[:, None] + np.arange(h)].astype(np.float32)
    nz = np.asarray(r_ent.draw_uniform(lo, hi, kw["site"], ids[:, None], 17,
                                       lane=np.arange(h)[None]))
    assert (lens + nz * np.float32(1e-3) != xla).sum() > 0


def test_plb_ewma_is_one_rounding_like_xla():
    """The PLB EWMA ``ewma * (1 - w*dec) + w*inc`` (``loopsim.py:1434``):
    XLA on the CPU rounds it once, ``fma(ewma, 1 - w*dec, w*inc)``, which
    the port's engine computes with ``fma32``."""
    rng = np.random.default_rng(1)
    n = 1 << 20
    ewma = rng.random(n).astype(np.float32)
    dec = (rng.random(n) < 0.7).astype(np.float32)
    inc = dec * (rng.random(n) < 0.5).astype(np.float32)
    w = jnp.float32(0.125)
    xla = np.asarray(jax.jit(lambda e, d, i: e * (1 - w * d) + w * i)(
        ewma, dec, inc))
    t = torch.from_numpy
    w_t = torch.tensor(0.125)
    port = fma32(t(ewma), 1.0 - w_t * t(dec), w_t * t(inc)).numpy()
    np.testing.assert_array_equal(port, xla)
    separate = ewma * (np.float32(1) - np.float32(0.125) * dec) \
        + np.float32(0.125) * inc
    assert (separate != xla).any()


def test_jsq_pick_fault_inputs_match_oracle_and_interpret_kernel():
    """The pick whose occupancy gather leaves the row (``qbase = [10, -1,
    -3, 17]`` of 12 queues and 4 ports): the plain version reads by the
    reference's gather rule (wrap once, then clamp) and picks ``[0, 1, 3,
    3]``, as the reference's oracle and interpret-mode kernel do."""
    *ops, t = pick_fault_operands()
    got = t_ops.jsq_pick(*[to_torch(a) for a in ops], t, **PICK_FAULT_KW)
    assert got.tolist() == [[0, 1, 3, 3]]
    args = [jnp.asarray(a[0]) for a in ops] + [t]
    _same([got], [qr.jsq_pick(*args, **PICK_FAULT_KW)], 0)
    _same([got], [qk.jsq_pick(*args, interpret=True, **PICK_FAULT_KW)], 0)


@pytest.mark.parametrize("quanta", [None, QUANTA])
@pytest.mark.parametrize("seed", [0, 1])
def test_jsq_pick_out_of_range_qbase_matches_oracle_and_interpret_kernel(
        seed, quanta):
    """``qbase`` below ``-NQ``, in ``[-NQ, 0)`` and past ``NQ - h``
    (``pick_oob_operands``): bit for bit against the reference's oracle and
    its interpret-mode Pallas kernel."""
    *ops, t = pick_oob_operands(seed)
    kw = dict(site=r_ent.SITE_EDGE_JSQ, quanta=quanta, cap=12)
    got = t_ops.jsq_pick(*[to_torch(a) for a in ops], t, **kw)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        _same([got], [qr.jsq_pick(*args, **kw)], b)
        _same([got], [qk.jsq_pick(*args, interpret=True, **kw)], b)
    qbase, nq = ops[1], ops[0].shape[1]
    assert (qbase < -nq).any() and ((qbase < 0) & (qbase >= -nq)).any()
    assert (qbase > nq - 4).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_agg_out_of_range_qbase_matches_oracle_and_interpret_kernel(seed):
    """The fused pick + enqueue whose agg-bound lanes' first ports ``off1 +
    asw * h`` leave ``[0, NQ - h]`` on both sides (``agg_pick_oob_operands``):
    the pick's gather wraps and clamps, the rewritten keys wrap, clip and
    drop; bit for bit against the reference's oracle and its interpret-mode
    Pallas kernel, and ``c_fin`` is the plain pick of the same choosers."""
    *ops, t = agg_pick_oob_operands(seed)
    kw = AGG_PICK_OOB_KW
    got = t_ops.agg_jsq_enqueue(*[to_torch(a) for a in ops], t, **kw)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        _same(got, qr.agg_jsq_enqueue(*args, **kw), b)
        _same(got, qk.agg_jsq_enqueue(*args, interpret=True, **kw), b)
    qb = kw["off1"] + ops[7] * kw["h"]
    pick = t_ops.jsq_pick(to_torch(ops[2]), torch.from_numpy(qb),
                          torch.from_numpy(np.maximum(ops[4], 0)),
                          *[to_torch(a) for a in ops[8:]], t, site=kw["site"],
                          quanta=kw["quanta"], cap=kw["cap"])
    assert torch.equal(got[2], pick)
    nq, to_agg = ops[2].shape[1], ops[6]
    assert (to_agg & (qb < -nq)).any() and (to_agg & (qb < 0)
                                            & (qb >= -nq)).any()
    assert (to_agg & (qb > nq - kw["h"])).any()


def test_sack_update_scan_fault_inputs_match_oracle_and_interpret_kernel():
    """Delivering lanes at ``pk = [-1, 3, -10, -11]`` of a 10-packet row:
    -1 and -10 wrap once (packets 9 and 0), -11 is dropped, so bits 0, 3
    and 9 are set and the first missing packet is 1, as in the reference's
    oracle and interpret-mode kernel."""
    ops = sack_fault_operands()
    got = t_ops.sack_update_scan(*[to_torch(a) for a in ops])
    assert torch.nonzero(got[0][0]).flatten().tolist() == [0, 3, 9]
    assert got[1].tolist() == [[1]]
    args = [jnp.asarray(a[0]) for a in ops]
    _same(got, qr.sack_update_scan(*args), 0)
    _same(got, qk.sack_update_scan(*args, interpret=True), 0)


def _same_sack(ops):
    """Both SACK functions' plain versions on numpy operands ``ops``
    (``(p_recv, pk, deliv, f_cum, fsize, pbase)``), bit for bit against the
    reference's oracles and interpret-mode Pallas kernels, row by row (the
    oracles alone where a row has no lanes or no flows: the interpreter
    divides by a block's size).  Returns ``(p_recv', first_missing,
    advanced f_cum)``."""
    interpret = min(ops[1].shape[1], ops[3].shape[1]) > 0
    got = t_ops.sack_update_scan(*[to_torch(a) for a in ops])
    adv = t_ops.sack_advance(*[to_torch(a) for i, a in enumerate(ops)
                               if i not in (1, 2)])
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops]
        _same(got, qr.sack_update_scan(*args), b)
        if interpret:
            _same(got, qk.sack_update_scan(*args, interpret=True), b)
        args = [args[0]] + args[3:]
        _same([adv], [qr.sack_advance(*args)], b)
        if interpret:
            _same([adv], [qk.sack_advance(*args, interpret=True)], b)
    return got + (adv,)


@pytest.mark.parametrize("seed", [0, 1, *SACK_EDGE_CASES])
def test_sack_out_of_range_match_oracle_and_interpret_kernel(seed):
    """Both SACK kernels outside the engine's domain
    (``sack_oob_operands``): ``pk`` in ``[-P, -1]``, below ``-P`` and at or
    past ``P``; windows that start before the row (wrapping once, or
    clamping after the wrap) and run past its end (clamping).  And
    (``sack_edge_operands``) flows of size <= 0 whose windows start below
    ``fsize - 1``, acks past the flow's end and acks within 64 of INT_MAX,
    where the candidates and the reads wrap in int32."""
    if seed in SACK_EDGE_CASES:
        ops = sack_edge_operands(seed)
        _, fm, adv = _same_sack(ops)
        f_cum, fsize = ops[3:5]
        if seed == "zero_size":
            assert fm.tolist() == [[-2, -5, -1, -2]]
            assert adv.tolist() == [[-2, -5, 0, 0]]
        elif seed == "below_size":
            assert (f_cum < fsize - 1).all() and (fsize <= 0).all()
            assert (fm.numpy() != fsize - 1).any()
        elif seed == "past_size":
            assert (f_cum > fsize).all()
            np.testing.assert_array_equal(adv.numpy(), fsize)
        else:
            assert (f_cum >= np.iinfo(np.int32).max - 64).all()
            assert (fm.numpy() < 0).any()           # wrapped candidates
        return
    ops = sack_oob_operands(seed)
    _same_sack(ops)
    p_recv, pk, deliv = ops[:3]
    P = p_recv.shape[1]
    assert (deliv & (pk < 0) & (pk >= -P)).any()
    assert (deliv & (pk < -P)).any() and (deliv & (pk >= P)).any()


SMALL_TILE_CASES = [c for c, (_, P, _, _) in SACK_TILE_CASES.items()
                    if P < 10_000]


@pytest.mark.parametrize("case", SMALL_TILE_CASES)
def test_sack_tile_cases_match_oracle_and_interpret_kernel(case):
    """The card kernel's grid edges (``SACK_TILE_CASES`` below 10,000
    packets: a row shorter than a tile, one tile, a tile and a byte, rows at
    every alignment, no lanes, no flows): the plain versions bit for bit
    against the reference's oracles and interpret-mode kernels, so that the
    card tests, which hold the kernels to the plain versions there, hold
    them to the reference."""
    ops = sack_tile_operands(case)
    new_bitmap, fm, _ = _same_sack(ops)
    B, P, F, M = SACK_TILE_CASES[case]
    assert new_bitmap.shape == (B, P) and fm.shape == (B, F)
    if F and M:      # deliveries fill window holes: the set decides the scan
        hole = ops[2] & ~ops[0][np.arange(B)[:, None],
                                np.clip(ops[1], 0, P - 1)] & (ops[1] >= 0)
        assert hole.any()


def test_sack_layout_reaches_every_set_form():
    """``kernel.sack_layout`` on ``SACK_TILE_CASES`` and the k=8 slot's
    (4, 32,768, M = 640, F = 128): CTAs past the row's last tile, tiles
    wider than ``SACK_TILE``, flows past the warps of 64 CTAs, the bitset,
    the table in shared memory and the table in a global scratch all occur;
    every tile of a row has its CTA, and the shared set fits ``SACK_SMEM``."""
    seen = set()
    shapes = [(P, M, F) for _, P, F, M in SACK_TILE_CASES.values()]
    for P, M, F in shapes + [(32_768, 640, 128)]:
        tile, ctas, hsize, shared = t_kernel.sack_layout(P, M, F)
        tiles = -(-P // tile)
        assert tile % 16 == 0 and tile >= t_kernel.SACK_TILE
        assert tiles <= ctas <= t_kernel.SACK_MAX_CTAS
        assert ctas * t_kernel.SACK_WARPS >= F or ctas == t_kernel.SACK_MAX_CTAS
        assert hsize == 0 or (hsize >= 2 * M and hsize & (hsize - 1) == 0)
        words = -(-P // 32) if hsize == 0 else hsize
        assert not shared or 4 * words <= t_kernel.SACK_SMEM
        seen |= {"past the end"} if ctas > tiles else set()
        seen |= {"wide"} if tile > t_kernel.SACK_TILE else set()
        seen |= {"flows loop"} if ctas * t_kernel.SACK_WARPS < F else set()
        seen.add(("bitset" if hsize == 0 else "table",
                  "shared" if shared else "global"))
    assert t_kernel.sack_layout(32_768, 640, 128) == (2048, 16, 0, True)
    assert seen == {"past the end", "wide", "flows loop",
                    ("bitset", "shared"), ("table", "shared"),
                    ("table", "global")}


@pytest.mark.parametrize("case", sorted(ENQUEUE_CASES))
def test_agg_jsq_enqueue_cases_match_oracle_and_interpret_kernel(case):
    """The fused pick + enqueue on the enqueue's edge cases
    (``agg_case_operands``: about half the valid lanes agg-bound, the others
    on the case's targets): bit for bit against the reference's oracle and
    its interpret-mode Pallas kernel."""
    (*ops, t), kw = agg_case_operands(case, seed=len(case))
    got = t_ops.agg_jsq_enqueue(*[to_torch(a) for a in ops], t, **kw)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        _same(got, qr.agg_jsq_enqueue(*args, **kw), b)
        _same(got, qk.agg_jsq_enqueue(*args, interpret=True, **kw), b)
    to_agg, do_enq = torch.from_numpy(ops[6]), got[4]
    assert bool((do_enq & to_agg).any()) and bool((do_enq & ~to_agg).any())


# Cases the reference's Pallas picks do not take: scores that hold a NaN,
# which they miss (test_reference_pallas_pick_misses_nan), edges too many to
# unroll in the interpreter, and a slot past INT_MAX (their jitted slot is
# int32).  The plain versions are held to the oracles alone there.
ORACLE_ONLY = ("nan_score", "edges_1100", "t_past_int_max")


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_cases_match_oracle_and_interpret_kernel(case):
    """Both picks at the edges of their domain (``PICK_CASES``: 0, 10, 16
    and 1,100 bin edges, the slot -1, -2**31 and 2**31 + 5, NaN and +-inf
    scores, all ports tied or dead, 1-400 ports, rows of 2,000-12,300
    queues): the plain ``jsq_pick`` and
    ``agg_jsq_enqueue`` bit for bit against the reference's oracles and,
    but for ``ORACLE_ONLY``, its
    interpret-mode Pallas kernels.  The pick is the first NaN score, else
    the first minimum (``torch.argmin``'s and ``jnp.argmin``'s order), and
    the slot wraps as uint32."""
    (*ops, t), kw = pick_case_operands(case)
    got = t_ops.jsq_pick(*[to_torch(a) for a in ops], t, **kw)
    (*aops, _), akw = agg_pick_case_operands(case)
    agg = t_ops.agg_jsq_enqueue(*[to_torch(a) for a in aops], t, **akw)
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        _same([got], [qr.jsq_pick(*args, **kw)], b)
        aargs = [jnp.asarray(a[b]) for a in aops] + [t]
        _same(agg, qr.agg_jsq_enqueue(*aargs, **akw), b)
        if case not in ORACLE_ONLY:
            _same([got], [qk.jsq_pick(*args, interpret=True, **kw)], b)
            _same(agg, qk.agg_jsq_enqueue(*aargs, interpret=True, **akw), b)
    g = got.numpy()
    if case == "nan_score":
        assert (g == np.array([1, 2, 3])[:, None]).all()
    elif case == "inf_score":
        assert (g[0] == 2).all() and (g[1:] == 0).all()
    elif case in ("all_tied", "all_dead"):
        assert (g == 0).all()
    elif case == "t_past_int_max":      # the slot wraps: 2**31 + 5 - 2**32
        wrapped = t_ops.jsq_pick(*[to_torch(a) for a in ops], t - 2**32, **kw)
        assert torch.equal(got, wrapped)
    else:
        assert g.min() >= 0 and g.max() < ops[4].shape[1]


def test_reference_pallas_pick_misses_nan():
    """A reference-side fault, recorded: the reference's Pallas pick takes
    the first index whose score equals the row's minimum
    (``repro/kernels/slot_step/kernel.py:_first_min_index``), and a NaN
    equals nothing, so a row with a NaN score gets ``h``, a port past the
    last.  Its oracle (``jnp.argmin``) and the port (``torch.argmin`` and
    both CUDA picks) give the first NaN."""
    (*ops, t), kw = pick_case_operands("nan_score")
    h = ops[4].shape[1]
    for b in range(ops[0].shape[0]):
        args = [jnp.asarray(a[b]) for a in ops] + [t]
        kern = np.asarray(qk.jsq_pick(*args, interpret=True, **kw))
        assert (kern == h).all()
        assert (np.asarray(qr.jsq_pick(*args, **kw)) == b + 1).all()
