"""Campaign result records, JSONL persistence, and seed aggregation.

One record per grid point (scheme x load x tree x failure x seed), holding
the scalar metrics the paper's figures are built from: collective completion
time, queue maxima, per-layer waits, delivery-time percentiles, and -- for
the layer-balance study -- counts-based per-layer overload ratios.

Records are written as JSONL with sorted keys and canonical float repr, so a
re-run of the same campaign produces a byte-identical file (tested in
``tests/test_sweep.py``); summaries aggregate over the seed axis (mean/p99
CCT plus seed spread).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

from ..net.topology import LAYER_NAMES
from .spec import GridPoint

# Grid-point identity fields, in summary group-by order (everything but seed).
# Fast-engine records carry no g_converge, only timing-axis loop records
# carry prop_slots/ack_delay, and only collective-phase records carry
# "phases"; .get(None) keeps the others grouped.
_KEY_FIELDS = ("campaign", "k", "workload", "failure", "g_converge",
               "prop_slots", "ack_delay", "phases", "scheme")


def _phase_fields(rec: Dict, point: GridPoint, phases, done) -> None:
    """Attach the collective-phase / iteration-time fields to a record.

    Only-when-set (the timings pattern): points without a phase schedule
    add no keys, keeping pre-phase campaign files byte-identical.  ``done``
    is the per-packet completion-slot vector of the point's engine
    (fast: ``delivery``; loop: ``delivered_slot``); ``phases`` is the
    runner-cached ``repro_torch.phases.CompiledPhases`` (None under degraded
    paths that lack it -- the identity fields still land).
    """
    if point.phase is None:
        return
    rec["phases"] = point.phase.label()
    rec["n_phases"] = int(point.phase.n_phases)
    rec["iterations"] = int(point.phase.iterations)
    if phases is None:
        return
    done = np.asarray(done, dtype=np.float64)
    comp = []
    for lo, hi, st in zip(phases.pkt_lo.tolist(), phases.pkt_hi.tolist(),
                          phases.phase_start.tolist()):
        # An empty phase (degenerate collective) completes at its start.
        comp.append(float(done[lo:hi].max()) if hi > lo else float(st))
    rec["phase_completion"] = comp
    mks = []
    for it in range(int(point.phase.iterations)):
        m = phases.iter_of == it
        if not m.any():
            continue
        end = max(c for c, sel in zip(comp, m.tolist()) if sel)
        mks.append(end - float(phases.phase_start[m].min()))
    rec["iter_makespan"] = mks
    rec["iter_time_mean"] = float(np.mean(mks)) if mks else 0.0


def point_record(point: GridPoint, res, phases=None) -> Dict:
    """Flatten one ``fastsim.FastSimResult`` into a JSON-safe record."""
    delivery = np.asarray(res.delivery)
    fcomp = np.asarray(res.flow_completion)
    rec = {
        "campaign": point.campaign,
        "k": point.k,
        "workload": point.load.label(),
        "failure": point.failure.label() if point.failure else None,
        "scheme": point.scheme,
        "seed": point.seed,
        "engine": "fast",
        "n_packets": int(delivery.shape[0]),
        "cct": float(res.cct),
        "max_queue": float(res.max_queue),
        # Zero-packet workloads (msg_packets=0, all-degenerate phases)
        # have no percentiles to take.
        "delivery_p50": float(np.percentile(delivery, 50))
        if delivery.size else 0.0,
        "delivery_p99": float(np.percentile(delivery, 99))
        if delivery.size else 0.0,
        "flow_completion_p99": float(np.percentile(fcomp, 99))
        if fcomp.size else 0.0,
    }
    for name in LAYER_NAMES:
        st = res.layers[name]
        tag = name.replace("->", "_")
        rec[f"max_queue_{tag}"] = float(st.max_queue)
        rec[f"avg_wait_{tag}"] = float(st.avg_wait)
        counts = np.asarray(st.counts)
        used = counts[counts > 0]
        if used.size and counts.sum() > 0:
            ideal = counts.sum() / counts.shape[0]
            rec[f"overload_{tag}"] = float(used.max() / ideal - 1.0)
        else:
            rec[f"overload_{tag}"] = 0.0
    _phase_fields(rec, point, phases, res.delivery)
    _attach_probe(rec, res)
    return rec


def _attach_probe(rec: Dict, res) -> None:
    """Add the opt-in queue time series to a point record.  Probes off (the
    default) adds no keys, keeping the record -- and the JSONL bytes --
    identical to a probe-free build."""
    probe = getattr(res, "probe", None)
    if probe is not None:
        rec["probe_stride"] = int(probe.stride)
        rec["probe_queue"] = np.asarray(probe.series).tolist()


def loop_point_record(point: GridPoint, res, phases=None) -> Dict:
    """Flatten one ``loopsim.LoopSimResult`` into a JSON-safe record."""
    rec = {
        "campaign": point.campaign,
        "k": point.k,
        "workload": point.load.label(),
        "failure": point.failure.label() if point.failure else None,
        "scheme": point.scheme,
        "seed": point.seed,
        "g_converge": point.g_converge,
        "engine": "loop",
        "cct": float(res.cct_slots),
        "cct_acked": float(res.cct_acked_slots),
        "max_queue": float(res.max_queue),
        "avg_queue": float(res.avg_queue),
        "drops": int(res.drops),
        "retransmissions": int(res.retransmissions),
        "finished": bool(res.finished),
        "mean_cwnd": float(res.mean_cwnd),
    }
    if point.timing is not None:
        # Timing-axis points record their (prop_slots, ack_delay) pair;
        # points off the axis add no keys, keeping pre-axis campaign files
        # byte-identical.
        rec["prop_slots"] = int(point.timing[0])
        rec["ack_delay"] = int(point.timing[1])
    _phase_fields(rec, point, phases, res.delivered_slot)
    _attach_probe(rec, res)
    return rec


def _canon(x):
    """JSON-canonical values: floats through repr-stable float(), numpy
    scalars unboxed, arrays/containers recursed (probe series are nested
    lists)."""
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, np.ndarray):
        return [_canon(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    return x


def encode_record(rec: Dict) -> str:
    return json.dumps({k: _canon(v) for k, v in rec.items()}, sort_keys=True)


class ResultStore:
    """Append-only JSONL store for point records, with deterministic bytes.

    ``path=None`` keeps records in memory only (used by benchmarks/tests
    that aggregate without persisting).

    ``overwrite=False`` turns an existing file into a resume checkpoint:
    complete lines load back into ``records`` (a torn final line -- the
    half-written tail of a SIGKILLed run; append flushes per record, so at
    most one line can be torn -- is discarded and truncated off the file)
    and subsequent appends extend the file.  Because encoding is
    canonical, a campaign finished via resume produces a byte-identical
    file to one that never crashed (``tests/test_faults.py``).
    """

    def __init__(self, path: Optional[str] = None, overwrite: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.records: List[Dict] = []
        # per-dispatch wall times, filled by the runner: list of
        # (SeedBatch, seconds).  Kept off the JSONL so result files stay
        # byte-deterministic; benchmarks read it for per-scheme timings.
        self.timings: List = []
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if self.path.exists():
                if overwrite:
                    self.path.unlink()
                else:
                    self._load_checkpoint()

    def _load_checkpoint(self) -> None:
        """Read back every complete line; drop (and truncate off disk) a
        torn tail line lacking its newline or failing to decode."""
        raw = self.path.read_text(errors="replace")
        lines = raw.split("\n")
        kept: List[Dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            if i == len(lines) - 1:      # no trailing newline: torn write
                break
            try:
                kept.append(json.loads(line))
            except json.JSONDecodeError:
                break
        self.records = kept
        self._rewrite()

    def _rewrite(self) -> None:
        self.close()
        with self.path.open("w") as f:
            for rec in self.records:
                f.write(encode_record(rec) + "\n")

    def truncate(self, n: int) -> None:
        """Keep only the first ``n`` records (resume: drop the records of a
        partially-recorded dispatch so it re-runs whole)."""
        if n >= len(self.records):
            return
        del self.records[n:]
        if self.path:
            self._rewrite()

    def append(self, rec: Dict) -> None:
        self.records.append(rec)
        if self.path:
            if self._fh is None:
                self._fh = self.path.open("a")
            self._fh.write(encode_record(rec) + "\n")
            self._fh.flush()    # every appended record is durable on return

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @classmethod
    def load(cls, path: str) -> "ResultStore":
        store = cls(None)
        with pathlib.Path(path).open() as f:
            store.records = [json.loads(line) for line in f if line.strip()]
        return store


def summarize(records: List[Dict]) -> List[Dict]:
    """Aggregate over the seed axis: one summary row per grid point identity.

    Reports mean and p99 CCT, the max-over-seeds queue maximum, and the seed
    spread (std / min / max of CCT) that the paper's error bars show.

    Tolerant of schema growth: records missing the core metrics (e.g. rows
    from a future producer, or non-point rows mixed into a shared file) are
    skipped rather than KeyError'd, and extra keys -- probe series, trace
    cross-references -- are ignored.
    """
    groups: Dict[tuple, List[Dict]] = {}
    order: List[tuple] = []
    for r in records:
        if "cct" not in r:
            continue
        key = tuple(r.get(k) for k in _KEY_FIELDS)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(r)

    out = []
    for key in order:
        rs = groups[key]
        cct = np.array([r["cct"] for r in rs], dtype=np.float64)
        mq = np.array([r.get("max_queue", 0.0) for r in rs],
                      dtype=np.float64)
        row = dict(zip(_KEY_FIELDS, key))
        row.update({
            "n_seeds": len(rs),
            "cct_mean": float(cct.mean()),
            "cct_p99": float(np.percentile(cct, 99)),
            "cct_std": float(cct.std()),
            "cct_min": float(cct.min()),
            "cct_max": float(cct.max()),
            "max_queue_mean": float(mq.mean()),
            "max_queue_max": float(mq.max()),
        })
        # Iteration time (collective-phase points; only-when-set).
        its = [r["iter_time_mean"] for r in rs if "iter_time_mean" in r]
        if its:
            row["iter_time_mean"] = float(np.mean(its))
            row["iter_time_max"] = float(np.max(its))
        out.append(row)
    return out


def write_summary(path: str, records: List[Dict]) -> List[Dict]:
    rows = summarize(records)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for row in rows:
            f.write(encode_record(row) + "\n")
    return rows
