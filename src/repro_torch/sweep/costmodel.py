"""Per-campaign cost model for bucket-policy selection.

The planner's default bucketing is a fixed heuristic: greedy 2x k-buckets
(up to ~8x padded packet rows on host-linear workloads, ~64x on
``all_to_all`` -- quadratic in hosts) and pow2 packet buckets (up to 2x).
This module replaces "hope the heuristic holds" with a per-campaign model:
enumerate candidate bucketings of the tree and packet axes, score each as

    total = padded packet rows            (the padded-FLOP proxy: every
                                           fused row executes its bucket's
                                           full packet axis)
          + slot-budget waste rows        (loop engine: the pow2 slot
                                           bucket overshoot, prorated)
          + compile_rows * n_shapes       (a per-new-shape compile charge
                                           in the same padded-row unit)

and plan under the minimizer.  The heuristic policy is always in the
candidate set, so the chosen bucketing never costs more than it under the
model -- splitting a pathological group (mixed-k ``all_to_all``) buys its
extra compiles explicitly, against the padding they save.

``compile_rows`` -- how many padded packet rows one fresh compile is worth
-- is the one free parameter.  :meth:`CostParams.from_trace` calibrates it
from a measured trace (``--plan-from-trace``): dispatch spans written
under ``timing_split`` carry ``compile_s``/``execute_s``, giving both the
per-padded-row execute rate and the typical compile cost in seconds.

Selection is deterministic given (campaign, calibration): candidates are
enumerated in a fixed order and ties keep the earliest candidate.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List, Optional, Tuple

from ..net._batching import k_buckets, pow2_bucket
from .spec import Campaign


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Cost-model calibration.

    ``compile_rows`` is the padded-packet-row-equivalent charge of one
    fresh pipeline compile.  The default (64k rows) is deliberately
    mid-scale: small fused groups keep fusing (a permutation sweep's 2x
    padding never outweighs a compile), while the quadratic blow-up of a
    mixed-k ``all_to_all`` group buys its split.  Calibrate from a real
    trace for anything load-bearing.
    """
    compile_rows: float = 65536.0
    source: Optional[str] = None       # provenance label for the plan span

    @classmethod
    def from_trace(cls, path) -> "CostParams":
        """Calibrate ``compile_rows`` from a measured dispatch trace.

        Uses the ``timing_split`` fields of dispatch spans: the summed
        ``execute_s`` over summed ``pkt_rows_padded`` gives seconds per
        padded packet row; the median ``compile_s`` over that rate is the
        row-equivalent compile charge.  A trace without usable timing
        spans falls back to the defaults (``source`` says so), so a
        heuristic-run trace can always be fed back in.
        """
        from ..obs.trace import load_trace
        spans = load_trace(path)
        timed = [s for s in spans if s.get("kind") == "dispatch"
                 and s.get("execute_s") and s.get("pkt_rows_padded")]
        compiles = sorted(float(s["compile_s"]) for s in timed
                          if s.get("compile_s"))
        rows = sum(int(s["pkt_rows_padded"]) for s in timed)
        exec_s = sum(float(s["execute_s"]) for s in timed)
        if not compiles or rows <= 0 or exec_s <= 0.0:
            return cls(source=f"{path} (no timing_split spans; defaults)")
        per_row_s = exec_s / rows
        median_compile_s = compiles[len(compiles) // 2]
        compile_rows = min(max(median_compile_s / per_row_s, 1.0), 1e12)
        return cls(compile_rows=compile_rows, source=str(path))


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """One candidate bucketing of the tree and packet axes.

    ``kmap`` maps every campaign tree size to its bucket head (ascending,
    as ``(k, k_pad)`` pairs); ``pkt_exact`` lists the bucket heads whose
    packet axis keys on the *exact* packet count instead of its pow2
    bucket -- tighter padding (up to 2x) at the price of splitting loads
    with different packet counts into separate shapes.
    """
    kmap: Tuple[Tuple[int, int], ...]
    pkt_exact: Tuple[int, ...] = ()
    label: str = "greedy2x/pow2"

    def kmap_dict(self) -> Dict[int, int]:
        return dict(self.kmap)

    def pkt_bucket(self, k_pad: int, n: int) -> int:
        """Packet-axis shape key for a load with ``n`` packets at bucket
        head ``k_pad``."""
        if k_pad in self.pkt_exact:
            return max(int(n), 1)
        return pow2_bucket(n)

    @classmethod
    def heuristic(cls, trees) -> "BucketPolicy":
        """The planner's default greedy-2x / pow2 policy as a
        :class:`BucketPolicy` (always candidate #0, so the model can never
        pick anything worse than it)."""
        return cls(kmap=tuple(sorted(k_buckets(trees).items())),
                   pkt_exact=(), label="greedy2x/pow2")


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Model cost of one (campaign, policy) plan, in padded-row units."""
    pkt_rows_real: int
    pkt_rows_padded: int
    slot_waste_rows: float
    compile_charge: float
    n_dispatches: int
    n_shapes: int

    @property
    def total(self) -> float:
        return (float(self.pkt_rows_padded) + self.slot_waste_rows
                + self.compile_charge)

    @property
    def pkt_fill(self) -> float:
        return self.pkt_rows_real / max(self.pkt_rows_padded, 1)

    def as_dict(self) -> Dict:
        return {"pkt_rows_real": self.pkt_rows_real,
                "pkt_rows_padded": self.pkt_rows_padded,
                "pkt_fill": self.pkt_fill,
                "slot_waste_rows": self.slot_waste_rows,
                "compile_charge": self.compile_charge,
                "n_dispatches": self.n_dispatches,
                "n_shapes": self.n_shapes,
                "total": self.total}


def _grouped(trees: List[int], groups: List[List[int]],
             pkt_exact: Tuple[int, ...]) -> BucketPolicy:
    kmap = tuple((k, max(g)) for g in groups for k in sorted(g))
    label = "k[" + "|".join(",".join(str(k) for k in sorted(g))
                            for g in groups) + "]"
    if pkt_exact:
        label += "+exact[" + ",".join(str(h) for h in pkt_exact) + "]"
    return BucketPolicy(kmap=kmap, pkt_exact=pkt_exact, label=label)


def candidate_policies(campaign: Campaign) -> List[BucketPolicy]:
    """The deterministic candidate set: the heuristic policy first, then
    every contiguous partition of the ascending tree axis (each group pads
    to its largest member) crossed with per-bucket-head exact-vs-pow2
    packet modes.  Contiguity is lossless -- padding cost is monotone in
    ``k``, so an optimal grouping never skips over a middle size.  Wide
    axes cap the enumeration (per-k split and full fuse only past 7 trees;
    all-exact/all-pow2 only past 4 bucket heads) to keep planning O(ms).
    """
    trees = sorted({int(k) for k in campaign.trees})
    cands = [BucketPolicy.heuristic(campaign.trees)]
    m = len(trees)
    partitions: List[List[List[int]]] = []
    if m <= 7:
        for mask in range(1 << (m - 1)):
            groups, cur = [], [trees[0]]
            for i in range(1, m):
                if (mask >> (i - 1)) & 1:
                    groups.append(cur)
                    cur = [trees[i]]
                else:
                    cur.append(trees[i])
            groups.append(cur)
            partitions.append(groups)
    else:
        partitions = [[[t] for t in trees], [list(trees)]]
    seen = {(cands[0].kmap, cands[0].pkt_exact)}
    for groups in partitions:
        heads = sorted({max(g) for g in groups})
        if len(heads) <= 4:
            exact_sets = [tuple(c) for r in range(len(heads) + 1)
                          for c in itertools.combinations(heads, r)]
        else:
            exact_sets = [(), tuple(heads)]
        for ex in exact_sets:
            pol = _grouped(trees, groups, ex)
            sig = (pol.kmap, pol.pkt_exact)
            if sig not in seen:
                seen.add(sig)
                cands.append(pol)
    return cands


def evaluate_policy(campaign: Campaign, policy: BucketPolicy,
                    params: Optional[CostParams] = None) -> PlanCost:
    """Model cost of planning ``campaign`` under ``policy`` (no dispatching
    -- this is pure host-side accounting over the would-be megabatches)."""
    from .planner import plan
    params = params if params is not None else CostParams()
    p = plan(campaign, policy=policy)
    real = padded = 0
    loop_padded = 0
    for mega in p.megabatches:
        rows = mega.n_points
        real += sum(len(b.seeds) * b.n_packets(b.k)
                    for b in mega.members)
        padded += rows * mega.npk_pad
        if mega.engine == "loop":
            loop_padded += rows * mega.npk_pad
    slot_waste = 0.0
    if loop_padded:
        budget = max(int(campaign.max_slots), 1)
        bucket = pow2_bucket(budget)
        slot_waste = loop_padded * (bucket - budget) / float(bucket)
    return PlanCost(pkt_rows_real=real, pkt_rows_padded=padded,
                    slot_waste_rows=slot_waste,
                    compile_charge=float(params.compile_rows) * p.n_shapes,
                    n_dispatches=p.n_dispatches, n_shapes=p.n_shapes)


@functools.lru_cache(maxsize=64)
def choose_policy(campaign: Campaign,
                  params: Optional[CostParams] = None
                  ) -> Tuple[BucketPolicy, PlanCost, Tuple]:
    """Pick the cost-minimizing bucket policy for ``campaign``.

    Returns ``(policy, cost, alternatives)`` where ``alternatives`` are the
    *rejected* candidates as ``(label, total_cost, predicted_pkt_fill)``
    rows sorted by cost (the plan span records them).  Deterministic given
    (campaign, params): candidate order is fixed and ties keep the earliest
    -- in particular the heuristic wins exact ties, so cost-mode plans on
    campaigns the heuristic already handles optimally are unchanged up to
    dispatch order.
    """
    params = params if params is not None else CostParams()
    scored = [(pol, evaluate_policy(campaign, pol, params))
              for pol in candidate_policies(campaign)]
    best_i = min(range(len(scored)), key=lambda i: scored[i][1].total)
    policy, cost = scored[best_i]
    alternatives = tuple(sorted(
        ((pol.label, c.total, c.pkt_fill)
         for i, (pol, c) in enumerate(scored) if i != best_i),
        key=lambda row: row[1]))
    return policy, cost, alternatives
