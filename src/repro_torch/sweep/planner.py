"""Campaign execution planning.

Three-level grouping of the expanded grid:

1. **Seed batches** -- grid points identical up to the replicate seed merge
   into one :class:`SeedBatch` (the record-keeping granularity: one
   workload/failure/scheme/G cell with all its seeds).
2. **Megabatches** -- fast-engine seed batches whose points lower to the
   same pipeline fuse into one :class:`MegaBatch`, which the runner
   executes as a *single* batched ``fastsim.simulate_megabatch`` dispatch:
   the scheme axis (flow_ecmp, subflow_mptcp, host_pkt and host_dr all lower
   to the same 'pre/pre' pipeline), the failure axis, and -- via
   shape-bucketed packet padding -- nearby message sizes all stack onto one
   fused ``(scheme x load x failure x seed)`` batch axis.
3. **Pipeline shapes** -- one per distinct megabatch key, so
   ``n_dispatches == n_shapes``: every dispatch's fixed cost (host
   preparation, kernel launches) is amortized over the whole grid slice
   that shares it.  The keys are the JAX reference's, so both packages plan
   a campaign identically.

Both engines fuse.  Fast-engine batches group by ``LBScheme.shape_key()``;
loop-engine batches (ACK/ECN schemes) group by ``LBScheme.loop_shape_key()``
plus the static ``LoopConfig`` fields (``loss``, ``cca``, ``buffer_pkts``,
timing constants) and the power-of-two-bucketed slot budget -- the failure,
``g_converge``, rho and seed axes all ride the fused batch axis as operands.

The *tree-size* axis buckets too (``_batching.k_buckets``): every tree of a
campaign pads its topology operands to the largest ``k`` of its bucket, so
fused keys carry the k-bucket head instead of the raw ``k`` and a grid
sweeping tree size costs ONE dispatch per compiled shape, not one per tree.
Packet buckets are taken at the bucket-head tree (``n_packets(k_pad)``) so
the packet axis can't silently re-split what the k axis fused.  This holds
for EVERY scheme on BOTH engines: loop-engine rand/JSQ in-loop randomness
comes from counter streams keyed on logical ids (``core.entropy``), so
tree padding cannot perturb the draws and no fused key carries a raw ``k``
anywhere.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from ..core import lb_schemes as lbs
from ..net._batching import k_buckets, pow2_bucket
from ..net import loopsim
from ..obs.probes import probe_shape
from .spec import Campaign, FailureSpec, GridPoint, WorkloadSpec


def bucket_packets(n: int) -> int:
    """Shape bucket for packet-array padding: next power of two.  Workloads
    whose packet counts land in one bucket share a compiled pipeline."""
    return pow2_bucket(n)


@functools.lru_cache(maxsize=256)
def _kmap_cached(trees: Tuple[int, ...]) -> Dict[int, int]:
    return k_buckets(trees)


def _kmap(trees: Tuple[int, ...]) -> Dict[int, int]:
    """Campaign-scoped tree-size buckets (``{k: k_pad}``).  The cache key is
    the canonicalized axis -- ``tuple(sorted(set(...)))`` -- so permuted or
    duplicated ``trees`` tuples (equal grids, equal buckets) hit one entry
    instead of multiplying equivalent ones."""
    return _kmap_cached(tuple(sorted({int(k) for k in trees})))


@dataclasses.dataclass(frozen=True)
class SeedBatch:
    """All replicate seeds of one simulation point."""
    campaign: str
    k: int
    load: WorkloadSpec
    failure: Optional[FailureSpec]
    scheme: str
    seeds: Tuple[int, ...]
    g_converge: Optional[int] = None
    timing: Optional[Tuple[int, int]] = None
    phase: Optional[object] = None     # repro_torch.phases.PhaseSchedule

    def points(self) -> List[GridPoint]:
        return [GridPoint(self.campaign, self.k, self.load, self.failure,
                          self.scheme, s, self.g_converge, self.timing,
                          self.phase)
                for s in self.seeds]

    def n_packets(self, k: int) -> int:
        """Packet count of this batch's (possibly phased) traffic on a
        fat-tree of size ``k`` -- the planner's bucketing input and the
        cost model / fill accounting's "real rows" term."""
        if self.phase is not None:
            return self.phase.n_packets(k, self.load.msg_packets)
        return self.load.n_packets(k)

    def fused_key(self, campaign: Campaign, policy=None) -> Tuple:
        """Megabatch identity: everything the fused dispatch compiles over.
        Loads/failures/g_converge are *not* part of it (their per-packet
        arrays and convergence/rho scalars ride the batch axis, padded to
        the bucketed packet count), and neither is the raw tree size: the
        key carries the campaign's k-bucket head, to which every member's
        topology operands pad (packet buckets are taken at the bucket-head
        tree for the same reason).  Loop-engine points additionally key on
        the static LoopConfig fields (timing constants pow2-bucketed --
        the ring shapes, not the per-row moduli) and the bucketed slot
        budget; in-loop randomness is counter-stream based
        (``core.entropy``), so rand/JSQ loop schemes bucket like every
        other scheme -- no fused key carries a raw k.

        ``policy`` (a ``sweep.costmodel.BucketPolicy``) overrides the
        default greedy-2x k-buckets / pow2 packet buckets; ``None`` keeps
        the heuristic."""
        scheme = lbs.by_name(self.scheme)
        kmap = policy.kmap_dict() if policy is not None else \
            _kmap(campaign.trees)
        kb = kmap[self.k]
        npk = (policy.pkt_bucket(kb, self.n_packets(kb))
               if policy is not None
               else bucket_packets(self.n_packets(kb)))
        if campaign.engine == "loop" or scheme.needs_feedback:
            return ("loop", kb, npk,
                    scheme.loop_shape_key(),
                    loopsim.static_config(
                        campaign.loop_config(timing=self.timing)),
                    pow2_bucket(int(campaign.max_slots)),
                    probe_shape(campaign.probes))
        return ("fast", kb, npk,
                scheme.shape_key(), campaign.backend,
                float(campaign.prop_slots), probe_shape(campaign.probes))


@dataclasses.dataclass
class MegaBatch:
    """One runner dispatch: all member batches execute as a single batched
    ``simulate_megabatch`` call on their engine (``fastsim`` or
    ``loopsim``)."""
    key: Tuple
    members: List[SeedBatch]

    @property
    def engine(self) -> str:
        return "loop" if self.key[0] == "loop" else "fast"

    @property
    def k_pad(self) -> int:
        """Tree size every member's topology operands pad to (the k-bucket
        head; equals the raw k for unbucketed members)."""
        return self.key[1]

    @property
    def npk_pad(self) -> int:
        """Bucketed packet-array padding of the fused dispatch."""
        return self.key[2]

    @property
    def n_points(self) -> int:
        return sum(len(b.seeds) for b in self.members)


@dataclasses.dataclass
class Plan:
    campaign: Campaign
    batches: List[SeedBatch]
    megabatches: List[MegaBatch]
    # Cost-modeled planning (``Campaign.planner == 'cost'`` or an explicit
    # ``policy=`` argument): the chosen ``costmodel.BucketPolicy``, its
    # predicted ``costmodel.PlanCost``, and the rejected alternatives as
    # (label, total cost, predicted pkt fill) rows.  All ``None``/empty
    # under the default heuristic policy.
    policy: Optional[object] = None
    cost: Optional[object] = None
    alternatives: Tuple = ()

    @property
    def n_points(self) -> int:
        return sum(len(b.seeds) for b in self.batches)

    @property
    def n_dispatches(self) -> int:
        return len(self.megabatches)

    @property
    def n_shapes(self) -> int:
        return len({m.key for m in self.megabatches})

    def describe(self) -> str:
        pol = (f" [policy {self.policy.label}]"
               if self.policy is not None else "")
        return (f"campaign {self.campaign.name!r}: {self.n_points} grid "
                f"points -> {self.n_dispatches} fused dispatches "
                f"({self.n_shapes} compiled pipeline shapes){pol}")


def plan(campaign: Campaign, policy=None, cost_params=None) -> Plan:
    """Group the campaign grid into seed batches, then fuse batches sharing
    a compiled pipeline into megabatches (one dispatch per compiled shape).

    With ``campaign.planner == 'cost'`` (and no explicit ``policy``) the
    ``sweep.costmodel`` cost model picks the bucketing: candidate tree/
    packet bucketings are scored as padded packet rows + slot-budget waste
    + a per-new-shape compile charge (``cost_params``, optionally
    calibrated from a measured trace), the minimizer wins, and dispatches
    are ordered largest-first so sharded device lanes fill before the
    small tails run.  An explicit ``policy`` (a
    ``costmodel.BucketPolicy``) bypasses selection and plans under that
    policy directly -- that is also how the cost model itself evaluates
    each candidate."""
    cost = None
    alternatives: Tuple = ()
    if policy is None and campaign.planner == "cost":
        from .costmodel import choose_policy
        policy, cost, alternatives = choose_policy(campaign, cost_params)

    batches: dict = {}
    for p in campaign.points():
        key = (p.k, p.load, p.failure, p.scheme, p.g_converge, p.timing,
               p.phase)
        batches.setdefault(key, []).append(p.seed)

    out = [SeedBatch(campaign=campaign.name, k=k, load=load, failure=failure,
                     scheme=scheme, seeds=tuple(seeds), g_converge=g,
                     timing=tm, phase=ph)
           for (k, load, failure, scheme, g, tm, ph), seeds
           in batches.items()]
    # Stable sort by fused key: batches sharing a compiled pipeline become
    # adjacent (and fuse into one dispatch) while the within-group grid
    # order is preserved.
    fused_rank: dict = {}
    for b in out:
        fused_rank.setdefault(b.fused_key(campaign, policy), len(fused_rank))
    out.sort(key=lambda b: fused_rank[b.fused_key(campaign, policy)])

    megas: List[MegaBatch] = []
    for b in out:
        key = b.fused_key(campaign, policy)
        if megas and megas[-1].key == key:
            megas[-1].members.append(b)
        else:
            megas.append(MegaBatch(key=key, members=[b]))

    if policy is not None:
        # Largest-first dispatch order: sharded fused axes fill their
        # device lanes on the big dispatches before the small tails run
        # (first-seen rank breaks ties, keeping the order deterministic).
        first_seen = {id(m): i for i, m in enumerate(megas)}
        megas.sort(key=lambda m: (-m.n_points * m.npk_pad,
                                  first_seen[id(m)]))
        out = [b for m in megas for b in m.members]
    return Plan(campaign=campaign, batches=out, megabatches=megas,
                policy=policy, cost=cost, alternatives=alternatives)
