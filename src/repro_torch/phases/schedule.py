"""Collective-phase training schedules on the fused campaign axis.

Production training traffic is *phased*: every iteration repeats a fixed
sequence of collectives -- MoE all-to-all dispatch/combine bursts, the
gradient all-reduce, FSDP ring shards -- and the metric that matters is
the *iteration time*, not any single snapshot's FCT ("High-speed
Networking for Giga-Scale AI Factories"; PRIME, arxiv 2507.23012).  This
module makes that traffic a first-class campaign axis, mirroring
``repro_torch.faults.FaultSchedule``:

* :class:`Phase` -- one collective step (kind, bytes, participants).
* :class:`PhaseSchedule` -- a declarative sequence of phases repeated for
  ``iterations`` training steps.  ``from_model`` derives one from a named
  ``repro_torch/configs`` model (e.g. ``"deepseek-v3-671b"``) + parallelism
  layout; each phase's implementation (one-shot vs rotation) is chosen by
  ``repro_torch.collectives.planner`` from the phase's bytes and axis size.
* :class:`CompiledPhases` -- ``compile(tree, load)`` lowers the schedule
  into ONE fused ``net.workloads.Workload``: per-phase traffic matrices
  (ring permutation for all-reduce, one-shot or rotation-round for
  all-to-all, hierarchical rings for FSDP) concatenated with
  globally-offset flow ids, per-packet ``t_release`` shifted by the phase
  start slot (the fast engine's phase binding) and a per-flow
  ``flow_start`` array (the slotted engine's per-row gate operand).

Like ``FaultSchedule``, a schedule rides the engines' fused batch axis
(``simulate_megabatch``): its workload is padded like any other, and a
single-phase schedule with zero start offset is bitwise-identical to the
equivalent static workload on both engines.  This module is a copy of the
JAX reference's ``repro.phases``, so one schedule compiles to the same
workload in both packages.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..collectives.planner import FabricModel, plan_all_reduce, plan_all_to_all
from ..net import workloads
from ..net.topology import FatTree
from ..net.workloads import Workload


@dataclasses.dataclass(frozen=True)
class Phase:
    """One collective step of a training iteration.

    ``bytes`` follows the collectives planner's convention: total bytes
    for ``all_reduce``, bytes per (src, dst) pair for ``all_to_all``, and
    per-ring-hop bytes for ``fsdp_ring``.  ``n`` is the size of the
    parallelism axis the collective runs over (expert-parallel degree,
    data-parallel degree, ...) -- it drives the planner's one-shot vs
    rotation decision, while the simulated traffic always spans the
    campaign tree's hosts.  ``gap_slots`` adds idle slots after the
    phase's send window (compute between collectives).
    """
    name: str
    collective: str            # 'all_reduce' | 'all_to_all' | 'fsdp_ring'
    bytes: float
    n: int
    intra_pod: bool = False
    gap_slots: int = 0

    def __post_init__(self):
        if self.collective not in ("all_reduce", "all_to_all", "fsdp_ring"):
            raise ValueError(f"unknown collective {self.collective!r}")

    def to_dict(self) -> Dict:
        return {"name": self.name, "collective": self.collective,
                "bytes": float(self.bytes), "n": int(self.n),
                "intra_pod": bool(self.intra_pod),
                "gap_slots": int(self.gap_slots)}

    @classmethod
    def from_dict(cls, d: Dict) -> "Phase":
        return cls(name=d["name"], collective=d["collective"],
                   bytes=float(d["bytes"]), n=int(d["n"]),
                   intra_pod=bool(d.get("intra_pod", False)),
                   gap_slots=int(d.get("gap_slots", 0)))


@dataclasses.dataclass
class CompiledPhases:
    """A schedule lowered onto one tree + load: the fused workload plus the
    per-phase bookkeeping iteration-time records need.

    ``workload.flow_start`` carries the per-flow phase start (slots); the
    fast engine sees the same offsets folded into ``t_release``.  Packet
    and flow index ranges are per *phase instance* (schedule phases x
    iterations), in schedule order.
    """
    workload: Workload
    phase_start: np.ndarray       # (n_instances,) int64 start slot
    pkt_lo: np.ndarray            # (n_instances,) int64 packet range
    pkt_hi: np.ndarray
    names: Tuple[str, ...]        # per instance
    impls: Tuple[str, ...]        # planner-chosen impl per instance
    iter_of: np.ndarray           # (n_instances,) int64 iteration index

    @property
    def n_instances(self) -> int:
        return int(self.phase_start.shape[0])


def _pair_counts(collective: str, impl: str, n_hosts: int) -> Tuple[int, int]:
    """(n_flows, flows_per_host) of a phase's traffic matrix on the tree."""
    if collective == "all_to_all" and impl == "xla":
        return n_hosts * (n_hosts - 1), n_hosts - 1
    # ring permutation / rotation round / fsdp rings: one flow per host
    return n_hosts, 1


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """A named sequence of collective phases repeated ``iterations`` times.

    ``slack`` scales each phase's send window beyond its serialization
    time (``flows_per_host * packets_per_flow`` slots at 1 pkt/slot) to
    leave drain room before the next phase starts; ``gpus_per_server``
    parameterizes the ``fsdp_ring`` traffic mapping.  Per-flow packet
    counts normalize so the largest phase sends ``load.msg_packets``
    packets per flow and the others scale by their byte ratio (minimum 1
    for any phase with positive traffic; degenerate phases -- ``n <= 1``
    or ``bytes <= 0`` -- compile to zero flows, the collectives planner's
    empty-plan edge).
    """
    name: str
    phases: Tuple[Phase, ...]
    iterations: int = 1
    slack: float = 1.5
    gpus_per_server: int = 4

    def __post_init__(self):
        if not self.phases:
            raise ValueError("PhaseSchedule needs at least one phase")
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")
        if self.slack <= 0:
            raise ValueError("slack must be positive")

    # -- identity ---------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.phases)

    @property
    def n_instances(self) -> int:
        return self.n_phases * self.iterations

    def label(self) -> str:
        """Stable human-prefixed identity used in records and resume keys."""
        digest = hashlib.md5(json.dumps(
            [p.to_dict() for p in self.phases], sort_keys=True
        ).encode()).hexdigest()[:8]
        return (f"{self.name}-{self.n_phases}p{self.iterations}i"
                f"-s{self.slack:g}-{digest}")

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict:
        return {"kind": "phases", "name": self.name,
                "phases": [p.to_dict() for p in self.phases],
                "iterations": int(self.iterations),
                "slack": float(self.slack),
                "gpus_per_server": int(self.gpus_per_server)}

    @classmethod
    def from_dict(cls, d: Dict) -> "PhaseSchedule":
        return cls(name=d["name"],
                   phases=tuple(Phase.from_dict(p) for p in d["phases"]),
                   iterations=int(d.get("iterations", 1)),
                   slack=float(d.get("slack", 1.5)),
                   gpus_per_server=int(d.get("gpus_per_server", 4)))

    # -- derivation from a model config -----------------------------------
    @classmethod
    def from_model(cls, model: str, ep: int = 8, dp: int = 8,
                   tokens_per_rank: int = 4096, iterations: int = 1,
                   smoke: bool = False, **kw) -> "PhaseSchedule":
        """Derive the per-iteration collective sequence of a named
        ``repro_torch/configs`` model under an (ep, dp) parallelism layout.

        Phases, in iteration order:

        * MoE dispatch + combine all-to-alls (one pair per MoE layer,
          folded into two aggregate phases) when the config has experts:
          each rank routes ``experts_per_tok`` activations of width
          ``moe_d_ff`` per token across the ``ep`` axis.
        * the gradient all-reduce over the ``dp`` axis (parameter bytes
          approximated by the dense transformer stack).
        * an FSDP ring all-gather phase when the config shards parameters
          over pods (``fsdp_over_pod``, e.g. DeepSeek-V3 671B).
        """
        from ..configs import get_config
        cfg = get_config(model, smoke=smoke)
        dt = 2 if cfg.dtype == "bfloat16" else 4
        phases: List[Phase] = []
        n_moe = cfg.n_layers - cfg.n_dense_layers
        if cfg.n_experts and cfg.experts_per_tok and n_moe > 0 and ep > 1:
            # Per (src, dst) pair bytes of one layer's dispatch a2a,
            # aggregated over the MoE layers of the iteration.
            pair = (tokens_per_rank * cfg.experts_per_tok * cfg.d_model
                    * dt / max(ep, 1))
            phases.append(Phase("moe_dispatch", "all_to_all",
                                bytes=pair * n_moe, n=ep))
            phases.append(Phase("moe_combine", "all_to_all",
                                bytes=pair * n_moe, n=ep))
        # Gradient all-reduce across data parallel: dense params only
        # (expert grads reduce inside the EP groups).
        dense_params = (cfg.n_layers * (4 * cfg.d_model * cfg.d_model
                                        + 2 * cfg.d_model * cfg.d_ff)
                        + cfg.vocab * cfg.d_model)
        phases.append(Phase("grad_allreduce", "all_reduce",
                            bytes=dense_params * dt, n=dp))
        if cfg.fsdp_over_pod:
            phases.append(Phase("fsdp_allgather", "fsdp_ring",
                                bytes=dense_params * dt / max(dp, 1), n=dp))
        return cls(name=model, phases=tuple(phases),
                   iterations=iterations, **kw)

    # -- lowering ---------------------------------------------------------
    def plans(self, fabric: Optional[FabricModel] = None) -> Tuple:
        """Per-phase ``collectives.planner.Plan`` (impl + estimate).  A
        degenerate phase (``n <= 1`` / ``bytes <= 0``) yields the planner's
        empty plan."""
        fabric = fabric if fabric is not None else FabricModel()
        out = []
        for p in self.phases:
            if p.collective == "all_reduce":
                out.append(plan_all_reduce(p.bytes, p.n, fabric,
                                           intra_pod=p.intra_pod))
            elif p.collective == "all_to_all":
                out.append(plan_all_to_all(p.bytes, p.n, fabric,
                                           intra_pod=p.intra_pod))
            else:   # fsdp_ring: always the hierarchical-ring mapping
                out.append(plan_all_reduce(p.bytes, p.n, fabric,
                                           intra_pod=False))
        return tuple(out)

    def _impl_of(self, phase: Phase, plan) -> str:
        if phase.collective == "fsdp_ring":
            return "fsdp_ring"
        if phase.collective == "all_reduce":
            return "ring"
        # all_to_all: planner picks one-shot ('xla') vs a rotation round
        return "rotation" if plan.impl == "rotation" else "xla"

    @functools.lru_cache(maxsize=64)
    def _shape(self) -> Tuple[Tuple[str, str, int], ...]:
        """(collective, impl, packets-per-flow-weight) per phase, with the
        largest phase normalized to weight 1.0 scaled later by the load's
        ``msg_packets``.  Degenerate phases get weight 0."""
        plans = self.plans()
        vols = []
        for p, pl in zip(self.phases, plans):
            degenerate = p.n <= 1 or p.bytes <= 0 or pl.impl == "none"
            vols.append(0.0 if degenerate else float(p.bytes))
        top = max(vols) if any(v > 0 for v in vols) else 1.0
        out = []
        for p, pl, v in zip(self.phases, plans, vols):
            out.append((p.collective, self._impl_of(p, pl), v / top))
        return tuple(out)

    def msg_packets(self, load_msg_packets: int) -> Tuple[int, ...]:
        """Packets per flow for each phase: the largest phase sends the
        load's ``msg_packets``, others scale by byte ratio (min 1 when
        non-degenerate, 0 when degenerate)."""
        base = int(load_msg_packets)
        out = []
        for _, _, w in self._shape():
            out.append(0 if w <= 0 else max(1, int(round(w * base))) if base
                       else 0)
        return tuple(out)

    def n_packets(self, k: int, load_msg_packets: int) -> int:
        """Total packet count on a k-ary fat tree WITHOUT materializing the
        workload -- the planner's bucketing input (must agree exactly with
        ``compile``'s output size)."""
        n_hosts = k ** 3 // 4
        mps = self.msg_packets(load_msg_packets)
        total = 0
        for (coll, impl, _), m in zip(self._shape(), mps):
            if m <= 0:
                continue
            n_flows, _ = _pair_counts(coll, impl, n_hosts)
            total += n_flows * m
        return total * self.iterations

    def compile(self, tree: FatTree, load_msg_packets: int,
                rng_seed: int = 0,
                gpus_per_server: Optional[int] = None) -> CompiledPhases:
        """Lower the schedule onto ``tree`` into one fused workload.

        Phase traffic matrices (per instance ``i = it * n_phases + p``):

        * ``all_reduce`` -> the ring-neighbor permutation host
          ``h -> (h+1) % n_hosts`` (what the fabric sees from ring RS+AG).
        * ``all_to_all`` with planner impl ``'xla'`` -> one-shot
          ``workloads.all_to_all``; impl ``'rotation'`` -> one rotation
          round, a random derangement seeded ``(rng_seed, i)`` (rounds are
          shape-identical, so one round represents the steady state).
        * ``fsdp_ring`` -> ``workloads.fsdp_rings`` with random server
          placement seeded ``(rng_seed, i)``.

        Phase ``i+1`` starts ``slack * window_i + gap_slots`` after phase
        ``i``: hosts pace 1 packet/slot, so a phase's serialization window
        is ``flows_per_host * msg_packets`` slots.  All phase workloads
        are built on the uniform (vectorized, flow-contiguous) path of
        ``_packets_from_flows``, so the concatenation stays
        flow-contiguous -- the slotted engine's layout invariant.
        """
        n_hosts = tree.n_hosts
        g = gpus_per_server if gpus_per_server is not None \
            else self.gpus_per_server
        mps = self.msg_packets(load_msg_packets)
        shape = self._shape()

        srcs, dsts, flows, seqs, rels = [], [], [], [], []
        fsrcs, fdsts, fsizes, fstarts = [], [], [], []
        starts, lows, highs, names, impls, iters = [], [], [], [], [], []
        start = 0
        pkt_off = 0
        flow_off = 0
        for it in range(self.iterations):
            for pi, (phase, (coll, impl, _), m) in enumerate(
                    zip(self.phases, shape, mps)):
                inst = it * self.n_phases + pi
                if m <= 0:
                    wl = workloads._packets_from_flows(
                        phase.name, n_hosts,
                        np.empty(0, np.int64), np.empty(0, np.int64),
                        np.empty(0, np.int64))
                elif coll == "all_reduce":
                    ring = (np.arange(n_hosts) + 1) % n_hosts
                    wl = workloads._packets_from_flows(
                        phase.name, n_hosts, np.arange(n_hosts), ring,
                        np.full(n_hosts, m, np.int64))
                elif coll == "fsdp_ring":
                    wl = workloads.fsdp_rings(
                        tree, g, m,
                        np.random.default_rng((rng_seed, inst)))
                elif impl == "xla":
                    wl = workloads.all_to_all(tree, m)
                else:   # rotation round
                    wl = workloads.permutation(
                        tree, m, np.random.default_rng((rng_seed, inst)))
                _, per_host = _pair_counts(coll, impl, n_hosts)
                window = int(math.ceil(self.slack * per_host * m)) \
                    + phase.gap_slots

                srcs.append(wl.src); dsts.append(wl.dst)
                flows.append(wl.flow + flow_off)
                seqs.append(wl.seq)
                rels.append(wl.t_release + start)
                fsrcs.append(wl.flow_src); fdsts.append(wl.flow_dst)
                fsizes.append(wl.flow_size)
                fstarts.append(np.full(wl.n_flows, start, np.int64))
                starts.append(start)
                lows.append(pkt_off); highs.append(pkt_off + wl.n_packets)
                names.append(phase.name)
                impls.append(impl)
                iters.append(it)
                pkt_off += wl.n_packets
                flow_off += wl.n_flows
                start += window

        fused = Workload(
            name=f"phases:{self.label()}", n_hosts=n_hosts,
            src=np.concatenate(srcs), dst=np.concatenate(dsts),
            flow=np.concatenate(flows), seq=np.concatenate(seqs),
            t_release=np.concatenate(rels),
            flow_src=np.concatenate(fsrcs), flow_dst=np.concatenate(fdsts),
            flow_size=np.concatenate(fsizes),
            flow_start=np.concatenate(fstarts) if flow_off else
            np.empty(0, np.int64))
        return CompiledPhases(
            workload=fused,
            phase_start=np.asarray(starts, np.int64),
            pkt_lo=np.asarray(lows, np.int64),
            pkt_hi=np.asarray(highs, np.int64),
            names=tuple(names), impls=tuple(impls),
            iter_of=np.asarray(iters, np.int64))


def phases_from_dict(d: Optional[Dict]) -> Optional[PhaseSchedule]:
    """Inverse of ``PhaseSchedule.to_dict`` accepting ``None``
    (the static-workload row of a campaign's phase axis)."""
    if d is None:
        return None
    if d.get("kind") != "phases":
        raise ValueError(f"not a phase schedule dict: {d.get('kind')!r}")
    return PhaseSchedule.from_dict(d)
