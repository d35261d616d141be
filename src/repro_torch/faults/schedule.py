"""Declarative mid-run link fault schedules.

A :class:`FaultSchedule` describes the fabric's link state as a *function of
time*: an optional random base failure pattern active from slot 0 (the static
``FailureSpec`` model) plus a train of timed :class:`LinkEvent` down/up
edits.  :meth:`FaultSchedule.compile` lowers it, for one concrete
:class:`~repro_torch.net.topology.FatTree`, into an epoch timeline::

    ep_start = [0, t_1, t_2, ...]        # slot each epoch takes effect
    links    = [LinkState_0, LinkState_1, ...]

where every distinct event time opens a new epoch whose ``LinkState`` is the
previous epoch's masks with that slot's events applied.  The engines derive
all per-epoch routing state (alive masks, W-ECMP port lists, OFAN IWRR
tables, REPS/PLB valid-label pools, host label redraws) from these stacks and
gather the current epoch by slot inside the simulation, so schedules ride the
fused campaign axis like any other grid dimension (epoch counts pad to the
dispatch maximum; pad epochs start at an unreachable sentinel slot and are
bitwise-inert).

Reaction-delay semantics: the *physical* link state (packets black-holing on
dead queues) switches exactly at ``ep_start[e]``; the *routing* state reacts
``host_react`` slots later for host-visible schemes (host-labelled ``pre``
schemes and ACK-adaptive REPS/PLB, which observe path changes end-to-end)
and ``switch_react`` slots later for switch-local schemes (RR/JSQ/OFAN,
which wait on local port-status/W-ECMP convergence) -- the per-scheme split
is :meth:`LBScheme.reaction_class`.  Before the first reaction slot, routing
is failure-unaware ("stale"), generalizing the static model's single
``g_converge`` convergence slot: a one-epoch schedule with
``host_react == switch_react == G`` is bitwise-identical to the static
``links`` + ``g_converge=G`` path (tested in ``tests/test_torch_faults.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ..net.topology import FatTree, LinkState

# Routing never reacts past this slot (also the pad-epoch start sentinel):
# far beyond any max_slots budget, well inside int32.
NEVER = 2 ** 30


@dataclasses.dataclass(frozen=True)
class LinkEvent:
    """One timed link edit: at slot ``t`` the link goes up (``up=True``) or
    down.  ``layer`` selects the mask: ``"ea"`` (edge<->agg, coordinates
    (pod, edge, agg)) or ``"ac"`` (agg<->core, coordinates (pod, agg, sub));
    ``i``/``j`` are the two intra-pod indices in [0, k/2)."""
    t: int
    layer: str          # 'ea' | 'ac'
    pod: int
    i: int
    j: int
    up: bool

    def __post_init__(self):
        if self.layer not in ("ea", "ac"):
            raise ValueError(f"LinkEvent layer must be 'ea' or 'ac', "
                             f"got {self.layer!r}")
        if self.t < 0:
            raise ValueError(f"LinkEvent t must be >= 0, got {self.t}")


@dataclasses.dataclass(frozen=True)
class CompiledFaults:
    """One schedule lowered for one concrete tree: ``links[e]`` is active
    from slot ``ep_start[e]`` (``ep_start[0] == 0``) to ``ep_start[e+1]``."""
    ep_start: Tuple[int, ...]
    links: Tuple[LinkState, ...]
    host_react: int
    switch_react: int

    @property
    def n_epochs(self) -> int:
        return len(self.links)

    def react_starts(self, reaction_class: str) -> np.ndarray:
        """Per-epoch slot at which *routing* reflects the epoch, saturated
        at :data:`NEVER` (int32-safe: the engines never add the reaction
        delay to a start themselves -- a pad epoch's sentinel start plus a
        large delay would overflow)."""
        react = (self.host_react if reaction_class == "host"
                 else self.switch_react)
        starts = np.asarray(self.ep_start, np.int64) + int(react)
        return np.minimum(starts, NEVER).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Timed link down/up events over an optional random base failure.

    ``p_fail``/``rng_seed``/``legacy_rng`` define the epoch-0 base pattern
    exactly like ``FailureSpec`` (``legacy_rng`` selects the old sequential
    ``np.random`` draws instead of the counter-keyed default; see
    ``LinkState.random_failures``).  ``host_react``/``switch_react`` are the
    reaction delays (slots) described in the module docstring.
    """
    events: Tuple[LinkEvent, ...] = ()
    p_fail: float = 0.0
    rng_seed: int = 42
    legacy_rng: bool = False
    host_react: int = 0
    switch_react: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # ---- constructors ------------------------------------------------------
    @classmethod
    def static(cls, p_fail: float, rng_seed: int = 42, **kw) -> "FaultSchedule":
        """Single-epoch schedule: the ``FailureSpec`` model with reaction
        delays playing the role of ``g_converge``."""
        return cls(events=(), p_fail=p_fail, rng_seed=rng_seed, **kw)

    @classmethod
    def flap(cls, layer: str = "ea", pod: int = 0, i: int = 0, j: int = 0,
             t0: int = 0, period: int = 256, cycles: int = 1,
             **kw) -> "FaultSchedule":
        """Flap train: the link goes down at ``t0``, back up ``period``
        slots later, repeated ``cycles`` times (2 epochs per cycle beyond
        the base epoch when ``t0 > 0``)."""
        if period <= 0 or cycles <= 0:
            raise ValueError("flap needs period > 0 and cycles > 0")
        ev = tuple(LinkEvent(t0 + m * period, layer, pod, i, j, up=bool(m % 2))
                   for m in range(2 * cycles))
        return cls(events=ev, **kw)

    @classmethod
    def burst(cls, down: Sequence[Tuple[str, int, int, int]],
              t_down: int, t_up: Optional[int] = None, **kw) -> "FaultSchedule":
        """Correlated burst: every ``(layer, pod, i, j)`` in ``down`` fails
        at ``t_down`` and (when ``t_up`` is given) recovers at ``t_up``."""
        ev = [LinkEvent(t_down, lay, p, i, j, up=False)
              for (lay, p, i, j) in down]
        if t_up is not None:
            if t_up <= t_down:
                raise ValueError("burst recovery must be after the failure")
            ev += [LinkEvent(t_up, lay, p, i, j, up=True)
                   for (lay, p, i, j) in down]
        return cls(events=tuple(ev), **kw)

    # ---- identity ----------------------------------------------------------
    @property
    def n_epochs(self) -> int:
        """Tree-independent epoch count: 1 + #distinct event times > 0."""
        return 1 + len({e.t for e in self.events if e.t > 0})

    def label(self) -> str:
        """Deterministic record label (the result store's ``failure`` field).
        Carries the knobs a reader scans for plus an event digest."""
        sig = hashlib.md5(repr(tuple(
            dataclasses.astuple(e) for e in self.events)).encode()
        ).hexdigest()[:8]
        legacy = "-np" if self.legacy_rng else ""
        return (f"sched{self.n_epochs}e-p{self.p_fail:g}-r{self.rng_seed}"
                f"{legacy}-hr{self.host_react}-sr{self.switch_react}-{sig}")

    # ---- lowering ----------------------------------------------------------
    def base_links(self, tree: FatTree) -> LinkState:
        if self.p_fail <= 0.0:
            return LinkState.all_up(tree)
        if self.legacy_rng:
            return LinkState.random_failures(
                tree, self.p_fail, np.random.default_rng(self.rng_seed))
        return LinkState.random_failures(tree, self.p_fail,
                                         seed=self.rng_seed)

    def compile(self, tree: FatTree) -> CompiledFaults:
        """Lower to the epoch timeline for one concrete tree (see module
        docstring).  Events are applied cumulatively in (t, definition)
        order; coordinates are validated against the tree."""
        h = tree.half
        for e in self.events:
            if not (0 <= e.pod < tree.k and 0 <= e.i < h and 0 <= e.j < h):
                raise ValueError(f"event {e} out of range for k={tree.k}")
        base = self.base_links(tree)
        ea, ac = base.ea.copy(), base.ac.copy()
        by_t: dict = {}
        for e in self.events:
            by_t.setdefault(e.t, []).append(e)
        ep_start = sorted(set(by_t) | {0})
        links = []
        for t in ep_start:
            for e in by_t.get(t, ()):
                (ea if e.layer == "ea" else ac)[e.pod, e.i, e.j] = e.up
            links.append(LinkState(tree, ea.copy(), ac.copy()))
        return CompiledFaults(ep_start=tuple(ep_start), links=tuple(links),
                              host_react=self.host_react,
                              switch_react=self.switch_react)

    # ---- JSON --------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [dataclasses.asdict(e) for e in self.events]
        d["kind"] = "schedule"          # discriminates from FailureSpec
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        d = dict(d)
        d.pop("kind", None)
        d["events"] = tuple(LinkEvent(**e) for e in d.get("events", ()))
        return cls(**d)
