"""Closed-form models from the paper's §6 and appendices.

* queue-scaling laws q(m) (Table 3, Theorems 1–3, App. C–E);
* the ND/D/1 bounded-queue model behind HOST DR / OFAN optimality;
* collective completion time lower bounds (§5 metric; App. B for the
  permutation's three-mode data/ACK dynamics);
* optimal packet size (Theorem 5, App. G);
* synchronization (collision) probabilities of App. C.

All times are in seconds unless suffixed ``_slots``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


# ---------------------------------------------------------------------------
# Network constants (paper §5 defaults).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetParams:
    link_rate_bps: float = 800e9
    link_latency_s: float = 0.5e-6
    payload_B: int = 4096
    header_B: int = 62
    gap_B: int = 20          # 12 B IFG + 8 B preamble/SFD
    ack_B: int = 64
    buffer_B: int = 800_000
    hops_inter_pod: int = 6  # host->edge->agg->core->agg->edge->host links

    @property
    def frame_B(self) -> int:
        return self.payload_B + self.header_B

    @property
    def slot_B(self) -> int:
        """Bytes per data-packet slot including inter-frame gap."""
        return self.frame_B + self.gap_B

    @property
    def slot_s(self) -> float:
        return self.slot_B * 8 / self.link_rate_bps

    @property
    def ack_slot_s(self) -> float:
        return (self.ack_B + self.gap_B) * 8 / self.link_rate_bps

    @property
    def prop_slots(self) -> float:
        return self.link_latency_s / self.slot_s

    @property
    def buffer_pkts(self) -> int:
        return self.buffer_B // self.slot_B

    @property
    def min_rtt_s(self) -> float:
        """Zero-load RTT: data out (6 hops store-and-forward + prop) and ACK
        back (6 hops, ACK-sized serialization + prop)."""
        data = 6 * (self.slot_s + self.link_latency_s)
        ack = 6 * (self.ack_slot_s + self.link_latency_s)
        return data + ack


DEFAULT_NET = NetParams()


# ---------------------------------------------------------------------------
# Queue scaling laws (Table 3).
# ---------------------------------------------------------------------------

def q_linear(m: np.ndarray, slope: float = 1.0) -> np.ndarray:
    """SIMPLE RR / JSQ under collective synchronization: Theta(m).

    The synchronization argument (App. C): sticky flows from different source
    pods that picked the same aggregation index and the same destination edge
    switch collide on one agg->edge downlink; two colliding line-rate flows
    build queue at 1 packet per 2 sent, i.e. q ~ m/2 per collision pair."""
    return slope * np.asarray(m, dtype=float)


def q_sqrt(m: np.ndarray, k: int) -> np.ndarray:
    """Random spraying (HOST PKT / RSQ), Theorem 2 / App. D:
    q(m) ~ sqrt(1 - 1/(k/2)) * sqrt(2 m / pi) (reflected random walk at
    critical load)."""
    m = np.asarray(m, dtype=float)
    return np.sqrt(1.0 - 1.0 / (k / 2)) * np.sqrt(2.0 * m / math.pi)


def q_nd_d_1(n_flows: float, rho: float) -> float:
    """Mean queue of the ND/D/1 model (superposition of N periodic unit-rate
    flows with random phases, load rho<=1): Gaussian/Brownian-bridge
    approximation of the stationary mean (App. E, [55, 74]).

    Bounded for any rho<1 and even at rho==1 stays O(sqrt(N)) *independent of
    message size m* — the paper's Theta(1)-in-m optimality.  We use the
    standard heavy-traffic approximation E[Q] ≈ rho^2 * sqrt(N*pi/8)/ ...;
    for our purposes (a horizontal reference line in Fig. 6-style plots) we
    expose the simple bound below.
    """
    n_flows = float(n_flows)
    if rho >= 1.0:
        # Critically loaded ND/D/1: mean queue ~ sqrt(N pi / 8) (Brownian
        # bridge peak of the arrival-curve deviation).
        return math.sqrt(n_flows * math.pi / 8.0)
    # Sub-critical: geometric-tail approximation.
    sigma2 = n_flows * rho * (1 - rho)
    return rho * sigma2 / (2 * n_flows * (1 - rho)) + rho


def fit_power_law(m: np.ndarray, q: np.ndarray) -> tuple[float, float]:
    """Fit q = c * m^alpha; returns (alpha, c).  Used by tbl3 benchmarks to
    check the Theta(m) / sqrt(m) / Theta(1) clusters."""
    m = np.asarray(m, dtype=float)
    q = np.maximum(np.asarray(q, dtype=float), 1e-9)
    A = np.stack([np.log(m), np.ones_like(m)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.log(q), rcond=None)
    return float(coef[0]), float(math.exp(coef[1]))


# ---------------------------------------------------------------------------
# CCT lower bounds (§5 + App. B).
# ---------------------------------------------------------------------------

def ata_cct_lower_bound_s(n: int, msg_B_per_dst: int, net: NetParams = DEFAULT_NET,
                          hops: int = 6) -> float:
    """All-to-all lower bound: host transmission time of all data plus the
    pipeline latency of the last packet (§5: 'simple sum of propagation and
    host transmission delays')."""
    pkts_per_dst = math.ceil(msg_B_per_dst / net.payload_B)
    total_slots = pkts_per_dst * (n - 1)
    send_s = total_slots * net.slot_s
    pipe_s = hops * net.link_latency_s + (hops - 1) * net.slot_s
    return send_s + pipe_s


def permutation_cct_lower_bound_s(m: int, net: NetParams = DEFAULT_NET,
                                  hops: int = 6) -> float:
    """Permutation lower bound with symmetric data/ACK dynamics (App. B).

    Each host simultaneously sends m data packets and returns ACKs for the m
    packets it receives; the host uplink must carry both.  Three modes:
      (1) data only until the first data packet arrives (i1 packets sent),
      (2) interleaved data/ACK round-robin,
      (3) ACK drain.
    Completion = time the last ACK is *received* by the sender... the paper
    measures CCT at full-message delivery + ACK; we follow App. B and return
    the time the last ACK arrives back.
    """
    H = hops
    T_d = net.frame_B * 8 / net.link_rate_bps          # data serialization
    T_a = net.ack_B * 8 / net.link_rate_bps
    T_g = net.gap_B * 8 / net.link_rate_bps
    T_dp = T_d + T_g
    T_ap = T_a + T_g
    T_p = H * net.link_latency_s                        # one-way propagation

    # Mode 1: first data packet arrives at t1 after T_p + H serializations.
    t1 = T_p + H * T_d
    i1 = math.ceil((T_p + (H - 1) * T_d) / T_dp) + 1
    if m <= i1:
        # Pure pipeline: last data at t1 + (m-1) T_dp; its ACK returns after
        # the reverse path.
        t_last_data = t1 + (m - 1) * T_dp
        return t_last_data + T_ap + T_p + (H - 1) * T_a
    # Packet i1 arrives at:
    t_i1 = t1 + (i1 - 1) * T_dp
    # First ACK right after:
    t_ack1 = t_i1 + T_ap
    # Mode 2: interleaved; ACK for packet i arrives at
    #   t_ack(i) = t_ack1 + (i-1)(T_dp + T_ap)   while data remains.
    i2 = m - i1 + 1
    t_ack_i2 = t_ack1 + (i2 - 1) * (T_dp + T_ap)
    # Mode 3: ACK-only drain, two constraints (App. B).
    best = t_ack_i2
    for i in range(i2 + 1, m + 1):
        c1 = t_ack_i2 + (i - i2) * T_ap
        # ACK i follows data packet i + (i1 - 1):
        j = i - (i1 - 1)
        t_ack_j = t_ack1 + (j - 1) * (T_dp + T_ap) if j >= 1 else t_ack1
        c2 = t_ack_j + (H - 1) * T_ap + T_p
        best = max(best, c1, c2)
    return best


def cct_increase(cct_s: float, bound_s: float) -> float:
    """The paper's metric: percentage increase over the lower bound."""
    return 100.0 * (cct_s / bound_s - 1.0)


# ---------------------------------------------------------------------------
# Theorem 5: optimal packet size.
# ---------------------------------------------------------------------------

def optimal_payload_B(msg_B: float, header_B: float = 82.0,
                      alpha_pkts: float = 10.0) -> float:
    """P - H = sqrt(H * D / alpha): payload minimizing CCT for a DR scheme
    whose queueing is a constant alpha packets (Thm 5 / App. G).  ``header_B``
    includes the inter-frame gap (the paper uses 82 B)."""
    return math.sqrt(header_B * msg_B / alpha_pkts)


def modeled_cct_slots(msg_B: float, payload_B: float, header_B: float = 82.0,
                      alpha_pkts: float = 10.0) -> float:
    """CCT model (App. G, eq. 29) in units of (P/C): transmission + queueing.
    Returns the P-dependent part  P*(D/(P-H) + alpha)  in *byte-time* units
    (divide by line rate for seconds)."""
    P = payload_B + header_B
    return P * (msg_B / payload_B + alpha_pkts)


def optimal_payload_sqrt_queue_B(msg_B: float, header_B: float = 82.0,
                                 beta: float = 1.0) -> float:
    """For sqrt-queue spraying schemes (q = beta*sqrt(n_pkts)), CCT ∝
    P*(D/(P-H)) + beta*sqrt(D/(P-H))*P; the optimum grows as Theta(D^{1/3})
    (paper §8.1).  Solved numerically."""
    from scipy.optimize import minimize_scalar  # pragma: no cover
    raise NotImplementedError("numeric helper lives in benchmarks")


def cube_root_payload_scaling(msg_B: np.ndarray, header_B: float = 82.0,
                              beta: float = 1.0) -> np.ndarray:
    """Numeric optimum payload for sqrt-queue schemes (no scipy): grid search
    over payloads; used to verify the Theta(D^{1/3}) claim."""
    outs = []
    for D in np.atleast_1d(msg_B):
        best, bestv = None, np.inf
        for payload in np.geomspace(64, 65536, 512):
            P = payload + header_B
            n_pkts = D / payload
            v = P * (n_pkts + beta * math.sqrt(max(n_pkts, 1.0)))
            if v < bestv:
                best, bestv = payload, v
        outs.append(best)
    return np.asarray(outs)


# ---------------------------------------------------------------------------
# App. C synchronization probabilities (SIMPLE RR / JSQ collisions).
# ---------------------------------------------------------------------------

def p_northbound(k: int) -> float:
    """All k/2 flows of an edge switch leave the switch (eq. 8)."""
    n = k ** 3 / 4
    h = k // 2
    p = 1.0
    for i in range(h):
        p *= (n - h - i) / (n - 1 - i)
    return p


def p_hotspot(k: int) -> float:
    """All flows of an edge switch target the same outside edge switch (eq. 9)."""
    n = k ** 3 / 4
    h = k // 2
    p = (n - h) / (n - 1)
    for i in range(1, h):
        p *= (h - i) / (n - 1 - i)
    return p


def p_red(k: int) -> float:
    return p_northbound(k) - p_hotspot(k)


def expected_collisions_rr(k: int) -> float:
    """Expected synchronized (linear-queue) flow pairs for SIMPLE RR (eq. 18/19)."""
    n = k ** 3 / 4
    h = k // 2
    p_same_agg = 1.0 / h
    p_same_dst_edge = (h - 1) / (n - 1 - h)
    p_coll = p_red(k) ** 2 * p_same_agg * p_same_dst_edge
    return n * (n - 1) / 2 * p_coll


def expected_collisions_jsq(k: int, t_ipg_frac: float = 0.0) -> float:
    """Same for JSQ with the App. C 'safe flow' factor (eq. 13, 17)."""
    h = k // 2
    p_safe = (1.0 - 2.0 * t_ipg_frac) ** (h - 1)
    return expected_collisions_rr(k) * p_safe ** 2
