"""Write the JAX reference's digests of the k=8 slotted-engine points that
``chip_smoke.py`` runs on the card (which has no JAX).

Run from the repository root on a machine with JAX (CPU is enough):

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/torch_golden/make_loopsim_golden.py

It writes ``tests/torch_golden/loopsim_k8.json``: for each point of
:data:`POINTS` and each of its schemes, seed 0, the
``repro_torch.obs.digest.loop_result_digest`` of the reference's
``repro.net.loopsim.simulate`` result (about 2.5 s a point on the CPU).
``tests/test_torch_golden.py`` re-derives one entry from both packages so a
stale file fails.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro.core import lb_schemes
from repro.net import loopsim, workloads
from repro.net.topology import FatTree, LinkState, rho_max

from repro_torch.obs.digest import loop_result_digest

OUT = Path(__file__).resolve().parent / "loopsim_k8.json"
K = 8
SEED = 0
MAX_SLOTS = 60_000
# point -> schemes; "free" is failure-free, "fig3" the paper's fig 3 point
# (1 % of links failed, rho = rho_max, routing never converges).
POINTS = {
    "free": ("host_pkt", "flow_ecmp", "host_dr", "host_pkt_ar",
             "host_flowlet_ar", "switch_pkt", "switch_pkt_ar", "jsq",
             "ofan"),
    "fig3": ("host_pkt", "switch_pkt", "host_pkt_ar", "switch_pkt_ar",
             "ofan"),
}
FAIL_P, FAIL_SEED, RTO_SLOTS = 0.01, 42, 300


def point(tree, name):
    """(workload, LoopConfig, links) of a point: the 1 MB (256-packet)
    permutation of ``permutation(tree, 256, default_rng(1))``."""
    wl = workloads.permutation(tree, 256, np.random.default_rng(1))
    if name == "free":
        return wl, loopsim.LoopConfig(max_slots=MAX_SLOTS), None
    links = LinkState.random_failures(tree, FAIL_P, seed=FAIL_SEED)
    rho = float(rho_max(tree, links, wl.flow_src, wl.flow_dst))
    return wl, loopsim.LoopConfig(max_slots=MAX_SLOTS, rho=rho,
                                  rto_slots=RTO_SLOTS), links


def reference_digest(point_name, scheme):
    tree = FatTree(K)
    wl, cfg, links = point(tree, point_name)
    res = loopsim.simulate(tree, wl, lb_schemes.by_name(scheme), cfg,
                           seed=SEED, links=links, g_converge=None)
    return loop_result_digest(res)


def main():
    points = {}
    for name, schemes in POINTS.items():
        for scheme in schemes:
            t0 = time.time()
            points[f"{name}/{scheme}"] = reference_digest(name, scheme)
            print(f"{name}/{scheme}: {time.time() - t0:.1f} s",
                  file=sys.stderr)
    tree = FatTree(K)
    wl, cfg, _ = point(tree, "fig3")
    doc = {"k": K, "seed": SEED, "max_slots": MAX_SLOTS,
           "workload": "permutation(tree, 256, default_rng(1))",
           "fig3": {"p_fail": FAIL_P, "fail_seed": FAIL_SEED,
                    "rho": cfg.rho, "rto_slots": RTO_SLOTS,
                    "g_converge": None},
           "points": points}
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
