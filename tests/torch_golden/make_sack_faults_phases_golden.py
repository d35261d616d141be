"""Write the JAX reference's digests of the k=8 points that ``chip_smoke.py``
runs on the card for SACK loss recovery, fault schedules and
collective-phase workloads (the card has no JAX).

Run from the repository root on a machine with JAX (CPU is enough):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/torch_golden/make_sack_faults_phases_golden.py

It writes ``tests/torch_golden/sack_faults_phases_k8.json``: for each point
of :data:`POINTS` and each of its schemes, seed 0, the digest
(``repro_torch.obs.digest``) of the reference's ``simulate`` result:

* ``fig12``: the ``fig12`` preset's SACK grid (``sack_thresh=32``) on the
  1 MB permutation ``permutation(tree, 256, default_rng(1))``;
* ``fig9``: fig 9's 20-packet buffers with SACK (``sack_thresh=8``);
* ``flap_loop`` / ``flap_fast``: :data:`FLAP` on the inter-pod 1 MB
  permutation, on the slotted engine (erasure, ``rto_slots=250``) and on
  the fast engine;
* ``train_iter``: the ``train_iter`` preset's DeepSeek-V3 671B phase
  schedule (ep = dp = 8, two iterations) at 8 and 16 packets per flow, on
  the fast engine.

``tests/test_torch_golden.py`` re-derives entries from both packages so a
stale file fails.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro.core import lb_schemes, theory
from repro.faults import FaultSchedule
from repro.net import fastsim, loopsim, workloads
from repro.net.topology import FatTree
from repro.phases import PhaseSchedule

from repro_torch.obs.digest import loop_result_digest, result_digest

OUT = Path(__file__).resolve().parent / "sack_faults_phases_k8.json"
K = 8
SEED = 0
MAX_SLOTS = 60_000
FAST_PROP = theory.DEFAULT_NET.prop_slots
TRAIN_PROP = 12.0            # the train_iter campaign's prop_slots
TRAIN_LOADS = (8, 16)        # packets per flow of its two loads
TRAIN_RNG_SEED = 1           # the loads' traffic-matrix seed
FLAP = dict(layer="ea", pod=0, i=0, j=1, t0=64, period=128, cycles=1,
            host_react=16, switch_react=48)
POINTS = {
    "fig12": ("host_pkt", "host_dr", "switch_pkt_ar", "host_pkt_ar", "ofan"),
    "fig9": ("host_pkt",),
    "flap_loop": ("host_pkt_ar", "switch_pkt_ar", "ofan"),
    "flap_fast": ("host_pkt", "switch_pkt", "ofan"),
    "train_iter": ("flow_ecmp", "host_pkt", "host_dr", "ofan"),
}


def loop_config(point):
    if point == "fig12":
        return loopsim.LoopConfig(loss="sack", sack_thresh=32,
                                  max_slots=MAX_SLOTS)
    if point == "fig9":
        return loopsim.LoopConfig(loss="sack", sack_thresh=8, buffer_pkts=20,
                                  max_slots=MAX_SLOTS)
    return loopsim.LoopConfig(rto_slots=250, max_slots=MAX_SLOTS)


def schedule():
    return PhaseSchedule.from_model("deepseek-v3-671b", ep=8, dp=8,
                                    iterations=2)


def digests(point):
    """{key: digest} of one point's schemes (and loads)."""
    tree = FatTree(K)
    out = {}
    if point == "train_iter":
        for m in TRAIN_LOADS:
            wl = schedule().compile(tree, m, rng_seed=TRAIN_RNG_SEED).workload
            for s in POINTS[point]:
                out[f"{point}/{m}/{s}"] = result_digest(fastsim.simulate(
                    tree, wl, lb_schemes.by_name(s), seed=SEED,
                    prop_slots=TRAIN_PROP))
        return out
    flap = point.startswith("flap")
    wl = workloads.permutation(tree, 256, np.random.default_rng(1),
                               inter_pod_only=flap)
    fault = FaultSchedule.flap(**FLAP) if flap else None
    for s in POINTS[point]:
        scheme = lb_schemes.by_name(s)
        if point == "flap_fast":
            out[f"{point}/{s}"] = result_digest(fastsim.simulate(
                tree, wl, scheme, seed=SEED, prop_slots=FAST_PROP,
                fault=fault))
        else:
            out[f"{point}/{s}"] = loop_result_digest(loopsim.simulate(
                tree, wl, scheme, loop_config(point), seed=SEED,
                fault=fault))
    return out


def main():
    points = {}
    for point in POINTS:
        t0 = time.time()
        points.update(digests(point))
        print(f"{point}: {time.time() - t0:.1f} s", file=sys.stderr)
    doc = {"k": K, "seed": SEED, "max_slots": MAX_SLOTS,
           "fast_prop_slots": FAST_PROP, "train_prop_slots": TRAIN_PROP,
           "train_loads": list(TRAIN_LOADS),
           "train_rng_seed": TRAIN_RNG_SEED, "flap": FLAP,
           "train_schedule": schedule().label(),
           "points": points}
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
