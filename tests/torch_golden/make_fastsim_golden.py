"""Write the JAX reference's digests of the k=8 fast-engine points that
``chip_smoke.py`` runs on the card (which has no JAX).

Run from the repository root on a machine with JAX (CPU is enough):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden/make_fastsim_golden.py

It writes ``tests/torch_golden/fastsim_k8.json``: for each workload of
:data:`WORKLOADS` and each scheme of :data:`SCHEMES`, seed 0, the
``repro_torch.obs.digest.result_digest`` of the reference's
``repro.net.fastsim.simulate`` result.  ``tests/test_torch_golden.py``
re-derives one entry from both packages so a stale file fails.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro.core import lb_schemes, theory
from repro.net import fastsim, workloads
from repro.net.topology import FatTree

from repro_torch.obs.digest import result_digest

OUT = Path(__file__).resolve().parent / "fastsim_k8.json"
K = 8
SEED = 0
PROP_SLOTS = theory.DEFAULT_NET.prop_slots
SCHEMES = ("flow_ecmp", "host_pkt", "host_dr", "switch_pkt", "switch_pkt_ar",
           "ofan")
WORKLOADS = ("permutation", "all_to_all")


def workload(tree, name):
    """The paper's k=8 points: 1 MB (256-packet) inter-pod permutation, and
    the all-to-all at 32 packets per destination."""
    if name == "permutation":
        return workloads.permutation(tree, 256, np.random.default_rng(1),
                                     inter_pod_only=True)
    return workloads.all_to_all(tree, 32)


def reference_digest(wl_name, scheme):
    tree = FatTree(K)
    res = fastsim.simulate(tree, workload(tree, wl_name),
                           lb_schemes.by_name(scheme), seed=SEED,
                           prop_slots=PROP_SLOTS)
    return result_digest(res)


def main():
    points = {}
    for wl_name in WORKLOADS:
        for scheme in SCHEMES:
            t0 = time.time()
            points[f"{wl_name}/{scheme}"] = reference_digest(wl_name, scheme)
            print(f"{wl_name}/{scheme}: {time.time() - t0:.1f} s",
                  file=sys.stderr)
    doc = {"k": K, "seed": SEED, "prop_slots": PROP_SLOTS,
           "workloads": {"permutation": "permutation(tree, 256, "
                         "default_rng(1), inter_pod_only=True)",
                         "all_to_all": "all_to_all(tree, 32)"},
           "points": points}
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
