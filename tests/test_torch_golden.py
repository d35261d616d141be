"""The committed JAX digests that ``chip_smoke.py`` holds the card to are
current: one entry is re-derived from the reference and from the port."""
import json
import sys
from pathlib import Path

import numpy as np

from repro.core import lb_schemes, theory
from repro.net import fastsim as ref_fastsim, workloads
from repro.net.topology import FatTree

from repro_torch.interop import from_reference
from repro_torch.net import fastsim
from repro_torch.obs.digest import result_digest

GOLDEN_DIR = Path(__file__).resolve().parent / "torch_golden"
sys.path.insert(0, str(GOLDEN_DIR))
import make_fastsim_golden as maker  # noqa: E402


def test_golden_file_is_current():
    doc = json.loads((GOLDEN_DIR / "fastsim_k8.json").read_text())
    assert doc["k"] == maker.K == 8 and doc["seed"] == maker.SEED == 0
    assert doc["prop_slots"] == theory.DEFAULT_NET.prop_slots
    assert sorted(doc["points"]) == sorted(
        f"{w}/{s}" for w in maker.WORKLOADS for s in maker.SCHEMES)
    want = doc["points"]["permutation/host_pkt"]

    tree = FatTree(8)
    wl = maker.workload(tree, "permutation")
    assert wl.n_packets == 32768
    scheme = lb_schemes.host_pkt()
    ref = ref_fastsim.simulate(tree, wl, scheme, seed=0,
                               prop_slots=doc["prop_slots"])
    port = fastsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(scheme), seed=0,
                            prop_slots=doc["prop_slots"], device="cpu")
    assert result_digest(ref) == want
    assert result_digest(port) == want
    assert np.isfinite(port.delivery).all()
