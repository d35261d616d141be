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


def test_loop_golden_file_is_current():
    import make_loopsim_golden as loop_maker
    from repro.net import loopsim as ref_loopsim
    from repro_torch.net import loopsim
    from repro_torch.obs.digest import loop_result_digest

    doc = json.loads((GOLDEN_DIR / "loopsim_k8.json").read_text())
    assert doc["k"] == loop_maker.K == 8 and doc["seed"] == 0
    assert sorted(doc["points"]) == sorted(
        f"{p}/{s}" for p, schemes in loop_maker.POINTS.items()
        for s in schemes)
    want = doc["points"]["free/host_pkt"]

    tree = FatTree(8)
    wl, cfg, links = loop_maker.point(tree, "free")
    assert wl.n_packets == 32768 and links is None
    scheme = lb_schemes.host_pkt()
    ref = ref_loopsim.simulate(tree, wl, scheme, cfg, seed=0)
    port = loopsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(scheme), from_reference(cfg),
                            seed=0, device="cpu")
    assert loop_result_digest(ref) == want
    assert loop_result_digest(port) == want
    assert port.finished and port.drops == 0
    _, cfg3, _ = loop_maker.point(tree, "fig3")
    assert cfg3.rho == doc["fig3"]["rho"]
