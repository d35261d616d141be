"""The committed JAX digests that ``chip_smoke.py`` holds the card to are
current: entries of each file are re-derived from the reference and from
the port."""
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


def test_sack_faults_phases_golden_file_is_current():
    """The SACK, fault-schedule and phase points: the file lists every
    point; a SACK, a flap and a phase entry are re-derived from the port and
    two of them from the reference too (the card run checks the rest)."""
    import make_sack_faults_phases_golden as maker3
    from repro.faults import FaultSchedule
    from repro.net import loopsim as ref_loopsim
    from repro_torch.net import loopsim
    from repro_torch.obs.digest import loop_result_digest

    doc = json.loads((GOLDEN_DIR / "sack_faults_phases_k8.json").read_text())
    assert doc["k"] == maker3.K == 8 and doc["seed"] == maker3.SEED == 0
    assert doc["flap"] == maker3.FLAP
    assert doc["train_schedule"] == maker3.schedule().label()
    assert sorted(doc["points"]) == sorted(
        [f"{p}/{s}" for p, schemes in maker3.POINTS.items()
         if p != "train_iter" for s in schemes]
        + [f"train_iter/{m}/{s}" for m in maker3.TRAIN_LOADS
           for s in maker3.POINTS["train_iter"]])
    pts = doc["points"]
    tree = FatTree(8)
    t = from_reference(tree)
    wl = workloads.permutation(tree, 256, np.random.default_rng(1))
    wl_inter = workloads.permutation(tree, 256, np.random.default_rng(1),
                                     inter_pod_only=True)
    flap = FaultSchedule.flap(**maker3.FLAP)

    ofan = loopsim.simulate(t, from_reference(wl),
                            from_reference(lb_schemes.ofan()),
                            from_reference(maker3.loop_config("fig12")),
                            seed=0, device="cpu")
    assert loop_result_digest(ofan) == pts["fig12/ofan"]
    assert loop_result_digest(ref_loopsim.simulate(
        tree, wl, lb_schemes.ofan(), maker3.loop_config("fig12"),
        seed=0)) == pts["fig12/ofan"]
    assert pts["fig9/host_pkt"]["retransmissions"] > 0
    assert result_digest(fastsim.simulate(
        t, from_reference(wl_inter), from_reference(lb_schemes.ofan()),
        seed=0, prop_slots=maker3.FAST_PROP, fault=from_reference(flap),
        device="cpu")) == pts["flap_fast/ofan"]
    wl_ph = maker3.schedule().compile(tree, 8,
                                      rng_seed=maker3.TRAIN_RNG_SEED).workload
    want = pts["train_iter/8/host_dr"]
    assert result_digest(ref_fastsim.simulate(
        tree, wl_ph, lb_schemes.host_dr(), seed=0,
        prop_slots=maker3.TRAIN_PROP)) == want
    assert result_digest(fastsim.simulate(
        t, from_reference(wl_ph), from_reference(lb_schemes.host_dr()),
        seed=0, prop_slots=maker3.TRAIN_PROP, device="cpu")) == want
