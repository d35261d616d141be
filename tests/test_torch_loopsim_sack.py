"""The PyTorch slotted engine's SACK loss recovery against the JAX
reference, bitwise: the ``sack``, ``short_buffer`` and ``mswift`` configs of
``tests/test_loopsim.py`` (ideal and MSwift, infinite and 20-packet
buffers) over six schemes, each port run held against both reference bodies
(``impl="lax"``, and ``impl="pallas"`` whose kernels run in interpret
mode).  Retransmit-heavy points, static failures and the batched entry
points are in ``tests/test_torch_loopsim_sack_batched.py``."""
import dataclasses

import numpy as np
import pytest

from repro.net.topology import FatTree
from repro.net import workloads, loopsim as ref_loopsim
from repro.core import lb_schemes as lbs

from repro_torch.interop import from_reference
from repro_torch.net import loopsim

from _torch_compare import assert_same_loop_result

CFGS = {
    "sack": ref_loopsim.LoopConfig(loss="sack", sack_thresh=8,
                                   max_slots=4000),
    "short_buffer": ref_loopsim.LoopConfig(loss="sack", sack_thresh=8,
                                           buffer_pkts=20, max_slots=4000),
    "mswift": ref_loopsim.LoopConfig(cca="mswift", loss="sack",
                                     max_slots=8000, sw_target_slots=80.0),
}
SCHEMES = ("host_pkt", "host_dr", "switch_pkt_ar", "host_pkt_ar",
           "host_flowlet_ar", "ofan")


def _perm_k4():
    tree = FatTree(4)
    return tree, workloads.permutation(tree, 32, np.random.default_rng(1),
                                       inter_pod_only=True)


def _port(tree, wl, scheme, cfg, **kw):
    conv = {k: from_reference(v) for k, v in kw.items()}
    return loopsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(scheme), from_reference(cfg),
                            device="cpu", **conv)


def assert_both_bodies(tree, wl, scheme, cfg, port, tag, **kw):
    """``port`` equals the reference under ``impl="lax"`` and under
    ``impl="pallas"`` (interpret mode on the CPU)."""
    for impl in ("lax", "pallas"):
        ref = ref_loopsim.simulate(tree, wl, lbs.by_name(scheme),
                                   dataclasses.replace(cfg, impl=impl), **kw)
        assert_same_loop_result(ref, port, f"{tag}/{impl}")


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sack_configs_match_reference(scheme, cfg_name):
    tree, wl = _perm_k4()
    cfg = CFGS[cfg_name]
    port = _port(tree, wl, lbs.by_name(scheme), cfg, seed=0)
    assert_both_bodies(tree, wl, scheme, cfg, port, f"{scheme}/{cfg_name}",
                       seed=0)
    assert port.finished


