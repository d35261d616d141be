"""The PyTorch slotted engine's SACK loss recovery against the JAX
reference, bitwise, where its retransmit paths run: short buffers under a
heavier permutation (drops, reordering past the threshold, the ``exhausted``
resend), static failures (timeouts rewind ``f_next`` to ``f_cum``), each
against both reference bodies; and the batched entry points against serial
``simulate`` and the reference."""
import numpy as np
import pytest

from repro.net.topology import FatTree, LinkState, rho_max
from repro.net import workloads, loopsim as ref_loopsim
from repro.core import lb_schemes as lbs

from repro_torch.interop import from_reference
from repro_torch.net import loopsim

from _torch_compare import assert_same_loop_result
from test_torch_loopsim_sack import (CFGS, _perm_k4, _port,
                                     assert_both_bodies)


def test_retransmits_match_both_reference_bodies():
    """20-packet buffers under a heavier permutation: drops, reordering past
    the threshold and the ``exhausted`` resend all happen, so every SACK
    branch runs.  One port run equals both reference bodies."""
    scheme = "host_pkt_ar"
    tree = FatTree(4)
    wl = workloads.permutation(tree, 96, np.random.default_rng(3))
    cfg = ref_loopsim.LoopConfig(loss="sack", sack_thresh=8, buffer_pkts=20,
                                 max_slots=8000)
    port = _port(tree, wl, lbs.by_name(scheme), cfg, seed=0)
    assert port.retransmissions > 0 and port.drops > 0
    assert_both_bodies(tree, wl, scheme, cfg, port, scheme, seed=0)


@pytest.mark.parametrize("scheme", ["host_pkt_ar", "ofan"])
def test_sack_static_failures_match_reference(scheme):
    """Packets black-holed before routing converges (slot 86) never ACK:
    retransmission timeouts fire and rewind ``f_next`` to ``f_cum``."""
    tree, wl = _perm_k4()
    links = LinkState.random_failures(tree, 0.15, seed=11)
    rho = float(rho_max(tree, links, wl.flow_src, wl.flow_dst))
    cfg = ref_loopsim.LoopConfig(loss="sack", sack_thresh=8, rho=rho,
                                 rto_slots=120, max_slots=12000)
    port = _port(tree, wl, lbs.by_name(scheme), cfg, seed=2, links=links,
                 g_converge=86)
    assert_both_bodies(tree, wl, scheme, cfg, port, scheme, seed=2,
                       links=links, g_converge=86)
    assert port.finished and port.drops > 0
    assert port.cct_acked_slots > 86 + cfg.rto_slots


def test_sack_batch_and_megabatch_equal_serial():
    """Rows that finish at different slots freeze; a megabatch over two
    workloads pads the flow, packet and host_flows axes."""
    tree, wl = _perm_k4()
    cfg = from_reference(CFGS["short_buffer"])
    t, w = from_reference(tree), from_reference(wl)
    w_b = from_reference(workloads.all_to_all(tree, 2))
    s = from_reference(lbs.host_pkt())
    serial = {(id(x), sd): loopsim.simulate(t, x, s, cfg, seed=sd,
                                             device="cpu")
              for x, sd in ((w, 0), (w, 1), (w, 2), (w_b, 0))}
    batch = loopsim.simulate_batch(t, w, s, [0, 1, 2], cfg, device="cpu")
    for sd, res in zip((0, 1, 2), batch):
        assert_same_loop_result(serial[(id(w), sd)], res, f"batch {sd}")
    items = [(t, w, s, cfg, [0, 1], None, None),
             (t, w_b, from_reference(lbs.host_dr()), cfg, [0], None, None)]
    mega = loopsim.simulate_megabatch(items, npk_pad=1024, device="cpu")
    for sd, res in zip((0, 1), mega[0]):
        assert_same_loop_result(serial[(id(w), sd)], res, f"mega {sd}")
    assert_both_bodies(tree, workloads.all_to_all(tree, 2), "host_dr",
                       CFGS["short_buffer"], mega[1][0], "mega a2a host_dr",
                       seed=0)
