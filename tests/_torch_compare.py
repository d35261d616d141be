"""Shared checks for the differential tests of the PyTorch port."""
import numpy as np
import pytest
import torch


def cuda_or_skip() -> torch.device:
    """The first CUDA device, or skip the calling test when there is none
    (decided at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_*.py`")
    return torch.device("cuda", 0)


def assert_same_result(ref, port, tag=""):
    """Bitwise equality of a reference FastSimResult and the port's."""
    for k in ("delivery", "flow_completion", "a_used", "c_used"):
        a, b = np.asarray(getattr(ref, k)), np.asarray(getattr(port, k))
        assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")
    assert ref.cct == port.cct, (tag, ref.cct, port.cct)
    assert ref.max_queue == port.max_queue, (tag, ref.max_queue,
                                             port.max_queue)
    assert list(ref.layers) == list(port.layers)
    for name, la in ref.layers.items():
        lb = port.layers[name]
        ca, cb = np.asarray(la.counts), np.asarray(lb.counts)
        assert ca.dtype == cb.dtype, (tag, name, ca.dtype, cb.dtype)
        np.testing.assert_array_equal(ca, cb, err_msg=f"{tag} {name}")
        assert la.max_queue == lb.max_queue, (tag, name, la.max_queue,
                                              lb.max_queue)
        assert la.avg_wait == lb.avg_wait, (tag, name, la.avg_wait,
                                            lb.avg_wait)
    assert (ref.probe is None) == (port.probe is None), tag
    if ref.probe is not None:
        assert ref.probe.stride == port.probe.stride
        np.testing.assert_array_equal(np.asarray(ref.probe.series),
                                      port.probe.series, err_msg=tag)


LOOP_SCALARS = ("cct_slots", "cct_acked_slots", "drops", "retransmissions",
                "max_queue", "avg_queue", "finished", "mean_cwnd")


def assert_same_loop_result(ref, port, tag=""):
    """Bitwise equality of two LoopSimResults (reference or port)."""
    for k in ("delivered_slot", "flow_complete_slot", "flow_data_done_slot"):
        a, b = np.asarray(getattr(ref, k)), np.asarray(getattr(port, k))
        assert a.dtype == b.dtype, (tag, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")
    for k in LOOP_SCALARS:
        a, b = getattr(ref, k), getattr(port, k)
        assert type(a) is type(b) and a == b, (tag, k, a, b)
    assert (ref.probe is None) == (port.probe is None), tag
    if ref.probe is not None:
        assert ref.probe.stride == port.probe.stride
        np.testing.assert_array_equal(np.asarray(ref.probe.series),
                                      port.probe.series, err_msg=tag)
