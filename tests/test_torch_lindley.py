"""The port's segmented max-plus (Lindley) scan against the JAX reference's
oracle and its Pallas kernel (interpret mode), bitwise."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.lindley import kernel as ref_kernel, ref as ref_lindley

from repro_torch.kernels.lindley import ops, ref

SIZES = [0, 1, 1023, 1025, 5000]
DENSITIES = ["first", 1e-3, 0.5, "all"]


def _inputs(n, density, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    if density == "first":
        f = np.zeros(n, bool)
        f[:1] = True
    elif density == "all":
        f = np.ones(n, bool)
    else:
        f = rng.random(n) < density
    return v, f


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("n", SIZES)
def test_segmented_cummax_matches_reference(n, density):
    v, f = _inputs(n, density, seed=n)
    port = ref.segmented_cummax(torch.from_numpy(v), torch.from_numpy(f))
    assert port.dtype == torch.float32 and port.shape == (n,)
    oracle = np.asarray(ref_lindley.segmented_cummax(jnp.asarray(v),
                                                     jnp.asarray(f)))
    np.testing.assert_array_equal(port.numpy(), oracle)
    serial = ref.segmented_cummax_serial(torch.from_numpy(v),
                                         torch.from_numpy(f))
    np.testing.assert_array_equal(serial.numpy(), oracle)
    np.testing.assert_array_equal(
        ref_lindley.segmented_cummax_serial(v, f), oracle)
    if n:     # the Pallas kernel pads to whole blocks and needs n > 0
        pallas = np.asarray(ref_kernel.segmented_cummax(
            jnp.asarray(v), jnp.asarray(f.astype(np.int32)), interpret=True))
        np.testing.assert_array_equal(port.numpy(), pallas)


def test_rows_are_scanned_independently():
    v, f = _inputs(3 * 700, 1e-3, seed=3)
    f[::700] = False            # rows do not start with a flag
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    batched = ref.segmented_cummax(vt.view(3, 700), ft.view(3, 700))
    for r in range(3):
        np.testing.assert_array_equal(
            batched[r].numpy(),
            ref.segmented_cummax(vt[r * 700:(r + 1) * 700],
                                 ft[r * 700:(r + 1) * 700]).numpy())


def test_ops_on_cpu_take_the_plain_version_and_count_nothing():
    v, f = _inputs(1025, 0.5)
    before = ops.LAUNCHES
    got = ops.segmented_cummax(torch.from_numpy(v), torch.from_numpy(f))
    np.testing.assert_array_equal(
        got.numpy(),
        ref.segmented_cummax(torch.from_numpy(v), torch.from_numpy(f)).numpy())
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.segmented_cummax(torch.from_numpy(v), torch.from_numpy(f),
                             backend="pallas")
    with pytest.raises(ValueError):
        ops.segmented_cummax(torch.empty(4, device="meta"),
                             torch.empty(4, dtype=torch.bool, device="meta"))


def test_lindley_departures_match_reference():
    rng = np.random.default_rng(4)
    n = 2000
    q = np.sort(rng.integers(0, 40, n))
    a = np.zeros(n, np.float32)
    for qi in np.unique(q):
        m = q == qi
        a[m] = np.sort(rng.random(m.sum()) * 300).astype(np.float32)
    seg = np.concatenate([[True], q[1:] != q[:-1]])
    want = np.asarray(ref_lindley.lindley_departures(jnp.asarray(a),
                                                     jnp.asarray(seg)))
    got = ops.lindley_departures(torch.from_numpy(a), torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), want)


def _nan_inputs(seed, n=4000):
    """Random values with about 1 % NaN and int64 flags (0, 1 and 7)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    v[rng.random(n) < 0.01] = np.nan
    f = np.where(rng.random(n) < 0.02, rng.choice([1, 7], n), 0)
    f[0] = 1
    return v, f.astype(np.int64)


@pytest.mark.parametrize("case", ["documented", "seed0", "seed1"])
def test_nan_propagates_and_flags_of_any_dtype(case):
    """NaN holds from its position to its segment's end, as jnp.maximum
    gives it, and int64 flags count where nonzero (the reference casts
    them to bool): the port's wrapper against the oracle and the Pallas
    kernel in interpret mode, bitwise (NaN positions included)."""
    if case == "documented":
        v = np.array([1, 5, np.nan, 2, 7, 3, 0, 9], np.float32)
        f = np.zeros(8, np.int64)
        f[[0, 5]] = 1
    else:
        v, f = _nan_inputs(int(case[-1]))
    got = ops.segmented_cummax(torch.from_numpy(v), torch.from_numpy(f))
    oracle = np.asarray(ref_lindley.segmented_cummax(jnp.asarray(v),
                                                     jnp.asarray(f, bool)))
    pallas = np.asarray(ref_kernel.segmented_cummax(
        jnp.asarray(v), jnp.asarray(f.astype(np.int32)), interpret=True))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if case == "documented":
        np.testing.assert_array_equal(
            got.numpy(), np.array([1, 5, np.nan, np.nan, np.nan, 3, 3, 9],
                                  np.float32))
    else:
        assert np.isnan(oracle).any() and not np.isnan(oracle).all()
