"""Stateless counter-based randomness streams for the simulation engines.

Every random draw an engine makes is a pure function

    value = threefry2x32(key(seed, site, lane), counter(logical_id, slot))

of the replicate ``seed``, a :data:`draw-site <SITE_EDGE_RAND>` tag, the
*logical* identity of the drawing entity (host id, packet id, switch id --
dense prefixes of any padded id space), the time slot (or arrival rank on
the fast engine), and an optional ``lane`` sub-index (the port column of a
JSQ noise grid).  Nothing else enters the computation: no carried generator
state, no array shapes, no batch position.  So a point padded onto a larger
tree or a fused megabatch draws bitwise-identical values for every real
entity, batched rows and serial runs agree, and any single draw can be
recomputed in isolation.

The PRF is Threefry-2x32 with 20 rounds (`Salmon et al., SC'11
<https://doi.org/10.1145/2063384.2063405>`_), bit-identical to the JAX
reference's ``repro.core.entropy`` (known-answer tested).  It comes in two
halves with the same streams: the numpy half (the fast engine's JSQ noise
grids, link-failure draws) and the torch half (``*_torch``: the slotted
engine's in-loop draws, on any device).  The torch half works on int64
tensors masked with ``& 0xFFFFFFFF``, because torch on the CPU has no
uint32 ``+``, ``<<``, ``>>`` or ``%``; one code path serves both devices.

Key/counter packing (injective over the tuples the engines use)::

    k0 = seed_lo                      # low 32 bits of the replicate seed
    k1 = seed_hi ^ (site << 16 | lane)  # site < 2**16, lane < 2**16
    c0 = slot                         # time slot / arrival rank
    c1 = logical id                   # host / packet / switch id

Draws at distinct (seed, site, lane, id, slot) tuples are therefore
distinct PRF evaluations; uniformity and cross-site independence are
tested statistically in ``tests/test_entropy.py``.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Draw-site tags.  One per randomness consumer; adding a site never perturbs
# the streams of existing sites (the tag is part of the PRF key).
# ---------------------------------------------------------------------------
SITE_EDGE_RAND = 1      # loopsim: per-host uniform (a, c) spray at the edge
SITE_AGG_RAND = 2       # loopsim: per-packet uniform core sub-link at the agg
SITE_EDGE_JSQ = 3       # loopsim: per-(host, port) JSQ tie-break noise
SITE_AGG_JSQ = 4        # loopsim: per-(packet, port) JSQ tie-break noise
SITE_FAST_EDGE_JSQ = 5  # fastsim: per-(edge switch, rank, port) JSQ noise
SITE_FAST_AGG_JSQ = 6   # fastsim: per-(agg switch, rank, port) JSQ noise
SITE_LINK_FAIL = 7      # topology: per-(tree, layer, link) random failures

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                       # Threefry key-schedule parity
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INV_2_24 = np.float32(1.0 / (1 << 24))


def key_words(seed: int):
    """Host-side split of a (possibly 64-bit) replicate seed into the two
    uint32 PRF key words the engines carry as per-row operands."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(s & _MASK32), np.uint32((s >> 32) & _MASK32)


def _rotl32(x, r: int):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds: PRF from (key, counter) to two uint32 words.

    Inputs are numpy uint32 arrays (broadcast together); all arithmetic is
    mod 2**32.
    """
    with np.errstate(over="ignore"):     # wraparound mod 2**32 is the point
        ks0, ks1 = k0, k1
        ks2 = ks0 ^ ks1 ^ np.uint32(_PARITY)
        x0 = c0 + ks0
        x1 = c1 + ks1
        schedule = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2),
                    (ks2, ks0))
        for block, (inj0, inj1) in enumerate(schedule):
            for r in _ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = _rotl32(x1, r) ^ x0
            x0 = x0 + inj0
            x1 = x1 + inj1 + np.uint32(block + 1)
    return x0, x1


def _as_u32(x):
    # Works for python ints and numpy arrays alike; values are taken
    # mod 2**32 (ids/slots are nonnegative and < 2**31 in practice).  Python
    # ints become 0-d *arrays*, not numpy scalars: scalar integer overflow
    # raises RuntimeWarnings, array overflow wraps silently.
    if isinstance(x, (int, np.integer)):
        return np.asarray(int(x) & _MASK32, np.uint32)
    return x.astype(np.uint32)


def draw_u32(seed_lo, seed_hi, site, ids, slot, lane=0):
    """One uint32 per element of ``broadcast(ids, slot, lane)``: the counter
    stream at (seed, site, lane, id, slot).  ``seed_lo``/``seed_hi`` are the
    :func:`key_words` operands (scalars); ``site`` is a
    python int tag; ``ids``/``slot``/``lane`` broadcast together."""
    k0 = _as_u32(seed_lo)
    k1 = _as_u32(seed_hi) ^ (np.uint32(site << 16) ^ _as_u32(lane))
    x0, _ = threefry2x32(k0, k1, _as_u32(slot), _as_u32(ids))
    return x0


def draw_int(seed_lo, seed_hi, site, ids, slot, bound, lane=0):
    """Integers in ``[0, bound)`` (int32).  ``bound`` may be a per-row
    array (the logical port count); the modulo bias is < 2**-25 for the
    bounds the engines use (<= k**2/4)."""
    u = draw_u32(seed_lo, seed_hi, site, ids, slot, lane=lane)
    return (u % _as_u32(bound)).astype(np.int32)


def draw_uniform(seed_lo, seed_hi, site, ids, slot, lane=0):
    """float32 uniforms in ``[0, 1)`` (24-bit mantissa resolution)."""
    u = draw_u32(seed_lo, seed_hi, site, ids, slot, lane=lane)
    return (u >> np.uint32(8)).astype(np.float32) * _INV_2_24


def uniform_grid(seed: int, site: int, n_ids: int, n_slots: int,
                 n_lanes: int) -> np.ndarray:
    """Host-side (numpy) ``(n_ids, n_slots, n_lanes)`` float32 uniform grid:
    element ``[i, s, l]`` is the stream value at (seed, site, lane=l, id=i,
    slot=s).  The fast engine precomputes its JSQ tie-break noise with this;
    growing any axis (JSQ pad-retry, megabatch group-wide padding) extends
    the grid without perturbing existing entries."""
    lo, hi = key_words(seed)
    return np.asarray(draw_uniform(
        lo, hi, site,
        ids=np.arange(n_ids, dtype=np.uint32)[:, None, None],
        slot=np.arange(n_slots, dtype=np.uint32)[None, :, None],
        lane=np.arange(n_lanes, dtype=np.uint32)[None, None, :]))


# ---------------------------------------------------------------------------
# Torch half: the same streams on int64 tensors holding uint32 values.
# ---------------------------------------------------------------------------

def _u32_torch(x, device=None) -> torch.Tensor:
    """int64 tensor of ``x`` taken mod 2**32 (python ints, numpy values and
    integer tensors of any width; negative values wrap as uint32 would)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    return torch.as_tensor(np.asarray(x).astype(np.int64) & _MASK32,
                           dtype=torch.int64, device=device)


def _rotl32_torch(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32_torch(k0, k1, c0, c1):
    """:func:`threefry2x32` on int64 tensors holding uint32 values
    (broadcast together); every sum is masked back to 32 bits."""
    ks0, ks1 = k0, k1
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (c0 + ks0) & _MASK32
    x1 = (c1 + ks1) & _MASK32
    schedule = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for block, (inj0, inj1) in enumerate(schedule):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32_torch(x1, r) ^ x0
        x0 = (x0 + inj0) & _MASK32
        x1 = (x1 + inj1 + (block + 1)) & _MASK32
    return x0, x1


def draw_u32_torch(seed_lo, seed_hi, site, ids, slot, lane=0) -> torch.Tensor:
    """:func:`draw_u32` as an int64 tensor of uint32 values.  ``seed_lo``
    and ``seed_hi`` are scalars or per-row tensors already shaped to
    broadcast against ``ids``/``slot``/``lane``."""
    dev = next((x.device for x in (ids, slot, lane, seed_lo, seed_hi)
                if isinstance(x, torch.Tensor)), None)
    k0 = _u32_torch(seed_lo, dev)
    k1 = _u32_torch(seed_hi, dev) ^ ((site << 16) ^ _u32_torch(lane, dev))
    x0, _ = threefry2x32_torch(k0, k1, _u32_torch(slot, dev),
                               _u32_torch(ids, dev))
    return x0


def draw_int_torch(seed_lo, seed_hi, site, ids, slot, bound,
                   lane=0) -> torch.Tensor:
    """:func:`draw_int` as an int32 tensor; ``bound`` may be a per-row
    tensor."""
    u = draw_u32_torch(seed_lo, seed_hi, site, ids, slot, lane=lane)
    return torch.remainder(u, _u32_torch(bound, u.device)).to(torch.int32)


def draw_uniform_torch(seed_lo, seed_hi, site, ids, slot,
                       lane=0) -> torch.Tensor:
    """:func:`draw_uniform` as a float32 tensor (the 24-bit integer is exact
    in float32 and the scale is a power of two)."""
    u = draw_u32_torch(seed_lo, seed_hi, site, ids, slot, lane=lane)
    return (u >> 8).to(torch.float32) * float(_INV_2_24)
