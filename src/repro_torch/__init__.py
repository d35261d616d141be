"""repro_torch -- the PyTorch / CUDA port of ``repro`` for NVIDIA H100.

The port keeps ``repro``'s module layout and is held bitwise against it.
Ported so far: the fast max-plus fabric engine (``net.fastsim``) with its
host-side inputs (``net.topology``, ``net.workloads``, ``core.lb_schemes``,
``core.dr``, ``core.ofan``, ``core.entropy``, ``obs.probes``) and its two
CUDA kernels (``kernels.lindley``, ``kernels.jsq_scan``).  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
