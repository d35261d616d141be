"""repro_torch -- the PyTorch / CUDA port of ``repro`` for NVIDIA H100.

The port keeps ``repro``'s module layout and is held against it: bitwise for
the fabric engines, within stated tolerances for the model zoo.  Ported so
far: the fast max-plus engine (``net.fastsim``) and the slotted feedback
engine (``net.loopsim``) with their host-side inputs, fault schedules and
collective phases, on CUDA kernels ``kernels.lindley``, ``kernels.jsq_scan``
and ``kernels.slot_step``; and the dense-transformer serving path
(``models``, ``serve``, ``launch.serve``) on the flash-attention kernel
``kernels.flash_attn``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
