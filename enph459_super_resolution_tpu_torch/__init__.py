"""enph459_super_resolution_tpu_torch — the PyTorch + CUDA port of
``enph459_super_resolution_tpu`` for an NVIDIA Hopper card (H100).

The JAX package stays the reference; this package mirrors its layout and
names so that each module has an obvious counterpart, and it imports
nothing of it (nor of JAX).  Every Pallas TPU kernel on a ported path is a
hand-written Hopper kernel under ``csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes``; beside each kernel sits its plain PyTorch
version, which is what runs for tensors on the CPU.

Ported so far: the classical SR main path (``sr.run`` -> pipeline ->
``sr.classical.solve``/``solve_batch``, banded ``mm`` engine, ``ibp``
solver) in the f32, bf16 and hybrid band stores, on the CUDA kernels
``csrc/banded_rows.cu`` and ``csrc/fused_ibp.cu``; and the neural serving
path (SRCNN, ESPCN, FSRCNN, EDSR, BurstFusionLR, the fused-trunk serving
functions and tiled inference) on ``csrc/trunk.cu``.

Subpackages
-----------
ops    host banded-operator construction, ``BandedOp``, the banded row,
       fused IBP and residual-trunk kernels
sr     classical solve, workload configs, session pipeline, CLI
models neural model zoo, fused-trunk serving, tiled inference
data   PNG IO (PIL or a stdlib zlib codec), session layouts
psf    Gaussian and measured PSF kernels
utils  stage timing
"""

__version__ = "0.1.0"
