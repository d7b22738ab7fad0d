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
functions and tiled inference) on ``csrc/trunk.cu``; and the learned burst
engine (``ops.resize``, ``sr.fusion``, ``train.burst``, BurstFusion, served
through ``sr.run --fusion-run``), whose refine and banded registration run
``csrc/banded_rows.cu``; the SR training loop; and spatial sharding
(``parallel``: meshes of tiles with halo exchange, ``sr.run --sp``).

Subpackages
-----------
ops    host banded-operator construction, ``BandedOp``, the banded row,
       fused IBP and residual-trunk kernels, Keys-cubic resize and shifts
sr     classical solve, burst fusion, workload configs, session pipeline,
       CLI
models neural model zoo, fused-trunk serving, tiled inference
train  SR and burst-engine training: losses, train state, samplers and
       scene pools, trainers, evaluation
parallel  device meshes, spatially-sharded (halo-exchange) compute
eval   image quality metrics
data   PNG IO (PIL or a stdlib zlib codec), session layouts
psf    Gaussian and measured PSF kernels
utils  stage timing
"""

__version__ = "0.1.0"
