"""sr_livo_tpu_torch: the PyTorch/CUDA port of the SR-LIVO engine.

A package beside the JAX reference (`sr_livo_tpu`) that runs the LIVO
pipeline (sweep cutting, 17-dim ESKF propagation, IEKF point-to-plane
registration against a device-resident voxel-hash map, map insertion, and
the vision frame: image preprocess, pyramidal LK, RANSAC gates, camera
ESIKFs, the colored map) on one NVIDIA GPU, and the map-sharded LIO
engine over several ranks (parallel.sharded_lio).  Plain tensor code is
PyTorch; the JAX package's one Pallas kernel (the plane-residual row) is a
hand-written CUDA kernel (`csrc/plane_fit.cu`).  Module names mirror the
JAX package.

The package imports torch and numpy, never jax and nothing of
`sr_livo_tpu`.  Entry points take a `device` argument that defaults to
"cuda"; asking for CUDA where there is none raises.
"""

__version__ = "0.1.0"

from sr_livo_tpu_torch.config import LivoConfig, load_config  # noqa: F401
