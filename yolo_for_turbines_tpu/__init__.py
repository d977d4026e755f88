"""YOLOv3 framework in JAX (XLA / Pallas / pjit).

A brand-new implementation of the capabilities of the PyTorch reference
GabeTsai/YOLO-For-Turbines, designed for accelerators first:

- functional model over parameter pytrees, NHWC layout, bf16 compute
- on-device decode + fixed-shape class-aware NMS (Triton sweep on GPUs)
- host-side numpy/PIL data pipeline with bucketed multi-scale shapes
- data-parallel training via jax.sharding.Mesh + jit sharding annotations
"""

__version__ = "0.1.0"
