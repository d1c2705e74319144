"""PyTorch / CUDA port of the Wild-Video 3D Reconstruction VO pipeline.

A second package beside the JAX one (`wild_video_3d_reconstruction_tpu`),
which stays the reference. Same layout and names, so each module's
counterpart is found by path:

  ops/     Lie groups, projective geometry, patch gathers, correlation and
           segment ops, and the loader of the CUDA kernels
  models/  the encoders, the update operator and the weight carry-over
  ba/      Gauss-Newton bundle adjustment
  slam/    the state, the per-frame steps and the DPVO class
  io/      TUM trajectory export
  utils/   the config
  csrc/    hand-written CUDA kernels for Hopper (sm_90a)

It imports torch and numpy and never jax. Entry points run on the card
unless the caller asks for the CPU; on CPU tensors the kernel wrappers use
their plain PyTorch versions.
"""

__version__ = "0.1.0"
