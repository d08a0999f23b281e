"""PyTorch/CUDA port of riskaversetrajopt_tpu: SAA risk-averse trajectory
optimization with hand-written Hopper kernels for the fused ADMM chunk, in
the natural (M, K, n) layout (B1) and the lane-flat layout (B2).

The JAX package ``riskaversetrajopt_tpu`` is the reference this package is
tested against; this package imports torch and never jax."""
