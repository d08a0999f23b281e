"""PyTorch/CUDA port of riskaversetrajopt_tpu: SAA risk-averse trajectory
optimization with a hand-written Hopper kernel for the fused ADMM chunk.

The JAX package ``riskaversetrajopt_tpu`` is the reference this package is
tested against; this package imports torch and never jax."""
