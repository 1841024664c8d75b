"""NetSpec constructors (framework-free copies of the JAX package's)."""
