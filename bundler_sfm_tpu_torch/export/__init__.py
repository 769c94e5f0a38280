"""Bundle-file tools on the host (copies of the JAX package's)."""
