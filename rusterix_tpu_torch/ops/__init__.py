"""Device passes of the port, one module per JAX package module."""
