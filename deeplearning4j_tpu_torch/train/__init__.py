"""Training stack: updaters, gradient normalization and listeners (the
port of the JAX package's train/)."""
