"""Training stack: updaters, gradient normalization, listeners,
checkpointing, evaluation and early stopping (the port of the JAX
package's train/)."""
