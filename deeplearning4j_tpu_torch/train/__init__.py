"""Training stack: updaters, gradient normalization, listeners,
checkpointing, evaluation, early stopping, the divergence sentinel, the
line-search solvers and the gradient check (the port of the JAX
package's train/)."""
