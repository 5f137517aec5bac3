"""The plain reference of the private retrieval round, in PyTorch and
NumPy, that decides ``correct``.  It imports neither ``jax``, the JAX
package nor the port: the planner's arithmetic, the DistanceDP mechanism
and the wire formula are frozen copies here (``plan``, ``dp``, ``wire``),
and ``check`` works out again, from the inputs the harness made, what the
program derived from them."""
