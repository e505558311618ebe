"""The benchmark's plain reference: a frozen, independent copy of what
the predictor computes for a healthy cluster.

It rebuilds each workflow from its parameters (`patterns/`), compiles it
into the micro-op DAG with the manager's placement (`compiler`), orders
the ops by their contention-free start and runs the FIFO recurrence op
by op in Python floats (`scan`). It imports NumPy and the standard
library only: nothing of the program under test, and no JAX.
"""
