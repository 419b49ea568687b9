"""Plain PyTorch primitives of the force path (counterparts of the JAX ``ops``).

Nothing is imported here: each module is imported by name, so a caller pays
only for what it uses.
"""
