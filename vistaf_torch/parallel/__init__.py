"""Batched execution over camera streams (JAX ``parallel/``): ``BatchedForce``
only so far; the sharded and whole-limb heads are ROADMAP Queue 1 item 7."""
