"""Pose-graph optimisation (`posegraph`). The mesh, the sharded map and
the multi-process deployment of the JAX package's `parallel/` are ROADMAP
A16."""
