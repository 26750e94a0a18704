"""Distribution (counterpart of `locus_tpu/parallel/`): the pose-graph
solver (`posegraph`, unsharded and with factors over a mesh), the process
group and its rank-ordered gather (`distributed`), the ("data", "map")
mesh with the shard layout of the state (`mesh`), and nearest neighbours
against a sharded map (`sharded_map`)."""
