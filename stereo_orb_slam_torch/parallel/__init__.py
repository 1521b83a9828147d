"""Multi-sequence tracking and distributed solvers on torch.distributed.

PyTorch counterpart of the JAX package's `parallel/`. The JAX package is
single-controller (one process drives a device mesh; `shard_map` and
`psum` do the rest); the port is SPMD: one process per rank, each holding
its shard and a replica of the replicated state, and every `psum` is an
`all_reduce` (`mesh.all_reduce`).
"""
