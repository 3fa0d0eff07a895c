"""Multi-chip scaling: mesh construction, DP training, sharded galleries.

The reference is strictly single-GPU (no NCCL/MPI/collectives anywhere —
see SURVEY.md §2); everything here is a new design:
data-parallel training via batch sharding under a Mesh, gallery-sharded
retrieval (local matmul+top-k, all_gather of per-shard candidates, global
re-rank), and psum'd covariance statistics for the exact multi-chip CCA
refinement.
"""
