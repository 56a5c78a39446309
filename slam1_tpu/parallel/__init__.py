"""Multi-device layer: mesh construction, data-parallel frontend,
distributed Schur-complement bundle adjustment.

The reference has NO parallelism or communication backend of any kind
(SURVEY.md §2 checklist: single-threaded frame loop, file-based IPC).
These components are new: `jax.sharding` meshes over the cards of one
host, with psum/all-gather collectives inserted by XLA.
"""
