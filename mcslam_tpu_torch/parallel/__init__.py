"""Multi-device paths on a single-process device mesh (parallel/mesh)."""
