"""Map-scale descriptor matching sharded over a device mesh (counterpart
of mcslam_tpu/parallel/sharded_match.py), on parallel/mesh's
single-process mesh.

The map descriptor table is split over the mesh; each shard computes the
Hamming distances of all queries against its rows (ops/hamming's plain
product, as the JAX package runs plain `hamming_matrix` here) and its
local best / second best per query. The global best is one `pmin` over
distance * (n + 1) + shard, which keeps ties deterministic (the lowest
shard, then the lowest row, wins); the global second best is the
minimum over every shard's second best and every losing shard's best.
What crosses shards is O(queries), not O(map).
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.parallel import mesh as mesh_mod

AXIS = "map"
_BIG = 1 << 20


def make_mesh(n_devices: int | None = None, device="cuda") -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(n_devices, device, AXIS)


def shard_map_desc(mesh, map_desc, map_valid, pad_multiple: int = 8):
    """Pad the map table (N, 8) uint32 words (or int32 words with the same
    bits) to Np rows, a multiple of size * pad_multiple, and split it over
    the mesh. -> (descriptor shards (Np / size, 8) int32, validity shards
    (Np / size,) bool, Np), shard i on device i."""
    n = mesh.size
    N = len(map_desc)
    Np = -(-max(N, 1) // (n * pad_multiple)) * n * pad_multiple
    d = np.zeros((Np, 8), np.uint32)
    v = np.zeros(Np, bool)
    if isinstance(map_desc, torch.Tensor):
        map_desc = hamming.desc_to_numpy_u32(map_desc)
    d[:N] = np.asarray(map_desc).astype(np.uint32)
    v[:N] = (map_valid.detach().cpu().numpy()
             if isinstance(map_valid, torch.Tensor) else map_valid)
    return (mesh.shard(hamming.desc_to_torch(d, mesh.first)),
            mesh.shard(torch.from_numpy(v).to(mesh.first)), Np)


def sharded_hamming_match(mesh, query_desc, query_valid, map_desc,
                          map_valid, max_dist: int = 64,
                          ratio: float = 0.85):
    """query_desc (Q, 8) int32 words and query_valid (Q,) against the map
    shards of shard_map_desc -> (idx (Q,) int32 global map row of the best
    match, ok (Q,) bool passing the distance and Lowe-ratio gates, best
    distance (Q,) int32), on the mesh's first device. Exactly the
    single-device brute force's answer, ties to the lowest row."""
    n = mesh.size
    n_local = map_desc[0].shape[0]
    d1s, d2s, i1s = [], [], []
    for s, (dev, md, mv) in enumerate(zip(mesh.devices, map_desc,
                                          map_valid)):
        d = hamming.hamming_matrix(query_desc.to(dev, non_blocking=True), md)
        d = torch.where(mv[None, :], d, _BIG)
        # local best (lowest row on ties) and second best per query
        d1, i1 = torch.min(d, dim=1)
        d_wo = d.scatter(1, i1[:, None], _BIG)
        d1s.append(d1)
        d2s.append(torch.min(d_wo, dim=1).values)
        i1s.append(i1.to(torch.int32) + s * n_local)
    # global best: distance in the high digits, shard in the low ones, so
    # one pmin is a lexicographic argmin
    packed = [d1 * (n + 1) + s for s, d1 in enumerate(d1s)]
    gbest = mesh.pmin(packed)
    best_shard = gbest % (n + 1)
    best_d = (gbest // (n + 1)).to(torch.int32)
    # the winner's global row, contributed by the winning shard only
    best_idx = mesh.psum([torch.where(best_shard.to(i.device) == s, i, 0)
                          for s, i in enumerate(i1s)])
    d1_losing = [torch.where(best_shard.to(d1.device) == s, _BIG, d1)
                 for s, d1 in enumerate(d1s)]
    gsecond = torch.minimum(mesh.pmin(d2s), mesh.pmin(d1_losing))
    ok = (query_valid.to(mesh.first, non_blocking=True)
          & (best_d <= max_dist)
          & (best_d.to(torch.float32) <= ratio * gsecond.to(torch.float32)))
    return best_idx.to(torch.int32), ok, best_d
