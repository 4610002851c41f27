"""Masked brute-force descriptor matching on dense Hamming matrices
(counterpart of mcslam_tpu/ops/match.py): best and second best per row,
mutual-best check, distance threshold and Lowe ratio test. argmin/argmax
take the first index on ties, as in JAX."""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1 << 20


class MatchResult(NamedTuple):
    """Row-aligned match table: for each of N query descriptors."""

    idx: torch.Tensor  # (N,) int32 index into the target set (undefined if !ok)
    dist: torch.Tensor  # (N,) int32 best distance
    ok: torch.Tensor  # (N,) bool


def best_two(dists: torch.Tensor, dim: int = -1):
    """(..., M) -> (best_idx int32, best, second_best) along `dim`."""
    best_idx = torch.argmin(dists, dim=dim, keepdim=True)
    best = torch.gather(dists, dim, best_idx)
    masked = dists.scatter(dim, best_idx, BIG)
    second = torch.amin(masked, dim=dim)
    return (best_idx.squeeze(dim).to(torch.int32), best.squeeze(dim), second)


def _apply_masks(d, row_mask, col_mask, pair_mask):
    big = torch.full_like(d, BIG)
    if pair_mask is not None:
        d = torch.where(pair_mask, d, big)
    if row_mask is not None:
        d = torch.where(row_mask[:, None], d, big)
    if col_mask is not None:
        d = torch.where(col_mask[None, :], d, big)
    return d


def match_mutual(dist_matrix: torch.Tensor, row_mask=None, col_mask=None,
                 max_dist: int = 50, ratio: float = 0.85,
                 pair_mask=None) -> MatchResult:
    """Mutual-best match with distance threshold and ratio test on an
    (N, M) int distance matrix."""
    d = _apply_masks(dist_matrix, row_mask, col_mask, pair_mask)
    fwd_idx, fwd_best, fwd_second = best_two(d, dim=1)
    bwd_idx = torch.argmin(d, dim=0)
    rows = torch.arange(d.shape[0], device=d.device)
    mutual = bwd_idx[fwd_idx.long()] == rows
    passes_ratio = fwd_best.to(torch.float32) <= ratio * fwd_second.to(
        torch.float32)
    ok = mutual & (fwd_best <= max_dist) & passes_ratio
    if row_mask is not None:
        ok = ok & row_mask
    return MatchResult(idx=fwd_idx, dist=fwd_best.to(torch.int32), ok=ok)


def match_one_way(dist_matrix: torch.Tensor, row_mask=None, col_mask=None,
                  max_dist: int = 50, ratio: float = 1.0,
                  pair_mask=None) -> MatchResult:
    """Best match per row without the mutual check."""
    d = _apply_masks(dist_matrix, row_mask, col_mask, pair_mask)
    idx, best, second = best_two(d, dim=1)
    ok = (best <= max_dist) & (
        best.to(torch.float32) <= ratio * second.to(torch.float32))
    if row_mask is not None:
        ok = ok & row_mask
    return MatchResult(idx=idx, dist=best.to(torch.int32), ok=ok)


def topk_neighbors(dist_matrix: torch.Tensor, k: int, col_mask=None):
    """The k nearest targets per row -> (idx (N, k) int32, dist (N, k) of
    the matrix's dtype), nearest first; among equal distances the lower
    index first, as jax.lax.top_k orders them (a stable sort: torch.topk
    makes no promise on ties). Replaces the reference fast-tracking
    module's cv::flann kNN queries (Tracking.cpp:321-360)."""
    d = dist_matrix
    if col_mask is not None:
        d = torch.where(col_mask[None, :], d, torch.full_like(d, BIG))
    vals, idx = torch.sort(d.to(torch.float32), dim=1, stable=True)
    return (idx[:, :k].to(torch.int32),
            vals[:, :k].to(dist_matrix.dtype))
