"""Binary bag-of-words vocabulary: a hierarchical k-medians tree over
BRIEF-256 descriptors (counterpart of mcslam_tpu/loop/vocab.py).

Training, save and load are the JAX package's host numpy code, unchanged,
so a seed gives the same tree and a `.npz` written by either package loads
in the other. The transform is tensor code on the descriptors' device: a
frame's descriptors descend the tree together (one gather and a popcount
argmin per level), then the tf-idf bucket and the L2 normalization.

Descriptors on the device are int32 words with the uint32 bits
(ops/hamming). Bits are counted on int64 widenings masked to 32 bits: an
arithmetic right shift of a negative int32 would smear the sign bit
through the popcount's shifts.

Scoring is the cosine of L2-normalized tf-idf vectors (DBoW2's default is
L1), as in the JAX package: database lookup is then one matvec.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.ops.hamming import popcount32


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(np.int32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int32."""
    return _popcount_np(a[:, None, :] ^ b[None, :, :]).sum(-1)


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote -> (8,) uint32 centroid."""
    bits = np.unpackbits(descs.view(np.uint8).reshape(len(descs), 32),
                         axis=1, bitorder="little")
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


class Vocabulary:
    """Array-form vocabulary tree (host numpy; device copies on demand).

    nodes:    (n_nodes, 8) uint32 centroids (level-major BFS layout)
    children: (n_nodes, k) int32 child node index (-1 past the end)
    word_id:  (n_nodes,) int32 leaf word id (-1 for internal nodes)
    weights:  (n_words,) float32 idf word weights
    """

    def __init__(self, nodes, children, word_id, weights, k, depth):
        self.nodes = np.asarray(nodes, np.uint32)
        self.children = np.asarray(children, np.int32)
        self.word_id = np.asarray(word_id, np.int32)
        self.weights = np.asarray(weights, np.float32)
        self.k = int(k)
        self.depth = int(depth)
        self.num_words = len(self.weights)
        self._dev = {}  # device -> (nodes, children, word_id, weights)

    # -- training ----------------------------------------------------------

    @staticmethod
    def train(descriptors: np.ndarray, k: int = 8, depth: int = 4,
              iters: int = 6, seed: int = 0) -> "Vocabulary":
        """Hierarchical k-medians on (N, 8) uint32 descriptors."""
        rng = np.random.RandomState(seed)
        nodes = [np.zeros(8, np.uint32)]  # root placeholder
        children = [[]]
        word_id = [-1]
        leaves = []
        frontier = [(0, descriptors)]
        for level in range(depth):
            next_frontier = []
            for node_idx, descs in frontier:
                if len(descs) == 0:
                    continue
                kk = min(k, len(descs))
                # k-medians init: random distinct picks
                pick = rng.choice(len(descs), kk, replace=False)
                cents = descs[pick].copy()
                for _ in range(iters):
                    lbl = _hamming_np(descs, cents).argmin(1)
                    for c in range(kk):
                        sel = descs[lbl == c]
                        if len(sel):
                            cents[c] = _majority_centroid(sel)
                lbl = _hamming_np(descs, cents).argmin(1)
                ch = []
                for c in range(kk):
                    nodes.append(cents[c])
                    children.append([])
                    word_id.append(-1)
                    idx = len(nodes) - 1
                    ch.append(idx)
                    sub = descs[lbl == c]
                    if level == depth - 1:
                        word_id[idx] = len(leaves)
                        leaves.append((idx, len(sub)))
                    else:
                        next_frontier.append((idx, sub))
                children[node_idx] = ch
            frontier = next_frontier

        n_nodes = len(nodes)
        child_arr = np.full((n_nodes, k), -1, np.int32)
        for i, ch in enumerate(children):
            child_arr[i, :len(ch)] = ch
        # idf weights from the training counts
        counts = np.array([max(c, 1) for _, c in leaves], np.float64)
        idf = np.log(counts.sum() / counts).astype(np.float32)
        return Vocabulary(np.stack(nodes), child_arr,
                          np.array(word_id, np.int32), idf, k, depth)

    # -- persistence --------------------------------------------------------

    def save(self, path):
        np.savez_compressed(
            path, nodes=self.nodes, children=self.children,
            word_id=self.word_id, weights=self.weights,
            k=self.k, depth=self.depth)

    @staticmethod
    def load(path) -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(z["nodes"], z["children"], z["word_id"],
                          z["weights"], int(z["k"]), int(z["depth"]))

    # -- device transform ---------------------------------------------------

    def device_arrays(self, device):
        """(nodes int32 words, children int64, word_id int64, weights f32)
        on `device`, uploaded once per device."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (
                hamming.desc_to_torch(self.nodes, device),
                torch.from_numpy(self.children.astype(np.int64)).to(device),
                torch.from_numpy(self.word_id.astype(np.int64)).to(device),
                torch.from_numpy(self.weights).to(device))
        return self._dev[device]

    def transform(self, desc: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        """(M, 8) int32 descriptor words, (M,) bool -> (n_words,) f32
        L2-normalized tf-idf BoW, on the descriptors' device."""
        nodes, children, word_id, weights = self.device_arrays(desc.device)
        wid = word_id[_descend_nodes(desc, nodes, children, self.depth)]
        wid = torch.where(valid, wid, torch.full_like(wid, self.num_words))
        # counts of 1.0: exact in any summation order (and, unlike
        # bincount, no host read of the largest id)
        tf = torch.zeros(self.num_words + 1, dtype=torch.float32,
                         device=desc.device).index_add_(
            0, wid, torch.ones(wid.shape, dtype=torch.float32,
                               device=desc.device))
        v = tf[:self.num_words] * weights
        n = torch.linalg.vector_norm(v)
        return v / torch.clamp(n, min=1e-9)

    def word_ids(self, desc: torch.Tensor) -> torch.Tensor:
        """(M, 8) -> (M,) int32 leaf word ids."""
        nodes, children, word_id, _ = self.device_arrays(desc.device)
        return word_id[_descend_nodes(desc, nodes, children,
                                      self.depth)].to(torch.int32)

    def node_ids(self, desc: torch.Tensor, levels_up: int = 2) -> torch.Tensor:
        """(M,) int32 tree node each descriptor reaches `levels_up` levels
        above the leaves: the direct index (DBoW2 di_levels). Features
        sharing a node are the candidate match pairs of
        detector._match_direct_index."""
        nodes, children, _, _ = self.device_arrays(desc.device)
        stop = max(self.depth - int(levels_up), 1)
        return _descend_nodes(desc, nodes, children, stop).to(torch.int32)


def score_database(query_bow: torch.Tensor,
                   db_bows: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the query against every stored frame
    (L2-normalized BoW vectors): one matvec, (F, V) @ (V,) -> (F,)."""
    return db_bows @ query_bow


def _descend_nodes(desc, nodes, children, n_levels):
    """(M, 8) int32 words -> (M,) int64 tree node after n_levels argmin
    descents from the root (first child on ties, as jnp.argmin)."""
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for _ in range(n_levels):
        ch = children[cur]  # (M, k)
        cents = nodes[torch.clamp(ch, min=0)]  # (M, k, 8)
        d = popcount32(torch.bitwise_xor(cents, desc[:, None, :])).sum(-1)
        d = torch.where(ch >= 0, d, torch.full_like(d, 1 << 20))
        cur = torch.gather(ch, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return cur

