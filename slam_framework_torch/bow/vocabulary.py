"""Bag-of-words vocabulary tree: batched descent on the device + host training / loading.

Port of slam_framework_tpu/bow/vocabulary.py, after DBoW2's TemplatedVocabulary
(third_party/DBoW2/DBoW2/TemplatedVocabulary.h): a k-ary tree of binary
descriptor centres. The whole frame's 2048 descriptors descend the tree
together: L levels of (N, k) Hamming comparisons, each one gather, XOR,
popcount and argmin.

  - `transform` (device): word id + level-up node id + weight per descriptor
    (the BowVector / FeatureVector of keyframe.cpp:130-135, levelsup = 4);
  - `train`, `transform_host`, `refit_idf`, the `.npz` asset and the ORBvoc.txt
    text format (header `k L scoring weighting`, then `parent is_leaf 32 bytes
    weight` per line, TemplatedVocabulary.h:1335-1418) are host numpy, copied
    from the reference.

Descriptor centres are uint32 words on the host and the same bits as int32 on
the device (see ops/brief.py). Scoring (L1, TF-IDF) works on the sparse
per-frame word lists on the host (bow/database.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from slam_framework_torch import PACKAGE_DIR

SHIPPED_VOCABULARY = os.path.join(PACKAGE_DIR, "assets", "orbvoc_synth.npz")


@dataclasses.dataclass
class Vocabulary:
    k: int                      # branching factor
    depth: int                  # tree depth (levels below root)
    node_desc: np.ndarray       # (num_nodes, 8) uint32 — descriptor centres
    node_children: np.ndarray   # (num_nodes, k) int32 — child node ids (-1 pad)
    node_weight: np.ndarray     # (num_nodes,) f32 — IDF weight (leaves)
    node_word: np.ndarray       # (num_nodes,) int32 — word id for leaves, -1 inner
    levelsup: int = 4           # feature-vector grouping level (from the leaves up)

    @property
    def num_nodes(self) -> int:
        return len(self.node_desc)

    @property
    def num_words(self) -> int:
        return int((self.node_word >= 0).sum())

    def device_tables(self, device=None):
        """(node_desc int32 bits, node_children, node_weight, node_word) on `device`."""
        return (
            torch.from_numpy(np.ascontiguousarray(self.node_desc).view(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.node_children)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.node_weight)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.node_word)).to(device),
        )


def _popcount_bits(x: np.ndarray) -> np.ndarray:
    """Set bits of (..., 8) uint32 descriptors, summed over the last axis (runs
    on any numpy: no `np.bitwise_count`)."""
    b = np.ascontiguousarray(x).view(np.uint8)
    return np.unpackbits(b, axis=-1).sum(axis=-1, dtype=np.int64)


def transform(vocab_tables, desc: torch.Tensor, valid: torch.Tensor, depth: int, k: int, levelsup: int = 4):
    """Batched tree descent. desc (N, 8) int32, valid (N,) bool. Returns
    (word_id (N,) int32, node_at_levelsup (N,) int32, weight (N,) f32); invalid
    descriptors get word -1, group -1 and weight 0.

    Hamming ties between children are common; the first child wins, as with
    the reference's argmin. The order is made explicit (the distance is
    combined with the child's slot into one key whose minimum is unique), so
    the CPU and the card cannot choose differently."""
    node_desc, node_children, node_weight, node_word = vocab_tables
    N = desc.shape[0]
    dev = desc.device
    cur = torch.zeros(N, dtype=torch.long, device=dev)  # root
    group = torch.zeros(N, dtype=torch.long, device=dev)
    group_level = depth - levelsup
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    slot = torch.arange(k, dtype=torch.int32, device=dev)

    for lvl in range(depth):
        children = node_children[cur]                                 # (N, k) int32
        cd = node_desc[torch.clamp(children, min=0).long()]           # (N, k, 8)
        x = torch.bitwise_xor(cd, desc[:, None, :])
        # >> on int32 is arithmetic: take the bit after the shift
        ham = ((x[..., None] >> shifts) & 1).sum(dim=(-1, -2), dtype=torch.int32)
        ham = torch.where(children >= 0, ham, torch.full_like(ham, 1 << 20))
        best = torch.argmin(ham * k + slot, dim=1)
        cur = torch.clamp(torch.gather(children, 1, best[:, None])[:, 0], min=0).long()
        if lvl == group_level - 1:
            group = cur

    word = torch.where(valid, node_word[cur], torch.full_like(node_word[cur], -1))
    weight = torch.where(valid, node_weight[cur], torch.zeros_like(node_weight[cur]))
    group = torch.where(valid, group.to(torch.int32), torch.full_like(word, -1))
    return word, group, weight


def train(
    descriptors: np.ndarray,
    k: int = 10,
    depth: int = 4,
    seed: int = 0,
    iters: int = 8,
) -> Vocabulary:
    """Binary k-medians vocabulary training (host, numpy).

    descriptors: (M, 8) uint32 sample (e.g. all map-point descriptors so far).
    k^depth leaves; with k=10, depth=4 -> 10k words (adequate for a single-sequence
    database; the reference's ORBvoc uses k=10, L=6 trained on a large corpus).
    """
    rng = np.random.default_rng(seed)
    nodes_desc = [np.zeros(8, np.uint32)]
    nodes_children: list[list[int]] = [[]]
    nodes_parent = [0]
    nodes_level = [0]

    def kmedians(data: np.ndarray):
        if len(data) <= k:
            return data, (np.arange(len(data)) if len(data) else np.zeros(0, np.int64))
        centers = data[rng.choice(len(data), k, replace=False)]
        assign = None
        for _ in range(iters):
            d = _popcount_bits(data[:, None, :] ^ centers[None, :, :])  # (n, k)
            assign = np.argmin(d, axis=1)
            new_centers = centers.copy()
            for c in range(k):
                members = data[assign == c]
                if len(members) == 0:
                    continue
                # bitwise median: majority vote per bit
                bits = np.unpackbits(members.view(np.uint8), axis=1)
                maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
                new_centers[c] = np.packbits(maj).view(np.uint32)
            centers = new_centers
        d = _popcount_bits(data[:, None, :] ^ centers[None, :, :])
        assign = np.argmin(d, axis=1)
        return centers, assign

    # BFS expansion
    frontier = [(0, descriptors, 0)]  # (node_id, data, level)
    leaves = []
    while frontier:
        node_id, data, level = frontier.pop()
        if level == depth or len(data) == 0:
            if level == depth:
                leaves.append(node_id)
            continue
        centers, assign = kmedians(data)
        for c in range(len(centers)):
            child_id = len(nodes_desc)
            nodes_desc.append(centers[c])
            nodes_children.append([])
            nodes_parent.append(node_id)
            nodes_level.append(level + 1)
            nodes_children[node_id].append(child_id)
            frontier.append((child_id, data[assign == c], level + 1))

    num_nodes = len(nodes_desc)
    node_desc = np.stack(nodes_desc).astype(np.uint32)
    node_children = np.full((num_nodes, k), -1, np.int32)
    for i, ch in enumerate(nodes_children):
        node_children[i, : len(ch)] = ch
    node_word = np.full(num_nodes, -1, np.int32)
    is_leaf = (node_children[:, 0] < 0) & (np.asarray(nodes_level) == depth)
    node_word[is_leaf] = np.arange(int(is_leaf.sum()))
    # uniform weights at train time; IDF can be refitted online from the database
    node_weight = np.where(is_leaf, 1.0, 0.0).astype(np.float32)
    return Vocabulary(
        k=k, depth=depth, node_desc=node_desc, node_children=node_children,
        node_weight=node_weight, node_word=node_word,
    )


def transform_host(vocab: Vocabulary, desc: np.ndarray) -> np.ndarray:
    """Host (numpy) batched tree descent: (N, 8) uint32 -> (N,) word ids.

    Used where no device round-trip is warranted (IDF refitting over the
    existing keyframes at vocabulary-training time)."""
    N = desc.shape[0]
    cur = np.zeros(N, np.int64)
    for _ in range(vocab.depth):
        children = vocab.node_children[cur]                    # (N, k)
        cd = vocab.node_desc[np.maximum(children, 0)]          # (N, k, 8)
        ham = _popcount_bits(cd ^ desc[:, None, :]).astype(np.int32)
        ham[children < 0] = 1 << 20
        cur = children[np.arange(N), np.argmin(ham, axis=1)]
        cur = np.maximum(cur, 0)
    return vocab.node_word[cur]


def refit_idf(vocab: Vocabulary, frame_word_lists: list) -> None:
    """Set leaf weights to IDF over a corpus of frames, in place.

    DBoW2 semantics (TemplatedVocabulary::create -> setNodeWeights, IDF part of
    TF_IDF): weight(word) = log(N_frames / n_frames_containing_word); words never
    seen keep a small floor so unseen-word hits still count."""
    n_frames = max(len(frame_word_lists), 1)
    df = np.zeros(vocab.num_words, np.int64)
    for words in frame_word_lists:
        w = np.unique(np.asarray(words))
        w = w[(w >= 0) & (w < vocab.num_words)]
        df[w] += 1
    idf = np.log(n_frames / np.maximum(df, 1e-9))
    idf = np.where(df > 0, idf, np.log(float(n_frames)))  # unseen words: max IDF
    is_leaf = vocab.node_word >= 0
    vocab.node_weight[is_leaf] = np.maximum(
        idf[vocab.node_word[is_leaf]], 1e-3
    ).astype(np.float32)


def save_orbvoc_text(vocab: Vocabulary, path: str) -> None:
    """Write the reference's ORBvoc.txt format (TemplatedVocabulary.h:1335-1418):
    header `k L scoring weighting`, then per node (preorder, root excluded)
    `parent is_leaf byte0..byte31 weight`. Node ids in the file are implicit
    (1-based insertion order); children follow their parent, matching the
    loader's child-slot assignment."""
    lines = [f"{vocab.k} {vocab.depth} 0 0\n"]  # 0 0 = L1 scoring, TF-IDF
    file_id = {0: 0}
    order = []

    def visit(node: int) -> None:
        for ch in vocab.node_children[node]:
            if ch < 0:
                continue
            file_id[int(ch)] = len(order) + 1
            order.append(int(ch))
            visit(int(ch))

    visit(0)
    parent_of = np.zeros(vocab.num_nodes, np.int64)
    for n in range(vocab.num_nodes):
        for ch in vocab.node_children[n]:
            if ch >= 0:
                parent_of[ch] = n
    for node in order:
        is_leaf = int(vocab.node_word[node] >= 0)
        desc_bytes = vocab.node_desc[node].view(np.uint8)
        b = " ".join(str(int(x)) for x in desc_bytes)
        w = float(vocab.node_weight[node])
        lines.append(f"{file_id[parent_of[node]]} {is_leaf} {b} {w}\n")
    with open(path, "w") as f:
        f.writelines(lines)


def save_npz(vocab: Vocabulary, path: str) -> None:
    """Compact compressed vocabulary asset (the shipped-artifact format; the
    reference ships a ~1M-leaf ORBvoc.txt blob, TemplatedVocabulary.h:1335-1418 —
    text round-trip stays available via save/load_orbvoc_text for parity, but a
    100k-word tree is ~12 MB of text vs ~2 MB npz). Children are rebuilt from
    the parent array on load, preserving child-slot order."""
    parent = np.full(vocab.num_nodes, -1, np.int64)
    for n in range(vocab.num_nodes):
        for ch in vocab.node_children[n]:
            if ch >= 0:
                parent[ch] = n
    np.savez_compressed(
        path,
        k=np.int64(vocab.k), depth=np.int64(vocab.depth),
        levelsup=np.int64(vocab.levelsup),
        node_desc=vocab.node_desc, node_parent=parent,
        node_weight=vocab.node_weight, node_word=vocab.node_word,
    )


def load_npz(path: str) -> Vocabulary:
    z = np.load(path)
    k = int(z["k"])
    parent = z["node_parent"]
    num_nodes = len(parent)
    node_children = np.full((num_nodes, k), -1, np.int32)
    slot = np.zeros(num_nodes, np.int32)
    # children were saved in node-id order == insertion order, so refilling
    # sequentially restores the original child-slot assignment
    for ch in range(num_nodes):
        p = parent[ch]
        if p >= 0:
            node_children[p, slot[p]] = ch
            slot[p] += 1
    return Vocabulary(
        k=k, depth=int(z["depth"]),
        node_desc=z["node_desc"].astype(np.uint32),
        node_children=node_children,
        node_weight=z["node_weight"].astype(np.float32),
        node_word=z["node_word"].astype(np.int32),
        levelsup=int(z["levelsup"]),
    )


def load(path: str) -> Vocabulary:
    """Extension-dispatched loader: .npz asset or reference ORBvoc .txt."""
    if str(path).endswith(".npz"):
        return load_npz(path)
    return load_orbvoc_text(path)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Load the reference's ORBvoc.txt format (TemplatedVocabulary.h:1335-1418)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            is_leaf = int(parts[1]) != 0
            desc_bytes = np.asarray([int(x) for x in parts[2:34]], np.uint8)
            weight = float(parts[34])
            rows.append((parent, is_leaf, desc_bytes, weight))
    num_nodes = len(rows) + 1
    node_desc = np.zeros((num_nodes, 8), np.uint32)
    node_children = np.full((num_nodes, k), -1, np.int32)
    node_weight = np.zeros(num_nodes, np.float32)
    node_word = np.full(num_nodes, -1, np.int32)
    child_count = np.zeros(num_nodes, np.int32)
    word_id = 0
    for i, (parent, is_leaf, desc_bytes, weight) in enumerate(rows, start=1):
        node_desc[i] = desc_bytes.view(np.uint32)
        node_weight[i] = weight
        node_children[parent, child_count[parent]] = i
        child_count[parent] += 1
        if is_leaf:
            node_word[i] = word_id
            word_id += 1
    return Vocabulary(
        k=k, depth=L, node_desc=node_desc, node_children=node_children,
        node_weight=node_weight, node_word=node_word,
    )
