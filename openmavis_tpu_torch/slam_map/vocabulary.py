"""Binary visual vocabulary: hierarchical k-medians over ORB descriptors
(port of `openmavis_tpu/slam_map/vocabulary.py`; reference: DBoW2's
TemplatedVocabulary, Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — a
k = 10 tree, tf-idf BowVector, L1 scoring).

The tree is dense tensors (one [k^(l+1), 256] int8 center table a level);
training clusters every node of a level at once (majority-bit centroids,
Hamming assignment among the k siblings of each descriptor's node);
descent is a level-wise batched argmin. BoW vectors are dense [n_words]
tf-idf tensors, or word-sparse (word id, weight) lists of a fixed
capacity (`transform_sparse`) for the inverted-file database of
`keyframe_db.py`.

Descriptors and centers are {0,1} int8 planes; a Hamming distance is a
sum of absolute differences, exact in any order of summation, and ties go
to the lower sibling (`torch.argmin` returns the first minimum, as
`jnp.argmin` does). Training keeps the reference's numpy initialisation
(the seeded permutation and the per-node member pick) and runs its EM
steps as tensor ops on the device, with integer counts, so the centers,
the idf and the word ids equal the reference's exactly.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.fast import topk_stable
from ..ops import scatter_max

# descriptors assigned per batch of the tree descent: [chunk, k, 256]
# int16 differences (42 MB at k = 10)
_CHUNK = 8192


class Vocabulary(NamedTuple):
    """Dense vocabulary tree: level l has k^(l+1) nodes."""
    centers: tuple          # per level: [k^(l+1), 256] int8 centers
    idf: torch.Tensor       # [n_words] f32 inverse document frequency
    k: int                  # branching factor

    @property
    def n_words(self):
        return self.centers[-1].shape[0]


def _assign(desc, centers_per_node, node_of_desc):
    """desc [N,256]; centers_per_node [n_nodes, k, 256]; node_of_desc [N].
    Returns the child index [N] in 0..k-1 by Hamming argmin (ties to the
    lower child)."""
    if desc.device.type == "cpu":
        return _assign_cpu(desc, centers_per_node, node_of_desc)
    return _assign_dense(desc, centers_per_node, node_of_desc)


def _assign_dense(desc, centers_per_node, node_of_desc):
    out = []
    for lo in range(0, desc.shape[0], _CHUNK):
        d_c = desc[lo:lo + _CHUNK].to(torch.int16)
        cen = centers_per_node[node_of_desc[lo:lo + _CHUNK]]   # [n, k, 256]
        d = torch.sum(torch.abs(cen.to(torch.int16) - d_c[:, None, :]),
                      dim=-1, dtype=torch.int32)
        out.append(torch.argmin(d, dim=-1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=desc.device)
    return torch.cat(out)


def _assign_cpu(desc, centers_per_node, node_of_desc):
    """The CPU route of `_assign`, equal to it exactly: the descriptors of
    each node against its k centers as one float product (|a| + |b| -
    2 a.b, exact integers below 2^24), the same first-minimum argmin."""
    out = torch.zeros(desc.shape[0], dtype=torch.int64)
    a = desc.to(torch.float32)
    order = torch.argsort(node_of_desc, stable=True)
    nodes, counts = torch.unique_consecutive(node_of_desc[order],
                                             return_counts=True)
    lo = 0
    for c, n in zip(nodes.tolist(), counts.tolist()):
        rows = order[lo:lo + n]
        lo += n
        cen = centers_per_node[c].to(torch.float32)          # [k, 256]
        ar = a[rows]
        d = (ar.sum(-1, keepdim=True) + cen.sum(-1)[None]
             - 2.0 * (ar @ cen.T))
        out[rows] = torch.argmin(d, dim=-1)
    return out


def train(desc, k: int = 10, levels: int = 3, iters: int = 6,
          seed: int = 0, device=None) -> Vocabulary:
    """Train a k^levels-word vocabulary from [N, 256] {0,1} descriptors
    (numpy or a tensor) on `device` (the current CUDA device when None).

    All nodes of a level are clustered in one batched loop: descriptors
    carry their parent-node id; centroids are per-(node, child) majority
    bits; assignment is Hamming argmin among the k sibling centers."""
    dev = resolve_device(device)
    if isinstance(desc, torch.Tensor):
        desc = desc.detach().cpu().numpy()
    desc = np.asarray(desc, np.int8)
    n = len(desc)
    rng = np.random.default_rng(seed)
    desc_t = torch.as_tensor(desc).to(dev)
    bits = desc_t.to(torch.int32)

    node = torch.zeros(n, dtype=torch.int64, device=dev)
    centers_list = []
    n_nodes = 1
    for _ in range(levels):
        # init: a random member of each node for each child slot
        perm = rng.permutation(n)
        init = np.zeros((n_nodes, k, 256), np.int8)
        node_np = node.cpu().numpy()
        for c in range(n_nodes):
            members = perm[node_np[perm] == c]
            if len(members) == 0:
                members = perm[:k]
            sel = members[(np.arange(k) * 2654435761) % len(members)]
            init[c] = desc[sel]
        centers = torch.as_tensor(init).to(dev)

        for _ in range(iters):
            slot = node * k + _assign(desc_t, centers, node)
            cnt = torch.zeros(n_nodes * k, dtype=torch.int32,
                              device=dev).index_add_(
                0, slot, torch.ones(n, dtype=torch.int32, device=dev))
            bit_sum = torch.zeros(n_nodes * k, 256, dtype=torch.int32,
                                  device=dev).index_add_(0, slot, bits)
            # majority bit: bit_sum > cnt / 2, in integers
            new = (2 * bit_sum > cnt[:, None]).to(torch.int8)
            flat = torch.where((cnt > 0)[:, None], new,
                               centers.reshape(-1, 256))
            centers = flat.reshape(n_nodes, k, 256)
        node = node * k + _assign(desc_t, centers, node)
        centers_list.append(centers.reshape(n_nodes * k, 256))
        n_nodes *= k

    # idf from the training counts
    counts = np.bincount(node.cpu().numpy(),
                         minlength=n_nodes).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(centers=tuple(centers_list),
                      idf=torch.as_tensor(idf).to(dev), k=k)


def word_ids(vocab: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """[..., F, 256] -> [..., F] leaf word id (int64)."""
    lead = desc.shape[:-1]
    flat = desc.reshape(-1, 256)
    node = torch.zeros(flat.shape[0], dtype=torch.int64, device=desc.device)
    k = vocab.k
    for centers in vocab.centers:
        node = node * k + _assign(flat, centers.reshape(-1, k, 256), node)
    return node.reshape(lead)


def _tf_idf(vocab: Vocabulary, desc, valid) -> torch.Tensor:
    """[F, 256], [F] -> the unnormalized [n_words] tf-idf vector."""
    tf = torch.zeros(vocab.n_words, dtype=torch.float32,
                     device=desc.device).index_add_(
        0, word_ids(vocab, desc), valid.to(torch.float32))
    return tf * vocab.idf


def transform(vocab: Vocabulary, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """[F, 256] descriptors -> [n_words] L1-normalized tf-idf BoW vector."""
    v = _tf_idf(vocab, desc, valid)
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: s = 1 - 0.5 |v1 - v2|_1 (vectors
    L1-normalized; reference: Thirdparty/DBoW2 ScoringObject.cpp
    L1Scoring). Batched over the leading dims of v1."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def transform_sparse(vocab: Vocabulary, desc: torch.Tensor,
                     valid: torch.Tensor, top_w: int):
    """[F, 256] descriptors -> word-sparse BoW: (word [W] i32, wt [W]
    f32), the heaviest `top_w` words of the L1-normalized tf-idf vector
    (all of them when the bank has no more distinct words), ties to the
    lower word id as `lax.top_k` breaks them (reference inverted file:
    src/KeyFrameDatabase.cc:581). Pad slots carry word 0 with weight 0.
    Batched over leading dims of desc/valid ([B, F, 256] -> [B, W])."""
    if desc.dim() > 2:
        outs = [transform_sparse(vocab, d, v, top_w)
                for d, v in zip(desc, valid)]
        if not outs:
            z = torch.zeros((0, top_w), device=desc.device)
            return z.to(torch.int32), z
        return (torch.stack([w for w, _ in outs]),
                torch.stack([x for _, x in outs]))
    v = _tf_idf(vocab, desc, valid)
    v = v / torch.clamp(torch.sum(v), min=1e-9)
    w = vocab.n_words
    eff = min(top_w, w)       # tiny vocabularies: fewer words than slots
    wt, word = topk_stable(v, eff)
    if eff < top_w:
        pad = top_w - eff
        word = torch.cat([word, torch.zeros(pad, dtype=word.dtype,
                                            device=word.device)])
        wt = torch.cat([wt, torch.zeros(pad, dtype=wt.dtype,
                                        device=wt.device)])
    return word.to(torch.int32), torch.clamp(wt, min=0.0)


def l1_score_sparse(word_a, wt_a, word_b, wt_b, n_words: int):
    """L1 similarity between two word-sparse BoW vectors: for
    L1-normalized nonnegative vectors 1 - 0.5|u - v|_1 is the
    min-intersection sum_w min(u_w, v_w) over shared words."""
    dense_a = scatter_max(torch.zeros(n_words, dtype=wt_a.dtype,
                                      device=wt_a.device), word_a, wt_a)
    return torch.sum(torch.minimum(wt_b, dense_a[word_b.to(torch.int64)]))


def _digest(centers, idf) -> str:
    blob = b"".join(np.asarray(c).tobytes() for c in centers)
    return hashlib.md5(blob + np.asarray(idf).tobytes()).hexdigest()


def save(path: str, vocab: Vocabulary) -> str:
    """Persist a trained vocabulary (npz) with a content hash, the md5 of
    the center tables' and the idf's bytes (the reference binds maps to
    its vocabulary by MD5, System.cc:1520-1556). The file loads in either
    package. Returns the hex digest."""
    arrays = {f"centers_{i}": c.detach().cpu().numpy()
              for i, c in enumerate(vocab.centers)}
    arrays["idf"] = vocab.idf.detach().cpu().numpy()
    digest = _digest([arrays[f"centers_{i}"]
                      for i in range(len(vocab.centers))], arrays["idf"])
    np.savez_compressed(path, k=np.asarray(vocab.k),
                        levels=np.asarray(len(vocab.centers)),
                        md5=np.asarray(digest), **arrays)
    return digest


def load(path: str, device=None) -> tuple:
    """Load a persisted vocabulary onto `device` (the current CUDA device
    when None). Returns (Vocabulary, md5 hex digest); raises ValueError
    when the stored hash does not match the content. A `.txt` path is
    parsed as the DBoW2 text format (`load_dbow2_text`) and its md5 is
    that of the raw file (System::Shutdown's checksum binding,
    src/System.cc:1520-1556)."""
    dev = resolve_device(device)
    if str(path).endswith(".txt"):
        with open(path, "rb") as f:
            digest = hashlib.md5(f.read()).hexdigest()
        return load_dbow2_text(path, device=dev), digest

    with np.load(path) as data:
        levels = int(data["levels"])
        centers = [np.asarray(data[f"centers_{i}"]) for i in range(levels)]
        idf = np.asarray(data["idf"])
        k = int(data["k"])
        stored = str(data["md5"])
    digest = _digest(centers, idf)
    if digest != stored:
        raise ValueError(f"vocabulary {path}: content hash {digest} != "
                         f"stored {stored} (corrupt or tampered file)")
    return Vocabulary(centers=tuple(torch.as_tensor(c).to(dev)
                                    for c in centers),
                      idf=torch.as_tensor(idf).to(dev), k=k), digest


def load_dbow2_text(path: str, device=None) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (the ORBvoc.txt format) into the
    dense-tensor Vocabulary on `device` (the current CUDA device when
    None).

    Format (TemplatedVocabulary::loadFromTextFile, Thirdparty/DBoW2/DBoW2/
    TemplatedVocabulary.h:1338): the first line is `k L scoring_type
    weight_type`; every following line is one node — `parent_id is_leaf
    b0 .. b31 weight` with the 256-bit descriptor as 32 bytes. Node ids
    are implicit (root = 0, then file order); children keep file order
    under their parent; words are the leaf nodes.

    DBoW2 trees are incomplete — nodes may have fewer than k children and
    leaves occur above the last level — which the dense layout absorbs
    exactly: a missing child slot copies the first child's center (the
    argmin tie goes to slot 0, so a pad never wins), and a leaf above the
    bottom level continues as a chain whose child slots all carry its
    center, down to one bottom-level node that receives its weight."""
    dev = resolve_device(device)
    with open(path, "r") as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leafs, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leafs.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))
    n_nodes = len(parents)
    bytes_arr = np.asarray(descs, np.uint8).reshape(n_nodes, 32)
    bits = np.unpackbits(bytes_arr, axis=1, bitorder="little")
    bits = bits.astype(np.int8)                            # [N, 256]

    # children of each node, in file order (node ids 1..N after root 0)
    children: list[list[int]] = [[] for _ in range(n_nodes + 1)]
    for i, p in enumerate(parents):
        children[p].append(i + 1)

    centers = [np.zeros((k ** (lv + 1), 256), np.int8) for lv in range(L)]
    idf = np.zeros((k ** L,), np.float32)

    # breadth first over dense positions: `frontier` holds (node id,
    # dense pos) of internal nodes, `chain` (dense pos, center, weight) of
    # leaves continued below their level
    frontier = [(0, 0)]
    chain: list[tuple] = []
    for lv in range(L):
        next_frontier = []
        next_chain = []
        for pos, bits_c, w in chain:
            centers[lv][pos * k:pos * k + k] = bits_c
            if lv == L - 1:
                idf[pos * k] = w
            else:
                next_chain.append((pos * k, bits_c, w))
        for node, pos in frontier:
            ch = children[node]
            if not ch:
                continue
            first_bits = bits[ch[0] - 1]
            for s in range(k):
                if s >= len(ch):
                    # pad: a copy of the first child (argmin tie -> slot 0)
                    centers[lv][pos * k + s] = first_bits
                    continue
                c = ch[s]
                cb = bits[c - 1]
                centers[lv][pos * k + s] = cb
                if leafs[c - 1] or not children[c]:
                    if lv == L - 1:
                        idf[pos * k + s] = weights[c - 1]
                    else:
                        next_chain.append((pos * k + s, cb, weights[c - 1]))
                else:
                    next_frontier.append((c, pos * k + s))
        frontier = next_frontier
        chain = next_chain

    return Vocabulary(centers=tuple(torch.as_tensor(c).to(dev)
                                    for c in centers),
                      idf=torch.as_tensor(idf).to(dev), k=k)


def save_dbow2_text(path: str, vocab: Vocabulary) -> None:
    """Write a trained (complete-tree) Vocabulary in the DBoW2 text
    format, byte for byte as the reference package writes it (leaves at
    the bottom level carry the idf weights; internal weights are 0)."""
    k = vocab.k
    L = len(vocab.centers)
    idf = vocab.idf.detach().cpu().numpy()
    lines = [f"{k} {L} 0 0"]
    # node ids: root 0; level-l nodes appended in dense order — the node
    # at level l, dense pos p has id offset(l) + p with
    # offset(l) = 1 + k + ... + k^l (geometric prefix, root excluded)
    offsets = [1]
    for lv in range(1, L):
        offsets.append(offsets[-1] + k ** lv)

    for lv, cen in enumerate(vocab.centers):
        cen_np = cen.detach().cpu().numpy().astype(np.int8)
        packed = np.packbits(cen_np.astype(np.uint8), axis=1,
                             bitorder="little")            # [n, 32]
        for p in range(cen_np.shape[0]):
            parent = 0 if lv == 0 else offsets[lv - 1] + p // k
            is_leaf = 1 if lv == L - 1 else 0
            w = float(idf[p]) if is_leaf else 0.0
            byte_str = " ".join(str(int(b)) for b in packed[p])
            lines.append(f"{parent} {is_leaf} {byte_str} {w}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
