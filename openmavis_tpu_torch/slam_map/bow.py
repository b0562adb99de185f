"""LSH bag-of-words place-recognition signatures (port of `word_ids`,
`histogram` and `scores` of `openmavis_tpu/slam_map/bow.py`; reference: the DBoW2 word
histograms of KeyFrameDatabase, src/KeyFrameDatabase.cc:581).

Each descriptor is hashed by BITS fixed bit positions per table into one of
2**BITS buckets; a keyframe's signature is the concatenated bucket-count
histogram over N_TABLES tables. The bit positions derive from SHA-256 of a
fixed seed string, so they are identical to the reference package's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

N_TABLES = 2
BITS = 15
TABLE_W = 1 << BITS
W = N_TABLES * TABLE_W


def _stable_positions(n_tables: int, bits: int) -> np.ndarray:
    tables = []
    for t in range(n_tables):
        chosen: list[int] = []
        seen: set[int] = set()
        ctr = 0
        while len(chosen) < bits:
            digest = hashlib.sha256(
                f"openmavis-bow-{t}-{ctr}".encode()).digest()
            ctr += 1
            for byte in digest:
                if byte not in seen:
                    seen.add(byte)
                    chosen.append(byte)
                    if len(chosen) == bits:
                        break
        tables.append(sorted(chosen))
    return np.asarray(tables, np.int64)


_POS = _stable_positions(N_TABLES, BITS)  # [N_TABLES, BITS]
_POW2 = (1 << np.arange(BITS)).astype(np.int32)


def word_ids(desc: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} descriptors -> [..., N_TABLES] word ids in [0, W)."""
    pos = torch.as_tensor(_POS, device=desc.device)
    bits = desc[..., pos].to(torch.int32)                  # [..., T, B]
    pow2 = torch.as_tensor(_POW2, device=desc.device)
    idx = torch.sum(bits * pow2, dim=-1, dtype=torch.int32)
    return idx + torch.arange(N_TABLES, dtype=torch.int32,
                              device=desc.device) * TABLE_W


def histogram(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keyframe signature: desc [F, 256], valid [F] -> [W] int8 bucket
    counts, clipped at 127."""
    ids = torch.where(valid[:, None], word_ids(desc),
                      torch.full((), W, dtype=torch.int32,
                                 device=desc.device))
    h = torch.zeros(W + 1, dtype=torch.int32, device=desc.device)
    h.index_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    return torch.clamp(h[:W], 0, 127).to(torch.int8)


def scores(kf_bow: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Min-intersection retrieval scores: kf_bow [K, W] int8, q [W] int8
    -> [K] int32 shared-word-occurrence counts (the DBoW2 L1-overlap
    analog on raw counts)."""
    return torch.sum(torch.minimum(kf_bow, q[None, :]), dim=1,
                     dtype=torch.int32)
