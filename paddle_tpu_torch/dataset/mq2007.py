"""MQ2007 learning to rank, the port's copy of paddle_tpu/dataset/mq2007.py
(reference python/paddle/v2/dataset/mq2007.py: LETOR 4.0 query-document
pairs, 46 dense features and a graded relevance, served pointwise,
pairwise or listwise). The LETOR text files train.txt / test.txt under
DATA_HOME/mq2007/ are parsed when present; otherwise the JAX package's
synthetic surrogate, the same samples from the same seed: per-query
document groups whose relevance follows a planted weight vector."""

from __future__ import annotations

import functools
import os

import numpy as np

from . import common

FEATURE_DIM = 46          # LETOR 4.0 feature count
_TRAIN_QUERIES, _TEST_QUERIES = 200, 40
_DOCS_PER_QUERY = (8, 20)


def _parse_letor(path):
    """LETOR lines `<rel> qid:<id> 1:<v> 2:<v> ... # comment` ->
    {qid: [(rel, features), ...]}, an absent feature -1 (the grammar of
    the reference's Query._parse_)."""
    groups = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(float(parts[0]))
            qid = parts[1].split(":")[1]
            feats = np.full(FEATURE_DIM, -1.0, np.float32)
            for tok in parts[2:]:
                idx, val = tok.split(":")
                i = int(idx) - 1
                if 0 <= i < FEATURE_DIM:
                    feats[i] = float(val)
            groups.setdefault(qid, []).append((rel, feats))
    return groups


def _synthetic_groups(n_queries, seed):
    """Relevance graded 0/1/2 by within-query quantile of a planted linear
    score plus noise."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(42).randn(FEATURE_DIM).astype(np.float32)
    groups = {}
    for q in range(n_queries):
        n_docs = int(rng.randint(*_DOCS_PER_QUERY))
        feats = rng.randn(n_docs, FEATURE_DIM).astype(np.float32)
        scores = feats @ w + 0.5 * rng.randn(n_docs).astype(np.float32)
        q1, q2 = np.quantile(scores, [0.5, 0.85])
        rels = (scores > q1).astype(int) + (scores > q2).astype(int)
        groups[str(q)] = [(int(r), f) for r, f in zip(rels, feats)]
    return groups


def _load(split, seed):
    fname = f"{split}.txt"
    if common.have_real_data("mq2007", fname):
        return _parse_letor(os.path.join(common.DATA_HOME, "mq2007", fname))
    n = _TRAIN_QUERIES if split == "train" else _TEST_QUERIES
    return _synthetic_groups(n, seed)


def __reader__(split, seed, format="pairwise"):
    def reader():
        groups = _load(split, seed)
        for qid in sorted(groups, key=str):
            docs = list(groups[qid])
            if sum(r for r, _ in docs) == 0:
                continue              # reference query_filter: drop all-0
            if format == "pointwise":
                for rel, f in docs:
                    yield f, float(rel)
            elif format == "pairwise":
                # every (more relevant, less relevant) pair of the query
                for i, (ri, fi) in enumerate(docs):
                    for rj, fj in docs[i + 1:]:
                        if ri > rj:
                            yield 1.0, fi, fj
                        elif rj > ri:
                            yield 1.0, fj, fi
            elif format == "listwise":
                rels = np.array([r for r, _ in docs], np.float32)
                yield rels, np.stack([f for _, f in docs])
            else:
                raise ValueError(f"unknown format {format!r}")
    return reader


def train(format="pairwise"):
    return __reader__("train", 0, format=format)


def test(format="pairwise"):
    return __reader__("test", 1, format=format)


fetch = functools.partial(common.download,
                          "https://example.invalid/MQ2007.rar", "mq2007")
