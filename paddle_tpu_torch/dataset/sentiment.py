"""The port's copy of paddle_tpu/dataset/sentiment.py.

NLTK movie-review sentiment corpus (reference:
python/paddle/v2/dataset/sentiment.py). Schema: (word-id sequence, label
0/1 = negative/positive).

Real data: drop the nltk corpus directory `corpora/movie_reviews/` (with
neg/*.txt and pos/*.txt, exactly what `nltk.download('movie_reviews')`
unpacks — reference sentiment.py:36-50) under DATA_HOME/sentiment/ and
get_word_dict/train/test parse it as the reference does
(sentiment.py:53-100): frequency-sorted word dict over the whole corpus,
neg/pos files interleaved so train/test splits stay balanced, word
tokenization approximating nltk's (word chars and punctuation runs as
separate tokens, lowercased). Synthetic surrogate otherwise."""

from __future__ import annotations

import os
import re

import numpy as np

from . import common

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 2048

_TOKEN = re.compile(r"[A-Za-z0-9_']+|[^\sA-Za-z0-9_']")


def _corpus_dir():
    for sub in ("corpora/movie_reviews", "movie_reviews"):
        d = os.path.join(common.DATA_HOME, "sentiment", sub)
        if os.path.isdir(d):
            return d
    return None


def _files(cat):
    d = _corpus_dir()
    sub = os.path.join(d, cat)
    return [os.path.join(sub, f) for f in sorted(os.listdir(sub))
            if f.endswith(".txt")]


def _words(path):
    with open(path, encoding="utf-8", errors="ignore") as f:
        return [w.lower() for w in _TOKEN.findall(f.read())]


def get_word_dict():
    """[(word, id)] sorted by corpus frequency, most frequent first
    (reference sentiment.py:53-71)."""
    if _corpus_dir() is None:
        return [(f"w{i}", i) for i in range(_VOCAB)]
    freq = {}
    for cat in ("neg", "pos"):
        for path in _files(cat):
            for w in _words(path):
                freq[w] = freq.get(w, 0) + 1
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(w, i) for i, (w, _) in enumerate(ranked)]


_DATA_CACHE = None  # parse-once (movielens._init_meta pattern)


def _load_real():
    """Interleave neg/pos files (sentiment.py:74-100: label 0=neg, 1=pos)
    so any prefix split is balanced. Parsed once per process — a reader
    is re-invoked every epoch and the corpus is 2000 files."""
    global _DATA_CACHE
    if _DATA_CACHE is not None:
        return _DATA_CACHE
    words_ids = dict(get_word_dict())
    data = []
    for neg, pos in zip(_files("neg"), _files("pos")):
        data.append(([words_ids[w] for w in _words(neg)], 0))
        data.append(([words_ids[w] for w in _words(pos)], 1))
    _DATA_CACHE = data
    return data


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            ln = int(rng.randint(10, 50))
            lo = 2 + label * (_VOCAB // 2)
            hi = lo + _VOCAB // 2 - 2
            yield rng.randint(lo, hi, ln).tolist(), label
    return reader


def _real_reader(lo, hi):
    def reader():
        data = _load_real()
        n = len(data)
        lo_i = min(lo, n)
        hi_i = min(hi, n)
        for sample in data[lo_i:hi_i]:
            yield sample
    return reader


def train():
    if _corpus_dir() is not None:
        return _real_reader(0, NUM_TRAINING_INSTANCES)
    return _synthetic_reader(NUM_TRAINING_INSTANCES, 0)


def test():
    if _corpus_dir() is not None:
        return _real_reader(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES)
    return _synthetic_reader(NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, 1)
