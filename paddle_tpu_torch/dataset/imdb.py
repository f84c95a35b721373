"""The port's copy of paddle_tpu/dataset/imdb.py.

IMDB sentiment (reference: python/paddle/v2/dataset/imdb.py). Schema:
variable-length int64 word-id sequences + binary label (pos=0, neg=1).

Real data: drop `aclImdb_v1.tar.gz` (the Stanford aclImdb tarball,
reference imdb.py:31) under DATA_HOME/imdb/ and tokenize/build_dict/
train/test work exactly as the reference (imdb.py:35-124): sequential tar
scan, punctuation stripped, lowercased whitespace split, frequency-sorted
dict with '<unk>' last, cutoff 150. Synthetic surrogate otherwise: two
disjoint vocab regions by sentiment."""

from __future__ import annotations

import collections
import re
import string
import tarfile

import numpy as np

from . import common

_VOCAB = 5147  # reference word_dict size ballpark
_TRAIN_N, _TEST_N = 2048, 256
_FILE = "aclImdb_v1.tar.gz"

_PUNCT = str.maketrans("", "", string.punctuation)


def _have_real():
    return common.have_real_data("imdb", _FILE)


def tokenize(pattern):
    """Sequential scan of the tarball (reference imdb.py:35-52: tarfile
    .next(), not random access), yielding the token list of each member
    whose name matches `pattern`."""
    with tarfile.open(common.cache_path("imdb", _FILE)) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="ignore")
                yield text.rstrip("\n\r").translate(_PUNCT).lower().split()
            tf = tarf.next()


def build_dict(pattern, cutoff):
    """Frequency-sorted word dict over the matching corpus files, words
    with freq <= cutoff dropped, '<unk>' appended last (imdb.py:55-72)."""
    word_freq = collections.defaultdict(int)
    for doc in tokenize(pattern):
        for word in doc:
            word_freq[word] += 1
    word_freq = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words = [w for w, _ in dictionary]
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


_DICT_CACHE = None  # building it scans the whole 100k-doc tarball


def word_dict():
    global _DICT_CACHE
    if _have_real():
        if _DICT_CACHE is None:
            _DICT_CACHE = build_dict(
                re.compile(
                    r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
                150)
        return _DICT_CACHE
    return {f"w{i}": i for i in range(_VOCAB)}


def _real_reader(pos_pattern, neg_pattern, word_idx):
    """pos label 0, neg label 1, exactly the reference's assignment
    (imdb.py:75-90)."""
    unk = word_idx["<unk>"]

    def reader():
        for doc in tokenize(pos_pattern):
            yield [word_idx.get(w, unk) for w in doc], 0
        for doc in tokenize(neg_pattern):
            yield [word_idx.get(w, unk) for w in doc], 1

    return reader


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            ln = int(rng.randint(8, 60))
            lo = 2 + label * (_VOCAB // 2)
            hi = lo + _VOCAB // 2 - 2
            words = rng.randint(lo, hi, ln).tolist()
            yield words, label
    return reader


def train(word_idx=None):
    if _have_real():
        return _real_reader(re.compile(r"aclImdb/train/pos/.*\.txt$"),
                            re.compile(r"aclImdb/train/neg/.*\.txt$"),
                            word_dict() if word_idx is None else word_idx)
    return _synthetic_reader(_TRAIN_N, 0)


def test(word_idx=None):
    if _have_real():
        return _real_reader(re.compile(r"aclImdb/test/pos/.*\.txt$"),
                            re.compile(r"aclImdb/test/neg/.*\.txt$"),
                            word_dict() if word_idx is None else word_idx)
    return _synthetic_reader(_TEST_N, 1)
