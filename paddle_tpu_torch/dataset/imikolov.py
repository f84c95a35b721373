"""PTB language-model data, the port's copy of paddle_tpu/dataset/imikolov.py
(reference: python/paddle/v2/dataset/
imikolov.py, used by the word2vec book chapter). Schema: n-gram tuples of
int64 word ids (NGRAM) or (src_seq, trg_seq) pairs (SEQ).

Real data: drop `simple-examples.tgz` (the Mikolov PTB tarball, reference
imikolov.py URL) under DATA_HOME/imikolov/ and build_dict/train/test parse
it exactly as the reference (imikolov.py:36-104): word freq over
ptb.train+ptb.valid with '<s>'/'<e>' counted per line, min_word_freq
cutoff, freq-then-lex sort, '<unk>' last; NGRAM slides a window over
'<s>' + words + '<e>', SEQ yields ('<s>'+ids, ids+'<e>') skipping
sentences longer than n. Synthetic surrogate otherwise: deterministic
successor chains so the n-gram task is learnable."""

from __future__ import annotations

import collections
import tarfile

import numpy as np

from . import common

_VOCAB = 2074
_TRAIN_N, _TEST_N = 4096, 512
_FILE = "simple-examples.tgz"
_TRAIN_MEMBER = "simple-examples/data/ptb.train.txt"
_TEST_MEMBER = "simple-examples/data/ptb.valid.txt"


class DataType:
    NGRAM = 1
    SEQ = 2


def _have_real():
    return common.have_real_data("imikolov", _FILE)


def _extract(tf, member):
    # upstream tarballs prefix members with './'
    try:
        return tf.extractfile(member)
    except KeyError:
        return tf.extractfile("./" + member)


def word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="ignore")
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict(min_word_freq=50):
    if not _have_real():
        return {f"w{i}": i for i in range(_VOCAB)}
    with tarfile.open(common.cache_path("imikolov", _FILE)) as tf:
        word_freq = word_count(_extract(tf, _TEST_MEMBER),
                               word_count(_extract(tf, _TRAIN_MEMBER)))
    word_freq.pop("<unk>", None)  # re-added as the last index below
    word_freq = [x for x in word_freq.items() if x[1] > min_word_freq]
    word_freq_sorted = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words = [w for w, _ in word_freq_sorted]
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


def _real_reader(member, word_idx, n, data_type):
    def reader():
        with tarfile.open(common.cache_path("imikolov", _FILE)) as tf:
            unk = word_idx["<unk>"]
            for line in _extract(tf, member):
                if isinstance(line, bytes):
                    line = line.decode("utf-8", errors="ignore")
                if data_type == DataType.NGRAM:
                    assert n > -1, "Invalid gram length"
                    toks = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(toks) >= n:
                        ids = [word_idx.get(w, unk) for w in toks]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif data_type == DataType.SEQ:
                    ids = [word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src_seq = [word_idx["<s>"]] + ids
                    trg_seq = ids + [word_idx["<e>"]]
                    if n > 0 and len(src_seq) > n:
                        continue
                    yield src_seq, trg_seq
                else:
                    raise AssertionError("Unknown data type")
    return reader


def _synthetic_reader(n_samples, n, seed, data_type):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            # active ids restricted to a subset so each id recurs often
            # enough for the n-gram task to be learnable in a short budget
            start = int(rng.randint(0, 256))
            # deterministic successor chain => learnable next-word task
            gram = [(start + 7 * k) % _VOCAB for k in range(max(n, 2))]
            if data_type == DataType.NGRAM:
                yield tuple(gram)
            else:
                yield gram, gram[1:] + [(gram[-1] + 7) % _VOCAB]
    return reader


def train(word_idx=None, n=5, data_type=DataType.NGRAM):
    if _have_real():
        return _real_reader(_TRAIN_MEMBER, build_dict() if word_idx is None else word_idx, n,
                            data_type)
    return _synthetic_reader(_TRAIN_N, n, 0, data_type)


def test(word_idx=None, n=5, data_type=DataType.NGRAM):
    if _have_real():
        return _real_reader(_TEST_MEMBER, build_dict() if word_idx is None else word_idx, n,
                            data_type)
    return _synthetic_reader(_TEST_N, n, 1, data_type)
