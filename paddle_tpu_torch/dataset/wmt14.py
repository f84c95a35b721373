"""WMT-14 fr-en, the port's copy of paddle_tpu/dataset/wmt14.py (reference:
python/paddle/v2/dataset/wmt14.py, used by the machine_translation book
chapter). Schema: (src_ids, trg_ids_with_<s>, trg_ids_next_with_<e>)
variable-length int64 sequences.

Real data: drop `wmt14.tgz` (the reference's shrunk training tarball,
wmt14.py:40-42: members train/train, test/test plus src.dict/trg.dict) under
DATA_HOME/wmt14/ and train/test/get_dict parse it exactly as the reference
(wmt14.py:53-110): first dict_size dict lines become ids, tab-separated
parallel lines, source wrapped <s>...<e>, UNK id 2, pairs longer than 80
tokens dropped, target emitted as (<s>+ids, ids+<e>). Synthetic surrogate
otherwise: target = deterministic function of source, so seq2seq+attention
can learn it."""

from __future__ import annotations

import tarfile

import numpy as np

from . import common

_START, _END, _UNK = 0, 1, 2
START, END, UNK = "<s>", "<e>", "<unk>"
UNK_IDX = _UNK

_TRAIN_N, _TEST_N = 2048, 256
_FILE = "wmt14.tgz"


def _have_real():
    return common.have_real_data("wmt14", _FILE)


def _default_dict(size):
    d = {START: _START, END: _END, UNK: _UNK}
    for i in range(3, size):
        d[f"w{i}"] = i
    return d


def _read_to_dict(dict_size):
    """First dict_size lines of the tarball's src.dict/trg.dict members
    (reference wmt14.py:53-76)."""
    def to_dict(fd, size):
        out = {}
        for line_count, line in enumerate(fd):
            if line_count >= size:
                break
            out[line.decode("utf-8", errors="ignore").strip()] = line_count
        return out

    with tarfile.open(common.cache_path("wmt14", _FILE)) as f:
        src_name, = [m.name for m in f if m.name.endswith("src.dict")]
        src_dict = to_dict(f.extractfile(src_name), dict_size)
        trg_name, = [m.name for m in f if m.name.endswith("trg.dict")]
        trg_dict = to_dict(f.extractfile(trg_name), dict_size)
    return src_dict, trg_dict


def _real_reader(file_name, dict_size):
    # parse the dicts once per reader construction, not once per epoch
    src_dict, trg_dict = _read_to_dict(dict_size)

    def reader():
        with tarfile.open(common.cache_path("wmt14", _FILE)) as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    line = line.decode("utf-8", errors="ignore")
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, _UNK)
                               for w in [START] + src_words + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, _UNK) for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_ids_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next
    return reader


def _synthetic_reader(n, dict_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, ln).tolist()
            # target = deterministic chain seeded by the source head: the
            # step-to-step rule is learnable via teacher forcing, the seed
            # via the encoder/attention path
            trg = [(src[0] * 3 + 1) % (dict_size - 3) + 3]
            for _k in range(ln - 1):
                trg.append((trg[-1] * 5 + 7) % (dict_size - 3) + 3)
            yield src, [_START] + trg, trg + [_END]
    return reader


def train(dict_size):
    if _have_real():
        return _real_reader("train/train", dict_size)
    return _synthetic_reader(_TRAIN_N, dict_size, 0)


def test(dict_size):
    if _have_real():
        return _real_reader("test/test", dict_size)
    return _synthetic_reader(_TEST_N, dict_size, 1)


def get_dict(dict_size, reverse=False):
    if _have_real():
        src, trg = _read_to_dict(dict_size)
    else:
        src, trg = _default_dict(dict_size), _default_dict(dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg
