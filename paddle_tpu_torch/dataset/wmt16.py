"""WMT-16 en-de, the port's copy of paddle_tpu/dataset/wmt16.py (reference:
python/paddle/v2/dataset/wmt16.py). Schema: (src_ids_with_<s>/<e>,
trg_ids_with_<s>, trg_ids_next_with_<e>) int64 sequences, with per-language
dict sizes.

Real data: drop `wmt16.tar.gz` (the reference's tokenized Multi30k-style
tarball, wmt16.py:46-48: members wmt16/train, wmt16/val, wmt16/test with
tab-separated en\\tde lines) under DATA_HOME/wmt16/ and
train/test/validation/get_dict parse it exactly as the reference
(wmt16.py:58-135): per-language frequency dicts built from the train split
with <s>/<e>/<unk> prepended and cached as {lang}_{size}.dict, source
wrapped in <s>/<e>, target emitted as (<s>+ids, ids+<e>). Synthetic
surrogate otherwise (deterministic learnable mapping)."""

from __future__ import annotations

import os
import tarfile
from collections import defaultdict

import numpy as np

from . import common

_START, _END, _UNK = 0, 1, 2
START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"
TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
_TRAIN_N, _TEST_N, _VALID_N = 2048, 256, 256
_FILE = "wmt16.tar.gz"


def _have_real():
    return common.have_real_data("wmt16", _FILE)


def _build_dict(tar_file, dict_size, save_path, lang):
    """Frequency dict over the train split (reference wmt16.py:58-74)."""
    word_dict = defaultdict(int)
    with tarfile.open(tar_file, mode="r") as f:
        for line in f.extractfile("wmt16/train"):
            line_split = line.decode("utf-8", errors="ignore").strip() \
                             .split("\t")
            if len(line_split) != 2:
                continue
            sen = line_split[0] if lang == "en" else line_split[1]
            for w in sen.split():
                word_dict[w] += 1
    with open(save_path, "w") as fout:
        fout.write(f"{START_MARK}\n{END_MARK}\n{UNK_MARK}\n")
        for idx, word in enumerate(
                sorted(word_dict.items(), key=lambda x: (-x[1], x[0]))):
            if idx + 3 == dict_size:
                break
            fout.write(f"{word[0]}\n")


def _clamp(src_dict_size, trg_dict_size, src_lang):
    """Reference wmt16.py __get_dict_size: cap requested sizes at the
    corpus vocab so the cached dict file is complete and the freshness
    check below never triggers a per-epoch rebuild."""
    src_total = TOTAL_EN_WORDS if src_lang == "en" else TOTAL_DE_WORDS
    trg_total = TOTAL_DE_WORDS if src_lang == "en" else TOTAL_EN_WORDS
    return min(src_dict_size, src_total), min(trg_dict_size, trg_total)


def _load_dict(dict_size, lang, reverse=False):
    tar_file = common.cache_path("wmt16", _FILE)
    dict_path = os.path.join(common.DATA_HOME, "wmt16",
                             f"{lang}_{dict_size}.dict")
    # the size is baked into the filename, so an existing file is valid:
    # fewer lines than dict_size just means the corpus vocab ran out
    # (rebuilding could never add more); more means corruption
    if not os.path.exists(dict_path) or (
            len(open(dict_path).readlines()) > dict_size):
        _build_dict(tar_file, dict_size, dict_path, lang)
    word_dict = {}
    with open(dict_path) as fdict:
        for idx, line in enumerate(fdict):
            if reverse:
                word_dict[idx] = line.strip()
            else:
                word_dict[line.strip()] = idx
    return word_dict


def _real_reader(file_name, src_dict_size, trg_dict_size, src_lang):
    src_dict_size, trg_dict_size = _clamp(src_dict_size, trg_dict_size,
                                          src_lang)

    def reader():
        src_dict = _load_dict(src_dict_size, src_lang)
        trg_dict = _load_dict(trg_dict_size,
                              "de" if src_lang == "en" else "en")
        start_id, end_id, unk_id = (src_dict[START_MARK],
                                    src_dict[END_MARK],
                                    src_dict[UNK_MARK])
        src_col = 0 if src_lang == "en" else 1
        trg_col = 1 - src_col
        with tarfile.open(common.cache_path("wmt16", _FILE)) as f:
            for line in f.extractfile(file_name):
                parts = line.decode("utf-8", errors="ignore").strip() \
                            .split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [start_id] + [src_dict.get(w, unk_id)
                                        for w in parts[src_col].split()] \
                    + [end_id]
                trg_ids = [trg_dict.get(w, unk_id)
                           for w in parts[trg_col].split()]
                trg_ids_next = trg_ids + [end_id]
                trg_ids = [start_id] + trg_ids
                yield src_ids, trg_ids, trg_ids_next
    return reader


def _synthetic_reader(n, src_dict_size, trg_dict_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(3, 12))
            src = rng.randint(3, src_dict_size, ln).tolist()
            trg = [(src[0] * 3 + 1) % (trg_dict_size - 3) + 3]
            for _k in range(ln - 1):
                trg.append((trg[-1] * 5 + 7) % (trg_dict_size - 3) + 3)
            yield src, [_START] + trg, trg + [_END]
    return reader


def _check_lang(src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("wrong language type: only 'en' and 'de'")


def train(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _have_real():
        return _real_reader("wmt16/train", src_dict_size, trg_dict_size,
                            src_lang)
    return _synthetic_reader(_TRAIN_N, src_dict_size, trg_dict_size, 0)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _have_real():
        return _real_reader("wmt16/test", src_dict_size, trg_dict_size,
                            src_lang)
    return _synthetic_reader(_TEST_N, src_dict_size, trg_dict_size, 1)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    _check_lang(src_lang)
    if _have_real():
        return _real_reader("wmt16/val", src_dict_size, trg_dict_size,
                            src_lang)
    return _synthetic_reader(_VALID_N, src_dict_size, trg_dict_size, 2)


def get_dict(lang, dict_size, reverse=False):
    if _have_real():
        dict_size = min(dict_size, (TOTAL_EN_WORDS if lang == "en"
                                    else TOTAL_DE_WORDS))
        return _load_dict(dict_size, lang, reverse)
    d = {START_MARK: _START, END_MARK: _END, UNK_MARK: _UNK}
    for i in range(3, dict_size):
        d[f"{lang}{i}"] = i
    if reverse:
        return {v: k for k, v in d.items()}
    return d
