"""CoNLL-2005 SRL, the port's copy of paddle_tpu/dataset/conll05.py (reference:
python/paddle/v2/dataset/conll05.py, used by the label_semantic_roles book
chapter). Schema per sample: 8 parallel variable-length int64 sequences
(word, predicate, ctx_n2..ctx_p2, mark) plus the IOB label sequence.

Real data: drop `conll05st-tests.tar.gz` plus `wordDict.txt`,
`verbDict.txt`, `targetDict.txt` (reference conll05.py:30-40) under
DATA_HOME/conll05st/ and test() parses the real corpus exactly as the
reference (conll05.py:74-198): the tarball's words.gz/props.gz member pair,
bracket-notation props converted to per-predicate IOB sequences, context
words around the B-V predicate, 2-word mark window. Synthetic surrogate
otherwise (labels tied to word ids so the task is learnable)."""

from __future__ import annotations

import gzip
import tarfile

import numpy as np

from . import common

WORD_VOCAB = 44068
PRED_VOCAB = 3162
MARK_VOCAB = 2
LABEL_N = 59

_TRAIN_N, _TEST_N = 1024, 128

_MODULE = "conll05st"
_DATA_FILE = "conll05st-tests.tar.gz"
_WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"
UNK_IDX = 0


def _have_real():
    return all(common.have_real_data(_MODULE, f) for f in
               (_DATA_FILE, "wordDict.txt", "verbDict.txt",
                "targetDict.txt"))


def load_dict(filename):
    """One token per line -> zero-based ids (reference conll05.py:66-71)."""
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def load_label_dict(filename):
    """B-/I- tag pairs from the target dict then 'O' last (reference
    conll05.py:45-62; sorted for determinism where the reference relied
    on set iteration order)."""
    tag_dict = set()
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if line.startswith("B-") or line.startswith("I-"):
                tag_dict.add(line[2:])
    d = {}
    index = 0
    for tag in sorted(tag_dict):
        d["B-" + tag] = index
        index += 1
        d["I-" + tag] = index
        index += 1
    d["O"] = index
    return d


def _corpus_reader():
    """(sentence words, predicate, IOB labels) triples from the real
    corpus: props columns are per-predicate bracket tag streams
    ('(A0*', '*', '*)' ...) converted to B-/I-/O (conll05.py:74-143)."""
    data_path = common.cache_path(_MODULE, _DATA_FILE)

    def lines(fobj):
        with gzip.GzipFile(fileobj=fobj) as g:
            for raw in g:
                yield raw.decode("utf-8", errors="ignore")

    with tarfile.open(data_path) as tf:
        words_file = lines(tf.extractfile(_WORDS_NAME))
        props_file = lines(tf.extractfile(_PROPS_NAME))
        sentences, one_seg = [], []
        for word, prop in zip(words_file, props_file):
            word = word.strip()
            label = prop.strip().split()
            if len(label) == 0:          # end of sentence
                labels = [[x[i] for x in one_seg]
                          for i in range(len(one_seg[0]))] if one_seg else []
                if len(labels) >= 1:
                    verb_list = [x for x in labels[0] if x != "-"]
                    for i, lbl in enumerate(labels[1:]):
                        cur_tag, in_bracket, lbl_seq = "O", False, []
                        for tok in lbl:
                            if tok == "*" and not in_bracket:
                                lbl_seq.append("O")
                            elif tok == "*" and in_bracket:
                                lbl_seq.append("I-" + cur_tag)
                            elif tok == "*)":
                                lbl_seq.append("I-" + cur_tag)
                                in_bracket = False
                            elif "(" in tok and ")" in tok:
                                cur_tag = tok[1:tok.find("*")]
                                lbl_seq.append("B-" + cur_tag)
                                in_bracket = False
                            elif "(" in tok:
                                cur_tag = tok[1:tok.find("*")]
                                lbl_seq.append("B-" + cur_tag)
                                in_bracket = True
                            else:
                                raise RuntimeError(
                                    f"Unexpected label: {tok}")
                        yield sentences, verb_list[i], lbl_seq
                sentences, one_seg = [], []
            else:
                sentences.append(word)
                one_seg.append(label)


def _real_reader(word_dict, predicate_dict, label_dict):
    """Map the corpus triples to the 9 id sequences (conll05.py:146-198),
    emitted in this module's (word, pred, ctx_n2..ctx_p2, mark, label)
    order."""
    def reader():
        for sentence, predicate, labels in _corpus_reader():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = "bos"
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = "bos"
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = "eos"
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = "eos"

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            pred_idx = [predicate_dict.get(predicate)] * sen_len
            ctxs = [[word_dict.get(c, UNK_IDX)] * sen_len
                    for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            label_idx = [label_dict.get(w) for w in labels]
            yield (word_idx, pred_idx, ctxs[0], ctxs[1], ctxs[2], ctxs[3],
                   ctxs[4], mark, label_idx)
    return reader


def get_dict():
    if _have_real():
        return (load_dict(common.cache_path(_MODULE, "wordDict.txt")),
                load_dict(common.cache_path(_MODULE, "verbDict.txt")),
                load_label_dict(common.cache_path(_MODULE,
                                                  "targetDict.txt")))
    word_dict = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(PRED_VOCAB)}
    label_dict = {f"l{i}": i for i in range(LABEL_N)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    if common.have_real_data(_MODULE, "emb"):
        return np.loadtxt(common.cache_path(_MODULE, "emb"),
                          dtype=np.float32)
    raise RuntimeError("pretrained emb unavailable without egress; "
                       "initialize embeddings randomly instead")


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(4, 20))
            words = rng.randint(0, 2000, ln)
            pred_id = int(rng.randint(0, PRED_VOCAB))
            pred = np.full(ln, pred_id)
            ctxs = [np.roll(words, k) for k in (-2, -1, 0, 1, 2)]
            mark = (rng.rand(ln) < 0.2).astype(np.int64)
            labels = (words * 7 + pred_id) % LABEL_N  # learnable mapping
            yield (words.tolist(), pred.tolist(),
                   ctxs[0].tolist(), ctxs[1].tolist(), ctxs[2].tolist(),
                   ctxs[3].tolist(), ctxs[4].tolist(), mark.tolist(),
                   labels.tolist())
    return reader


def test():
    if _have_real():
        return _real_reader(*get_dict())
    return _synthetic_reader(_TEST_N, 1)


def train():
    # Conll05 train data is not freely available (reference conll05.py:17
    # ships only the public test split); the real-data path serves the
    # test corpus for both, as the reference demo does.
    if _have_real():
        return _real_reader(*get_dict())
    return _synthetic_reader(_TRAIN_N, 0)
