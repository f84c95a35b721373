"""The book chapters the port runs, driven through it on the CPU at their
reference tests' budgets and thresholds, each with the inference round
trip through the port's io (save_inference_model, a load into a fresh
scope, the same predictions): tests/book/test_fit_a_line.py,
test_recognize_digits.py (mlp, conv), test_image_classification.py
(resnet, vgg), test_word2vec.py, test_understand_sentiment.py (conv,
stacked_lstm: LoDTensor feeds, the round trip over a LoDTensor) and
test_recommender_system.py (LoD category and title slots),
test_machine_translation.py (training; decoding with While, beam_search
and greedy), test_label_semantic_roles.py (the CRF and Viterbi) and
test_beam_search_decode.py. The chapters live in chip_smoke.py (`BOOK`),
which runs the same thirteen on the card.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402


@pytest.mark.parametrize("chapter", sorted(chip_smoke.BOOK))
def test_book_chapter(chapter):
    res = chip_smoke.BOOK[chapter](pt, pt.CPUPlace())
    assert res["steps"] > 0
    if chapter == "fit_a_line":
        assert res["last_loss"] < 1.0
    elif chapter.startswith("recognize_digits"):
        assert np.mean(res["last_accuracy"]) > 0.7
        assert np.mean(res["last_losses"]) < 1.0
        assert res["steps"] == 61
    elif chapter == "image_classification[vgg]":
        assert np.mean(res["last_losses"]) < np.mean(res["first_losses"])
        assert res["steps"] == 16
    elif chapter.startswith("image_classification"):
        assert np.mean(res["last_losses"]) < 2.2 and res["steps"] == 31
    elif chapter.startswith("understand_sentiment"):
        assert np.mean(res["last_accuracy"]) > 0.8 and res["steps"] == 31
    elif chapter == "machine_translation[train]":
        assert np.mean(res["last_losses"]) < 0.8 * res["first_loss"]
        assert res["steps"] == 202
    elif chapter == "machine_translation[decode]":
        assert res["last_loss"] < res["first_loss"] and res["steps"] == 30
        assert np.all(np.asarray(res["beam_best"])
                      >= np.asarray(res["greedy"]) - 1e-4)
    elif chapter == "label_semantic_roles":
        assert np.mean(res["last_losses"]) < 0.7 * np.mean(res["first_losses"])
        assert res["steps"] == 55
    elif chapter == "beam_search_decode":
        assert len(res["best_scores"]) == 2
    elif chapter == "recommender_system":
        assert res["last_loss"] < res["first_loss"]
        assert np.mean(res["last_losses"]) < 2.5 and res["steps"] == 41
    else:
        assert res["last_loss"] < 0.8 * res["first_loss"]
