"""The book chapters that need no sequence (LoD) op, driven through the port
on the CPU at their reference tests' budgets and thresholds, each with the
inference round trip through the port's io (save_inference_model, a load
into a fresh scope, the same predictions): tests/book/test_fit_a_line.py,
test_recognize_digits.py (mlp, conv), test_image_classification.py
[resnet] and test_word2vec.py. The chapters live in chip_smoke.py
(`BOOK`), which runs the same five on the card.
"""

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
    elif chapter.startswith("image_classification"):
        assert np.mean(res["last_losses"]) < 2.2 and res["steps"] == 31
    else:
        assert res["last_loss"] < 0.8 * res["first_loss"]
