"""Datasets, the port's copy of the part of paddle_tpu/dataset that its
book chapters and its training smoke read (reference:
python/paddle/v2/dataset/). Each module parses the reference's real
on-disk format when the file is present under common.DATA_HOME, and
otherwise serves the JAX package's deterministic synthetic surrogate with
the same schema: the same samples from the same seed, so both packages
stream identical data. No module downloads anything.

uci_housing (fit_a_line), mnist (recognize_digits), cifar
(image_classification), imikolov (word2vec), flowers (ResNet-50 training
on the card), imdb (understand_sentiment), movielens (recommender_system)
and sentiment; conll05 (label_semantic_roles), wmt14 and wmt16
(machine_translation); mq2007 (learning to rank); voc2012 (segmentation:
images and class masks)."""

from . import (cifar, common, conll05, flowers, imdb, imikolov, mnist,
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)

__all__ = ["cifar", "common", "conll05", "flowers", "imdb", "imikolov",
           "mnist", "movielens", "mq2007", "sentiment", "uci_housing",
           "voc2012", "wmt14", "wmt16"]
