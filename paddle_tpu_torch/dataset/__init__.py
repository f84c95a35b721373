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
and sentiment. The JAX package's other five (conll05, mq2007, voc2012,
wmt14, wmt16) feed chapters the port has not yet."""

from . import (cifar, common, flowers, imdb, imikolov, mnist, movielens,
               sentiment, uci_housing)

__all__ = ["cifar", "common", "flowers", "imdb", "imikolov", "mnist",
           "movielens", "sentiment", "uci_housing"]
