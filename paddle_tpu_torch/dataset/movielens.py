"""The port's copy of paddle_tpu/dataset/movielens.py.

MovieLens-1M (reference: python/paddle/v2/dataset/movielens.py, used by
the recommender_system book chapter). Schema per sample:
([user_id], [gender_id], [age_id], [job_id], [movie_id],
 category_ids[var], title_ids[var], [score]).

Real data: drop `ml-1m.zip` (GroupLens, reference movielens.py:39) under
DATA_HOME/movielens/ and the readers parse movies.dat / users.dat /
ratings.dat exactly as the reference (movielens.py:102-159): '::'-split
records, title '(year)' suffix stripped, category and title-word dicts
built from the corpus, age bucketed by age_table, deterministic 10%
train/test split via random.Random(0), rating mapped to 2r-5. Synthetic
surrogate otherwise (same id spaces, learnable score)."""

from __future__ import annotations

import random
import re
import zipfile

import numpy as np

from . import common

USER_N = 6040
MOVIE_N = 3952
GENDER_N = 2
AGE_N = 7
JOB_N = 21
CATEGORY_N = 18
TITLE_VOCAB = 5175

_TRAIN_N, _TEST_N = 4096, 512
_FILE = "ml-1m.zip"

_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]

# parsed-once metadata caches (reference movielens.py:96-99)
_MOVIE_INFO = None      # id -> (movie_id, [cat ids], [title word ids])
_USER_INFO = None       # id -> (user_id, gender01, age_idx, job_id)
_TITLE_DICT = None
_CATEGORIES_DICT = None


def _have_real():
    return common.have_real_data("movielens", _FILE)


def _init_meta():
    """Parse movies.dat + users.dat once (reference movielens.py:102-142)."""
    global _MOVIE_INFO, _USER_INFO, _TITLE_DICT, _CATEGORIES_DICT
    if _MOVIE_INFO is not None:
        return
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    raw_movies, title_words, categories = {}, set(), set()
    with zipfile.ZipFile(common.cache_path("movielens", _FILE)) as pkg:
        with pkg.open("ml-1m/movies.dat") as f:
            for line in f:
                line = line.decode("latin1").strip()
                if not line:
                    continue
                movie_id, title, cats = line.split("::")
                cats = cats.split("|")
                categories.update(cats)
                title = pattern.match(title).group(1).strip()
                raw_movies[int(movie_id)] = (title, cats)
                for w in title.split():
                    title_words.add(w.lower())
        _TITLE_DICT = {w: i for i, w in enumerate(sorted(title_words))}
        _CATEGORIES_DICT = {c: i for i, c in enumerate(sorted(categories))}
        _MOVIE_INFO = {
            mid: (mid, [_CATEGORIES_DICT[c] for c in cats],
                  [_TITLE_DICT[w.lower()] for w in title.split()])
            for mid, (title, cats) in raw_movies.items()}
        _USER_INFO = {}
        with pkg.open("ml-1m/users.dat") as f:
            for line in f:
                line = line.decode("latin1").strip()
                if not line:
                    continue
                uid, gender, age, job = line.split("::")[:4]
                _USER_INFO[int(uid)] = (
                    int(uid), 0 if gender == "M" else 1,
                    _AGE_TABLE.index(int(age)), int(job))


def _real_reader(is_test, test_ratio=0.1, rand_seed=0):
    """ratings.dat split deterministically into train/test by
    random.Random(rand_seed) draws (reference movielens.py:145-159)."""
    def reader():
        _init_meta()
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(common.cache_path("movielens", _FILE)) as pkg:
            with pkg.open("ml-1m/ratings.dat") as f:
                for line in f:
                    line = line.decode("latin1").strip()
                    if not line:
                        continue
                    if (rand.random() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ts = line.split("::")
                    u = _USER_INFO[int(uid)]
                    m = _MOVIE_INFO[int(mid)]
                    score = float(rating) * 2 - 5.0
                    yield [u[0]], [u[1]], [u[2]], [u[3]], [m[0]], m[1], \
                        m[2], [score]
    return reader


def max_user_id():
    if _have_real():
        _init_meta()
        return max(_USER_INFO)
    return USER_N


def max_movie_id():
    if _have_real():
        _init_meta()
        return max(_MOVIE_INFO)
    return MOVIE_N


def max_job_id():
    if _have_real():
        _init_meta()
        return max(u[3] for u in _USER_INFO.values())
    return JOB_N - 1


def age_table():
    return list(_AGE_TABLE)


def movie_categories():
    if _have_real():
        _init_meta()
        return dict(_CATEGORIES_DICT)
    return {f"cat{i}": i for i in range(CATEGORY_N)}


def get_movie_title_dict():
    if _have_real():
        _init_meta()
        return dict(_TITLE_DICT)
    return {f"t{i}": i for i in range(TITLE_VOCAB)}


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            uid = int(rng.randint(1, USER_N + 1))
            gender = int(rng.randint(0, GENDER_N))
            age = int(rng.randint(0, AGE_N))
            job = int(rng.randint(0, JOB_N))
            mid = int(rng.randint(1, MOVIE_N + 1))
            ncat = int(rng.randint(1, 4))
            cats = rng.randint(0, CATEGORY_N, ncat).tolist()
            ntit = int(rng.randint(1, 6))
            titles = rng.randint(0, TITLE_VOCAB, ntit).tolist()
            # learnable score: smooth function of user/movie ids
            score = 1 + ((uid * 31 + mid * 17) % 5)
            yield [uid], [gender], [age], [job], [mid], cats, titles, \
                [float(score)]
    return reader


def train():
    if _have_real():
        return _real_reader(is_test=False)
    return _synthetic_reader(_TRAIN_N, 0)


def test():
    if _have_real():
        return _real_reader(is_test=True)
    return _synthetic_reader(_TEST_N, 1)
