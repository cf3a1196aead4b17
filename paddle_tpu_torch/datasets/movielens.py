"""Synthetic MovieLens-1M (python/paddle/dataset/movielens.py interface).
Samples follow the reference layout: [user_id, gender_id, age_id, job_id,
movie_id, category_ids(list), title_ids(list)] + [score]."""

import numpy as np

MAX_USER = 6040
MAX_MOVIE = 3952
MAX_JOB = 20
N_AGE = 7
N_CATEGORIES = 18
TITLE_VOCAB = 5174
TRAIN_SIZE = 4096
TEST_RATIO = 0.1

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [c for c in self.categories],
                [t for t in self.title]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def _movie(mid):
    n_cat = 1 + mid % 3
    cats = [(mid * 7 + k) % N_CATEGORIES for k in range(n_cat)]
    title = [(mid * 13 + k) % TITLE_VOCAB for k in range(2 + mid % 4)]
    return MovieInfo(mid, cats, title)


def _user(uid):
    return UserInfo(uid, "M" if uid % 2 else "F",
                    age_table[uid % N_AGE], uid % (MAX_JOB + 1))


def movie_info():
    return {mid: _movie(mid) for mid in range(1, MAX_MOVIE + 1)}


def user_info():
    return {uid: _user(uid) for uid in range(1, MAX_USER + 1)}


def _reader(is_test):
    def reader():
        rng = np.random.RandomState(9 if is_test else 10)
        n = int(TRAIN_SIZE * TEST_RATIO) if is_test else TRAIN_SIZE
        for _ in range(n):
            uid = int(rng.randint(1, MAX_USER + 1))
            mid = int(rng.randint(1, MAX_MOVIE + 1))
            usr = _user(uid)
            mov = _movie(mid)
            # score correlates with (uid+mid) parity bands -> learnable
            score = float(1 + ((uid * 3 + mid * 5) % 5))
            yield usr.value() + mov.value() + [score]

    return reader


def train():
    return _reader(False)


def test():
    return _reader(True)


def get_movie_title_dict():
    return {("t%d" % i): i for i in range(TITLE_VOCAB)}


def max_movie_id():
    return MAX_MOVIE


def max_user_id():
    return MAX_USER


def max_job_id():
    return MAX_JOB


def movie_categories():
    return {("c%d" % i): i for i in range(N_CATEGORIES)}


def fetch():
    pass
