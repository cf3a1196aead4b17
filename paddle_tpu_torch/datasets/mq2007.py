"""Synthetic LETOR MQ2007 learning-to-rank
(python/paddle/dataset/mq2007.py interface: __reader__ with pointwise /
pairwise / listwise formats).  46-dim feature vectors whose first feature
correlates with relevance, so rankers can learn."""

import numpy as np

FEATURE_DIM = 46
N_QUERIES = 120
DOCS_PER_QUERY = (5, 20)


class Query:
    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []


class QueryList:
    def __init__(self, querylist=None):
        self.querylist = querylist or []

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda q: -q.relevance_score)


def _queries(seed):
    rng = np.random.RandomState(seed)
    for qid in range(N_QUERIES):
        n = int(rng.randint(*DOCS_PER_QUERY))
        ql = QueryList()
        for _ in range(n):
            rel = int(rng.randint(0, 3))
            fv = rng.rand(FEATURE_DIM).astype("float64")
            fv[0] = rel / 2.0 + 0.1 * rng.randn()  # learnable signal
            ql.querylist.append(Query(qid, rel, list(fv)))
        yield ql


def gen_point(querylist):
    for q in querylist:
        yield q.relevance_score, np.array(q.feature_vector)


def gen_pair(querylist, partial_order="full"):
    querylist._correct_ranking_()
    for i, qi in enumerate(querylist):
        for qj in querylist[i + 1:]:
            if qi.relevance_score > qj.relevance_score:
                yield (1, np.array(qi.feature_vector),
                       np.array(qj.feature_vector))


def gen_list(querylist):
    querylist._correct_ranking_()
    labels = [q.relevance_score for q in querylist]
    features = [q.feature_vector for q in querylist]
    yield np.array(labels), np.array(features)


def __reader__(filepath=None, format="pairwise", shuffle=False,
               fill_missing=-1, seed=71):
    def reader():
        gen = {"pointwise": gen_point, "pairwise": gen_pair,
               "listwise": gen_list}[format]
        for ql in _queries(seed):
            for sample in gen(ql):
                yield sample

    return reader


def train(format="pairwise"):
    return __reader__(format=format, seed=71)


def test(format="pairwise"):
    return __reader__(format=format, seed=72)


def fetch():
    pass
