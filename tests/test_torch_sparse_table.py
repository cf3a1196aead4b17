"""The sparse-table path of the PyTorch port
(paddle_tpu_torch/distributed/sparse_table.py) held against the JAX
package's ``distributed/sparse_table.py`` on the CPU.

* A shard against the reference's ``SparseTableServer`` row logic,
  called directly with no RPC (``_row``, ``_update``): the lazy draws,
  the ``sgd`` and ``adagrad`` updates, repeated and never-pulled ids;
  bitwise over many rounds.
* The client's ``id % n`` routing against the reference's client and two
  servers over their RPC transport on localhost: bitwise.
* ``DistributedEmbedding``: ``lookup_bag`` / ``prepare_feed_bags`` and
  ``lookup`` / ``prepare_feed`` with the stub client of
  ``tests/test_pallas_blocks.py`` (row i holds i + 1): the same programs,
  feeds and ``ValueError``s, and the outputs through the port's Executor
  with the embedding-bag flag off and on.
* The state carry: a reference server's rows, adagrad sums and generator
  state into a port shard, which then continues bitwise."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.distributed.sparse_table import (
    DistributedEmbedding as JEmb, SparseTableClient as JClient,
    SparseTableServer as JServer)
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
import paddle_tpu_torch.layers  # noqa: F401  (pkg.layers in _both)
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import Executor, Scope
from paddle_tpu_torch.distributed import (DistributedEmbedding,
                                          SparseTableClient,
                                          SparseTableShard, server_state)
from paddle_tpu_torch.utils import unique_name as tun

FLAG = "FLAGS_use_pallas_embedding_bag"
DIM = 16


def ref_server(dim=DIM, optimizer="sgd", lr=0.3, init_scale=0.05, seed=0):
    """The reference's server without its RPC endpoint: its row logic."""
    s = JServer.__new__(JServer)
    s.dim, s.lr, s.optimizer, s.init_scale = dim, lr, optimizer, init_scale
    s.rows, s.g2sum = {}, {}
    s.rng = np.random.RandomState(seed)
    return s


def _rounds(rng, n=30, span=400):
    for _ in range(n):
        pull = rng.randint(0, span, 40)          # repeats allowed
        push = np.unique(rng.randint(0, span + 100, 25))  # some never pulled
        yield pull, push, rng.randn(len(push), DIM).astype(np.float32)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_shard_bitwise_equals_reference_server(optimizer):
    ref = ref_server(optimizer=optimizer, seed=3)
    port = SparseTableShard(DIM, optimizer, 0.3, 0.05, seed=3)
    for pull, push, g in _rounds(np.random.RandomState(0)):
        want = np.stack([ref._row(int(i)) for i in pull])
        np.testing.assert_array_equal(port.pull(pull), want)
        for i, gid in enumerate(push):
            ref._update(int(gid), g[i])
        port.push(push, g)
    st = port.state()
    assert list(st["rows"]) == list(ref.rows)  # first-touch order
    for gid, row in ref.rows.items():
        np.testing.assert_array_equal(st["rows"][gid], row)
    assert st["g2sum"] == ref.g2sum


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_push_with_repeated_ids_applies_each_in_order(optimizer):
    ref = ref_server(optimizer=optimizer, seed=5)
    port = SparseTableShard(DIM, optimizer, 0.3, 0.05, seed=5)
    ids = np.array([4, 9, 4, 4, 2], np.int64)
    g = np.random.RandomState(1).randn(len(ids), DIM).astype(np.float32)
    for i, gid in enumerate(ids):
        ref._update(int(gid), g[i])
    port.push(ids, g)
    np.testing.assert_array_equal(
        port.pull([4, 9, 2, 7]),
        np.stack([ref._row(i) for i in (4, 9, 2, 7)]))


def test_state_carry_continues_bitwise():
    ref = ref_server(optimizer="adagrad", seed=7)
    rng = np.random.RandomState(2)
    rounds = list(_rounds(rng, n=20))
    for pull, push, g in rounds[:10]:
        [ref._row(int(i)) for i in pull]
        for i, gid in enumerate(push):
            ref._update(int(gid), g[i])
    port = SparseTableShard.from_state(server_state(ref))
    again = SparseTableShard.from_state(port.state())
    for pull, push, g in rounds[10:]:
        want = np.stack([ref._row(int(i)) for i in pull])
        np.testing.assert_array_equal(port.pull(pull), want)
        np.testing.assert_array_equal(again.pull(pull), want)
        for i, gid in enumerate(push):
            ref._update(int(gid), g[i])
        port.push(push, g)
        again.push(push, g)
    assert port.state()["g2sum"] == ref.g2sum == again.state()["g2sum"]


def test_client_routing_bitwise_equals_reference_over_rpc():
    servers = [JServer(0, dim=DIM, optimizer="sgd", lr=0.5, seed=s)
               for s in range(2)]
    for s in servers:
        s.start_thread()
    jc = JClient("emb", ["127.0.0.1:%d" % s.port for s in servers])
    tc = SparseTableClient("emb", [SparseTableShard(DIM, "sgd", 0.5,
                                                    seed=s)
                                   for s in range(2)])
    try:
        rng = np.random.RandomState(4)
        for _ in range(4):
            ids = rng.randint(0, 60, 17).astype(np.int64)
            np.testing.assert_array_equal(tc.pull(ids), jc.pull(ids))
            u = np.unique(ids)
            g = rng.randn(len(u), DIM).astype(np.float32)
            jc.push(u, g)
            tc.push(u, g)
        ids = np.arange(60, dtype=np.int64)
        np.testing.assert_array_equal(tc.pull(ids), jc.pull(ids))
    finally:
        jc.complete()
        jc.close()
        for s in servers:
            s.shutdown()
    for s, shard in enumerate(tc.shards):   # each id lives on shard id % 2
        assert all(g % 2 == s for g in shard.state()["rows"])


class _StubClient:
    """pull() returns row i filled with i + 1, so sums are predictable
    (``tests/test_pallas_blocks.py``'s stub)."""

    def __init__(self, dim):
        self.dim = dim
        self.pushed = []

    def pull(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        if not len(ids):
            return np.zeros((0, self.dim), np.float32)
        return np.stack([np.full((self.dim,), float(i + 1), np.float32)
                         for i in ids])

    def push(self, ids, grads):
        self.pushed.append((np.asarray(ids), np.asarray(grads)))


def _both(build):
    """``build(fluid_module, emb_cls)`` in both packages -> ((JAX main,
    startup, result), (port main, startup, result))."""
    import paddle_tpu_torch

    out = []
    for pkg, fw, un, emb in ((fluid, fluid, jun, JEmb),
                             (paddle_tpu_torch, tfw, tun,
                              DistributedEmbedding)):
        main, startup = fw.Program(), fw.Program()
        with un.guard(), fw.program_guard(main, startup):
            res = build(pkg, emb)
        out.append((main, startup, res))
    return out


def test_lookup_bag_program_feed_and_outputs():
    d = 128
    (jm, _js, (jemb, _jo)), (tm, ts, (temb, tout)) = _both(
        lambda pkg, emb: (lambda e: (e, e.lookup_bag(3, 4, 8)))(
            emb("tbl", d, client=_StubClient(d))))
    assert tm.to_dict() == jm.to_dict()
    bags = [[5, 9], [9], []]
    want_feed, want_info = jemb.prepare_feed_bags(bags)
    feed, info = temb.prepare_feed_bags(bags)
    assert set(feed) == set(want_feed)
    for k in feed:
        np.testing.assert_array_equal(feed[k], want_feed[k])
    assert info["n"] == want_info["n"] == 2
    np.testing.assert_array_equal(info["uniq"], want_info["uniq"])
    # a [B, K] array feeds like the same bags as lists
    arr_feed, _ = temb.prepare_feed_bags(np.array([[5, 9], [9, 5], [5, 5]]))
    np.testing.assert_array_equal(arr_feed[temb.local_ids_name],
                                  [[0, 1, -1, -1], [1, 0, -1, -1],
                                   [0, 0, -1, -1]])
    expected = np.zeros((3, d), np.float32)
    expected[0] = 6.0 + 10.0
    expected[1] = 10.0
    exe = Executor(tfw.CPUPlace())
    saved = tflags.get_flags([FLAG])
    try:
        for on in (False, True):
            tflags.set_flags({FLAG: on})
            got, = exe.run(tm, feed=feed, fetch_list=[tout], scope=Scope())
            np.testing.assert_array_equal(got, expected)
    finally:
        tflags.set_flags(saved)


@pytest.mark.parametrize("bags, match", [
    ([[1, 2, 3], [4]], "unique rows"),     # 4 unique ids > batch_ids_max 3
    ([[1, 2, 3], [1]], "bag_size"),        # a bag longer than bag_size
])
def test_prepare_feed_bags_raises_as_reference(bags, match):
    d = 128
    (_jm, _js, jemb), (_tm, _ts, temb) = _both(
        lambda pkg, emb: (lambda e: (e.lookup_bag(2, 2, 3), e)[1])(
            emb("tbl2", d, client=_StubClient(d))))
    with pytest.raises(ValueError, match=match) as want:
        jemb.prepare_feed_bags(bags)
    with pytest.raises(ValueError, match=match) as got:
        temb.prepare_feed_bags(bags)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="lookup_bag"):
        DistributedEmbedding("t", d).prepare_feed_bags([[1]])


def test_lookup_gather_program_feed_and_outputs():
    d = 8

    def build(pkg, emb):
        e = emb("tbl3", d, client=_StubClient(d))
        ids = pkg.layers.data("ids", shape=[1], dtype="int64")
        return e, e.lookup(ids, batch_ids_max=6)

    (jm, _js, (jemb, _jo)), (tm, _ts, (temb, tout)) = _both(build)
    assert tm.to_dict() == jm.to_dict()
    ids = np.array([7, 3, 7, 11], np.int64)
    want_feed, want_info = jemb.prepare_feed(ids)
    feed, info = temb.prepare_feed(ids)
    for k in feed:
        np.testing.assert_array_equal(feed[k], want_feed[k])
    np.testing.assert_array_equal(info["uniq"], want_info["uniq"])
    got, = Executor(tfw.CPUPlace()).run(tm, feed=feed, fetch_list=[tout],
                                        scope=Scope())
    np.testing.assert_array_equal(got[:, 0], ids + 1.0)
    with pytest.raises(ValueError, match="unique rows"):
        temb.prepare_feed(np.arange(7))
    temb.push_grads(info, np.ones((6, d), np.float32))
    pushed_ids, pushed = temb.client.pushed[-1]
    np.testing.assert_array_equal(pushed_ids, [3, 7, 11])
    assert pushed.shape == (3, d)


def test_shard_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="sgd or adagrad"):
        SparseTableShard(DIM, "adam")
    assert SparseTableShard(DIM).pull([]).shape == (0, DIM)
