"""Host-resident sparse embedding tables: shards, an in-process client,
and the program wiring of a table.

Counterpart of ``paddle_tpu/distributed/sparse_table.py``
(``SparseTableServer:42`` without its RPC loop, ``SparseTableClient:126``,
``DistributedEmbedding:182``).  The table lives on the host in both
packages by design: a training step computes on the [batch_ids_max, D]
rows it pulled, fed like data with the batch's ids remapped to
[0, U), and pushes the rows' gradients back after the step.  The device
never holds the table.

* ``SparseTableShard``: one shard's rows and optimizer state, the
  reference server's ``_row`` / ``_update`` logic.  Rows are drawn
  lazily from the shard's ``RandomState`` on first touch, uniform in
  [-init_scale, init_scale], in the reference's draw order (first touch
  order within a call); ``sgd`` and ``adagrad`` update them as the
  reference does.  The rows sit in one growable f32 array with sorted
  keys, so a pull or push of a DLRM-sized batch is a few vector
  operations instead of a Python loop over ids; draws and updates stay
  bitwise the reference's loop (``tests/test_torch_sparse_table.py``).
* ``SparseTableClient``: the reference client's ``pull`` / ``push`` with
  its ``id % n`` routing, over shard objects in this process.  The RPC
  transport (the reference's ``native/`` tensor RPC) is not ported.
* ``DistributedEmbedding``: ``lookup`` (one-hot: a ``gather`` of the
  pulled rows) and ``lookup_bag`` (multi-hot: one ``embedding_bag`` op)
  at build time; ``prepare_feed`` / ``prepare_feed_bags`` (pull), and
  ``grad_var`` / ``push_grads`` (push) around ``Executor.run``.
* ``server_state`` and ``SparseTableShard.state`` / ``from_state``:
  carry a shard (rows, adagrad sums, the generator's state) from a
  reference server or a port shard into a port shard, so both packages
  continue from one state.
"""

import numpy as np

__all__ = ["SparseTableShard", "SparseTableClient", "DistributedEmbedding",
           "server_state"]

_STATE_KEYS = ("dim", "optimizer", "lr", "init_scale", "rows", "g2sum",
               "rng")


class SparseTableShard:
    """One shard of a sparse embedding table and its optimizer state
    (``sgd`` or ``adagrad``, the reference's default)."""

    def __init__(self, dim, optimizer="adagrad", lr=0.05, init_scale=0.01,
                 seed=0):
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError("sparse table optimizer %r: the table runs sgd "
                             "or adagrad" % (optimizer,))
        self.dim = dim
        self.lr = lr
        self.optimizer = optimizer
        self.init_scale = init_scale
        self.rng = np.random.RandomState(seed)
        self._keys = np.zeros(0, np.int64)    # sorted global ids
        self._key_slot = np.zeros(0, np.int64)  # slot of each sorted key
        self._ids = np.zeros(0, np.int64)     # global id of each slot
        self._rows = np.zeros((0, dim), np.float32)  # slot -> row
        self._g2sum = np.zeros(0, np.float64)  # adagrad's sum of g^2
        self._has_g2 = np.zeros(0, bool)
        self._n = 0

    def _find(self, ids):
        """(slots, found) of global ids; a missing id's slot is
        meaningless."""
        if not len(self._keys):
            return np.zeros(len(ids), np.int64), np.zeros(len(ids), bool)
        pos = np.minimum(np.searchsorted(self._keys, ids),
                         len(self._keys) - 1)
        return self._key_slot[pos], self._keys[pos] == ids

    def _grow(self, n_new):
        need = self._n + n_new
        if need > len(self._rows):
            cap = max(need, 2 * len(self._rows), 1024)

            def grown(a):
                b = np.empty((cap,) + a.shape[1:], a.dtype)
                b[:self._n] = a[:self._n]
                return b

            self._rows, self._ids = grown(self._rows), grown(self._ids)
            self._g2sum, self._has_g2 = grown(self._g2sum), \
                grown(self._has_g2)

    def _insert(self, ids, rows):
        """New rows for the new, distinct global ``ids``, slots in order."""
        n = len(ids)
        self._grow(n)
        slots = np.arange(self._n, self._n + n)
        self._rows[slots] = rows
        self._ids[slots] = ids
        self._g2sum[slots] = 0.0
        self._has_g2[slots] = False
        self._n += n
        keys = np.concatenate([self._keys, ids])
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._key_slot = np.concatenate([self._key_slot, slots])[order]

    def _slots(self, ids):
        """Slots of global ``ids`` (repeats allowed), drawing the rows of
        the ids not seen before in the order of their first appearance,
        as the reference's per-id ``_row`` does."""
        slots, found = self._find(ids)
        if not found.all():
            new = ids[~found]
            _u, first = np.unique(new, return_index=True)
            new = new[np.sort(first)]
            s = self.init_scale
            self._insert(new, self.rng.uniform(
                -s, s, (len(new), self.dim)).astype(np.float32))
            slots, _found = self._find(ids)
        return slots

    def pull(self, ids):
        """Rows [len(ids), D] of the global ids, in order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if not len(ids):
            return np.zeros((0, self.dim), np.float32)
        slots = self._slots(ids)  # may grow the row array
        return self._rows[slots]

    def push(self, ids, grads):
        """Apply per-row gradients [len(ids), D], in order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if not len(ids):
            return
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        slots = self._slots(ids)
        distinct = bool(np.all(ids[1:] > ids[:-1])) \
            or len(np.unique(ids)) == len(ids)   # push_grads' ids are sorted
        if self.optimizer == "sgd" and distinct:
            self._rows[slots] -= self.lr * grads
            return
        for slot, g in zip(slots, grads):  # the reference's _update
            r = self._rows[slot]
            if self.optimizer == "adagrad":
                acc = float(self._g2sum[slot]) + float(np.sum(g * g))
                self._g2sum[slot] = acc
                self._has_g2[slot] = True
                r -= self.lr / np.sqrt(acc + 1e-10) * g
            else:
                r -= self.lr * g

    def state(self):
        """{dim, optimizer, lr, init_scale, rows: {id: row}, g2sum:
        {id: float}, rng: RandomState state}, rows in first-touch order:
        the reference server's attributes, as ``server_state`` reads
        them."""
        n = self._n
        return {"dim": self.dim, "optimizer": self.optimizer, "lr": self.lr,
                "init_scale": self.init_scale,
                "rows": {int(g): self._rows[i].copy()
                         for i, g in enumerate(self._ids[:n])},
                "g2sum": {int(g): float(self._g2sum[i])
                          for i, g in enumerate(self._ids[:n])
                          if self._has_g2[i]},
                "rng": self.rng.get_state()}

    @classmethod
    def from_state(cls, state):
        """A shard continuing from ``state`` (``state()`` or
        ``server_state``)."""
        shard = cls(state["dim"], state["optimizer"], state["lr"],
                    state["init_scale"])
        shard.rng.set_state(state["rng"])
        rows = state["rows"]
        if rows:
            ids = np.fromiter(rows, np.int64, len(rows))
            shard._insert(ids, np.stack([np.asarray(rows[int(g)],
                                                    np.float32)
                                         for g in ids]))
        if state["g2sum"]:
            ids = np.fromiter(state["g2sum"], np.int64, len(state["g2sum"]))
            slots, found = shard._find(ids)
            if not found.all():
                raise ValueError("g2sum holds ids with no row")
            shard._g2sum[slots] = list(state["g2sum"].values())
            shard._has_g2[slots] = True
        return shard


def server_state(server):
    """The state of a shard of the reference's ``SparseTableServer`` (or
    of any object with its ``dim``, ``optimizer``, ``lr``,
    ``init_scale``, ``rows``, ``g2sum`` and ``rng`` attributes), for
    ``SparseTableShard.from_state``."""
    st = {k: getattr(server, k) for k in _STATE_KEYS}
    st["rows"] = {int(g): np.array(r, np.float32)
                  for g, r in server.rows.items()}
    st["g2sum"] = {int(g): float(v) for g, v in server.g2sum.items()}
    st["rng"] = server.rng.get_state()
    return st


class SparseTableClient:
    """Trainer-side pull and push, routing ids to shards by id % n (the
    reference client's routing), over shards in this process."""

    def __init__(self, table, shards):
        self.table = table
        self.shards = list(shards)
        self.n = len(self.shards)

    def pull(self, ids):
        """ids: global row ids -> rows [len(ids), D] in order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = None
        for s, shard in enumerate(self.shards):
            m = ids % self.n == s
            rows = shard.pull(ids[m])
            if out is None:
                out = np.empty((len(ids), rows.shape[1]), np.float32)
            out[m] = rows
        return out

    def push(self, ids, grads):
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        for s, shard in enumerate(self.shards):
            m = ids % self.n == s
            shard.push(ids[m], grads[m])


class DistributedEmbedding:
    """Program wiring of a host-resident embedding table.

    Build (inside ``program_guard``)::

        demb = DistributedEmbedding("tbl", dim=128, client=client)
        out = demb.lookup_bag(batch_size, bag_size, batch_ids_max)

    Each step::

        feed, info = demb.prepare_feed_bags(bags)      # pulls the rows
        outs = exe.run(main, feed={**data_feed, **feed},
                       fetch_list=[loss, demb.grad_var(main)])
        demb.push_grads(info, outs[-1])                # pushes row grads
    """

    def __init__(self, table, dim, client=None):
        self.table = table
        self.dim = dim
        self.client = client
        self.rows_name = table + "@rows"
        self.local_ids_name = table + "@local_ids"
        self.max_rows = None
        self.bag_size = None

    def _rows_var(self, batch_ids_max):
        from .. import layers

        self.max_rows = batch_ids_max
        return layers.data(self.rows_name, shape=[batch_ids_max, self.dim],
                           append_batch_size=False, stop_gradient=False)

    def lookup(self, ids_var, batch_ids_max):
        """One id a sample: a ``gather`` of the pulled rows.
        ``batch_ids_max`` bounds the unique ids of a batch (rows are
        zero-padded to it, so every step has one shape)."""
        from .. import layers

        rows = self._rows_var(batch_ids_max)
        local = layers.data(self.local_ids_name, shape=[], dtype="int64")
        return layers.gather(rows, local)

    def lookup_bag(self, batch_size, bag_size, batch_ids_max):
        """Up to ``bag_size`` ids a sample: Out[b] = the sum of the
        sample's rows, one ``embedding_bag`` op over the pulled
        [batch_ids_max, D] rows and [B, K] local ids (-1 pads a ragged
        bag); ``FLAGS_use_pallas_embedding_bag`` routes it to the
        embedding-bag kernel.  Feed it with ``prepare_feed_bags``."""
        from .. import layers
        from ..layer_helper import LayerHelper

        self.bag_size = bag_size
        rows = self._rows_var(batch_ids_max)
        local = layers.data(self.local_ids_name,
                            shape=[batch_size, bag_size], dtype="int64",
                            append_batch_size=False)
        helper = LayerHelper("embedding_bag", name=self.table + "_bag")
        out = helper.create_variable_for_type_inference(rows.dtype)
        helper.append_op(type="embedding_bag",
                         inputs={"W": [rows], "Ids": [local]},
                         outputs={"Out": [out]}, attrs={"mode": "sum"})
        return out

    def _pull_padded(self, uniq):
        n = len(uniq)
        if n > self.max_rows:
            raise ValueError("batch touches %d unique rows > "
                             "batch_ids_max=%d" % (n, self.max_rows))
        padded = np.empty((self.max_rows, self.dim), np.float32)
        padded[:n] = self.client.pull(uniq)
        padded[n:] = 0.0
        return padded

    def prepare_feed_bags(self, bags):
        """Pull the rows of B bags of global ids (a sequence of id
        sequences, each at most bag_size long, or a [B, K] array) ->
        (feed dict, push info); shorter bags are -1-padded."""
        if self.max_rows is None or self.bag_size is None:
            raise RuntimeError("call lookup_bag() during program build first")
        if isinstance(bags, np.ndarray) and bags.ndim == 2:
            flat = bags.astype(np.int64).reshape(-1)
            lengths = np.full(len(bags), bags.shape[1], np.int64)
        else:
            parts = [np.asarray(b, np.int64).reshape(-1) for b in bags]
            flat = np.concatenate(parts) if parts \
                else np.zeros((0,), np.int64)
            lengths = np.array([len(p) for p in parts], np.int64)
        uniq, inverse = np.unique(flat, return_inverse=True)
        padded = self._pull_padded(uniq)
        over = np.nonzero(lengths > self.bag_size)[0]
        if len(over):
            i = int(over[0])
            raise ValueError("bag %d has %d ids > bag_size=%d"
                             % (i, lengths[i], self.bag_size))
        local = np.full((len(lengths), self.bag_size), -1, np.int64)
        row = np.repeat(np.arange(len(lengths)), lengths)
        col = np.arange(len(flat)) - np.repeat(np.cumsum(lengths) - lengths,
                                               lengths)
        local[row, col] = inverse.reshape(-1)
        return ({self.rows_name: padded, self.local_ids_name: local},
                {"uniq": uniq, "n": len(uniq), "batch": len(lengths)})

    def prepare_feed(self, ids):
        """Pull the rows of one id a sample -> (feed dict, push info)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        uniq, inverse = np.unique(ids, return_inverse=True)
        if self.max_rows is None:
            raise RuntimeError("call lookup() during program build first")
        padded = self._pull_padded(uniq)
        return ({self.rows_name: padded,
                 self.local_ids_name: inverse.reshape(-1).astype(np.int64)},
                {"uniq": uniq, "n": len(uniq), "batch": len(ids)})

    def grad_var(self, program):
        return program.global_block().var(self.rows_name + "@GRAD")

    def push_grads(self, info, rows_grad):
        self.client.push(info["uniq"], np.asarray(rows_grad)[:info["n"]])
