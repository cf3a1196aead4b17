"""DLRM through the PyTorch port's sparse-table path, held against the JAX
package on the CPU.

DLRM-tiny (``chip_smoke.DLRM_TINY``: 3 tables of width 128 with bags of
3, 1 and 5 ids, one table smaller than a batch's ids; bottom MLP
13-32-128, top 64-1; batch 8) is built by ``chip_smoke.build_dlrm`` in
both packages, each with its own ``DistributedEmbedding``: the reference
over its ``SparseTableServer`` row logic in this process (no RPC), the
port over its ``SparseTableShard``s carried from the same servers.

* Programs: main and startup equal through ``to_dict()``, also after
  the optimizer fusion (one ``fused_sgd`` over the 8 dense parameters).
* 5 SGD steps on one batch under ``FLAGS_use_pallas_embedding_bag``, the
  reference's bag kernel in interpret mode, the port's on its plain
  version: losses within 1e-5; the dense parameters and every table row
  after the steps within 1e-5 of each tensor's largest element (f32,
  other summation orders)."""

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.distributed.sparse_table import (
    DistributedEmbedding as JEmb, SparseTableServer as JServer)
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.distributed import (DistributedEmbedding,
                                          SparseTableClient,
                                          SparseTableShard, server_state)
from paddle_tpu_torch.utils import unique_name as tun

FLAG = "FLAGS_use_pallas_embedding_bag"
CFG = cs.DLRM_TINY
BATCH = 8
STEPS = 5
LR = cs.DLRM_LR
LOSS_ATOL = 1e-5
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _kernel_route(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    saved_j, saved_t = fluid.get_flags([FLAG]), tflags.get_flags([FLAG])
    adoption.reset()
    fluid.set_flags({FLAG: True})
    tflags.set_flags({FLAG: True})
    yield
    fluid.set_flags(saved_j)
    tflags.set_flags(saved_t)
    adoption.reset()


class _RefClient:
    """The reference client's ``id % n`` routing over its servers' row
    logic (``_row`` / ``_update``) in this process."""

    def __init__(self, servers):
        self.servers = servers
        self.n = len(servers)

    def pull(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.zeros((len(ids), self.servers[0].dim), np.float32)
        for s, srv in enumerate(self.servers):
            m = ids % self.n == s
            if m.any():
                out[m] = np.stack([srv._row(int(g)) for g in ids[m]])
        return out

    def push(self, ids, grads):
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        for s, srv in enumerate(self.servers):
            m = ids % self.n == s
            for gid, g in zip(ids[m], grads[m]):
                srv._update(int(gid), g)


def _ref_servers():
    """Reference servers with the port tables' settings
    (``chip_smoke.dlrm_tables``), without their RPC endpoints."""
    out = []
    for t, rows in enumerate(CFG.rows):
        shards = []
        for s in range(CFG.shards):
            srv = JServer.__new__(JServer)
            srv.dim, srv.lr, srv.optimizer = CFG.dim, LR, "sgd"
            srv.init_scale = float(np.sqrt(1.0 / rows))
            srv.rows, srv.g2sum = {}, {}
            srv.rng = np.random.RandomState(CFG.shards * t + s)
            shards.append(srv)
        out.append(shards)
    return out


def _programs():
    servers = _ref_servers()
    jm, js = fluid.Program(), fluid.Program()
    js.random_seed = 5
    with jun.guard(), fluid.program_guard(jm, js):
        jloss, jembs = cs.build_dlrm(fluid, JEmb,
                                     [_RefClient(s) for s in servers],
                                     BATCH, CFG, LR)
    clients = [SparseTableClient("dlrm_t%d" % t, [
        SparseTableShard.from_state(server_state(srv)) for srv in shards])
        for t, shards in enumerate(servers)]
    tm, ts = tfw.Program(), tfw.Program()
    ts.random_seed = 5
    with tun.guard(), tfw.program_guard(tm, ts):
        tloss, tembs = cs.build_dlrm(paddle_tpu_torch, DistributedEmbedding,
                                     clients, BATCH, CFG, LR)
    return (jm, js, jloss, jembs, servers), (tm, ts, tloss, tembs)


@pytest.mark.parametrize("which", ["main", "startup", "fused main"])
def test_programs_equal_reference(which):
    (jm, js, *_j), (tm, ts, *_t) = _programs()
    if which == "fused main":
        jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
        tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
        ops = tm.global_block().ops
        fused, = [op for op in ops if op.type == "fused_sgd"]
        assert len(fused.input("Param")) == 8
        assert not any(op.type == "sgd" for op in ops)
        assert sum(op.type == "embedding_bag" for op in ops) == 3
    got, want = (ts, js) if which == "startup" else (tm, jm)
    assert got.to_dict() == want.to_dict()


def test_dlrm_tiny_trains_with_the_reference_losses():
    (jm, js, jloss, jembs, servers), (tm, _ts, tloss, tembs) = _programs()
    data = cs.dlrm_batch(np.random.RandomState(0), BATCH, CFG)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        jl = [cs.dlrm_step(exe, jm, jloss, jembs, data)[0]
              for _ in range(STEPS)]
        jp = {n: np.array(scope.find_var(n).get_tensor().numpy())
              for n in names}
    tsc = scope_from_numpy(Scope(), init, "cpu", program=tm)
    texe = Executor(tfw.CPUPlace())
    tl = [cs.dlrm_step(texe, tm, tloss, tembs, data, tsc)[0]
          for _ in range(STEPS)]
    assert any(op.type == "fused_sgd" for op in tm.global_block().ops)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0]
    for n, want in jp.items():
        got = tsc.find_var(n).get_tensor().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()),
                                   err_msg=n)
    for emb, shards in zip(tembs, servers):
        for shard, srv in zip(emb.client.shards, shards):
            st = shard.state()
            assert list(st["rows"]) == list(srv.rows)
            want = np.stack(list(srv.rows.values()))
            got = np.stack(list(st["rows"].values()))
            np.testing.assert_allclose(
                got, want, rtol=0, atol=RTOL * float(np.abs(want).max()))
