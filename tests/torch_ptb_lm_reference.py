"""PTB-LM at ``PTB_LARGE``'s widths on the CPU, the port against the JAX
package, step by step: the losses of SGD(lr) under the global-norm clip
from the port's initial weights (its startup program on the CPU, the
seed ``chip_smoke.py``'s LM phase uses) and its feeds
(``ptb_lm.batches``), the final states carried as in training.

Not a test (it runs a full-width model for minutes): a script that holds
the port's training trajectory against the reference's where the
trajectory swings.  Besides each step's two losses it prints, from the
port, the global norm of the gradients before the clip and the norm of
the step the parameters took (the clip makes it ``max_grad_norm`` when
the gradients are longer), and the loss of the batch just trained on
evaluated again after the step (at dropout 0 only: a forward of the
same parameters), so a swing can be told from a fault.  At dropout > 0
both packages draw one mask (``torch_rnn_common.patch_masks``).

    JAX_PLATFORMS=cpu python tests/torch_ptb_lm_reference.py \\
        --rnn-model basic_lstm --batch 4 --steps 12 --dropout 0

``--batch 2 --steps 3 --feed-seed 5`` at dropout 0 gives the reference
losses ``chip_smoke.py`` holds the card's against (``LM_REFERENCE``), with
the fingerprint of the initial weights (``init_sum``) they start from.

``--no-reference`` runs the port alone (a control: another ``--lr`` or
``--clip``).  ``--json PATH`` writes the records.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import paddle_tpu as fluid  # noqa: E402
import paddle_tpu_torch.framework as tfw  # noqa: E402
from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy  # noqa: E402
from paddle_tpu_torch.models import ptb_lm  # noqa: E402
from torch_rnn_common import J, T, patch_masks  # noqa: E402
from test_torch_rnn_lm import ref_lm  # noqa: E402

INIT_SEED = 21


def programs(cfg, rnn_model, reference):
    tm, ts = tfw.Program(), tfw.Program()
    tm.random_seed = ts.random_seed = INIT_SEED
    with T.un.guard(), tfw.program_guard(tm, ts):
        tfetch = [v for v in ptb_lm.build_train(cfg, rnn_model)
                  if v is not None]
    # the loss alone, on the same parameter names (a forward, no step)
    em, es = tfw.Program(), tfw.Program()
    with T.un.guard(), tfw.program_guard(em, es):
        efetch = ptb_lm.lm_model(cfg, rnn_model)[0]
    if not reference:
        return tm, ts, tfetch, (em, efetch), None, None
    jm, js = fluid.Program(), fluid.Program()
    jm.random_seed = js.random_seed = INIT_SEED
    with J.un.guard(), fluid.program_guard(jm, js):
        jfetch = [v for v in ref_lm(cfg, rnn_model) if v is not None]
    if tm.to_dict() != jm.to_dict():
        raise SystemExit("the port's program differs from the reference's")
    return tm, ts, tfetch, (em, efetch), jm, jfetch


def norm(arrays):
    return float(np.sqrt(sum(float(np.square(a.astype(np.float64)).sum())
                             for a in arrays)))


def init_sum(init, params):
    """The float64 sum of the initial parameters (a fingerprint)."""
    return float(sum(init[n].astype(np.float64).sum() for n in params))


def run(args):
    cfg = ptb_lm.PTB_LARGE.replace(batch_size=args.batch,
                                   dropout=args.dropout, lr=args.lr,
                                   max_grad_norm=args.clip)
    tm, ts, tfetch, (em, efetch), jm, jfetch = programs(
        cfg, args.rnn_model, not args.no_reference)
    params = [p.name for p in tm.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in params]
    texe = Executor(tfw.CPUPlace())
    tscope = Scope()
    texe.run(ts, scope=tscope)
    init = scope_to_numpy(tscope, tm)
    if jm is not None:
        jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(jscope):
            for n, a in init.items():
                jscope.var(n).get_tensor().set(a.copy())
    print(json.dumps({"init_sum": init_sum(init, params)}), flush=True)
    feeds = list(ptb_lm.batches(cfg, args.steps, seed=args.feed_seed))
    carry = args.rnn_model != "cudnn"   # layers.lstm reads no init states
    z = np.zeros((cfg.num_layers, cfg.batch_size, cfg.hidden_size), "f")
    th = tc = jh = jc = z
    records = []
    for i, f in enumerate(feeds):
        t0 = time.perf_counter()
        before = {n: tscope.find_var(n).get_tensor().numpy().copy()
                  for n in params}
        tout = texe.run(tm, feed=dict(f, init_hidden=th, init_cell=tc),
                        fetch_list=tfetch + grads, scope=tscope)
        n_st = len(tfetch) - 1
        t_loss = float(np.asarray(tout[0]).ravel()[0])
        t_states = [np.asarray(o) for o in tout[1:1 + n_st]]
        g_norm = norm([np.asarray(g) for g in tout[1 + n_st:]])
        s_norm = norm([tscope.find_var(n).get_tensor().numpy() - before[n]
                       for n in params])
        rec = {"step": i + 1, "port_loss": t_loss, "grad_norm": g_norm,
               "step_norm": s_norm}
        if not cfg.dropout:
            after = texe.run(em, feed=dict(f, init_hidden=th, init_cell=tc),
                             fetch_list=[efetch], scope=tscope)
            rec["loss_after_step"] = float(np.asarray(after[0]).ravel()[0])
        if jm is not None:
            with fluid.scope_guard(jscope):
                jout = jexe.run(jm, feed=dict(f, init_hidden=jh,
                                              init_cell=jc),
                                fetch_list=jfetch)
            rec["ref_loss"] = float(np.asarray(jout[0]).ravel()[0])
            rec["loss_rel_gap"] = abs(t_loss - rec["ref_loss"]) / abs(
                rec["ref_loss"])
            rec["state_gap"] = max(
                float(np.abs(a - np.asarray(b)).max())
                for a, b in zip(t_states, jout[1:]))
            if carry:
                jh = np.asarray(jout[1])
                jc = np.asarray(jout[2]) if len(jout) > 2 else z
        if carry:
            th = t_states[0]
            tc = t_states[1] if len(t_states) > 1 else z
        rec["s"] = round(time.perf_counter() - t0, 1)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if jm is not None:
        with fluid.scope_guard(jscope):
            w = {n: np.asarray(jscope.find_var(n).get_tensor().numpy())
                 for n in params}
        gaps = {n: float(np.abs(tscope.find_var(n).get_tensor().numpy()
                                - w[n]).max()) for n in params}
        worst = max(gaps, key=gaps.get)
        print(json.dumps({"param_gap": gaps[worst], "at": worst}),
              flush=True)
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rnn-model", default="basic_lstm",
                    choices=["basic_lstm", "cudnn", "basic_gru",
                             "dynamic_gru"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--feed-seed", type=int, default=7)
    ap.add_argument("--lr", type=float, default=ptb_lm.PTB_LARGE.lr)
    ap.add_argument("--clip", type=float,
                    default=ptb_lm.PTB_LARGE.max_grad_norm)
    ap.add_argument("--no-reference", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    with pytest.MonkeyPatch.context() as mp:
        if args.dropout:
            patch_masks(mp, ptb_lm.PTB_LARGE.num_layers)
        records = run(args)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"args": vars(args), "records": records}, fh,
                      indent=1)


if __name__ == "__main__":
    main()
