"""Recurrent ops: contrib's whole-recurrence ops ``basic_gru_rnn`` and
``basic_lstm_rnn``, and the op-level recurrences ``gru``, ``gru_unit``,
``lstm``, ``lstmp``, ``lstm_unit``, ``cudnn_lstm``, ``fusion_gru`` and
``fusion_lstm``.

Counterpart of ``paddle_tpu/ops/contrib_rnn.py`` (``basic_gru_rnn:80``,
``basic_lstm_rnn:146``) and of ``paddle_tpu/ops/coverage_tail.py``
(``gru:563``, ``gru_unit:584``, ``lstm:639``, ``lstmp:666``,
``lstm_unit:718``, ``cudnn_lstm:733``, ``fusion_gru:780``,
``fusion_lstm:805``).  The reference runs each recurrence as
``jnp.dot`` plus elementwise jnp inside ``lax.scan``; the port runs the
same arithmetic in a Python loop over the time steps, the products as
``torch.matmul``.  ``lax.scan(..., reverse=True)`` visits the steps last
to first and stores each step's output at its own index; so do the
``is_reverse`` paths here.

Gate orders differ between the functions, each as its reference:

* ``basic_lstm_rnn``: i, j, f, o, the forget bias added inside;
  ``basic_gru_rnn``: r, u of the gate product, then the candidate.
* ``lstm``, ``lstmp``, ``cudnn_lstm``, ``fusion_lstm``: i, f, c, o;
  ``lstm_unit``: i, c, f, o.
* ``gru``, ``gru_unit``, ``fusion_gru``: u, r, then c; ``origin_mode``
  swaps the roles of h and c in the update.  ``gru_unit``'s activations
  are enums (0 identity, 1 sigmoid, 2 tanh, 3 relu).

``lstm`` and ``lstmp`` ignore ``use_peepholes`` (the reference folds the
peepholes away); ``cudnn_lstm`` reads its weights from cuDNN's blob, per
(layer, direction) ``[Wx (F x 4D), Wh (D x 4D), bias (8D)]``, and draws
no dropout, as the reference.

Dropout of ``basic_*_rnn``.  Both apply dropout to each layer's output
at each step, the last layer's being the step output, and never to
``LastHidden`` / ``LastCell``.  ``basic_gru_rnn`` keeps
``downgrade_in_infer`` (training masks without rescale, ``is_test``
scales by 1 - p) and ``basic_lstm_rnn`` ``upscale_in_train`` (training
divides the kept values by 1 - p, ``is_test`` is the identity), as the
reference's layers choose them.  The masks come from the port's Philox
stream (``kernels/philox.py``), keyed by the op's seed (``op_seed`` of
its place in the step): all T x L masks of one call are one launch of the
dropout kernel over a ``[T, L, B, H]`` block of ones, so the keep flag of
layer ``l``'s output at step ``t``, batch row ``b``, unit ``h`` is byte
``((t L + l) B + b) H + h`` of the stream (keep iff below round((1 - p)
256)).  An op draws only while its dropout is active (``rng_when``).

Gradients.  The recurrences' grads are the registry's vjp replays; those
of ``basic_*_rnn`` are written out (``register_grad_lowering``), since
the forward's draw is a ctypes launch on the card: the grad op draws the
forward's masks again from the forward op's seed (one launch) and
replays the plain recurrence under ``torch.func.vjp`` with the masks
held constant.
"""

import torch

from ..core.lowering import path_seed
from ..core.registry import register_grad_lowering, register_op, \
    vjp_replay
from ..kernels import philox
from ..kernels.dropout import dropout as dropout_kernel, true_divide
from .common import byte_threshold

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v, "": lambda v: v}

# gru_unit's ActivationType enum (gru_unit_op.h)
_ENUM_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(name):
    try:
        return _ACTS[name]
    except KeyError:
        raise NotImplementedError(
            "recurrent activation %r (the port has %s)"
            % (name, sorted(k for k in _ACTS if k)))


# -- contrib's whole recurrences ----------------------------------------------


def _uses_dropout(attrs):
    return (float(attrs.get("dropout_prob", 0.0) or 0.0) > 0.0
            and not attrs.get("is_test", False))


def _forward_seed(ctx):
    """The seed of the forward op a ``basic_*_rnn_grad`` op differentiates:
    the op of its block that wrote its ``Out@Out``, at that op's place in
    the step."""
    op = ctx.op
    if ctx.runner is None:
        raise RuntimeError("%s draws its forward's masks again and needs "
                           "an executor step" % op.type)
    base, out = op.type[:-len("_grad")], op.input("Out@Out")[0]
    ops = [o for o in op.block.ops if o.type not in ("feed", "fetch")]
    idx = next(i for i, o in enumerate(ops)
               if o.type == base and out in o.output("Out"))
    return path_seed(ctx.runner.seed, ctx.runner.step, ctx.path[:-1] + (idx,))


def rnn_keep_masks(words, shape, dropout_prob, device):
    """The keep flags of one ``basic_*_rnn`` call, bool ``shape`` =
    [T, L, B, H]: one launch of the dropout kernel over ones (its plain
    version on the CPU), keyed by the key ``words``."""
    ones = torch.ones(shape, dtype=torch.float32, device=device)
    _out, mask = dropout_kernel(ones, words,
                                byte_threshold(1.0 - float(dropout_prob)),
                                1.0, upscale=False)
    return mask.bool()


def _keep_of(ctx, x, hidden_size, num_layers, attrs, forward=True):
    """The op's masks (None while its dropout is off); ``forward=False``
    in its grad op, which keys them by the forward's seed."""
    if not _uses_dropout(attrs):
        return None
    words = ctx.seed_words() if forward else philox.words_of(
        _forward_seed(ctx))
    shape = (x.shape[0], int(num_layers), x.shape[1], int(hidden_size))
    return rnn_keep_masks(words, shape, attrs["dropout_prob"], x.device)


def _states(s, n_layers, batch, hidden, like):
    if s is None:
        return [torch.zeros((batch, hidden), dtype=like.dtype,
                            device=like.device)] * n_layers
    return list(s.reshape(n_layers, batch, hidden).to(like.dtype).unbind(0))


def _masked(new, prev, m_t):
    """The masked step: new where the row's step is real, prev past its
    length."""
    mt = m_t.unsqueeze(1).to(new.dtype)
    return new * mt + prev * (1.0 - mt)


def dropped(v, keep, q):
    """v where ``keep``, zero elsewhere; the kept values divided by ``q``
    (upscale_in_train), or as they are where ``q`` is None
    (downgrade_in_infer's training side)."""
    return torch.where(keep, v if q is None else true_divide(v, q), 0.0)


def gru_recurrence(x, h0, mask, gate_w, cand_w, gate_b, cand_b, keep,
                   hidden_size, dropout_prob=0.0, is_test=False,
                   gate_activation="sigmoid", activation="tanh", **_):
    """The plain recurrence of ``basic_gru_rnn``; ``keep`` [T, L, B, H]
    bool or None.  -> (out [T, B, H], last_hidden [L, B, H])."""
    g_act, c_act = _act(gate_activation), _act(activation)
    n_steps, batch = x.shape[0], x.shape[1]
    n_layers, hid = len(gate_w), int(hidden_size)
    infer_scale = 1.0 - float(dropout_prob) \
        if is_test and float(dropout_prob) > 0.0 else None
    h = _states(h0, n_layers, batch, hid, x)
    outs = []
    for t in range(n_steps):
        step_in = x[t]
        for i in range(n_layers):
            h_prev = h[i]
            gate = g_act(torch.cat([step_in, h_prev], 1) @ gate_w[i]
                         + gate_b[i])
            r, u = gate[:, :hid], gate[:, hid:]
            m = c_act(torch.cat([step_in, r * h_prev], 1) @ cand_w[i]
                      + cand_b[i])
            nh = u * h_prev + (1.0 - u) * m
            if mask is not None:
                nh = _masked(nh, h_prev, mask[t])
            h[i] = step_in = nh
            if keep is not None:
                step_in = dropped(step_in, keep[t, i], None)
            elif infer_scale is not None:
                step_in = step_in * infer_scale
        outs.append(step_in)
    return torch.stack(outs), torch.stack(h)


def lstm_recurrence(x, h0, c0, mask, weight, bias, keep, hidden_size,
                    dropout_prob=0.0, forget_bias=1.0,
                    gate_activation="sigmoid", activation="tanh", **_):
    """The plain recurrence of ``basic_lstm_rnn``; ``keep`` [T, L, B, H]
    bool or None.  -> (out [T, B, H], last_hidden, last_cell [L, B, H])."""
    g_act, c_act = _act(gate_activation), _act(activation)
    n_steps, batch = x.shape[0], x.shape[1]
    n_layers, hid = len(weight), int(hidden_size)
    q = 1.0 - float(dropout_prob)
    h = _states(h0, n_layers, batch, hid, x)
    c = _states(c0, n_layers, batch, hid, x)
    outs = []
    for t in range(n_steps):
        step_in = x[t]
        for i in range(n_layers):
            h_prev, c_prev = h[i], c[i]
            gates = torch.cat([step_in, h_prev], 1) @ weight[i] + bias[i]
            gi, gj, gf, go = gates.split(hid, dim=1)
            nc = c_prev * g_act(gf + float(forget_bias)) \
                + g_act(gi) * c_act(gj)
            nh = c_act(nc) * g_act(go)
            if mask is not None:
                nh = _masked(nh, h_prev, mask[t])
                nc = _masked(nc, c_prev, mask[t])
            h[i], c[i] = nh, nc
            step_in = nh
            if keep is not None:
                step_in = dropped(step_in, keep[t, i], q)
        outs.append(step_in)
    return torch.stack(outs), torch.stack(h), torch.stack(c)


def _rnn_infer(*slots):
    """Out [T, B, H] and the final states of the other ``slots`` [L, B,
    H], B the input's.  As the reference's symbolic evaluation: nothing
    when an input's shape is unknown or the mask's batch (-1, a batch
    symbol) cannot broadcast against the input's."""

    def infer(op, block):
        ins = [block._find_var_recursive(n) for n in op.input_arg_names if n]
        if any(v is None or v.shape is None for v in ins):
            return
        x = block._find_var_recursive(op.input("Input")[0])
        b = x.shape[1]
        if op.input("Mask"):
            mb = block._find_var_recursive(op.input("Mask")[0]).shape[1]
            if mb != b and 1 not in (mb, b):
                return
        hid, n_layers = op.attr("hidden_size"), op.attr("num_layers")
        shapes = [(x.shape[0], b, hid)] + [(n_layers, b, hid)] * (
            len(slots) - 1)
        for slot, shape in zip(slots, shapes):
            v = block._find_var_recursive(op.output(slot)[0])
            v.shape = shape
            if v.dtype is None:
                v.dtype = x.dtype

    return infer


_GRU_ATTRS = {"hidden_size": 0, "num_layers": 1, "dropout_prob": 0.0,
              "is_test": False, "gate_activation": "sigmoid",
              "activation": "tanh"}


@register_op("basic_gru_rnn",
             inputs=("Input", "InitHidden", "Mask", "GateWeight",
                     "CandWeight", "GateBias", "CandBias"),
             outputs=("Out", "LastHidden"), attrs=_GRU_ATTRS,
             optional_inputs=("InitHidden", "Mask"),
             duplicable_inputs=("GateWeight", "CandWeight", "GateBias",
                                "CandBias"),
             n_rng=1)
def basic_gru_rnn(ctx, x, h0, mask, gate_w, cand_w, gate_b, cand_b,
                  **attrs):
    """Single-direction multi-layer GRU over time-major x [T, B, I]: h0
    [L, B, H] or None (zeros), mask [T, B] or None, per layer gate_w
    [I_l + H, 2H], cand_w [I_l + H, H].  -> (out [T, B, H], last_hidden
    [L, B, H])."""
    keep = _keep_of(ctx, x, attrs["hidden_size"], attrs["num_layers"],
                    attrs)
    return gru_recurrence(x, h0, mask, gate_w, cand_w, gate_b, cand_b,
                          keep, **attrs)


@register_op("basic_lstm_rnn",
             inputs=("Input", "InitHidden", "InitCell", "Mask", "Weight",
                     "Bias"),
             outputs=("Out", "LastHidden", "LastCell"),
             attrs=dict(_GRU_ATTRS, forget_bias=1.0),
             optional_inputs=("InitHidden", "InitCell", "Mask"),
             duplicable_inputs=("Weight", "Bias"), n_rng=1)
def basic_lstm_rnn(ctx, x, h0, c0, mask, weight, bias, **attrs):
    """Single-direction multi-layer LSTM over time-major x [T, B, I]:
    weight[l] [I_l + H, 4H] (gates i, j, f, o), bias[l] [4H].  -> (out,
    last_hidden [L, B, H], last_cell [L, B, H])."""
    keep = _keep_of(ctx, x, attrs["hidden_size"], attrs["num_layers"],
                    attrs)
    return lstm_recurrence(x, h0, c0, mask, weight, bias, keep, **attrs)


def _rnn_rng_when(attrs):
    return _uses_dropout(attrs)


basic_gru_rnn.opdef.rng_when = _rnn_rng_when
basic_lstm_rnn.opdef.rng_when = _rnn_rng_when
basic_gru_rnn.opdef.infer_shape = _rnn_infer("Out", "LastHidden")
basic_lstm_rnn.opdef.infer_shape = _rnn_infer("Out", "LastHidden",
                                              "LastCell")


@register_grad_lowering("basic_gru_rnn")
def basic_gru_rnn_grad(ctx, x, h0, mask, gate_w, cand_w, gate_b, cand_b,
                       out, dout, last_h, dlast_h, **attrs):
    keep = _keep_of(ctx, x, attrs["hidden_size"], attrs["num_layers"],
                    attrs, forward=False)
    return vjp_replay(
        ctx, basic_gru_rnn.opdef,
        [x, h0, mask, gate_w, cand_w, gate_b, cand_b],
        lambda *a: gru_recurrence(*a, keep, **attrs), [dout, dlast_h])


@register_grad_lowering("basic_lstm_rnn")
def basic_lstm_rnn_grad(ctx, x, h0, c0, mask, weight, bias, out, dout,
                        last_h, dlast_h, last_c, dlast_c, **attrs):
    keep = _keep_of(ctx, x, attrs["hidden_size"], attrs["num_layers"],
                    attrs, forward=False)
    return vjp_replay(
        ctx, basic_lstm_rnn.opdef,
        [x, h0, c0, mask, weight, bias],
        lambda *a: lstm_recurrence(*a, keep, **attrs),
        [dout, dlast_h, dlast_c])


# -- the op-level recurrences -------------------------------------------------


def _steps(n_steps, reverse):
    return range(n_steps - 1, -1, -1) if reverse else range(n_steps)


def _in_order(seq, reverse):
    """Per-step outputs collected in visiting order -> time order, [B, T,
    ...]."""
    return torch.stack(seq[::-1] if reverse else seq, dim=1)


def _gru_scan(x_proj, h0, wh, act, gate_act, origin_mode, reverse=False):
    """The shared GRU recurrence of gru_op.cc: x_proj [B, T, 3D]
    pre-projected, wh [D, 3D] packed {u, r | c}.  -> hidden states [B, T,
    D]."""
    d = wh.shape[0]
    w_ur, w_c = wh[:, :2 * d], wh[:, 2 * d:]
    h, hs = h0, []
    for t in _steps(x_proj.shape[1], reverse):
        xt = x_proj[:, t]
        ur = xt[:, :2 * d] + h @ w_ur
        u, r = gate_act(ur[:, :d]), gate_act(ur[:, d:])
        c = act(xt[:, 2 * d:] + (r * h) @ w_c)
        h = (1.0 - u) * h + u * c if origin_mode else u * h + (1.0 - u) * c
        hs.append(h)
    return _in_order(hs, reverse)


def _lstm_scan(x_proj, h0, c0, wh, acts, reverse=False):
    """The shared LSTM recurrence of lstm_op.cc: x_proj [B, T, 4D]
    pre-projected, gates i, f, c, o; wh [D, 4D].  -> (hidden, cell), each
    [B, T, D]."""
    gate_act, cell_act, cand_act = acts
    d = wh.shape[1] // 4
    h, c, hs, cs = h0, c0, [], []
    for t in _steps(x_proj.shape[1], reverse):
        g = x_proj[:, t] + h @ wh
        i, f = gate_act(g[:, :d]), gate_act(g[:, d:2 * d])
        cand, o = cand_act(g[:, 2 * d:3 * d]), gate_act(g[:, 3 * d:])
        c = f * c + i * cand
        h = o * cell_act(c)
        hs.append(h)
        cs.append(c)
    return _in_order(hs, reverse), _in_order(cs, reverse)


def _zeros1(x):
    """The (1,) placeholder of the outputs the reference leaves empty."""
    return torch.zeros((1,), dtype=x.dtype, device=x.device)


def _or_zeros(s, batch, width, like):
    return s if s is not None else torch.zeros(
        (batch, width), dtype=like.dtype, device=like.device)


def _lstm_acts(gate_activation, cell_activation, candidate_activation):
    return (_act(gate_activation), _act(cell_activation),
            _act(candidate_activation))


@register_op("gru", inputs=("Input", "H0", "Weight", "Bias"),
             outputs=("BatchGate", "BatchResetHiddenPrev", "BatchHidden",
                      "Hidden"),
             attrs={"activation": "tanh", "gate_activation": "sigmoid",
                    "is_reverse": False, "origin_mode": False},
             optional_inputs=("H0", "Bias"))
def gru(ctx, x, h0, weight, bias, activation="tanh",
        gate_activation="sigmoid", is_reverse=False, origin_mode=False):
    """Input [B, T, 3D] pre-projected, Weight [D, 3D], Bias [1, 3D].  ->
    (the biased input, a placeholder, hidden [B, T, D] twice)."""
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    hs = _gru_scan(x, _or_zeros(h0, x.shape[0], weight.shape[0], x), weight,
                   _act(activation), _act(gate_activation), origin_mode,
                   is_reverse)
    return x, _zeros1(x), hs, hs


@register_op("gru_unit", inputs=("Input", "HiddenPrev", "Weight", "Bias"),
             outputs=("Gate", "ResetHiddenPrev", "Hidden"),
             attrs={"activation": 2, "gate_activation": 1,
                    "origin_mode": False},
             optional_inputs=("Bias",))
def gru_unit(ctx, x, h_prev, weight, bias, activation=2, gate_activation=1,
             origin_mode=False):
    """One GRU step: Input [B, 3D], Weight [D, 3D] packed {u, r | c}.  ->
    (gates [u, r, c] [B, 3D], r * h_prev, hidden)."""
    act = _act(_ENUM_ACTS[int(activation)])
    gate_act = _act(_ENUM_ACTS[int(gate_activation)])
    d = weight.shape[0]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    ur = x[:, :2 * d] + h_prev @ weight[:, :2 * d]
    u, r = gate_act(ur[:, :d]), gate_act(ur[:, d:])
    rh = r * h_prev
    c = act(x[:, 2 * d:] + rh @ weight[:, 2 * d:])
    h = (1.0 - u) * h_prev + u * c if origin_mode \
        else u * h_prev + (1.0 - u) * c
    return torch.cat([u, r, c], dim=1), rh, h


@register_op("lstm", inputs=("Input", "H0", "C0", "Weight", "Bias"),
             outputs=("Hidden", "Cell", "BatchGate", "BatchCellPreAct"),
             attrs={"use_peepholes": True, "is_reverse": False,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh"},
             optional_inputs=("H0", "C0", "Bias"))
def lstm(ctx, x, h0, c0, weight, bias, use_peepholes=True,
         is_reverse=False, gate_activation="sigmoid",
         cell_activation="tanh", candidate_activation="tanh"):
    """Input [B, T, 4D] pre-projected, Weight [D, 4D]; Bias's first 4D
    (the peephole part past it is not read).  -> (hidden, cell [B, T, D],
    two placeholders)."""
    d = weight.shape[0]
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)[..., :4 * d]
    b = x.shape[0]
    hs, cs = _lstm_scan(x, _or_zeros(h0, b, d, x), _or_zeros(c0, b, d, x),
                        weight, _lstm_acts(gate_activation, cell_activation,
                                           candidate_activation),
                        is_reverse)
    return hs, cs, _zeros1(x), _zeros1(x)


@register_op("lstmp",
             inputs=("Input", "H0", "C0", "Weight", "ProjWeight", "Bias"),
             outputs=("Projection", "Cell", "BatchGate",
                      "BatchCellPreAct", "BatchHidden"),
             attrs={"use_peepholes": True, "is_reverse": False,
                    "cell_clip": 0.0, "proj_clip": 0.0,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh",
                    "proj_activation": "tanh"},
             optional_inputs=("H0", "C0", "Bias"))
def lstmp(ctx, x, h0, c0, weight, proj_weight, bias, use_peepholes=True,
          is_reverse=False, cell_clip=0.0, proj_clip=0.0,
          gate_activation="sigmoid", cell_activation="tanh",
          candidate_activation="tanh", proj_activation="tanh"):
    """LSTM with a projection: the recurrent state is r = proj_act(h
    ProjWeight) [B, P]; Weight [P, 4D]; ``cell_clip`` / ``proj_clip``
    (0: off) clip c and r.  -> (projection [B, T, P], cell [B, T, D],
    three placeholders)."""
    d, p = weight.shape[1] // 4, proj_weight.shape[1]
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)[..., :4 * d]
    b = x.shape[0]
    gate_act, cell_act, cand_act = _lstm_acts(
        gate_activation, cell_activation, candidate_activation)
    proj_act = _act(proj_activation)
    r, c = _or_zeros(h0, b, p, x), _or_zeros(c0, b, d, x)
    rs, cs = [], []
    for t in _steps(x.shape[1], is_reverse):
        g = x[:, t] + r @ weight
        i, f = gate_act(g[:, :d]), gate_act(g[:, d:2 * d])
        cand, o = cand_act(g[:, 2 * d:3 * d]), gate_act(g[:, 3 * d:])
        c = f * c + i * cand
        if cell_clip:
            c = torch.clamp(c, -cell_clip, cell_clip)
        r = proj_act((o * cell_act(c)) @ proj_weight)
        if proj_clip:
            r = torch.clamp(r, -proj_clip, proj_clip)
        rs.append(r)
        cs.append(c)
    z = _zeros1(x)
    return (_in_order(rs, is_reverse), _in_order(cs, is_reverse), z, z, z)


@register_op("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"),
             attrs={"forget_bias": 0.0})
def lstm_unit(ctx, x, c_prev, forget_bias=0.0):
    """One LSTM step over pre-projected gates X [B, 4D] in the order i, c
    (tanh), f, o.  -> (cell, hidden)."""
    d = c_prev.shape[-1]
    i, g = torch.sigmoid(x[:, :d]), torch.tanh(x[:, d:2 * d])
    f = torch.sigmoid(x[:, 2 * d:3 * d] + forget_bias)
    o = torch.sigmoid(x[:, 3 * d:])
    c = f * c_prev + i * g
    return c, o * torch.tanh(c)


@register_op("cudnn_lstm", inputs=("Input", "InitH", "InitC", "W"),
             outputs=("Out", "last_h", "last_c", "Reserve", "StateOut"),
             attrs={"max_len": 0, "hidden_size": 0, "num_layers": 1,
                    "is_bidirec": False, "is_test": False,
                    "dropout_prob": 0.0, "seed": 0},
             optional_inputs=("InitH", "InitC"))
def cudnn_lstm(ctx, x, init_h, init_c, w, max_len=0, hidden_size=0,
               num_layers=1, is_bidirec=False, is_test=False,
               dropout_prob=0.0, seed=0):
    """Stacked LSTM over batch-major x [B, T, F] and cuDNN's packed weight
    blob; InitH / InitC [L * dirs, B, D].  The backward direction runs last
    to first and its final state is its step 0.  -> (out [B, T, D * dirs],
    last_h, last_c [L * dirs, B, D], two placeholders)."""
    b = x.shape[0]
    d = int(hidden_size)
    flat = w.reshape(-1)
    off = 0
    ndir = 2 if is_bidirec else 1
    acts = (torch.sigmoid, torch.tanh, torch.tanh)
    out, last_h, last_c = x, [], []
    for layer in range(int(num_layers)):
        fin = out.shape[-1]
        dir_outs = []
        for k in range(ndir):
            wx = flat[off:off + fin * 4 * d].reshape(fin, 4 * d)
            off += fin * 4 * d
            wh = flat[off:off + d * 4 * d].reshape(d, 4 * d)
            off += d * 4 * d
            bias = flat[off:off + 8 * d]
            off += 8 * d
            proj = out @ wx + (bias[:4 * d] + bias[4 * d:]).reshape(1, 1, -1)
            s = layer * ndir + k
            h0 = init_h[s] if init_h is not None else _or_zeros(None, b, d, x)
            c0 = init_c[s] if init_c is not None else _or_zeros(None, b, d, x)
            hs, cs = _lstm_scan(proj, h0, c0, wh, acts, reverse=(k == 1))
            dir_outs.append(hs)
            last_h.append(hs[:, 0 if k == 1 else -1])
            last_c.append(cs[:, 0 if k == 1 else -1])
        out = torch.cat(dir_outs, dim=-1) if ndir == 2 else dir_outs[0]
    z = _zeros1(x)
    return out, torch.stack(last_h), torch.stack(last_c), z, z


@register_op("fusion_gru", inputs=("X", "H0", "WeightX", "WeightH", "Bias"),
             outputs=("ReorderedH0", "XX", "BatchedInput", "BatchedOut",
                      "Hidden"),
             attrs={"activation": "tanh", "gate_activation": "sigmoid",
                    "is_reverse": False, "use_seq": True,
                    "origin_mode": False},
             optional_inputs=("H0", "Bias"))
def fusion_gru(ctx, x, h0, wx, wh, bias, activation="tanh",
               gate_activation="sigmoid", is_reverse=False, use_seq=True,
               origin_mode=False):
    """fc + gru: X [B, T, F], WeightX [F, 3D], WeightH [D, 3D].  -> (four
    placeholders, hidden [B, T, D])."""
    proj = x @ wx
    if bias is not None:
        proj = proj + bias.reshape(1, 1, -1)
    hs = _gru_scan(proj, _or_zeros(h0, x.shape[0], wh.shape[0], x), wh,
                   _act(activation), _act(gate_activation), origin_mode,
                   is_reverse)
    z = _zeros1(x)
    return z, z, z, z, hs


@register_op("fusion_lstm",
             inputs=("X", "H0", "C0", "WeightX", "WeightH", "Bias"),
             outputs=("Hidden", "Cell", "XX", "BatchedInput",
                      "BatchedHidden", "BatchedCell", "ReorderedH0",
                      "ReorderedC0"),
             attrs={"use_peepholes": False, "is_reverse": False,
                    "use_seq": True, "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh"},
             optional_inputs=("H0", "C0", "Bias"))
def fusion_lstm(ctx, x, h0, c0, wx, wh, bias, use_peepholes=False,
                is_reverse=False, use_seq=True, gate_activation="sigmoid",
                cell_activation="tanh", candidate_activation="tanh"):
    """fc + lstm: WeightX [F, 4D], WeightH [D, 4D].  -> (hidden, cell [B,
    T, D], six placeholders)."""
    proj = x @ wx
    if bias is not None:
        proj = proj + bias.reshape(1, 1, -1)[..., :wh.shape[1]]
    d, b = wh.shape[0], x.shape[0]
    hs, cs = _lstm_scan(proj, _or_zeros(h0, b, d, x), _or_zeros(c0, b, d, x),
                        wh, _lstm_acts(gate_activation, cell_activation,
                                       candidate_activation), is_reverse)
    z = _zeros1(x)
    return (hs, cs) + (z,) * 6
