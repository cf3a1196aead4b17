"""Recurrent and decoding layers.  Counterpart of
``paddle_tpu/layers/rnn.py``: ``beam_search:18``,
``beam_search_decode:46``, the units ``gru_unit:72`` and
``lstm_unit:92``, the recurrences over ``StaticRNN`` ``dynamic_gru:111``,
``dynamic_lstm:134``, ``dynamic_lstmp:166`` and the stacked ``lstm:224``
(``_reverse_time:267``), the cells ``RNNCell:296``, ``GRUCell:319`` and
``LSTMCell:347`` with ``rnn:384``, and ``dynamic_decode:458`` with
``BeamSearchDecoder:498`` (``_batched_gather:631``).

Each builds the reference's ops, names and shapes, including where the
reference departs from Fluid (ROADMAP, section C):

* ``dynamic_gru`` and ``dynamic_lstm`` accept ``seq_len`` and ``reverse``
  and read neither; ``lstm`` takes batch-major input [B, T, F], reads
  neither ``init_h`` nor ``init_c`` (zero states) nor
  ``default_initializer``, and returns the last layer's final states,
  [B, 1, H] (two directions concatenated);
* ``rnn(sequence_length=...)`` raises NotImplementedError,
  ``dynamic_decode`` without ``max_step_num`` a ValueError, and
  ``LSTMCell`` takes only sigmoid gates and tanh;
* ``gru_unit`` hands its ``param_attr`` to two ``fc``s of different
  shapes: a named attr raises the layer helper's "shared parameter"
  ValueError, as there.

The gate orders are the reference's: ``lstm_unit`` splits its product i,
f, c, o; ``gru_unit`` splits the input u, r, c and the hidden product u,
r.
"""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode", "gru_unit", "lstm_unit",
           "dynamic_lstmp", "lstm", "dynamic_gru", "dynamic_lstm", "RNNCell",
           "GRUCell", "LSTMCell", "rnn", "dynamic_decode",
           "BeamSearchDecoder"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One beam expansion step -> (selected_ids, selected_scores[,
    parent_idx]), each [B, K]."""
    helper = LayerHelper("beam_search", name=name)
    selected_ids = helper.create_variable_for_type_inference(
        dtype=pre_ids.dtype)
    selected_scores = helper.create_variable_for_type_inference(
        dtype=scores.dtype)
    parent_idx = helper.create_variable_for_type_inference(
        dtype=pre_ids.dtype)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(type="beam_search", inputs=inputs,
                     outputs={"selected_ids": [selected_ids],
                              "selected_scores": [selected_scores],
                              "parent_idx": [parent_idx]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level,
                            "is_accumulated": is_accumulated})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, parent_idx, scores=None, beam_size=4, end_id=1,
                       name=None):
    """Backtrack the tensor arrays of ids and parents into sequences ->
    (SentenceIds [B, K, T], SentenceScores [B, K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sentence_ids = helper.create_variable_for_type_inference(dtype="int64")
    sentence_scores = helper.create_variable_for_type_inference(
        dtype="float32")
    inputs = {"Ids": [ids], "ParentIdx": [parent_idx]}
    if scores is not None:
        inputs["Scores"] = [scores]
    helper.append_op(type="beam_search_decode", inputs=inputs,
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sentence_ids, sentence_scores


def _act(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step: ``input`` the projected step input [B, 3D] (u, r, c),
    ``hidden`` [B, D], ``size`` 3D.  -> (new hidden, new hidden,
    candidate)."""
    from . import nn

    d = size // 3
    gates_w = nn.fc(hidden, 2 * d, param_attr=param_attr,
                    bias_attr=bias_attr, name=(name or "gru") + "_gates")
    xu, xr, xc = nn.split(input, 3, dim=-1)
    hu, hr = nn.split(gates_w, 2, dim=-1)
    u = _act(gate_activation, xu + hu)
    r = _act(gate_activation, xr + hr)
    cand_h = nn.fc(hidden * r, d, param_attr=param_attr, bias_attr=False,
                   name=(name or "gru") + "_cand")
    c = _act(activation, xc + cand_h)
    new_hidden = u * hidden + (1.0 - u) * c
    return new_hidden, new_hidden, c


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: one fc over [x_t, h] to the gates i, f, c, o.  ->
    (new hidden, new cell)."""
    from . import nn

    d = hidden_t_prev.shape[-1]
    concat_in = nn.concat([x_t, hidden_t_prev], axis=-1)
    gates = nn.fc(concat_in, 4 * d, param_attr=param_attr,
                  bias_attr=bias_attr, name=(name or "lstm") + "_gates")
    i, f, c, o = nn.split(gates, 4, dim=-1)
    i = _act("sigmoid", i)
    f = _act("sigmoid", f + forget_bias)
    o = _act("sigmoid", o)
    c = _act("tanh", c)
    new_cell = f * cell_t_prev + i * c
    new_hidden = o * _act("tanh", new_cell)
    return new_hidden, new_cell


def dynamic_gru(input, size, seq_len=None, h_0=None, reverse=False,
                param_attr=None, bias_attr=None, name=None):
    """GRU over the time axis of [B, T, F] (a StaticRNN of ``gru_unit``)
    -> [B, T, size]; ``seq_len`` and ``reverse`` are not read."""
    from .control_flow import StaticRNN
    from . import nn

    name = name or "dynamic_gru"
    proj = nn.fc(input, 3 * size, num_flatten_dims=2, param_attr=param_attr,
                 bias_attr=bias_attr, name=name + "_proj")
    proj_t = nn.transpose(proj, [1, 0, 2])  # [T, B, 3D]
    srnn = StaticRNN()
    with srnn.step():
        x_t = srnn.step_input(proj_t)
        h_prev = srnn.memory(init=h_0, shape=(-1, size), batch_ref=input,
                             init_value=0.0, ref_batch_dim_idx=0)
        h, _, _ = gru_unit(x_t, h_prev, 3 * size, name=name)
        srnn.update_memory(h_prev, h)
        srnn.step_output(h)
    out = srnn()  # [T, B, D]
    return nn.transpose(out, [1, 0, 2])


def dynamic_lstm(input, size, seq_len=None, h_0=None, c_0=None,
                 reverse=False, param_attr=None, bias_attr=None, name=None,
                 return_cell=False):
    """LSTM over the time axis of [B, T, F] (a StaticRNN of ``lstm_unit``,
    ``size`` 4D) -> hidden [B, T, D], and the cells with ``return_cell``;
    ``seq_len`` and ``reverse`` are not read."""
    from .control_flow import StaticRNN
    from . import nn

    name = name or "dynamic_lstm"
    d = size // 4
    x_t_all = nn.transpose(input, [1, 0, 2])  # [T, B, F]
    srnn = StaticRNN()
    with srnn.step():
        x_t = srnn.step_input(x_t_all)
        h_prev = srnn.memory(init=h_0, shape=(-1, d), batch_ref=input,
                             init_value=0.0, ref_batch_dim_idx=0)
        c_prev = srnn.memory(init=c_0, shape=(-1, d), batch_ref=input,
                             init_value=0.0, ref_batch_dim_idx=0)
        h, c = lstm_unit(x_t, h_prev, c_prev, name=name)
        srnn.update_memory(h_prev, h)
        srnn.update_memory(c_prev, c)
        srnn.step_output(h)
        if return_cell:
            srnn.step_output(c)
    if return_cell:
        out, cells = srnn()
        return nn.transpose(out, [1, 0, 2]), nn.transpose(cells, [1, 0, 2])
    out = srnn()
    return nn.transpose(out, [1, 0, 2])


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  cell_clip=None, proj_clip=None):
    """LSTM with a projection over [B, T, F]: the recurrent state is the
    projection r [B, P] of the hidden state.  -> (projections [B, T, P],
    cells [B, T, D]); ``use_peepholes``, ``cell_clip`` and ``proj_clip``
    are not read."""
    from .control_flow import StaticRNN
    from . import nn

    name = name or "dynamic_lstmp"
    d = size // 4
    x = _reverse_time(input) if is_reverse else input
    x_t_all = nn.transpose(x, [1, 0, 2])
    srnn = StaticRNN()
    with srnn.step():
        x_t = srnn.step_input(x_t_all)
        r_prev = srnn.memory(init=h_0, shape=(-1, proj_size),
                             batch_ref=input, init_value=0.0,
                             ref_batch_dim_idx=0)
        c_prev = srnn.memory(init=c_0, shape=(-1, d), batch_ref=input,
                             init_value=0.0, ref_batch_dim_idx=0)
        gates = nn.fc(nn.concat([x_t, r_prev], axis=-1), 4 * d,
                      param_attr=param_attr, bias_attr=bias_attr,
                      name=name + "_gates")
        gi, gf, gc, go = nn.split(gates, 4, dim=-1)
        gi = _act(gate_activation, gi)
        gf = _act(gate_activation, gf)
        go = _act(gate_activation, go)
        gc = _act(candidate_activation, gc)
        c = gf * c_prev + gi * gc
        h = go * _act(cell_activation, c)
        # the projection's weight is its own parameter: a named attr (or
        # one the gates' fc has named) gives it a "_proj" name of its own
        proj_attr = None
        if param_attr is not None and getattr(param_attr, "name", None):
            from ..param_attr import ParamAttr

            proj_attr = ParamAttr(name=param_attr.name + "_proj")
        r = nn.fc(h, proj_size, param_attr=proj_attr, bias_attr=False,
                  act=proj_activation, name=name + "_proj")
        srnn.update_memory(r_prev, r)
        srnn.update_memory(c_prev, c)
        srnn.step_output(r)
        srnn.step_output(c)
    proj_out, cells = srnn()
    proj_out = nn.transpose(proj_out, [1, 0, 2])
    cells = nn.transpose(cells, [1, 0, 2])
    if is_reverse:
        proj_out = _reverse_time(proj_out)
        cells = _reverse_time(cells)
    return proj_out, cells


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Stacked LSTM over batch-major input [B, T, F], one
    ``dynamic_lstm`` a layer and direction, the backward one over the
    time-reversed input; upscale_in_train dropout between layers in
    training.  -> (out [B, T, H or 2H], last_h, last_c [B, 1, H or 2H] of
    the last layer)."""
    from . import nn

    name = name or "lstm"
    x = input
    for layer in range(num_layers):
        fwd, fwd_c = dynamic_lstm(
            x, 4 * hidden_size, name="%s_l%d_fwd" % (name, layer),
            return_cell=True)
        if is_bidirec:
            bwd, bwd_c = dynamic_lstm(
                _reverse_time(x), 4 * hidden_size,
                name="%s_l%d_bwd" % (name, layer), return_cell=True)
            x = nn.concat([fwd, _reverse_time(bwd)], axis=2)
        else:
            x = fwd
        if dropout_prob and not is_test and layer + 1 < num_layers:
            x = nn.dropout(x, dropout_prob,
                           dropout_implementation="upscale_in_train")
    n_steps = fwd.shape[1]

    def _last(t):  # the final state: step T - 1 of the scan order
        return nn.slice(t, axes=[1], starts=[n_steps - 1], ends=[n_steps])

    if is_bidirec:
        # the backward pass's final state is its own step T - 1, read from
        # its trajectory before the un-reversal
        last_h = nn.concat([_last(fwd), _last(bwd)], axis=2)
        last_c = nn.concat([_last(fwd_c), _last(bwd_c)], axis=2)
    else:
        last_h, last_c = _last(fwd), _last(fwd_c)
    return x, last_h, last_c


def _reverse_time(x):
    """x [B, T, D] reversed along time (one ``reverse`` op)."""
    helper = LayerHelper("reverse_time")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": [1]})
    out.shape = x.shape
    return out


# -- the cell classes over StaticRNN -----------------------------------------


def _derived_attr(attr, suffix):
    """A parameter of its own per use: a named attr gets ``suffix`` added
    (one name over two shapes would alias them)."""
    if attr is None or getattr(attr, "name", None) is None:
        return attr
    from ..param_attr import ParamAttr

    return ParamAttr(name=attr.name + suffix)


class RNNCell:
    """Base cell: ``call(inputs, states) -> (outputs, new_states)``."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        from . import tensor

        shape = list(shape or [self.hidden_size])
        return tensor.fill_constant_batch_size_like(
            batch_ref, [-1] + shape, dtype, init_value,
            input_dim_idx=batch_dim_idx)

    @property
    def state_shape(self):
        return [self.hidden_size]


class GRUCell(RNNCell):
    """GRU cell: an input fc to 3H, then ``gru_unit``."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", activation="tanh",
                 dtype="float32", name="GRUCell"):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_activation = gate_activation or "sigmoid"
        self._activation = activation or "tanh"
        self._name = name

    def call(self, inputs, states):
        from . import nn

        proj = nn.fc(inputs, 3 * self.hidden_size,
                     param_attr=_derived_attr(self._param_attr, "_in"),
                     bias_attr=self._bias_attr, name=self._name + "_in")
        h, _, _ = gru_unit(proj, states, 3 * self.hidden_size,
                           param_attr=_derived_attr(self._param_attr, "_rec"),
                           bias_attr=self._bias_attr,
                           activation=self._activation,
                           gate_activation=self._gate_activation,
                           name=self._name)
        return h, h


class LSTMCell(RNNCell):
    """LSTM cell over ``lstm_unit``; states [hidden, cell].  Sigmoid gates
    and tanh only (``lstm_unit``'s)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        if gate_activation not in (None, "sigmoid") or activation not in (
                None, "tanh"):
            raise NotImplementedError(
                "LSTMCell supports only sigmoid gates / tanh activation "
                "(lstm_unit's fixed nonlinearity)")
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._forget_bias = forget_bias
        self._name = name

    def call(self, inputs, states):
        h_prev, c_prev = states
        h, c = lstm_unit(inputs, h_prev, c_prev,
                         forget_bias=self._forget_bias,
                         param_attr=self._param_attr,
                         bias_attr=self._bias_attr, name=self._name)
        return h, [h, c]

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        mk = super().get_initial_states
        return [mk(batch_ref, shape, dtype, init_value, batch_dim_idx),
                mk(batch_ref, shape, dtype, init_value, batch_dim_idx)]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """``cell`` over the time axis of inputs [B, T, F] ([T, B, F] when
    ``time_major``).  -> (outputs, final states in the cell's structure:
    [B, H], or [h, c] for an LSTMCell)."""
    from .control_flow import StaticRNN
    from . import nn

    if sequence_length is not None:
        raise NotImplementedError(
            "rnn(): sequence_length masking is not implemented — pad-safe "
            "models should mask outputs downstream (sequence ops) instead")
    batch_dim = 1 if time_major else 0
    if is_reverse:
        if time_major:
            x_bt = nn.transpose(inputs, [1, 0, 2])
            x = nn.transpose(_reverse_time(x_bt), [1, 0, 2])
        else:
            x = nn.transpose(_reverse_time(inputs), [1, 0, 2])
    else:
        x = inputs if time_major else nn.transpose(inputs, [1, 0, 2])
    multi_state = isinstance(cell.state_shape[0], (list, tuple))

    srnn = StaticRNN()
    with srnn.step():
        x_t = srnn.step_input(x)
        if multi_state:
            shapes = cell.state_shape
            inits = initial_states or [None] * len(shapes)
            states = [srnn.memory(init=inits[i], shape=(-1, shapes[i][0]),
                                  batch_ref=inputs, init_value=0.0,
                                  ref_batch_dim_idx=batch_dim)
                      for i in range(len(shapes))]
            out, new_states = cell.call(x_t, states)
            for s, ns in zip(states, new_states):
                srnn.update_memory(s, ns)
            srnn.step_output(out)
            for ns in new_states:
                srnn.step_output(ns)
        else:
            state = srnn.memory(init=initial_states,
                                shape=(-1, cell.state_shape[0]),
                                batch_ref=inputs, init_value=0.0,
                                ref_batch_dim_idx=batch_dim)
            out, new_state = cell.call(x_t, state)
            srnn.update_memory(state, new_state)
            srnn.step_output(out)
            srnn.step_output(new_state)
    results = srnn()
    if not isinstance(results, (list, tuple)):
        results = [results]
    outs = results[0]                       # [T, B, H]
    n_steps = outs.shape[0]

    def _final(traj):  # the last scan step, [B, H]
        last = nn.slice(traj, axes=[0], starts=[n_steps - 1],
                        ends=[n_steps])
        return nn.squeeze(last, [0])

    final_states = [_final(t) for t in results[1:]]
    outs_bt = nn.transpose(outs, [1, 0, 2])
    if is_reverse:
        outs_bt = _reverse_time(outs_bt)
    result = outs_bt if not time_major else nn.transpose(outs_bt, [1, 0, 2])
    if multi_state:
        return result, final_states
    return result, final_states[0]


def dynamic_decode(decoder, inits=None, max_step_num=None, **kwargs):
    """``decoder`` unrolled ``max_step_num`` steps (needed: the
    reference's static shapes).  A row's states freeze once its
    ``finished`` flag is set; its later outputs repeat.  -> (outputs [B,
    T, ...], final states)."""
    from . import nn, tensor

    if max_step_num is None:
        raise ValueError("dynamic_decode requires max_step_num on TPU "
                         "(static shapes)")
    inputs, states, _ = decoder.initialize(inits)
    step_outputs = []
    fin = None

    def _freeze(old, new):
        if fin is None:
            return new
        keep = nn.elementwise_mul(old, fin, axis=0)
        upd = nn.elementwise_mul(new, 1.0 - fin, axis=0)
        out = nn.elementwise_add(keep, upd)
        out.shape = new.shape
        return out

    for t in range(int(max_step_num)):
        out, new_states, inputs, finished = decoder.step(t, inputs, states)
        if isinstance(new_states, (list, tuple)):
            states = [_freeze(o, n) for o, n in zip(states, new_states)]
        else:
            states = _freeze(states, new_states)
        if finished is not None:
            f = tensor.cast(finished, "float32")
            fin = f if fin is None else nn.elementwise_max(fin, f)
        step_outputs.append(nn.unsqueeze(out, [1]))
    outputs = nn.concat(step_outputs, axis=1)
    return outputs, states


class BeamSearchDecoder:
    """Beam search over an RNNCell for ``dynamic_decode``, on flattened
    [B K, ...] tensors: each step expands the K beams over the vocabulary
    with the ``beam_search`` op, keeps the top K and reorders the cell
    states by their parents; a step's output is [tokens, parents] [B,
    2K], and ``finalize`` backtracks them with ``gather_tree``.  The
    decoder's states are [*cell states, logp [B K, 1], last tokens [B K,
    1]]."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _merge(self, x):      # [B, K, ...] -> [B*K, ...]
        from . import nn

        shape = [-1] + [int(d) for d in x.shape[2:]]
        out = nn.reshape(x, shape)
        out.shape = tuple(shape)
        return out

    def _split(self, x):      # [B*K, ...] -> [B, K, ...]
        from . import nn

        shape = [-1, self.beam_size] + [int(d) for d in x.shape[1:]]
        out = nn.reshape(x, shape)
        out.shape = tuple(shape)
        return out

    def initialize(self, inits):
        """The cell's initial states (batch B) tiled K times; beam 0 at
        log-prob 0 and the others at -1e9, so the first expansion draws
        from beam 0 only."""
        from . import nn, tensor

        k = self.beam_size
        states = inits if isinstance(inits, (list, tuple)) else [inits]

        def tile(s):  # [B, H] -> [B*K, H]
            e = nn.unsqueeze(s, [1])
            e.shape = (s.shape[0], 1) + tuple(s.shape[1:])
            e = nn.expand(e, [1, k, 1])
            e.shape = (s.shape[0], k) + tuple(s.shape[1:])
            return self._merge(e)

        tiled = [tile(s) for s in states]
        b = states[0]
        # logp [B*K, 1] as the outer product ones[B, 1] @ bias[1, K]
        ones_col = tensor.fill_constant_batch_size_like(b, [-1, 1],
                                                        "float32", 1.0)
        beam_bias = tensor.assign(
            np.array([[0.0] + [-1e9] * (k - 1)], "float32"))   # [1, K]
        logp = nn.reshape(nn.matmul(ones_col, beam_bias), [-1, 1])
        logp.shape = (-1, 1)
        start = tensor.fill_constant_batch_size_like(
            logp, [-1, 1], "int64", self.start_token)
        start.shape = (-1, 1)
        inputs = self.embedding_fn(start) if self.embedding_fn else start
        return inputs, tiled + [logp, start], None

    def step(self, time, inputs, states):
        from . import nn, tensor

        k = self.beam_size
        cell_states, logp, last_tok = states[:-2], states[-2], states[-1]
        cs = cell_states if len(cell_states) > 1 else cell_states[0]
        out, new_states = self.cell.call(inputs, cs)
        if not isinstance(new_states, (list, tuple)):
            new_states = [new_states]
        logits = self.output_fn(out) if self.output_fn else out
        lp_step = nn.log_softmax(logits)                 # [B*K, V]
        lp_step.shape = logits.shape
        v = int(lp_step.shape[-1])
        total = nn.elementwise_add(lp_step, logp, axis=0)
        total.shape = lp_step.shape
        total3 = nn.reshape(total, [-1, k, v])
        total3.shape = (-1, k, v)
        pre_ids = nn.reshape(last_tok, [-1, k])
        pre_ids.shape = (-1, k)
        pre_scores = nn.reshape(logp, [-1, k])
        pre_scores.shape = (-1, k)
        # the beam_search op keeps a finished beam on end_id at its score
        tokens, sel_scores, parents = beam_search(
            pre_ids, pre_scores, None, total3, k, self.end_token)
        tokens.shape = parents.shape = sel_scores.shape = (-1, k)

        def gather_beams(s):  # [B*K, H] reordered by the parents
            return self._merge(_batched_gather(self._split(s), parents))

        new_states = [gather_beams(s) for s in new_states]
        sv = nn.unsqueeze(sel_scores, [2])
        sv.shape = (-1, k, 1)
        new_logp = self._merge(sv)                       # [B*K, 1]
        tok_flat = nn.reshape(tokens, [-1, 1])           # [B*K, 1]
        tok_flat.shape = (-1, 1)
        inputs = self.embedding_fn(tok_flat) if self.embedding_fn else \
            tensor.cast(tok_flat, "float32")
        out_pair = nn.concat([tokens, parents], axis=1)  # [B, 2K]
        return out_pair, new_states + [new_logp, tok_flat], inputs, None

    def finalize(self, outputs):
        """outputs [B, T, 2K] of ``dynamic_decode`` -> sequences [T, B,
        K]."""
        from . import nn
        from .extra import gather_tree

        k = self.beam_size
        ids = nn.transpose(nn.slice(outputs, axes=[2], starts=[0],
                                    ends=[k]), [1, 0, 2])      # [T, B, K]
        parents = nn.transpose(nn.slice(outputs, axes=[2], starts=[k],
                                        ends=[2 * k]), [1, 0, 2])
        return gather_tree(ids, parents)


def _batched_gather(x, idx):
    """x [B, K, ...], idx [B, K] -> x[b, idx[b, k]] as a one-hot product."""
    from . import nn

    k = int(x.shape[1])
    # one_hot squeezes a trailing 1: [B, K, 1] -> [B, K, K] for every K
    idx3 = nn.unsqueeze(idx, [2])
    idx3.shape = (-1, k, 1)
    oh = nn.one_hot(idx3, k)                 # [B, K, K]
    oh.shape = (-1, k, k)
    flat = nn.reshape(x, [0, k, -1])         # [B, K, H]
    out = nn.matmul(oh, flat)                # [B, K, H]
    shape = [0, k] + [int(d) for d in x.shape[2:]]
    out2 = nn.reshape(out, shape)
    out2.shape = tuple([-1] + list(shape[1:]))
    return out2
