"""Multi-layer, optionally bidirectional GRU and LSTM, one
whole-recurrence op a direction.  Counterpart of
``paddle_tpu/contrib/layers/rnn_impl.py`` (``basic_gru:179``,
``basic_lstm:260``, ``_rnn_prologue:165``, ``_per_param_attr:146``);
the ops are ``ops/rnn.py``'s ``basic_gru_rnn`` and ``basic_lstm_rnn``.

The layers keep the reference's parameter names and order (per
direction, per layer: gate_w, cand_w, gate_b, cand_b for the GRU; w, b
for the LSTM; a named attr gets ``<name>_<fw|bw>_layers_<i>_<slot>``),
its ``sequence_length`` mask (``sequence_mask`` over the time-major
input's T, so a padded step leaves the states where they were), and its
backward direction over ``reverse``d input, mask and output.

``BasicGRUUnit`` and ``BasicLSTMUnit`` are dygraph Layers in the
reference; the port has no dygraph yet, so they raise.
"""

import copy

from ... import layers
from ...layer_helper import LayerHelper
from ...param_attr import ParamAttr

__all__ = ["BasicGRUUnit", "basic_gru", "BasicLSTMUnit", "basic_lstm"]

_ACT_NAMES = ("sigmoid", "tanh", "relu", "identity")


def _waits_for_dygraph(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "%s is not ported yet: it waits for dygraph (ROADMAP)" % name)

    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet: waits for dygraph."})


BasicGRUUnit = _waits_for_dygraph("BasicGRUUnit")
BasicLSTMUnit = _waits_for_dygraph("BasicLSTMUnit")


def _act_name(fn, default):
    """The op attr of an activation given as a layers.* callable or a
    name."""
    if fn is None:
        return default
    if isinstance(fn, str):
        if fn not in _ACT_NAMES:
            raise NotImplementedError("activation %r" % fn)
        return fn
    name = getattr(fn, "__name__", None)
    if name in ("sigmoid", "tanh", "relu"):
        return name
    raise NotImplementedError(
        "basic_gru/basic_lstm support sigmoid/tanh/relu activations; got %r"
        % (fn,))


def _per_param_attr(attr, pname, suffix):
    """A named attr made unique per direction, layer and slot (else every
    weight would alias one parameter)."""
    if attr is None or attr is False:
        return attr
    attr = ParamAttr._to_attr(attr)
    if not attr.name:
        return attr
    new = copy.copy(attr)
    new.name = "%s_%s_%s" % (attr.name, pname, suffix)
    return new


def _rnn_prologue(input, batch_first, sequence_length):
    """Time-major input and, with ``sequence_length``, its [T, B] mask."""
    if batch_first:
        input = layers.transpose(input, [1, 0, 2])
    mask = None
    if sequence_length is not None:
        max_seq_len = input.shape[0]
        mask = layers.sequence_mask(sequence_length, maxlen=max_seq_len,
                                    dtype="float32")
        mask = layers.transpose(mask, [1, 0])
    return input, mask


def _pick_direction(init, direc_index, num_layers, hidden_size):
    """Direction ``direc_index``'s [L, B, H] slice of an init reshaped to
    [L, dirs, B, H]."""
    return layers.reshape(
        layers.slice(init, axes=[1], starts=[direc_index],
                     ends=[direc_index + 1]),
        shape=[num_layers, -1, hidden_size])


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """-> (rnn_out [T, B, H dirs] (or batch first), last_hidden [L dirs,
    B, H]).  Dropout between layers and on the output is
    downgrade_in_infer."""
    g_act = _act_name(gate_activation, "sigmoid")
    c_act = _act_name(activation, "tanh")
    helper = LayerHelper(name)
    input, mask = _rnn_prologue(input, batch_first, sequence_length)
    input_size = input.shape[2]
    direc_num = 2 if bidirectional else 1
    if init_hidden is not None:
        init_hidden = layers.reshape(
            init_hidden, shape=[num_layers, direc_num, -1, hidden_size])

    def one_direction(rnn_input, rnn_mask, direc_index, dname):
        gw, cw, gb, cb = [], [], [], []
        for i in range(num_layers):
            layer_in = input_size if i == 0 else hidden_size
            pname = "%s_layers_%d" % (dname, i)
            gw.append(helper.create_parameter(
                attr=_per_param_attr(param_attr, pname, "gate_w"),
                shape=[layer_in + hidden_size, 2 * hidden_size],
                dtype=dtype))
            cw.append(helper.create_parameter(
                attr=_per_param_attr(param_attr, pname, "cand_w"),
                shape=[layer_in + hidden_size, hidden_size], dtype=dtype))
            gb.append(helper.create_parameter(
                attr=_per_param_attr(bias_attr, pname, "gate_b"),
                shape=[2 * hidden_size], dtype=dtype, is_bias=True))
            cb.append(helper.create_parameter(
                attr=_per_param_attr(bias_attr, pname, "cand_b"),
                shape=[hidden_size], dtype=dtype, is_bias=True))
        h0 = None
        if init_hidden is not None:
            h0 = _pick_direction(init_hidden, direc_index, num_layers,
                                 hidden_size)
        out = helper.create_variable_for_type_inference(dtype)
        last_h = helper.create_variable_for_type_inference(dtype)
        inputs = {"Input": [rnn_input], "GateWeight": gw, "CandWeight": cw,
                  "GateBias": gb, "CandBias": cb}
        if h0 is not None:
            inputs["InitHidden"] = [h0]
        if rnn_mask is not None:
            inputs["Mask"] = [rnn_mask]
        helper.append_op(
            type="basic_gru_rnn", inputs=inputs,
            outputs={"Out": [out], "LastHidden": [last_h]},
            attrs={"hidden_size": hidden_size, "num_layers": num_layers,
                   "dropout_prob": float(dropout_prob or 0.0),
                   "is_test": False, "gate_activation": g_act,
                   "activation": c_act})
        return out, last_h

    fw_out, fw_last = one_direction(input, mask, 0, "fw")
    if bidirectional:
        bw_in = layers.reverse(input, axis=[0])
        bw_mask = layers.reverse(mask, axis=[0]) if mask is not None \
            else None
        bw_out, bw_last = one_direction(bw_in, bw_mask, 1, "bw")
        bw_out = layers.reverse(bw_out, axis=[0])
        rnn_out = layers.concat([fw_out, bw_out], axis=2)
        last_hidden = layers.concat([fw_last, bw_last], axis=1)
        last_hidden = layers.reshape(
            last_hidden, shape=[num_layers * direc_num, -1, hidden_size])
    else:
        rnn_out, last_hidden = fw_out, fw_last
    if batch_first:
        rnn_out = layers.transpose(rnn_out, [1, 0, 2])
    return rnn_out, last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """-> (rnn_out, last_hidden, last_cell [L dirs, B, H]).  Dropout
    between layers and on the output is upscale_in_train."""
    g_act = _act_name(gate_activation, "sigmoid")
    c_act = _act_name(activation, "tanh")
    helper = LayerHelper(name)
    input, mask = _rnn_prologue(input, batch_first, sequence_length)
    input_size = input.shape[2]
    direc_num = 2 if bidirectional else 1
    if init_hidden is not None:
        init_hidden = layers.reshape(
            init_hidden, shape=[num_layers, direc_num, -1, hidden_size])
    if init_cell is not None:
        init_cell = layers.reshape(
            init_cell, shape=[num_layers, direc_num, -1, hidden_size])

    def one_direction(rnn_input, rnn_mask, direc_index, dname):
        ws, bs = [], []
        for i in range(num_layers):
            layer_in = input_size if i == 0 else hidden_size
            pname = "%s_layers_%d" % (dname, i)
            ws.append(helper.create_parameter(
                attr=_per_param_attr(param_attr, pname, "w"),
                shape=[layer_in + hidden_size, 4 * hidden_size],
                dtype=dtype))
            bs.append(helper.create_parameter(
                attr=_per_param_attr(bias_attr, pname, "b"),
                shape=[4 * hidden_size], dtype=dtype, is_bias=True))
        h0 = c0 = None
        if init_hidden is not None:
            h0 = _pick_direction(init_hidden, direc_index, num_layers,
                                 hidden_size)
        if init_cell is not None:
            c0 = _pick_direction(init_cell, direc_index, num_layers,
                                 hidden_size)
        out = helper.create_variable_for_type_inference(dtype)
        last_h = helper.create_variable_for_type_inference(dtype)
        last_c = helper.create_variable_for_type_inference(dtype)
        inputs = {"Input": [rnn_input], "Weight": ws, "Bias": bs}
        if h0 is not None:
            inputs["InitHidden"] = [h0]
        if c0 is not None:
            inputs["InitCell"] = [c0]
        if rnn_mask is not None:
            inputs["Mask"] = [rnn_mask]
        helper.append_op(
            type="basic_lstm_rnn", inputs=inputs,
            outputs={"Out": [out], "LastHidden": [last_h],
                     "LastCell": [last_c]},
            attrs={"hidden_size": hidden_size, "num_layers": num_layers,
                   "dropout_prob": float(dropout_prob or 0.0),
                   "is_test": False, "forget_bias": float(forget_bias),
                   "gate_activation": g_act, "activation": c_act})
        return out, last_h, last_c

    fw_out, fw_last_h, fw_last_c = one_direction(input, mask, 0, "fw")
    if bidirectional:
        bw_in = layers.reverse(input, axis=[0])
        bw_mask = layers.reverse(mask, axis=[0]) if mask is not None \
            else None
        bw_out, bw_last_h, bw_last_c = one_direction(bw_in, bw_mask, 1, "bw")
        bw_out = layers.reverse(bw_out, axis=[0])
        rnn_out = layers.concat([fw_out, bw_out], axis=2)
        last_hidden = layers.reshape(
            layers.concat([fw_last_h, bw_last_h], axis=1),
            shape=[num_layers * direc_num, -1, hidden_size])
        last_cell = layers.reshape(
            layers.concat([fw_last_c, bw_last_c], axis=1),
            shape=[num_layers * direc_num, -1, hidden_size])
    else:
        rnn_out, last_hidden, last_cell = fw_out, fw_last_h, fw_last_c
    if batch_first:
        rnn_out = layers.transpose(rnn_out, [1, 0, 2])
    return rnn_out, last_hidden, last_cell
