"""A state cell and two decoders over it.  Counterpart of
``paddle_tpu/contrib/decoder/beam_search_decoder.py`` (``InitState:36``,
``StateCell:97``, ``TrainingDecoder:204``, ``BeamSearchDecoder:263``).

The reference keeps Fluid's API over its dense design, and so does the
port:

* ``StateCell``: ``inputs`` / ``states`` dicts, an updater registered
  with ``@state_cell.state_updater``, ``compute_state``, ``get_state``,
  ``set_state`` and ``update_states``.
* ``TrainingDecoder``: teacher-forced steps inside ``with
  decoder.block():`` over a ``StaticRNN``, the states its memories.
* ``BeamSearchDecoder``: ``decode()`` unrolls ``max_len`` steps of a
  dense [batch, beam] beam (the ``beam_search`` op keeps a finished beam
  on ``end_id``, so no step stops early), each step an embedding of the
  last ids, the cell, a softmax fc and, below ``topk_size``, a mask of
  all but each beam's top candidates; ``beam_search_decode`` backtracks
  the stacked ids, parents and scores.
"""

import contextlib

import numpy as np

from ... import layers
from ...layers import tensor as ltensor
from ...param_attr import ParamAttr

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """A state's initial value: ``init``, or a constant of ``shape`` and
    ``value`` with the batch of ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the shape of "
                "InitState .\n")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape or [-1, 1],
                dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState(object):
    """A training state: a StaticRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _DenseState(object):
    """A beam-search state: the variable of the latest unrolled step."""

    def __init__(self, state_name, init_state):
        self._state_name = state_name
        self._var = init_state.value

    def get_state(self):
        return self._var

    def update_state(self, state):
        self._var = state


class StateCell(object):
    """The decoder's states and the updater that advances them a step.

    ``inputs``: name -> Variable or None (filled each step through
    ``compute_state``); ``states``: name -> InitState; ``out_state``: the
    state a step exposes."""

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)
        self._cur_states = {}
        self._state_names = []
        self._states_holder = {}
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object.")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._out_state = out_state
        self._state_updater = None
        self._cur_decoder_obj = None
        self._switched_decoder = False
        self._in_decoder = False

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder:
            raise ValueError("StateCell has already entered a decoder.")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._cur_decoder_obj is not decoder_obj:
            raise ValueError("StateCell not in decoder %r" % decoder_obj)
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must be in a decoder.")
        if self._switched_decoder:
            raise ValueError("StateCell already switched.")
        for state_name in self._state_names:
            init = self._cur_states[state_name]
            if not isinstance(init, InitState):
                raise ValueError("init state diverged before switch")
            if self._cur_decoder_obj.type == _DecoderType.TRAINING:
                holder = _MemoryState(state_name,
                                      self._cur_decoder_obj.dynamic_rnn,
                                      init)
            else:
                holder = _DenseState(state_name, init)
            self._states_holder[state_name] = holder
            self._cur_states[state_name] = holder.get_state()
        self._switched_decoder = True

    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError("Unknown state %s." % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError("Invalid input %s." % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError("updater is bound to another cell")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError("Unknown input %s." % input_name)
            self._inputs[input_name] = input_value
        self._state_updater(self)

    def update_states(self):
        if self._in_decoder and not self._switched_decoder:
            raise ValueError("update_states before compute_state")
        for state_name, holder in self._states_holder.items():
            holder.update_state(self._cur_states[state_name])
            self._cur_states[state_name] = holder.get_state()

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoding: the step's layers inside ``with
    decoder.block():``, over a StaticRNN."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._status = TrainingDecoder.BEFORE_DECODER
        self.dynamic_rnn = layers.StaticRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell._enter_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def type(self):
        return self._type

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("decoder.block() can only be invoked once")
        self._status = TrainingDecoder.IN_DECODER
        with self.dynamic_rnn.step():
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        """x: a time-major teacher sequence [T, B, D] -> its step [B,
        D]."""
        self._assert_in_decoder_block("step_input")
        return self.dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return x

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self.dynamic_rnn.step_output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("Output of training decoder can only be "
                             "visited outside the block.")
        return self.dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError("%s should be invoked inside block of "
                             "TrainingDecoder object." % method)


class BeamSearchDecoder(object):
    """Dense beam search of ``max_len`` unrolled steps; ``decode()`` builds
    it, ``decoder()`` returns (SentenceIds, SentenceScores)."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._state_cell = state_cell
        self._type = _DecoderType.BEAM_SEARCH
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._name = name or "beam_search_decoder"
        self._decoded = False
        self._result = None
        self._state_cell._enter_decoder(self)

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def type(self):
        return self._type

    def decode(self):
        """Build the unrolled dense beam search."""
        if self._decoded:
            raise ValueError("decode() can only be invoked once")
        k = self._beam_size
        pre_ids = layers.reshape(self._init_ids, shape=[-1, k])
        pre_scores = layers.reshape(self._init_scores, shape=[-1, k])
        # beams 1..K-1 start at -1e9 (beam 0 alone expands at step 0):
        # all-zero init scores would otherwise decode K equal sequences;
        # an outer product, so the batch may be dynamic
        ones_col = ltensor.fill_constant_batch_size_like(
            pre_scores, [-1, 1], "float32", 1.0)
        beam_bias = ltensor.assign(
            np.array([[0.0] + [-1e9] * (k - 1)], "float32"))
        pre_scores = layers.elementwise_add(
            pre_scores, layers.matmul(ones_col, beam_bias))

        # every state beam-expanded: [B, D] -> [B*K, D]
        for state_name in self._state_cell._state_names:
            st = self._state_cell.get_state(state_name)
            ex = layers.expand(layers.unsqueeze(st, axes=[1]),
                               expand_times=[1, k, 1])
            self._state_cell.set_state(
                state_name, layers.reshape(ex, shape=[-1, st.shape[-1]]))
        self._state_cell.update_states()

        step_ids, step_parents, step_scores = [], [], []
        for _ in range(self._max_len):
            prev_ids_flat = layers.reshape(pre_ids, shape=[-1, 1])
            emb = layers.embedding(
                input=prev_ids_flat,
                size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=ParamAttr(name=self._name + "_emb"))
            emb = layers.reshape(emb, shape=[-1, self._word_dim])

            feed_dict = {}
            for name, var in self._input_var_dict.items():
                if name not in self._state_cell._inputs:
                    raise ValueError(
                        "Variable %s not found in StateCell!\n" % name)
                feed_dict[name] = var
            for input_name in self._state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = emb

            self._state_cell.compute_state(inputs=feed_dict)
            current_state = self._state_cell.out_state()
            scores = layers.fc(
                current_state, self._target_dict_dim, act="softmax",
                param_attr=ParamAttr(name=self._name + "_fc_w"),
                bias_attr=ParamAttr(name=self._name + "_fc_b"))
            log_scores = layers.reshape(
                layers.log(scores), shape=[-1, k, self._target_dict_dim])
            if self._topk_size < self._target_dict_dim:
                # every candidate below its beam's top-k threshold -> -1e9
                # (the candidate set of the reference's topk pre-prune)
                topk_vals, _ = layers.topk(log_scores, self._topk_size)
                thresh = layers.slice(
                    topk_vals, axes=[2], starts=[self._topk_size - 1],
                    ends=[self._topk_size])           # [B, K, 1]
                keep = layers.cast(
                    layers.greater_equal(log_scores, thresh), "float32")
                log_scores = layers.elementwise_add(
                    layers.elementwise_mul(log_scores, keep),
                    layers.scale(keep, scale=1e9, bias=-1e9))
            # axis=0 aligns pre_scores [B, K] with log_scores' leading dims
            accu = layers.elementwise_add(log_scores, pre_scores, axis=0)
            sel_ids, sel_scores, parent_idx = layers.beam_search(
                pre_ids, pre_scores, None, accu, k, self._end_id)
            # the states reordered by the winning parents
            for state_name in self._state_cell._state_names:
                st = self._state_cell.get_state(state_name)
                st_k = layers.reshape(st, shape=[-1, k, st.shape[-1]])
                picked = self._gather_beams(st_k, parent_idx, k)
                new_st = layers.reshape(picked, shape=[-1, st.shape[-1]])
                # the one-hot gather loses the B*K dim; the next fc's
                # shape check wants it back
                if st.shape is not None:
                    new_st.shape = tuple(st.shape)
                self._state_cell.set_state(state_name, new_st)
            self._state_cell.update_states()

            step_ids.append(sel_ids)
            step_parents.append(parent_idx)
            step_scores.append(sel_scores)
            pre_ids, pre_scores = sel_ids, sel_scores

        ids_arr = layers.stack(step_ids, axis=0)        # [T, B, K]
        parents_arr = layers.stack(step_parents, axis=0)
        scores_arr = layers.stack(step_scores, axis=0)
        self._result = layers.beam_search_decode(
            ids_arr, parents_arr, scores=scores_arr, beam_size=k,
            end_id=self._end_id)
        self._decoded = True
        self._state_cell._leave_decoder(self)

    @staticmethod
    def _gather_beams(state_k, parent_idx, beam_size):
        """state_k [B, K, D] and parent_idx [B, K] -> each batch's rows
        picked by parent (``layers/rnn.py``'s one-hot gather)."""
        from ...layers.rnn import _batched_gather

        return _batched_gather(state_k, parent_idx)

    def early_stop(self):
        """A finished beam already stays on end_id (the beam_search op),
        so no step stops early."""

    def __call__(self):
        if not self._decoded:
            raise ValueError("decode() must be called before the decoder")
        return self._result
