"""The LSTM language model of Zaremba, Sutskever and Vinyals 2014
("Recurrent Neural Network Regularization"), as PaddleNLP's
``language_model/lm_model.py`` builds it, through the port's layer API.

``lm_model`` follows that file: an embedding, upscale_in_train dropout,
the recurrence, dropout, the softmax projection (``softmax_weight``,
``softmax_bias``) and ``softmax_with_cross_entropy``; the loss is the
batch mean summed over the unrolled steps.  ``init_hidden`` and
``init_cell`` [L, B, H] are fed, and ``last_hidden`` / ``last_cell``
fetched so a driver carries them to the next batch (truncated BPTT).  Two
emissions of the recurrence:

* ``rnn_model="basic_lstm"``: contrib's ``basic_lstm`` (one
  ``basic_lstm_rnn`` op; its dropout between layers and on its output,
  drawn in the op), forget bias 0, the init_scale uniform on its weights;
  it reads the fed states and returns [L, B, H] ones.
* ``rnn_model="cudnn"``: ``layers.lstm`` (a ``dynamic_lstm`` StaticRNN a
  layer, dropout ops between layers), then a dropout op.  The repo's
  ``lstm`` takes batch-major input, where Fluid's takes time-major, so
  the embedding goes in without PaddleNLP's transposes; it reads neither
  the fed states nor ``default_initializer`` and returns the last
  layer's final states [B, 1, H] (ROADMAP, section C).

Two GRU emissions take the same shape: ``rnn_model="basic_gru"``
(contrib's ``basic_gru``, one ``basic_gru_rnn`` op, its own dropout rule:
downgrade_in_infer) and ``rnn_model="dynamic_gru"`` (a ``dynamic_gru``
layer under ``rnn`` over a ``GRUCell``, dropout ops between them and on
the output); both return the layers' final hidden states [L, B, H] and
no cell state (None).

``build_train`` adds SGD under a global-norm clip.  ``PTB_LARGE`` is the
paper's large setting (PaddleNLP's ``large`` config); ``PTB_TINY`` the
size of the CPU tests.  ``markov_stream`` makes a token stream from a
seeded Markov source over the vocabulary, Zipf-distributed successors, so
training has something to learn until the PTB text is in the repo.
"""

import numpy as np

from .. import layers
from ..clip import GradientClipByGlobalNorm
from ..contrib.layers import basic_gru, basic_lstm
from ..initializer import Constant, UniformInitializer
from ..optimizer import SGD
from ..param_attr import ParamAttr

__all__ = ["LmConfig", "PTB_LARGE", "PTB_TINY", "lm_model", "build_train",
           "markov_stream", "batches"]


class LmConfig:
    def __init__(self, vocab_size=10000, hidden_size=1500, num_layers=2,
                 num_steps=35, batch_size=20, init_scale=0.04, dropout=0.65,
                 lr=1.0, max_grad_norm=10.0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_steps = num_steps
        self.batch_size = batch_size
        self.init_scale = init_scale
        self.dropout = dropout
        self.lr = lr
        self.max_grad_norm = max_grad_norm

    def replace(self, **kw):
        d = dict(self.__dict__)
        d.update(kw)
        return LmConfig(**d)


PTB_LARGE = LmConfig()
PTB_TINY = LmConfig(vocab_size=50, hidden_size=16, num_layers=2, num_steps=6,
                    batch_size=4, init_scale=0.1, dropout=0.0)


def _uniform(scale):
    return UniformInitializer(low=-scale, high=scale)


def lm_model(cfg, rnn_model="basic_lstm"):
    """-> (loss, last_hidden, last_cell or None); feeds x [B, T, 1] and y
    [B T, 1] int64, init_hidden and init_cell [L, B, H]."""
    h, n_layers, n_steps, b = (cfg.hidden_size, cfg.num_layers,
                               cfg.num_steps, cfg.batch_size)
    dropout = cfg.dropout
    x = layers.data(name="x", shape=[b, n_steps, 1], dtype="int64",
                    append_batch_size=False)
    y = layers.data(name="y", shape=[b * n_steps, 1], dtype="int64",
                    append_batch_size=False)
    init_hidden = layers.data(name="init_hidden", shape=[n_layers, b, h],
                              dtype="float32", append_batch_size=False)
    init_cell = layers.data(name="init_cell", shape=[n_layers, b, h],
                            dtype="float32", append_batch_size=False)
    init_hidden_reshape = layers.reshape(init_hidden, shape=[n_layers, -1, h])
    init_cell_reshape = layers.reshape(init_cell, shape=[n_layers, -1, h])
    x_emb = layers.embedding(
        input=x, size=[cfg.vocab_size, h], dtype="float32", is_sparse=False,
        param_attr=ParamAttr(name="embedding_para",
                             initializer=_uniform(cfg.init_scale)))
    x_emb = layers.reshape(x_emb, shape=[-1, n_steps, h])
    if dropout:
        x_emb = layers.dropout(x_emb, dropout_prob=dropout,
                               dropout_implementation="upscale_in_train")
    if rnn_model == "cudnn":
        rnn_out, last_hidden, last_cell = layers.lstm(
            x_emb, init_hidden_reshape, init_cell_reshape, n_steps, h,
            n_layers, dropout_prob=dropout,
            default_initializer=_uniform(cfg.init_scale))
        if dropout:
            rnn_out = layers.dropout(
                rnn_out, dropout_prob=dropout,
                dropout_implementation="upscale_in_train")
    elif rnn_model == "basic_gru":
        rnn_out, last_hidden = basic_gru(
            x_emb, init_hidden, h, num_layers=n_layers, batch_first=True,
            dropout_prob=dropout,
            param_attr=ParamAttr(initializer=_uniform(cfg.init_scale)),
            bias_attr=ParamAttr(initializer=Constant(0.0)))
        last_cell = None
    elif rnn_model == "dynamic_gru":
        if n_layers != 2:
            raise ValueError("the dynamic_gru emission has 2 layers")
        out1 = layers.dynamic_gru(
            layers.fc(x_emb, 3 * h, num_flatten_dims=2), h,
            h_0=layers.reshape(layers.slice(init_hidden_reshape, axes=[0],
                                            starts=[0], ends=[1]), [-1, h]))
        last_1 = layers.reshape(layers.slice(
            out1, axes=[1], starts=[n_steps - 1], ends=[n_steps]),
            [1, -1, h])
        if dropout:
            out1 = layers.dropout(out1, dropout_prob=dropout,
                                  dropout_implementation="upscale_in_train")
        h_1 = layers.reshape(layers.slice(init_hidden_reshape, axes=[0],
                                          starts=[1], ends=[2]), [-1, h])
        rnn_out, last_2 = layers.rnn(layers.GRUCell(h), out1,
                                     initial_states=h_1)
        if dropout:
            rnn_out = layers.dropout(
                rnn_out, dropout_prob=dropout,
                dropout_implementation="upscale_in_train")
        last_hidden = layers.concat(
            [last_1, layers.reshape(last_2, [1, -1, h])], axis=0)
        last_cell = None
    elif rnn_model == "basic_lstm":
        rnn_out, last_hidden, last_cell = basic_lstm(
            x_emb, init_hidden, init_cell, h, num_layers=n_layers,
            batch_first=True, dropout_prob=dropout,
            param_attr=ParamAttr(initializer=_uniform(cfg.init_scale)),
            bias_attr=ParamAttr(initializer=Constant(0.0)), forget_bias=0.0)
    else:
        raise ValueError("rnn_model %r: the port builds 'basic_lstm', "
                         "'cudnn', 'basic_gru' and 'dynamic_gru'"
                         % (rnn_model,))
    rnn_out = layers.reshape(rnn_out, shape=[-1, n_steps, h])
    softmax_weight = layers.create_parameter(
        [h, cfg.vocab_size], dtype="float32", name="softmax_weight",
        default_initializer=_uniform(cfg.init_scale))
    softmax_bias = layers.create_parameter(
        [cfg.vocab_size], dtype="float32", name="softmax_bias",
        default_initializer=_uniform(cfg.init_scale))
    projection = layers.matmul(rnn_out, softmax_weight)
    projection = layers.elementwise_add(projection, softmax_bias)
    projection = layers.reshape(projection, shape=[-1, cfg.vocab_size])
    loss = layers.softmax_with_cross_entropy(logits=projection, label=y,
                                             soft_label=False)
    loss = layers.reshape(loss, shape=[-1, n_steps])
    loss = layers.reduce_mean(loss, dim=[0])
    loss = layers.reduce_sum(loss)
    return loss, last_hidden, last_cell


def build_train(cfg, rnn_model="basic_lstm"):
    """``lm_model`` and SGD at ``cfg.lr`` under a global-norm clip of
    ``cfg.max_grad_norm`` -> (loss, last_hidden, last_cell)."""
    loss, last_hidden, last_cell = lm_model(cfg, rnn_model)
    SGD(learning_rate=cfg.lr,
        grad_clip=GradientClipByGlobalNorm(clip_norm=cfg.max_grad_norm)
        ).minimize(loss)
    return loss, last_hidden, last_cell


def markov_stream(vocab_size, n_tokens, seed=0, fanout=4):
    """``n_tokens`` int64 tokens of a seeded Markov source: each token has
    ``fanout`` successors, drawn from a Zipf law over the vocabulary (as
    words are: the unigram a model learns first), followed with
    probabilities 0.55, 0.25, 0.12, 0.08 (for fanout 4)."""
    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, vocab_size + 1)
    succ = rng.choice(vocab_size, size=(vocab_size, fanout),
                      p=zipf / zipf.sum())
    probs = np.array([0.55, 0.25, 0.12, 0.08][:fanout])
    probs = probs / probs.sum()
    picks = rng.choice(fanout, size=n_tokens, p=probs)
    out = np.empty(n_tokens, np.int64)
    tok = rng.randint(vocab_size)
    for i in range(n_tokens):
        out[i] = tok
        tok = succ[tok, picks[i]]
    return out


def batches(cfg, n_batches, seed=0):
    """Feeds x, y of ``n_batches`` consecutive truncated-BPTT windows of
    ``cfg.batch_size`` parallel streams (PaddleNLP's ``ptb_iterator``
    layout: stream b reads its own contiguous stretch)."""
    b, t = cfg.batch_size, cfg.num_steps
    data = markov_stream(cfg.vocab_size, b * (n_batches * t + 1), seed)
    data = data.reshape(b, -1)
    for i in range(n_batches):
        x = data[:, i * t:(i + 1) * t]
        y = data[:, i * t + 1:(i + 1) * t + 1]
        yield {"x": x.reshape(b, t, 1), "y": y.reshape(b * t, 1)}
