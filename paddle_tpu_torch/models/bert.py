"""BERT-style transformer encoder built from the port's layer API.

Counterpart of ``paddle_tpu/models/bert.py``: the same configurations,
layer calls and parameter names, so the two packages build identical
programs and share saved weights.  Every emission of the reference but
one:

* without dropout (inference, or training at ``dropout=0``): one
  ``flash_attention`` op per layer;
* training at dropout p (BERT's published 0.1 by default): a ``dropout``
  op on the embeddings and, per layer, the composed attention
  (``matmul`` with alpha, the bias ``elementwise_add``, ``softmax``,
  ``dropout``, ``matmul``);
* training with ``BERT_FUSED_ATTN=1`` in the environment (read at build
  time, where the reference reads it): one ``flash_attention`` op with
  in-op dropout per layer, which ``FLAGS_fused_small_attention`` routes
  to the small-sequence kernels;

each with two ``fused_dropout_add_ln`` epilogues per layer (dropout p in
training), a ``layer_norm`` on the embeddings, and ``build_pretrain``'s
masked-LM head with Adam (``amp=True``: the bf16 AMP policy's decorated
Adam, as the reference's ``bench.py`` trains it).  The reference's
``BERT_COMPOSED_LN=1``
epilogue is not carried: building with it set raises.  ``pretrain_feed``
makes the pretraining feed of the reference's ``bench.py``
(``_bert_feed``).
"""

import os

import numpy as np

from .. import layers
from ..contrib import mixed_precision
from ..optimizer import Adam
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "BERT_BASE", "BERT_TINY", "multi_head_attention",
           "encoder_layer", "embeddings", "bert_encoder", "build_pretrain",
           "MASK_FRAC", "no_weight_decay", "pretrain_feed"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 ffn=3072, max_pos=512, type_vocab=2, dropout=0.1):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.ffn = ffn
        self.max_pos = max_pos
        self.type_vocab = type_vocab
        self.dropout = dropout


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                       ffn=128, max_pos=64)


def multi_head_attention(x, cfg, prefix, is_test=False, attn_mask=None):
    """Self-attention: q/k/v projections, the attention of the emission
    (see the module's docstring), the output projection."""
    h, heads = cfg.hidden, cfg.heads
    d = h // heads
    q = layers.fc(x, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=prefix + "_q_w"))
    k = layers.fc(x, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=prefix + "_k_w"))
    v = layers.fc(x, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=prefix + "_v_w"))

    def split_heads(t):
        t = layers.reshape(t, [0, 0, heads, d])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if is_test or not cfg.dropout:
        ctxv = layers.flash_attention(q, k, v, bias_qk=attn_mask,
                                      scale=d ** -0.5)
    elif os.environ.get("BERT_FUSED_ATTN") == "1":
        # in-op attention-prob dropout: the small-sequence kernels under
        # FLAGS_fused_small_attention, else the composed route inside the op
        ctxv = layers.flash_attention(q, k, v, bias_qk=attn_mask,
                                      scale=d ** -0.5,
                                      dropout_prob=cfg.dropout,
                                      is_test=is_test)
    else:
        scores = layers.matmul(q, k, transpose_y=True, alpha=d ** -0.5)
        if attn_mask is not None:
            scores = layers.elementwise_add(scores, attn_mask)
        probs = layers.dropout(layers.softmax(scores), cfg.dropout,
                               is_test=is_test,
                               dropout_implementation="upscale_in_train")
        ctxv = layers.matmul(probs, v)
    ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
    ctxv = layers.reshape(ctxv, [0, 0, h])
    return layers.fc(ctxv, h, num_flatten_dims=2,
                     param_attr=ParamAttr(name=prefix + "_out_w"))


def _epilogue(x, y, cfg, is_test):
    if os.environ.get("BERT_COMPOSED_LN") == "1":
        raise NotImplementedError(
            "BERT_COMPOSED_LN=1 (the reference's composed dropout, add and "
            "layer_norm epilogue) is not ported: unset it to build the "
            "fused_dropout_add_ln epilogue")
    return layers.fused_dropout_add_ln(x, y, dropout_prob=cfg.dropout,
                                       is_test=is_test, begin_norm_axis=2)


def encoder_layer(x, cfg, prefix, is_test=False, attn_mask=None):
    attn = multi_head_attention(x, cfg, prefix + "_attn", is_test, attn_mask)
    x = _epilogue(x, attn, cfg, is_test)
    ffn = layers.fc(x, cfg.ffn, num_flatten_dims=2, act="gelu",
                    param_attr=ParamAttr(name=prefix + "_ffn1_w"))
    ffn = layers.fc(ffn, cfg.hidden, num_flatten_dims=2,
                    param_attr=ParamAttr(name=prefix + "_ffn2_w"))
    return _epilogue(x, ffn, cfg, is_test)


def embeddings(src_ids, pos_ids, sent_ids, cfg, is_test=False):
    w = layers.embedding(src_ids, (cfg.vocab_size, cfg.hidden),
                         param_attr=ParamAttr(name="word_emb"))
    p = layers.embedding(pos_ids, (cfg.max_pos, cfg.hidden),
                         param_attr=ParamAttr(name="pos_emb"))
    s = layers.embedding(sent_ids, (cfg.type_vocab, cfg.hidden),
                         param_attr=ParamAttr(name="sent_emb"))
    emb = layers.elementwise_add(layers.elementwise_add(w, p), s)
    emb = layers.layer_norm(emb, begin_norm_axis=2)
    if cfg.dropout and not is_test:
        emb = layers.dropout(emb, cfg.dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return emb


def bert_encoder(cfg, seq_len, is_test=False):
    """Declare the four inputs and build the encoder stack; returns
    (inputs, sequence_output)."""
    src_ids = layers.data("src_ids", shape=[seq_len, 1], dtype="int64")
    pos_ids = layers.data("pos_ids", shape=[seq_len, 1], dtype="int64")
    sent_ids = layers.data("sent_ids", shape=[seq_len, 1], dtype="int64")
    input_mask = layers.data("input_mask", shape=[seq_len, 1])
    x = embeddings(src_ids, pos_ids, sent_ids, cfg, is_test)
    # attention bias: 1e4 * m m^T - 1e4 is 0 where both tokens are real
    # and -1e4 where either is padding
    mask2d = layers.matmul(input_mask, input_mask, transpose_y=True)
    attn_mask = layers.scale(mask2d, scale=1e4, bias=-1e4)
    attn_mask = layers.unsqueeze(attn_mask, [1])  # [B, 1, S, S]
    for i in range(cfg.layers):
        x = encoder_layer(x, cfg, "layer_%d" % i, is_test, attn_mask)
    return (src_ids, pos_ids, sent_ids, input_mask), x


def build_pretrain(cfg=BERT_BASE, seq_len=128, lr=1e-4, is_test=False,
                   amp=False, optimizer=None):
    """Masked-LM pretraining: the encoder, a gather of the mask positions
    (flat indices into [batch * seq_len]), fc + gelu, layer_norm, fc to
    the vocabulary, softmax_with_cross_entropy and mean; with
    ``is_test=False`` Adam(lr).minimize(loss), the Adam decorated by
    ``mixed_precision.decorate`` under ``amp`` (the program the
    reference's ``bench.py`` trains, ``_bench_bert_at``), or
    ``optimizer().minimize(loss)`` where a callable is given (LAMB's
    recipe: ``Lamb(..., exclude_from_weight_decay_fn=no_weight_decay)``).
    Returns (inputs + (mask_pos, mask_label), loss)."""
    inputs, seq_out = bert_encoder(cfg, seq_len, is_test)
    mask_pos = layers.data("mask_pos", shape=[1], dtype="int64")
    mask_label = layers.data("mask_label", shape=[1], dtype="int64")
    flat = layers.reshape(seq_out, [-1, cfg.hidden])
    picked = layers.gather(flat, mask_pos)
    trans = layers.fc(picked, cfg.hidden, act="gelu")
    trans = layers.layer_norm(trans, begin_norm_axis=1)
    logits = layers.fc(trans, cfg.vocab_size)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, mask_label))
    if not is_test:
        opt = Adam(learning_rate=lr) if optimizer is None else optimizer()
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return inputs + (mask_pos, mask_label), loss


def no_weight_decay(param):
    """LAMB's BERT recipe (You et al. 2019): no weight decay on the
    LayerNorm scales and shifts (``layer_norm_*``,
    ``fused_dropout_add_ln_*``) or on any bias (``*.b_0``)."""
    return param.name.endswith(".b_0") or param.name.startswith(
        ("layer_norm", "fused_dropout_add_ln"))


# share of a batch's tokens that the masked-LM head predicts
MASK_FRAC = 0.15


def pretrain_feed(rng, cfg, batch, seq_len):
    """A ``build_pretrain`` feed from the numpy RandomState ``rng``:
    random ids, every token real, int(batch * seq_len * MASK_FRAC) mask
    positions (flat indices) drawn with replacement, random labels."""
    n_mask = max(int(batch * seq_len * MASK_FRAC), 1)
    return {
        "src_ids": rng.randint(0, cfg.vocab_size,
                               (batch, seq_len, 1)).astype("int64"),
        "pos_ids": np.tile(np.arange(seq_len).reshape(1, seq_len, 1),
                           (batch, 1, 1)).astype("int64"),
        "sent_ids": np.zeros((batch, seq_len, 1), "int64"),
        "input_mask": np.ones((batch, seq_len, 1), "float32"),
        "mask_pos": rng.randint(0, batch * seq_len, (n_mask,)).astype("int64"),
        "mask_label": rng.randint(0, cfg.vocab_size,
                                  (n_mask, 1)).astype("int64"),
    }
