"""Transformer NMT (encoder-decoder) built from the port's layer API.

Counterpart of ``paddle_tpu/models/transformer.py``: the same
configurations, layer calls and parameter names, so the two packages
build the same training and beam programs and share weights.  Multi-head
attention is composed (``matmul``, the additive -1e9 mask, ``softmax``,
``dropout``, ``matmul``), as the reference emits it: never the flash op.
Positions are sinusoidal tables and masks numpy constants of the program
(``assign_value``).  ``build_train`` takes label-smoothed cross entropy
over padded batches weighted per token, under the noam schedule, with
Adam(beta1 0.9, beta2 0.997, eps 1e-9).  ``build_beam_infer`` unrolls the
decode loop at build time: step t re-runs the decoder over the whole
prefix [B K, t + 1] (no cache), takes the last position's log-probs,
``beam_search`` picks the K best (parent, token) pairs, and the prefixes
are re-ordered by a one-hot product with the parents;
``beam_search_decode`` backtracks the arrays of ids and parents.

``TRANSFORMER_BASE`` is transformer-base at the widths of the reference's
``bench.py`` ``nmt`` configuration (Vaswani et al. 2017, with a 30000
vocabulary each side); ``TRANSFORMER_TINY`` the reference's bundled
``transformer_tiny`` (``paddle_tpu/models/__init__.py``).
"""

import numpy as np

from .. import layers
from ..optimizer import Adam
from ..param_attr import ParamAttr

__all__ = ["BOS", "EOS", "TransformerConfig", "TRANSFORMER_BASE",
           "TRANSFORMER_TINY", "encoder", "decoder", "build_train",
           "build_beam_infer", "pad_batch"]

BOS, EOS = 0, 1


class TransformerConfig:
    def __init__(self, src_vocab=1000, trg_vocab=1000, d_model=64, heads=4,
                 enc_layers=2, dec_layers=2, ffn=128, max_len=64,
                 dropout=0.1, label_smooth=0.1):
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.d_model = d_model
        self.heads = heads
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.ffn = ffn
        self.max_len = max_len
        self.dropout = dropout
        self.label_smooth = label_smooth


TRANSFORMER_BASE = TransformerConfig(
    src_vocab=30000, trg_vocab=30000, d_model=512, heads=8, enc_layers=6,
    dec_layers=6, ffn=2048, max_len=64)
TRANSFORMER_TINY = TransformerConfig(
    src_vocab=64, trg_vocab=64, d_model=32, heads=2, enc_layers=1,
    dec_layers=1, ffn=64, max_len=16)


def _pos_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float32")
    i = np.arange(d_model)[None, :].astype("float32")
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.zeros((max_len, d_model), "float32")
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


def _attention(q_in, kv_in, cfg, prefix, mask=None, is_test=False):
    """Multi-head attention; q_in [B, Tq, D], kv_in [B, Tk, D], mask an
    additive bias broadcastable to [B, heads, Tq, Tk]."""
    d, heads = cfg.d_model, cfg.heads
    dh = d // heads

    def proj(x, nm):
        return layers.fc(x, d, num_flatten_dims=2,
                         param_attr=ParamAttr(name=prefix + nm + "_w"),
                         bias_attr=ParamAttr(name=prefix + nm + "_b"))

    def split_heads(t, n):
        t = layers.reshape(t, [-1, n, heads, dh])
        return layers.transpose(t, [0, 2, 1, 3])

    tq, tk = q_in.shape[1], kv_in.shape[1]
    q = split_heads(proj(q_in, "_q"), tq)
    k = split_heads(proj(kv_in, "_k"), tk)
    v = split_heads(proj(kv_in, "_v"), tk)
    scores = layers.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
    if mask is not None:
        scores = layers.elementwise_add(scores, mask)
    attn = layers.softmax(scores)
    if cfg.dropout and not is_test:
        attn = layers.dropout(attn, cfg.dropout, is_test=is_test)
    out = layers.matmul(attn, v)                  # [B, H, Tq, dh]
    out = layers.transpose(out, [0, 2, 1, 3])
    out = layers.reshape(out, [-1, tq, d])
    return layers.fc(out, d, num_flatten_dims=2,
                     param_attr=ParamAttr(name=prefix + "_o_w"),
                     bias_attr=ParamAttr(name=prefix + "_o_b"))


def _ffn(x, cfg, prefix, is_test=False):
    h = layers.fc(x, cfg.ffn, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=prefix + "_fc1_w"),
                  bias_attr=ParamAttr(name=prefix + "_fc1_b"))
    if cfg.dropout and not is_test:
        h = layers.dropout(h, cfg.dropout, is_test=is_test)
    return layers.fc(h, cfg.d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=prefix + "_fc2_w"),
                     bias_attr=ParamAttr(name=prefix + "_fc2_b"))


def _ln(x, prefix):
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name=prefix + "_ln_s"),
                             bias_attr=ParamAttr(name=prefix + "_ln_b"))


def _embed(ids, vocab, cfg, name, seq_len):
    # an explicit trailing 1: lookup_table squeezes [..., 1] ids, which
    # would collapse a length-1 decode prefix ([B, 1] -> [B, D])
    ids3 = layers.reshape(ids, [-1, seq_len, 1])
    emb = layers.embedding(ids3, size=[vocab, cfg.d_model],
                           param_attr=ParamAttr(name=name))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    pos = layers.tensor.assign(
        _pos_encoding(cfg.max_len, cfg.d_model)[:seq_len])
    return layers.elementwise_add(emb, pos)


def encoder(src_ids, src_mask, cfg, seq_len, is_test=False):
    """src_ids [B, S] int64; src_mask [B, 1, 1, S] additive (-1e9 on
    padding)."""
    x = _embed(src_ids, cfg.src_vocab, cfg, "src_emb", seq_len)
    for i in range(cfg.enc_layers):
        p = "enc%d" % i
        x = _ln(x + _attention(x, x, cfg, p + "_self", src_mask, is_test),
                p + "_att")
        x = _ln(x + _ffn(x, cfg, p, is_test), p + "_ffn")
    return x


def decoder(trg_emb, enc_out, cfg, self_mask, cross_mask, is_test=False):
    x = trg_emb
    for i in range(cfg.dec_layers):
        p = "dec%d" % i
        x = _ln(x + _attention(x, x, cfg, p + "_self", self_mask, is_test),
                p + "_att")
        x = _ln(x + _attention(x, enc_out, cfg, p + "_cross", cross_mask,
                               is_test), p + "_cross")
        x = _ln(x + _ffn(x, cfg, p, is_test), p + "_ffn")
    return x


def _logits(dec_out, cfg):
    return layers.fc(dec_out, cfg.trg_vocab, num_flatten_dims=2,
                     param_attr=ParamAttr(name="out_proj_w"),
                     bias_attr=ParamAttr(name="out_proj_b"))


def _causal_mask(t):
    m = np.triu(np.full((t, t), -1e9, "float32"), k=1)
    return layers.tensor.assign(m.reshape(1, 1, t, t))


def _pad_mask(ids, pad_id=EOS):
    """[B, T] ids -> [B, 1, 1, T] additive mask, -1e9 at padding (padded
    source positions hold EOS by convention)."""
    is_pad = layers.cast(layers.equal(
        ids, layers.fill_constant([1], "int64", pad_id)), "float32")
    m = layers.scale(is_pad, scale=-1e9)
    return layers.reshape(m, [-1, 1, 1, ids.shape[1]])


def build_train(cfg, src_len, trg_len, lr=1.0, warmup=400):
    """Training program over padded batches: feeds src_ids, trg_ids,
    trg_next [B, T] int64 and trg_weight [B, T] f32 (0 on padding); the
    loss is the weighted mean of the per-token (label-smoothed) cross
    entropy.  ``warmup`` > 0: the learning rate is ``lr`` times noam's;
    0: the constant ``lr``.  Returns (feeds, avg_loss)."""
    src = layers.data("src_ids", shape=[-1, src_len], dtype="int64",
                      append_batch_size=False)
    trg = layers.data("trg_ids", shape=[-1, trg_len], dtype="int64",
                      append_batch_size=False)
    lbl = layers.data("trg_next", shape=[-1, trg_len], dtype="int64",
                      append_batch_size=False)
    weights = layers.data("trg_weight", shape=[-1, trg_len],
                          dtype="float32", append_batch_size=False)

    src_mask = _pad_mask(src)
    enc_out = encoder(src, src_mask, cfg, src_len)
    trg_emb = _embed(trg, cfg.trg_vocab, cfg, "trg_emb", trg_len)
    dec_out = decoder(trg_emb, enc_out, cfg, _causal_mask(trg_len), src_mask)
    logits = _logits(dec_out, cfg)

    if cfg.label_smooth:
        one_hot = layers.one_hot(layers.reshape(lbl, [-1, trg_len]),
                                 cfg.trg_vocab)
        smooth = layers.label_smooth(one_hot, epsilon=cfg.label_smooth)
        ce = layers.softmax_with_cross_entropy(logits, smooth,
                                               soft_label=True)
    else:
        label = layers.reshape(lbl, [-1, trg_len, 1])
        ce = layers.softmax_with_cross_entropy(logits, label)
    ce = layers.reshape(ce, [-1, trg_len])
    token_loss = layers.elementwise_mul(ce, weights)
    avg_loss = layers.reduce_sum(token_loss) / layers.reduce_sum(weights)

    if warmup:
        sched = layers.learning_rate_scheduler.noam_decay(cfg.d_model,
                                                          warmup)
        if lr != 1.0:
            # lr scales noam's schedule (the reference's
            # TrainTaskConfig.learning_rate)
            sched = layers.scale(sched, scale=float(lr))
    else:
        sched = lr
    Adam(learning_rate=sched, beta1=0.9, beta2=0.997,
         epsilon=1e-9).minimize(avg_loss)
    return [src, trg, lbl, weights], avg_loss


def build_beam_infer(cfg, src_len, beam_size=4, max_out_len=None):
    """Beam-search decode program: the decode loop unrolled ``max_out_len``
    (default ``cfg.max_len``) steps.  Returns (src var, seq_ids [B, K, T],
    seq_scores [B, K])."""
    k = beam_size
    steps = max_out_len or cfg.max_len

    src = layers.data("src_ids", shape=[-1, src_len], dtype="int64",
                      append_batch_size=False)
    src_mask = _pad_mask(src)
    enc_out = encoder(src, src_mask, cfg, src_len, is_test=True)

    # the encoder state repeated per beam: [B, S, D] -> [B K, S, D]
    enc_k = layers.expand(layers.unsqueeze(enc_out, [1]), [1, k, 1, 1])
    enc_k = layers.reshape(enc_k, [-1, src_len, cfg.d_model])
    srcm_k = layers.expand(src_mask, [1, k, 1, 1])      # [B, K, 1, S]
    srcm_k = layers.reshape(srcm_k, [-1, 1, 1, src_len])

    # live state: prefixes [B K, t], scores [B, K]
    prefix = layers.fill_constant_batch_size_like(src, [-1, 1], "int64",
                                                  BOS)
    prefix = layers.expand(layers.reshape(prefix, [-1, 1, 1]), [1, k, 1])
    prefix = layers.reshape(prefix, [-1, 1])            # [B K, 1] of BOS
    init = np.full((1, k), -1e9, "float32")
    init[0, 0] = 0.0
    pre_scores = layers.elementwise_add(
        layers.fill_constant_batch_size_like(src, [-1, k], "float32", 0.0),
        layers.tensor.assign(init))
    pre_ids = layers.fill_constant_batch_size_like(src, [-1, k], "int64",
                                                   BOS)

    ids_array = layers.create_array("int64")
    parents_array = layers.create_array("int64")
    counter = layers.zeros([1], "int64")

    for t in range(steps):
        cur = t + 1
        trg_emb = _embed(prefix, cfg.trg_vocab, cfg, "trg_emb", cur)
        dec_out = decoder(trg_emb, enc_k, cfg, _causal_mask(cur), srcm_k,
                          is_test=True)
        last = layers.slice(dec_out, axes=[1], starts=[cur - 1], ends=[cur])
        logits = _logits(last, cfg)                     # [B K, 1, V]
        logp = layers.log_softmax(
            layers.reshape(logits, [-1, k, cfg.trg_vocab]), axis=-1)
        acc = layers.elementwise_add(logp, pre_scores, axis=0)
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, None, acc, beam_size=k, end_id=EOS)
        layers.array_write(sel_ids, counter, ids_array)
        layers.array_write(parent, counter, parents_array)
        counter = layers.increment(counter, 1, in_place=False)

        # prefixes re-ordered by parent beam, the new token appended
        pref3 = layers.reshape(prefix, [-1, k, cur])
        new_pref = _reorder_and_append(pref3, parent, sel_ids, k)
        prefix = layers.reshape(new_pref, [-1, cur + 1])
        pre_scores = sel_scores
        pre_ids = sel_ids

    seq_ids, seq_scores = layers.beam_search_decode(
        ids_array, parents_array, scores=pre_scores, beam_size=k,
        end_id=EOS)
    return src, seq_ids, seq_scores


def _reorder_and_append(pref3, parent, sel_ids, k):
    """pref3 [B, K, t]; parent, sel_ids [B, K] -> [B, K, t + 1]: row k of
    the result is the prefix of beam parent[b, k], then sel_ids[b, k]."""
    # one-hot product: perm[b, k, j] = 1 where j == parent[b, k]
    onehot = layers.one_hot(layers.reshape(parent, [-1, k]), k)  # [B, K, K]
    onehot = layers.reshape(onehot, [-1, k, k])
    gathered = layers.matmul(onehot, layers.cast(pref3, "float32"))
    gathered = layers.cast(gathered, "int64")
    return layers.concat([gathered, layers.reshape(sel_ids, [-1, k, 1])],
                         axis=2)


def pad_batch(samples, src_len, trg_len):
    """samples: a list of (src_ids, trg_ids, trg_next) -> padded int64
    src, trg, next [n, len] (EOS-padded) and f32 per-token weights (0 on
    padding)."""
    n = len(samples)
    src = np.full((n, src_len), EOS, "int64")
    trg = np.full((n, trg_len), EOS, "int64")
    nxt = np.full((n, trg_len), EOS, "int64")
    w = np.zeros((n, trg_len), "float32")
    for i, (s, t, tn) in enumerate(samples):
        s = list(s)[:src_len]
        t = list(t)[:trg_len]
        tn = list(tn)[:trg_len]
        src[i, :len(s)] = s
        trg[i, :len(t)] = t
        nxt[i, :len(tn)] = tn
        w[i, :len(tn)] = 1.0
    return src, trg, nxt, w
