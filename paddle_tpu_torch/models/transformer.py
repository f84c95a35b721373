"""Decoder-only transformer language model on the layers DSL (the port's
counterpart of paddle_tpu/models/transformer.py).

Pre-LN GPT-style blocks whose attention is one `scaled_dot_product_attention`
op: with use_flash=True, or "auto" at T >= 2048, it runs the port's flash
kernels (K7 forward, K8 + K9 backward, ops/attention_cuda.py); otherwise
the einsum path. With sequence_parallel=True and an 'sp' mesh on the
program it runs ring attention (parallel/ring_attention.py: K10 forward,
K8 + K9 backward). The model of bench.py's `transformer` and
`ring_attention` modes.
"""

from __future__ import annotations

from .. import layers
from ..initializer import NormalInitializer
from ..param_attr import ParamAttr


def transformer_lm(tokens, labels, vocab_size, d_model=512, n_head=8,
                   n_layer=4, ffn_mult=4, dropout_prob=0.0, is_test=False,
                   use_flash="auto", sequence_parallel=False,
                   return_logits=False):
    """tokens/labels [B, T] int -> mean next-token cross-entropy loss.

    Pre-LN residual blocks: x += Wo·attn(LN(x)); x += W2·gelu(W1·LN(x)).
    Causal attention over [B, T, H, D] via fused_attention.

    With return_logits=True returns (loss, logits), logits the pre-softmax
    [B, T, V] head output: the inference fetch the serving engine prunes
    to, which drops the loss tail. In training (is_test=False) a
    dropout_prob > 0 drops out the embedding sum, where the JAX package's
    model has its one dropout (models/transformer.py:44)."""
    seqlen = int(tokens.shape[-1])
    d_head = d_model // n_head
    assert d_head * n_head == d_model

    x = layers.embedding(tokens, size=[vocab_size, d_model],
                         param_attr=ParamAttr(
                             initializer=NormalInitializer(scale=0.02)))
    pos = layers.create_parameter(
        shape=[seqlen, d_model], dtype="float32", name="pos_emb",
        default_initializer=NormalInitializer(scale=0.01))
    x = layers.elementwise_add(x, pos, axis=1)          # [B, T, D]
    if dropout_prob and not is_test:
        x = layers.dropout(x, dropout_prob, is_test=is_test)

    def _proj(h, size, act=None):
        return layers.fc(input=h, size=size, num_flatten_dims=2, act=act,
                         param_attr=ParamAttr(
                             initializer=NormalInitializer(scale=0.02)))

    for _ in range(n_layer):
        h = layers.layer_norm(x, begin_norm_axis=2)
        q = layers.reshape(_proj(h, d_model), [-1, seqlen, n_head, d_head])
        k = layers.reshape(_proj(h, d_model), [-1, seqlen, n_head, d_head])
        v = layers.reshape(_proj(h, d_model), [-1, seqlen, n_head, d_head])
        attn = layers.fused_attention(q, k, v, causal=True,
                                      use_flash=use_flash,
                                      sequence_parallel=sequence_parallel)
        attn = layers.reshape(attn, [-1, seqlen, d_model])
        x = layers.elementwise_add(x, _proj(attn, d_model))

        h = layers.layer_norm(x, begin_norm_axis=2)
        ff = _proj(h, ffn_mult * d_model, act="gelu")
        x = layers.elementwise_add(x, _proj(ff, d_model))

    x = layers.layer_norm(x, begin_norm_axis=2)
    logits = _proj(x, vocab_size)                        # [B, T, V]
    flat = layers.reshape(logits, [-1, vocab_size])
    lab = layers.reshape(labels, [-1, 1])
    loss = layers.softmax_with_cross_entropy(logits=flat, label=lab)
    mean_loss = layers.mean(loss)
    if return_logits:
        return mean_loss, logits
    return mean_loss
