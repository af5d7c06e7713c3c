"""The BERT encoder family on the eager ``nn.Layer`` API (``BASELINE.md``
#3: BERT-base pretraining under group sharding).

Port of ``paddle_tpu/models/bert.py``: the same layers, parameter names,
initializers and post-LN blocks, built on the default place
(:func:`paddle_tpu_torch.device.set_device`; ``cuda`` unless set).

- Self-attention calls :func:`scaled_dot_product_attention` by its name
  in this module. Without a mask it is the flash path: K1 forward and
  K2 backward on the card (non-causal, head_dim 64 at BERT's widths;
  attention dropout on the output, as the JAX package drops it). A 2-D
  ``[b, s]`` key mask becomes the additive ``[b, 1, 1, s]`` mask of
  ``finfo(float32).min`` where the key is padding, which takes the
  masked composition, as in the JAX package.
- The MLM decoder's weight IS the word-embedding table (one tensor): the
  head keeps it outside its registered parameters, so ``parameters()``
  and ``state_dict()`` list it once, under
  ``bert.embeddings.word_embeddings.weight``, as the JAX ``state_dict``
  does, and its gradient is the sum of the lookup's and the decoder's.
- The ``annotate_param`` / ``shard_activation`` calls are the JAX
  model's (``distributed/auto_parallel/constraint.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn
from ..distributed.auto_parallel.constraint import (annotate_param,
                                                    shard_activation)
from ..incubate.nn.functional.flash_attention import \
    scaled_dot_product_attention
from ..nn import functional as F

__all__ = ["BertConfig", "BertModel", "BertForPreTraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "bert_tiny", "bert_base", "bert_large"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_tiny(**kw) -> BertConfig:
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=256,
                      max_position_embeddings=128, **kw)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, **kw)


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        init = nn.initializer.Normal(0.0, config.initializer_range)
        self.word_embeddings = nn.Embedding(
            config.vocab_size, config.hidden_size, weight_attr=init)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, weight_attr=init)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout)
        annotate_param(self.word_embeddings.weight, ("mp", None))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        ids = torch.as_tensor(input_ids,
                              device=self.word_embeddings.weight.device)
        b, s = ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = (self.word_embeddings(ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        init = nn.initializer.Normal(0.0, config.initializer_range)
        self.q_proj = nn.Linear(h, h, weight_attr=init)
        self.k_proj = nn.Linear(h, h, weight_attr=init)
        self.v_proj = nn.Linear(h, h, weight_attr=init)
        self.out_proj = nn.Linear(h, h, weight_attr=nn.initializer.Normal(
            0.0, config.initializer_range / math.sqrt(2 * config.num_layers)))
        for p in (self.q_proj.weight, self.k_proj.weight, self.v_proj.weight):
            annotate_param(p, (None, "mp"))
        annotate_param(self.out_proj.weight, ("mp", None))
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x, attention_mask=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        q = shard_activation(q, ("dp", None, "mp", None))
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask, is_causal=False,
            dropout_p=cfg.attention_dropout if self.training else 0.0,
            training=self.training)
        out = out.reshape(b, s, cfg.hidden_size)
        return self.dropout(self.out_proj(out))


class BertLayer(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        init = nn.initializer.Normal(0.0, config.initializer_range)
        self.attention = BertSelfAttention(config)
        self.ln1 = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.linear1 = nn.Linear(h, config.intermediate_size,
                                 weight_attr=init)
        self.linear2 = nn.Linear(config.intermediate_size, h,
                                 weight_attr=init)
        annotate_param(self.linear1.weight, (None, "mp"))
        annotate_param(self.linear2.weight, ("mp", None))
        self.ln2 = nn.LayerNorm(h, epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x, attention_mask=None):
        # post-LN residual blocks (original BERT)
        x = self.ln1(x + self.attention(x, attention_mask))
        ff = self.linear2(F.gelu(self.linear1(x)))
        return self.ln2(x + self.dropout(ff))


class BertPooler(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, x):
        return F.tanh(self.dense(x[:, 0]))


def additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """A ``[b, s]`` key mask (1 keep, 0 padding) -> the additive
    ``[b, 1, 1, s]`` f32 mask: 0 where kept, ``finfo(float32).min``
    where padding."""
    m = attention_mask.float()
    return ((1.0 - m)[:, None, None, :]
            * torch.finfo(torch.float32).min)


class BertModel(nn.Layer):
    def __init__(self, config: BertConfig, with_pool: bool = True):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = nn.LayerList(
            [BertLayer(config) for _ in range(config.num_layers)])
        self.pooler = BertPooler(config) if with_pool else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=x.device)
            if attention_mask.dim() == 2:
                attention_mask = additive_mask(attention_mask)
        x = shard_activation(x, ("dp", None, None))
        for layer in self.encoder:
            x = layer(x, attention_mask)
        if self.pooler is not None:
            return x, self.pooler(x)
        return x


class BertLMPredictionHead(nn.Layer):
    """MLM head: transform + decoder tied to the word embeddings."""

    def __init__(self, config: BertConfig, embedding_weights):
        super().__init__()
        self.transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        # [vocab, hidden], the word embeddings' own tensor: held outside
        # the registered parameters, so that it is listed once
        object.__setattr__(self, "decoder_weight", embedding_weights)
        self.decoder_bias = self.create_parameter(
            [config.vocab_size], is_bias=True)

    def forward(self, x):
        x = self.layer_norm(F.gelu(self.transform(x)))
        return torch.nn.functional.linear(x, self.decoder_weight,
                                          self.decoder_bias)


class BertForPreTraining(nn.Layer):
    """MLM + NSP pretraining model."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, with_pool=True)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight)
        self.nsp = nn.Linear(config.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        prediction_scores = self.cls(seq)
        seq_relationship = self.nsp(pooled)
        return prediction_scores, seq_relationship


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = -100) -> torch.Tensor:
    """The mean negative log-likelihood (f32 log-softmax) over the
    positions whose label is not ``ignore_index`` (0 when none is)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    keep = labels != ignore_index
    safe = torch.where(keep, labels, 0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = keep.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


class BertPretrainingCriterion(nn.Layer):
    """Masked-LM + next-sentence loss; positions without an MLM label
    carry ``ignore_index`` (-100)."""

    def __init__(self, vocab_size: int, ignore_index: int = -100):
        super().__init__()
        self.vocab_size = vocab_size
        self.ignore_index = ignore_index

    def forward(self, prediction_scores, seq_relationship, masked_lm_labels,
                next_sentence_labels=None):
        loss = mlm_loss(prediction_scores, masked_lm_labels,
                        self.ignore_index)
        if next_sentence_labels is not None:
            nsp = F.cross_entropy(seq_relationship, torch.as_tensor(
                next_sentence_labels, device=seq_relationship.device))
            loss = loss + nsp.mean()
        return loss


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(config, with_pool=True)
        self.dropout = nn.Dropout(config.hidden_dropout)
        self.classifier = nn.Linear(config.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))
