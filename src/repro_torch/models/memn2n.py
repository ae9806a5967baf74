"""End-to-End Memory Network (Sukhbaatar et al.), the paper's primary
workload (SSVI-A, bAbI QA); PyTorch port of ``repro.models.memn2n``.

The attention inside each hop is the paper's Figure-1 unit op: one
query vector against an n x d key matrix and an n x d value matrix.
``answer_with_a3`` routes that hop through the port's
``core.a3_attention`` (candidate selection on the pre-sorted key matrix,
post-scoring selection), so the accuracy experiments exercise the real
approximation pipeline.

Sentences are embedded as position-weighted bags of words (the paper's
"PE" encoding) with temporal encodings; adjacent-weight tying
(A^{k+1} = C^k) as in the original.

Parameters are a name -> tensor dict in the reference's layout
(``embeddings`` [hops+1, V, d], ``temporal`` [hops+1, n, d],
``query_embed`` [V, d], ``w_final`` [d, V], float32), which AdamW takes
as it is. Where the reference ``vmap``s a single-example function, the
port's takes leading batch dimensions ([B, n, J] sentences), the A^3
path included.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config, A3Mode
from repro_torch.core.a3_attention import a3_attention_single, preprocess
from repro_torch.core.post_scoring import masked_softmax

Params = Dict[str, torch.Tensor]


class MemN2NConfig(NamedTuple):
    vocab_size: int
    d_embed: int = 64
    num_hops: int = 3
    max_sentences: int = 50      # n
    max_words: int = 12          # words per sentence


def init_params(cfg: MemN2NConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """The reference's distributions (N(0, 0.1^2) embeddings and temporal
    encodings, N(0, 1/d) ``w_final``) drawn from ``generator``: the same
    distributions as ``memn2n.init_params``, not the same numbers."""
    dev = resolve_device(device)

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    h, v, d, n = cfg.num_hops, cfg.vocab_size, cfg.d_embed, cfg.max_sentences
    return {
        "embeddings": normal(h + 1, v, d, scale=0.1),
        "temporal": normal(h + 1, n, d, scale=0.1),
        "query_embed": normal(v, d, scale=0.1),
        "w_final": normal(d, v, scale=1.0 / math.sqrt(d)),
    }


def position_encoding(cfg: MemN2NConfig, device=None) -> torch.Tensor:
    """bAbI position-encoding weights l_kj (Sukhbaatar eq. PE), [J, d]."""
    J, d = cfg.max_words, cfg.d_embed
    j = torch.arange(1, J + 1, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(1, d + 1, dtype=torch.float32, device=device)[None, :]
    return (1 - j / J) - (k / d) * (1 - 2 * j / J)


def embed_sentences(embed: torch.Tensor, sentences: torch.Tensor,
                    cfg: MemN2NConfig,
                    temporal: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """sentences [..., n, J] int (0 = pad) -> [..., n, d]."""
    sentences = sentences.long()
    pe = position_encoding(cfg, embed.device)
    vecs = embed[sentences] * pe                              # [.., n, J, d]
    mask = (sentences > 0)[..., None].float()
    out = (vecs * mask).sum(-2)
    if temporal is not None:
        # recency index: the most recent valid sentence -> T[0]
        valid = (sentences > 0).any(-1)                       # [..., n]
        count = valid.sum(-1, keepdim=True)
        n = sentences.shape[-2]
        idx = torch.clamp(count - 1 - torch.arange(n, device=count.device),
                          0, cfg.max_sentences - 1)
        out = out + temporal[idx] * valid[..., None]
    return out


def _query(params: Params, question: torch.Tensor) -> torch.Tensor:
    """question [..., J] -> the bag-of-words query [..., d]."""
    question = question.long()
    return (params["query_embed"][question]
            * (question > 0)[..., None].float()).sum(-2)


def _memories(params: Params, sentences: torch.Tensor, cfg: MemN2NConfig,
              hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, value) matrices of one hop, [..., n, d] each."""
    emb, tmp = params["embeddings"], params["temporal"]
    return (embed_sentences(emb[hop], sentences, cfg, tmp[hop]),
            embed_sentences(emb[hop + 1], sentences, cfg, tmp[hop + 1]))


def answer(params: Params, sentences: torch.Tensor, question: torch.Tensor,
           cfg: MemN2NConfig, sentence_mask: Optional[torch.Tensor] = None,
           linear: bool = False) -> torch.Tensor:
    """Exact (training) forward: sentences [..., n, J], question [..., J]
    -> answer logits [..., V]. ``linear=True`` is the paper's "linear
    start": no softmax, scores averaged over the valid sentences."""
    sentences = torch.as_tensor(sentences).to(params["w_final"].device)
    question = torch.as_tensor(question).to(sentences.device)
    u = _query(params, question)
    mask = sentence_mask if sentence_mask is not None else \
        (sentences > 0).any(-1)
    for hop in range(cfg.num_hops):
        key_mat, val_mat = _memories(params, sentences, cfg, hop)
        scores = torch.einsum("...nd,...d->...n", key_mat, u)
        if linear:
            w = torch.where(mask, scores, 0.0)
            w = w / torch.clamp(mask.float().sum(-1, keepdim=True), min=1.0)
        else:
            w = masked_softmax(scores, mask)
        u = u + torch.einsum("...n,...nd->...d", w, val_mat)
    return u @ params["w_final"]


def answer_with_a3(params: Params, sentences: torch.Tensor,
                   question: torch.Tensor, cfg: MemN2NConfig, a3: A3Config
                   ) -> Tuple[torch.Tensor, Dict]:
    """Inference forward (sentences [..., n, J], question [..., J]) with the
    A^3 pipeline in each hop -> (logits [..., V], {"hop<i>": aux of
    ``a3_attention_single``}). Each example is its own memory: the
    reference's single-example function with leading batch dimensions."""
    sentences = torch.as_tensor(sentences).to(params["w_final"].device)
    question = torch.as_tensor(question).to(sentences.device)
    u = _query(params, question)
    aux_all = {}
    mask = (sentences > 0).any(-1)
    for hop in range(cfg.num_hops):
        key_mat, val_mat = _memories(params, sentences, cfg, hop)
        # empty (padded) sentences get a zero key
        key_mat = torch.where(mask[..., None], key_mat, 0.0)
        out, aux = a3_attention_single(preprocess(key_mat, val_mat), u, a3)
        u = u + out
        aux_all[f"hop{hop}"] = aux
    return u @ params["w_final"], aux_all


def loss_fn(params: Params, batch: Dict, cfg: MemN2NConfig,
            linear: bool = False) -> torch.Tensor:
    """batch: sentences [B, n, J], question [B, J], answer [B] -> mean
    cross-entropy of the answer."""
    logits = answer(params, batch["sentences"], batch["question"], cfg,
                    linear=linear)
    gold = torch.as_tensor(batch["answer"]).to(logits.device).long()
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.gather(-1, gold[:, None])[:, 0]).mean()


@torch.no_grad()
def accuracy(params: Params, batch: Dict, cfg: MemN2NConfig,
             a3: Optional[A3Config] = None) -> torch.Tensor:
    """Share of answers right, exact attention or (``a3`` given, not off)
    the A^3 pipeline in every hop."""
    if a3 is None or a3.mode == A3Mode.OFF:
        logits = answer(params, batch["sentences"], batch["question"], cfg)
    else:
        logits = answer_with_a3(params, batch["sentences"],
                                batch["question"], cfg, a3)[0]
    gold = torch.as_tensor(batch["answer"]).to(logits.device).long()
    return (logits.argmax(-1) == gold).float().mean()
