"""Transducer decoding: batched greedy search and the default beam search
(counterpart of espnet_tpu/decode/transducer_search.py).

Both walk the (frame, emission) lattice for the whole batch at once, as
the JAX package's while-loops do, with one host check per step of
whether every row is done. Greedy search is ``greedy_stream_step`` over
the whole utterance; a stream feeds it one encoder chunk at a time. Ties
in the top-k choices go to the lowest index, as ``jax.lax.top_k``'s do:
the selections take a stable sort, not ``torch.topk``, which promises no
order among equal values (and at the first step every beam but the first
scores -1e10, so ties are the rule).
The other search types (maes, tsd, alsd, nsc, multi-blank) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

NEG_INF = -1e10


@dataclasses.dataclass(frozen=True)
class TransducerSearchConfig:
    beam_size: int = 5
    search_type: str = "default"  # greedy | default
    max_sym_exp: int = 3          # max symbols per frame (greedy)
    score_norm: bool = True
    nbest: int = 1


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis; among equal
    values the lowest index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _select_carry(emit, new, old):
    """Per row: the new carry where ``emit``, else the old one."""
    return [tuple(torch.where(emit[:, None], n, o) for n, o in zip(nc, oc))
            for nc, oc in zip(new, old)]


def _gather_carry(carry, rows):
    return [tuple(x[rows] for x in c) for c in carry]


class GreedyStreamState(NamedTuple):
    """A greedy transducer decode carried across encoder chunks."""
    tokens: torch.Tensor    # (B, Umax)
    n_tok: torch.Tensor     # (B,)
    dec_out: torch.Tensor   # (B, Dd)
    carry: list


def greedy_stream_init(model, batch: int, umax: int,
                       device=None) -> GreedyStreamState:
    """No token yet: the prediction network has read blank. On ``device``
    or the model's."""
    if device is None:
        device = next(model.parameters()).device
    carry = model.decoder_init_carry(batch, device)
    dec_out, carry = model.decoder_step(
        carry, torch.zeros(batch, dtype=torch.long, device=device))
    tokens = torch.zeros(batch, umax, dtype=torch.long, device=device)
    return GreedyStreamState(tokens=tokens,
                             n_tok=torch.zeros_like(tokens[:, 0]),
                             dec_out=dec_out, carry=carry)


def greedy_stream_step(model, enc_chunk, chunk_lens,
                       state: GreedyStreamState,
                       max_sym_exp: int = 3) -> GreedyStreamState:
    """Continue a greedy decode over the first chunk_lens (B,) frames of
    enc_chunk (B, C, D). Each step every active row either emits its
    argmax token (at most max_sym_exp per frame) or takes blank and moves
    to its next frame; one host read a step asks whether any row is
    active. Tokens past Umax overwrite the last slot, as the JAX
    package's clipped scatter does."""
    B, C, _ = enc_chunk.shape
    dev = enc_chunk.device
    Umax = state.tokens.shape[1]
    rows = torch.arange(B, device=dev)
    t = torch.zeros(B, dtype=torch.long, device=dev)
    n_sym_frame = torch.zeros_like(t)
    tokens, n_tok = state.tokens.clone(), state.n_tok
    dec_out, carry = state.dec_out, state.carry
    while bool((t < chunk_lens).any()):
        logits = model.joint_step(enc_chunk[rows, t.clamp(0, C - 1)],
                                  dec_out)
        tok = logits.argmax(dim=-1)
        active = t < chunk_lens
        emit = ((tok != model.blank_id) & active
                & (n_sym_frame < max_sym_exp))
        new_out, new_carry = model.decoder_step(carry, tok)
        dec_out = torch.where(emit[:, None], new_out, dec_out)
        carry = _select_carry(emit, new_carry, carry)
        pos = n_tok.clamp(0, Umax - 1)
        tokens[rows, pos] = torch.where(emit, tok, tokens[rows, pos])
        n_tok = n_tok + emit.long()
        t = t + (~emit & active).long()
        n_sym_frame = torch.where(emit, n_sym_frame + 1, 0)
    return GreedyStreamState(tokens=tokens, n_tok=n_tok, dec_out=dec_out,
                             carry=carry)


def greedy_search(model, enc, enc_lens, max_sym_exp: int = 3):
    """enc (B, T, D) -> tokens (B, T * max_sym_exp), counts (B,): the
    streaming step over the whole utterance."""
    B, T, _ = enc.shape
    state = greedy_stream_init(model, B, T * max_sym_exp, enc.device)
    state = greedy_stream_step(model, enc, enc_lens, state, max_sym_exp)
    return state.tokens, state.n_tok


def beam_search(model, enc, enc_lens, beam_size: int = 5,
                score_norm: bool = True):
    """Batched transducer beam search: each step every hypothesis either
    emits one of its top tokens or takes blank and moves to its next
    frame; hypotheses of an utterance that hold the same (tokens, frame)
    are merged, their probabilities summed into the first.
    -> tokens (B * beam, T), counts, scores (normalised by length when
    ``score_norm``)."""
    B, T, _ = enc.shape
    dev = enc.device
    beam = beam_size
    R = B * beam
    Umax = T                       # at most one emission per step
    Wc = beam + 1                  # candidates per row: blank | top tokens
    enc_rows = enc.repeat_interleave(beam, dim=0)
    lens_rows = enc_lens.repeat_interleave(beam, dim=0)
    rows = torch.arange(R, device=dev)
    carry = model.decoder_init_carry(R, dev)
    dec_out, carry = model.decoder_step(
        carry, torch.zeros(R, dtype=torch.long, device=dev))
    t = torch.zeros(R, dtype=torch.long, device=dev)
    tokens = torch.zeros(R, Umax, dtype=torch.long, device=dev)
    n_tok = torch.zeros_like(t)
    scores = torch.where(rows % beam == 0, 0.0, NEG_INF)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    hold = torch.arange(Wc, device=dev)[None, :] == 0
    beam_idx = torch.arange(beam, device=dev)
    for _ in range(2 * T):         # a step takes a frame or emits
        if bool(done.all()):
            break
        logits = model.joint_step(enc_rows[rows, t.clamp(0, T - 1)],
                                  dec_out)
        logp = torch.log_softmax(logits, dim=-1)
        nb_logp = logp.clone()
        nb_logp[:, model.blank_id] = NEG_INF
        top_lp, top_id = _top_k(nb_logp, beam)
        cand = torch.cat([(scores + logp[:, model.blank_id])[:, None],
                          scores[:, None] + top_lp], dim=1)
        # a finished row may only hold
        cand = torch.where(done[:, None],
                           torch.where(hold, scores[:, None], NEG_INF), cand)
        new_scores, idx = _top_k(cand.reshape(B, beam * Wc), beam)
        src = (idx // Wc + (torch.arange(B, device=dev) * beam)[:, None]
               ).reshape(-1)
        col = (idx % Wc).reshape(-1)
        is_blank = col == 0
        tok = torch.where(is_blank, 0,
                          top_id[src, (col - 1).clamp(min=0)])
        was_done = done[src]
        t = t[src] + (is_blank & ~was_done).long()
        tokens = tokens[src]
        n_tok = n_tok[src]
        emit = ~is_blank & ~was_done
        pos = n_tok.clamp(0, Umax - 1)
        tokens[rows, pos] = torch.where(emit, tok, tokens[rows, pos])
        n_tok = n_tok + emit.long()
        old_carry = _gather_carry(carry, src)
        new_out, new_carry = model.decoder_step(old_carry, tok)
        dec_out = torch.where(emit[:, None], new_out, dec_out[src])
        carry = _select_carry(emit, new_carry, old_carry)
        done = was_done | (t >= lens_rows)
        # prefix merge: rows of one utterance with the same (tokens, frame)
        # were reached by different blank/emit orders; their mass goes to
        # the first of them, the others drop out
        tb, nb, tt = (x.view(B, beam, -1) for x in (tokens, n_tok, t))
        eq = ((nb == nb.transpose(1, 2)) & (tt == tt.transpose(1, 2))
              & (tb[:, :, None] == tb[:, None]).all(dim=-1))  # (B, k, k)
        first = eq.int().argmax(dim=2)
        group = torch.logsumexp(
            torch.where(eq, new_scores[:, None, :], NEG_INF), dim=2)
        scores = torch.where(first == beam_idx, group, NEG_INF).reshape(-1)
    if score_norm:
        scores = scores / n_tok.clamp(min=1)
    return tokens, n_tok, scores


def decode_transducer(model, enc, enc_lens, config: TransducerSearchConfig):
    """-> per utterance the n-best [(token ids, score)], best first."""
    B = enc.shape[0]
    if config.search_type == "greedy" or config.beam_size <= 1:
        tokens, n_tok = greedy_search(model, enc, enc_lens,
                                      config.max_sym_exp)
        tokens, n_tok = tokens.cpu().numpy(), n_tok.cpu().numpy()
        return [[(tokens[b, :n_tok[b]].tolist(), 0.0)] for b in range(B)]
    if config.search_type != "default":
        raise NotImplementedError(
            f"search_type {config.search_type!r}: the port has default "
            f"and greedy")
    tokens, n_tok, scores = beam_search(model, enc, enc_lens,
                                        config.beam_size, config.score_norm)
    tokens, n_tok = tokens.cpu().numpy(), n_tok.cpu().numpy()
    scores = scores.cpu().numpy()
    beam = config.beam_size
    results = []
    for b in range(B):
        hyps = sorted(((tokens[r, :n_tok[r]].tolist(), float(scores[r]))
                       for r in range(b * beam, (b + 1) * beam)),
                      key=lambda h: -h[1])
        seen, uniq = set(), []
        for ids, score in hyps:    # identical sequences: keep the best
            if tuple(ids) not in seen:
                seen.add(tuple(ids))
                uniq.append((ids, score))
        results.append(uniq[:config.nbest])
    return results
