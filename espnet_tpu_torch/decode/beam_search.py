"""Batched hybrid CTC/attention beam search (counterpart of
espnet_tpu/decode/beam_search.py:_beam_search_device).

The beam is a fixed block of B * beam slots on the device. A hypothesis
that emits eos moves into a per-utterance store of the best ``beam``
ended hypotheses and frees its slot; n-best comes from the store. Each
step: decoder score -> pre-beam top-W -> CTC prefix DP -> per-utterance
top-k over beam * W -> gather the states. With an LM (shallow fusion),
``lm_weight`` times its log-probabilities joins the decoder's weighted
scores before the pruning, and its state is gathered by the same source
rows as the decoder's, in the same step. The steps are a Python loop
over tensors that stay on the device; it ends when every utterance is
done (no live slot, or end_detect) or at maxlen.

Top-k ties go to the lower index, as jax.lax.top_k breaks them.
"""

from __future__ import annotations

import dataclasses

import torch

from espnet_tpu_torch.decode.ctc_prefix import (init_state,
                                                pad_log_posteriors,
                                                score_candidates,
                                                select_state)

NEG_INF = -1e10
PRE_BEAM_RATIO = 1.5
# e2e_asr_common.end_detect, applied when maxlenratio == 0: stop once the
# best hypotheses ended at each of the last M lengths score D below the
# best ended one
END_DETECT_M = 3
END_DETECT_D = -10.0


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 10
    ctc_weight: float = 0.5
    lm_weight: float = 0.0
    length_bonus: float = 0.0
    maxlenratio: float = 0.0
    minlenratio: float = 0.0
    nbest: int = 1


def topk(x, k: int):
    """Largest k along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _merge_store(store_score, store_yseq, store_len, scores, yseq, lengths,
                 beam: int):
    """Keep the best ``beam`` of the store and the (B, beam) newcomers."""
    B, _, Lmax = store_yseq.shape
    merged_scores = torch.cat([store_score, scores], dim=1)
    merged_yseq = torch.cat([store_yseq, yseq.reshape(B, beam, Lmax)], dim=1)
    merged_len = torch.cat([store_len, lengths.reshape(B, beam)], dim=1)
    keep_scores, keep_idx = topk(merged_scores, beam)
    return (keep_scores,
            merged_yseq.gather(1, keep_idx[:, :, None].expand(-1, -1, Lmax)),
            merged_len.gather(1, keep_idx))


@torch.no_grad()
def beam_search(model, enc, enc_lens, config: BeamSearchConfig, lm=None):
    """enc (B, T, D), enc_lens (B,) -> yseq (B*beam, Lmax) with sos first,
    lengths, scores (the best of each utterance in row b*beam) and the
    number of steps run. ``lm``: a scorer (init_carry / score_step /
    select_state, models/lm.py) over the same token list."""
    B, Tenc, _ = enc.shape
    dev = enc.device
    beam = config.beam_size
    V = model.vocab_size
    rows = B * beam
    sos, eos = model.sos_id, model.eos_id
    use_ctc = config.ctc_weight > 0.0
    att_w = 1.0 - config.ctc_weight
    W = min(max(int(PRE_BEAM_RATIO * beam), beam), V) if use_ctc else V
    maxlen = (int(config.maxlenratio * Tenc) if config.maxlenratio > 0
              else Tenc)
    maxlen = max(min(maxlen, Tenc), 2)

    enc_lens_rows = enc_lens.repeat_interleave(beam)
    minlens = torch.clamp((config.minlenratio * enc_lens_rows).long(), min=0)
    if config.maxlenratio > 0:
        maxlens = (config.maxlenratio * enc_lens_rows).long()
    else:
        maxlens = enc_lens_rows
    maxlens = torch.clamp(maxlens, min=1, max=maxlen)

    dec_state = model.decoder_init_state(enc, enc_lens, rows, maxlen + 1)
    if use_ctc:
        ctc_logp = torch.log_softmax(model.ctc_logits(enc), dim=-1)
        ctc_logp = pad_log_posteriors(ctc_logp, enc_lens, model.blank_id)
        ctc_logp_rows = ctc_logp.repeat_interleave(beam, dim=0)
        ctc_state = init_state(ctc_logp_rows, model.blank_id)
    if lm is not None:
        lm_state = lm.init_carry(rows, maxlen + 1, device=dev)

    Lmax = maxlen + 2
    ar_rows = torch.arange(rows, device=dev)
    yseq = torch.full((rows, Lmax), eos, dtype=torch.int64, device=dev)
    yseq[:, 0] = sos
    lengths = torch.zeros(rows, dtype=torch.int64, device=dev)
    scores = torch.where(ar_rows % beam == 0, 0.0, NEG_INF)
    finished = torch.zeros(rows, dtype=torch.bool, device=dev)
    store_yseq = torch.full((B, beam, Lmax), eos, dtype=torch.int64,
                            device=dev)
    store_len = torch.zeros(B, beam, dtype=torch.int64, device=dev)
    store_score = torch.full((B, beam), NEG_INF, device=dev)
    ended_at_len = torch.full((B, Lmax), NEG_INF, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    use_end_detect = config.maxlenratio == 0.0
    eos_col = torch.arange(V, device=dev)[None, :] == eos
    utt_of_row = ar_rows // beam
    row0 = (torch.arange(B, device=dev) * beam)[:, None]

    step = 0
    while step < maxlen and not bool(done.all()):
        last = (torch.full((rows,), sos, dtype=torch.int64, device=dev)
                if step == 0 else yseq[:, step])
        att_logp, dec_state = model.decoder_score_step(last, step, dec_state)
        weighted = att_w * att_logp
        if lm is not None:
            lm_logp, lm_state = lm.score_step(last, step, lm_state)
            weighted = weighted + config.lm_weight * lm_logp
        # eos is barred before minlen and forced at each row's maxlen
        allow_eos = lengths >= minlens
        force_eos = (step + 1) >= maxlens
        weighted = weighted.masked_fill(eos_col & ~allow_eos[:, None],
                                        NEG_INF)
        weighted = weighted.masked_fill(~eos_col & force_eos[:, None],
                                        NEG_INF)
        if use_ctc:
            pre_scores, cand_ids = topk(weighted, W)
            local, log_psi, r_nb_new, r_b_new = score_candidates(
                ctc_state, cand_ids, ctc_logp_rows, enc_lens_rows,
                model.blank_id, eos)
            cand_scores = (scores[:, None] + pre_scores
                           + config.ctc_weight * local + config.length_bonus)
        else:
            cand_ids = torch.arange(V, device=dev)[None].expand(rows, V)
            cand_scores = scores[:, None] + weighted + config.length_bonus

        # dead slots (hypothesis in the store) and done utterances offer
        # nothing
        dead = finished | done[utt_of_row]
        cand_scores = cand_scores.masked_fill(dead[:, None], NEG_INF)
        Wc = cand_ids.shape[1]
        top_scores, top_idx = topk(cand_scores.reshape(B, beam * Wc), beam)
        src_row = (top_idx // Wc + row0).reshape(-1)
        cand_col = (top_idx % Wc).reshape(-1)
        new_scores = top_scores.reshape(-1)
        new_tok = cand_ids[src_row, cand_col]
        was_dead = dead[src_row]

        yseq = yseq[src_row]
        write_pos = torch.where(was_dead, 0, step + 1)[:, None]
        kept = yseq.gather(1, write_pos)[:, 0]
        yseq.scatter_(1, write_pos,
                      torch.where(was_dead, kept, new_tok)[:, None])
        lengths = lengths[src_row] + (~was_dead).long()

        # hypotheses that emitted eos move to the store and free the slot
        newly_fin = ((new_tok == eos) & ~was_dead
                     & (new_scores > NEG_INF / 2))
        fin_scores = torch.where(newly_fin, new_scores, NEG_INF).reshape(
            B, beam)
        store_score, store_yseq, store_len = _merge_store(
            store_score, store_yseq, store_len, fin_scores, yseq, lengths,
            beam)
        fin_len = torch.where(newly_fin, lengths, 0).reshape(B, beam)
        ended_at_len = ended_at_len.scatter_reduce(1, fin_len, fin_scores,
                                                   reduce="amax")

        finished = was_dead | (new_tok == eos)
        scores = torch.where(finished, NEG_INF, new_scores)
        done = done | torch.all(scores.reshape(B, beam) <= NEG_INF / 2,
                                dim=1)
        if use_end_detect:
            best_ended = store_score.max(dim=1).values
            count = torch.zeros(B, dtype=torch.int64, device=dev)
            for m in range(END_DETECT_M):
                if step + 1 - m < 1:
                    continue
                at_l = ended_at_len[:, min(step + 1 - m, Lmax - 1)]
                count += ((at_l > NEG_INF / 2)
                          & (at_l - best_ended < END_DETECT_D)).long()
            done = done | (count == END_DETECT_M)

        dec_state = model.decoder_mod.select_state(dec_state, src_row)
        if use_ctc:
            ctc_state = select_state(ctc_state, r_nb_new, r_b_new, log_psi,
                                     src_row, cand_col, new_tok)
        if lm is not None:
            lm_state = lm.select_state(lm_state, src_row)
        step += 1

    # rows still live at the end get eos appended and compete for the store
    live = ~finished & (scores > NEG_INF / 2)
    flush_len = torch.clamp(lengths + 1, max=Lmax - 1)
    flush_yseq = yseq.scatter(1, flush_len[:, None],
                              torch.full((rows, 1), eos, dtype=torch.int64,
                                         device=dev))
    flush_scores = torch.where(live, scores, NEG_INF).reshape(B, beam)
    scores_out, yseq_out, len_out = _merge_store(
        store_score, store_yseq, store_len, flush_scores, flush_yseq,
        flush_len, beam)
    return (yseq_out.reshape(rows, Lmax), len_out.reshape(rows),
            scores_out.reshape(rows), step)


def batch_beam_search(model, enc, enc_lens, config: BeamSearchConfig,
                      lm=None):
    """Decode a batch -> per utterance, its n-best [(token ids, score)]
    with sos and the final eos stripped."""
    B = enc.shape[0]
    beam = config.beam_size
    yseq, lengths, scores, _ = beam_search(model, enc, enc_lens, config, lm)
    yseq, lengths, scores = (yseq.cpu().numpy(), lengths.cpu().numpy(),
                             scores.cpu().numpy())
    results = []
    for b in range(B):
        hyps = []
        for r in range(b * beam, (b + 1) * beam):
            if scores[r] <= NEG_INF / 2:
                continue
            ids = yseq[r, 1:1 + lengths[r]].tolist()
            if ids and ids[-1] == model.eos_id:
                ids = ids[:-1]
            hyps.append((ids, float(scores[r])))
        hyps.sort(key=lambda h: -h[1])
        results.append(hyps[:config.nbest])
    return results
