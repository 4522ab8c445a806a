"""Corpus WER/CER (counterpart of espnet_tpu/utils/native.py:score_corpus).

The edit-distance DP breaks ties as the reference does (substitution or
match, then deletion, then insertion), so the sub/del/ins counts agree
and not only the error rate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """-> (substitutions, deletions, insertions, len(ref))."""
    m = len(hyp)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, len(ref) + 1):
        cur = [(i, 0, i, 0)]
        for j in range(1, m + 1):
            miss = int(ref[i - 1] != hyp[j - 1])
            c, s, d, n = prev[j - 1]
            best = (c + miss, s + miss, d, n)
            c, s, d, n = prev[j]
            if c + 1 < best[0]:
                best = (c + 1, s, d + 1, n)
            c, s, d, n = cur[j - 1]
            if c + 1 < best[0]:
                best = (c + 1, s, d, n + 1)
            cur.append(best)
        prev = cur
    _, s, d, n = prev[m]
    return s, d, n, len(ref)


def score_corpus(ref_texts: List[str], hyp_texts: List[str],
                 unit: str = "word") -> Dict:
    """Corpus error rate over words (``unit="word"``) or characters
    without spaces (``unit="char"``) -> err_rate, sub, del, ins, ref_len."""

    def toks(text):
        return text.split() if unit == "word" else list(text.replace(" ", ""))

    S = D = I = N = 0
    for ref, hyp in zip(ref_texts, hyp_texts):
        s, d, i, n = edit_distance(toks(ref), toks(hyp))
        S, D, I, N = S + s, D + d, I + i, N + n
    return {"err_rate": float((S + D + I) / max(N, 1)), "sub": S, "del": D,
            "ins": I, "ref_len": N}
