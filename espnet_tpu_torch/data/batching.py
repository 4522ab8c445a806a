"""Batch samplers and padded collation (counterpart of
espnet_tpu/data/batching.py): ``unsorted``, ``sorted``, ``folded`` and
``numel`` batches, and
collation that pads every sequence to a fixed length
(``collate_fixed_lengths``) or to a length bucket, adding ``*_lengths``.
Fixed lengths keep the train step at one shape, as they keep the JAX
package's step at one compiled program."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from espnet_tpu_torch.data.fileio import load_num_sequence_text


def bucket_length(n: int, base: int = 16, growth: float = 1.25) -> int:
    """Smallest bucket >= n on a geometric grid, multiples of 8."""
    if n <= base:
        return base
    b = float(base)
    while b < n:
        b *= growth
    return int(math.ceil(b / 8.0) * 8)


def _folded(sk: List[str], primary: Dict[str, int], batch_size: int,
            fold_length: int, min_batch_size: int) -> List[Tuple[str, ...]]:
    """Batches of the ascending keys ``sk`` whose size shrinks by
    ceil(longest / fold_length): the window's last key bounds the fold
    factor, so the size is iterated to a fixed point."""
    fold = max(int(fold_length), 1)
    batches, i = [], 0
    while i < len(sk):
        bs = batch_size
        while True:
            j = min(i + bs, len(sk))
            factor = -(-primary[sk[j - 1]] // fold)
            bs_new = max(batch_size // max(factor, 1), min_batch_size)
            if bs_new >= bs or bs == min_batch_size:
                break
            bs = bs_new
        batches.append(tuple(sk[i:i + bs]))
        i += bs
    return batches


def _numel(sk: List[str], utt2shapes, batch_bins: int, drop_last: bool,
           min_batch_size: int) -> List[Tuple[str, ...]]:
    """Batches of the ascending keys ``sk`` holding at most ``batch_bins``
    elements (the sum of each key's lengths over the data names), each of
    at least ``min_batch_size`` keys."""
    batches, cur, cur_bins = [], [], 0
    for k in sk:
        numel = sum(d[k] for d in utt2shapes)
        if cur and cur_bins + numel > batch_bins and \
                len(cur) >= min_batch_size:
            batches.append(tuple(cur))
            cur, cur_bins = [], 0
        cur.append(k)
        cur_bins += numel
    if cur and (not drop_last or len(cur) >= min_batch_size):
        batches.append(tuple(cur))
    return batches


def build_batch_sampler(
    batch_type: str,
    batch_size: int = 20,
    batch_bins: int = 4000000,
    shape_files: Sequence[str] = (),
    utt2shapes: Optional[Sequence[Dict[str, int]]] = None,
    keys: Optional[List[str]] = None,
    sort_in_batch: str = "descending",
    drop_last: bool = False,
    min_batch_size: int = 1,
    fold_length: int = 80000,
) -> List[Tuple[str, ...]]:
    """-> a list of key tuples, one per batch. ``utt2shapes`` (or the
    shape files) give each key's first-dim length per data name; the first
    decides the order of ``sorted``, ``folded`` and ``numel`` batches
    (ascending) and within a batch."""
    if utt2shapes is None:
        utt2shapes = [{k: int(v[0]) for k, v in
                       load_num_sequence_text(f, "csv_int").items()}
                      for f in shape_files]
    if keys is None:
        keys = list(utt2shapes[0]) if utt2shapes else []
    if batch_type == "unsorted":
        batches = [tuple(keys[i:i + batch_size])
                   for i in range(0, len(keys), batch_size)]
    elif batch_type in ("sorted", "folded", "numel"):
        primary = utt2shapes[0]
        sk = sorted(keys, key=lambda k: primary[k])
        if batch_type == "folded":
            batches = _folded(sk, primary, batch_size, fold_length,
                              min_batch_size)
        elif batch_type == "numel":
            batches = _numel(sk, utt2shapes, batch_bins, drop_last,
                             min_batch_size)
        else:
            batches = [tuple(sk[i:i + batch_size])
                       for i in range(0, len(sk), batch_size)]
    else:
        raise ValueError(f"unknown batch_type {batch_type!r}")
    if sort_in_batch == "descending" and utt2shapes:
        primary = utt2shapes[0]
        batches = [tuple(sorted(b, key=lambda k: -primary.get(k, 0)))
                   for b in batches]
    return batches


def common_collate_fn(
    samples: Sequence[Tuple[str, Dict[str, np.ndarray]]],
    bucket_growth: float = 1.25,
    fixed_lengths: Optional[Dict[str, int]] = None,
) -> Tuple[Tuple[str, ...], Dict[str, np.ndarray]]:
    """[(uid, {name: array})] -> (uids, {name: (B, L, ...), name_lengths}).

    Sequences pad with 0 (labels carry their lengths). A name in
    ``fixed_lengths`` pads to at least that length, the others to their
    length bucket; scalars are stacked."""
    uids = tuple(s[0] for s in samples)
    data = {}
    for name in samples[0][1]:
        arrs = [np.asarray(s[1][name]) for s in samples]
        if arrs[0].ndim == 0:
            data[name] = np.stack(arrs)
            continue
        lens = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
        maxlen = int(lens.max())
        if fixed_lengths and name in fixed_lengths:
            maxlen = max(maxlen, int(fixed_lengths[name]))
        else:
            maxlen = bucket_length(maxlen, growth=bucket_growth)
        out = np.zeros((len(arrs), maxlen) + arrs[0].shape[1:],
                       dtype=arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        data[name] = out
        data[f"{name}_lengths"] = lens
    return uids, data
