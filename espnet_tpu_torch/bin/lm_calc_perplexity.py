"""Perplexity of a text set under an LM (counterpart of
espnet_tpu/bin/lm_calc_perplexity.py):

    python -m espnet_tpu_torch.bin.lm_calc_perplexity \
        --train_config assets/synth_lm/config.yaml \
        --model_file assets/synth_lm \
        --data_path_and_name_and_type data/valid/text,text,text \
        [--batch_size 64] [--output_dir exp/ppl] [--device cpu]

exp of the summed nll over the summed tokens (each sentence and its eos),
in batches in key order; writes ``<output_dir>/ppl`` when given. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
import math
import sys
from pathlib import Path

import torch

from espnet_tpu_torch.data.batching import common_collate_fn
from espnet_tpu_torch.data.dataset import ESPnetDataset
from espnet_tpu_torch.tasks.abs_task import parse_triples
from espnet_tpu_torch.tasks.lm import LMTask
from espnet_tpu_torch.utils.config import parse_cli_overrides

logger = logging.getLogger(__name__)


@torch.no_grad()
def calc_perplexity(train_config, model_file, data_path_and_name_and_type,
                    batch_size: int = 8, output_dir=None, device=None):
    model, cfg = LMTask.build_model_from_file(train_config, model_file,
                                              device)
    dev = model.lm.decoder.weight.device
    ds = ESPnetDataset(parse_triples(data_path_and_name_and_type),
                       preprocess=LMTask.build_preprocess_fn(cfg, train=False))
    total_nll, total_tok = 0.0, 0
    keys = ds.keys()
    for i in range(0, len(keys), batch_size):
        _, batch = common_collate_fn([ds[k] for k in keys[i:i + batch_size]])
        nll, t_valid, _, _ = model.nll(
            torch.from_numpy(batch["text"]).long().to(dev),
            torch.from_numpy(batch["text_lengths"]).long().to(dev))
        total_nll += float(nll.sum())
        total_tok += int(t_valid.sum())
    ppl = math.exp(total_nll / max(total_tok, 1))
    logger.info("perplexity: %.3f over %d tokens", ppl, total_tok)
    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "ppl").write_text(f"{ppl}\n")
    return ppl


def main(argv=None):
    calc_perplexity(**parse_cli_overrides(sys.argv[1:] if argv is None
                                          else argv))


if __name__ == "__main__":
    main()
