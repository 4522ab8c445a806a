"""Bulk speaker-embedding extraction (counterpart of
espnet_tpu/bin/spk_embed_extract.py): every utterance of a wav.scp
embedded at its own length into ``<output_dir>/<key>.npy`` ((1,
embed_dim) each), listed in ``embed.scp``:

    python -m espnet_tpu_torch.bin.spk_embed_extract --output_dir exp/emb \\
        --wav_scp data/test/wav.scp --train_config exp/spk/config.yaml \\
        --model_file exp/spk/checkpoint [--device cpu]

It runs on the card unless ``device`` says otherwise.
"""

import sys
from pathlib import Path

import numpy as np

from espnet_tpu_torch.bin.spk_inference import SpeakerEmbedding


def extract(output_dir, wav_scp, train_config=None, model_file=None,
            device=None) -> Path:
    from espnet_tpu_torch.data.fileio import SoundScpReader
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    se = SpeakerEmbedding(train_config, model_file, device)
    reader = SoundScpReader(wav_scp)
    with open(out / "embed.scp", "w", encoding="utf-8") as scp:
        for k in reader.keys():
            _, wav = reader[k]
            np.save(out / f"{k}.npy", se(np.asarray(wav, np.float32)))
            scp.write(f"{k} {out / f'{k}.npy'}\n")
    return out / "embed.scp"


def main(argv=None):
    from espnet_tpu_torch.utils.config import parse_cli_overrides
    return extract(**parse_cli_overrides(
        sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
