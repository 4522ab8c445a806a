"""ASR training entry point (counterpart of espnet_tpu/bin/asr_train.py).

    python -m espnet_tpu_torch.bin.asr_train --config conf/train.yaml \\
        --output_dir exp/asr [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.asr import ASRTask


def main(argv=None):
    return ASRTask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
