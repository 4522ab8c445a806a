"""Transducer training entry point (counterpart of
espnet_tpu/bin/asr_transducer_train.py).

    python -m espnet_tpu_torch.bin.asr_transducer_train \\
        --config conf/train.yaml --output_dir exp/transducer \\
        [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask


def main(argv=None):
    return ASRTransducerTask.main(argv=sys.argv[1:] if argv is None
                                  else argv)


if __name__ == "__main__":
    main()
