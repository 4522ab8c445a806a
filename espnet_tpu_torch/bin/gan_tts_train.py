"""VITS training entry point (counterpart of
espnet_tpu/bin/gan_tts_train.py).

    python -m espnet_tpu_torch.bin.gan_tts_train --config train.yaml \\
        --output_dir exp/vits [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.gan_tts import GANTTSTask


def main(argv=None):
    return GANTTSTask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
