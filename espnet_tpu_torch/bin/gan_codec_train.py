"""Codec training entry point (counterpart of
espnet_tpu/bin/gan_codec_train.py).

    python -m espnet_tpu_torch.bin.gan_codec_train --config train.yaml \\
        --output_dir exp/codec [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.ssl import CodecTask


def main(argv=None):
    return CodecTask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
