"""Joint enhancement + ASR training entry point (counterpart of
espnet_tpu/bin/enh_s2t_train.py).

    python -m espnet_tpu_torch.bin.enh_s2t_train --config conf/train.yaml \\
        --output_dir exp/enh_s2t [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.enh import EnhS2TTask


def main(argv=None):
    return EnhS2TTask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
