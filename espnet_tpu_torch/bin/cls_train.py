"""Audio-classification training entry point (counterpart of
espnet_tpu/bin/cls_train.py).

    python -m espnet_tpu_torch.bin.cls_train --config train.yaml \\
        --output_dir exp/cls [--key value ...] [--device cpu]

Trains on the card unless ``--device cpu`` is given; without a card and
without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.spk import ClassificationTask


def main(argv=None):
    return ClassificationTask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
