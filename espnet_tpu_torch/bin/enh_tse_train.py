"""Target-speaker extraction training entry point (counterpart of
espnet_tpu/bin/enh_tse_train.py).

    python -m espnet_tpu_torch.bin.enh_tse_train --config conf/train.yaml \
        --output_dir exp/tse [--key value ...] [--device cpu]

The data triples name ``speech_mix``, ``enroll_ref1`` and
``speech_ref1``. Trains on the card unless ``--device cpu`` is given;
without a card and without that option it raises.
"""

import sys

from espnet_tpu_torch.tasks.enh import EnhTSETask


def main(argv=None):
    return EnhTSETask.main(argv=sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
