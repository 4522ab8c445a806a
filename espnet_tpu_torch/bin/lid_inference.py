"""Language-ID inference (counterpart of espnet_tpu/bin/lid_inference.py):
single-label classification over languages, through ClassifySpeech with
the task's model;
``main`` writes ``prediction`` and ``score`` as
bin/cls_inference.py's does. It runs on the card unless ``device`` says
otherwise."""

import sys

from espnet_tpu_torch.bin.cls_inference import ClassifySpeech  # noqa: F401
from espnet_tpu_torch.bin.cls_inference import main as _cls_main
from espnet_tpu_torch.tasks.spk import LIDTask


def main(argv=None):
    return _cls_main(sys.argv[1:] if argv is None else argv, task=LIDTask)


if __name__ == "__main__":
    main()
