"""Anti-spoofing (counterpart of espnet_tpu/tasks/misc.py:ASVSpoofTask):
classification of bona fide against spoofed speech, two classes. The
other tasks of that module are not ported (ROADMAP A.8)."""

from __future__ import annotations

from espnet_tpu_torch.tasks.spk import ClassificationTask


class ASVSpoofTask(ClassificationTask):
    name = "asvspoof"

    @classmethod
    def task_defaults(cls):
        return dict(super().task_defaults(), n_classes=2)
