"""Prepare a SpeechLM dataset JSON (counterpart of
espnet_tpu/bin/speechlm_prepare_dataset.py): a task, its data entries
(name, path, loader type) and the sample ids, which training reads
through ``multi_task_dataset``.

Usage:
  python -m espnet_tpu_torch.bin.speechlm_prepare_dataset \
      --output data/t2a.json --task text_to_audio \
      --entry text1:data/train/text:text \
      --entry audio1:data/train/codes.scp:npy [--samples data/train/ids]
Sample ids default to the intersection of all entries' keys.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--task", required=True)
    ap.add_argument("--entry", action="append", default=[],
                    help="name:path:type triple (repeatable)")
    ap.add_argument("--samples", default=None,
                    help="file with one sample id per line (optional)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    from espnet_tpu_torch.data.dataset import build_loader
    from espnet_tpu_torch.data.speechlm import write_dataset_json
    entries = []
    keysets = []
    for spec in args.entry:
        name, path, typ = spec.split(":", 2)
        entries.append({"name": name, "path": path, "type": typ})
        keysets.append(set(build_loader(path, typ).keys()))
    if args.samples:
        samples = [ln.split()[0] for ln in
                   Path(args.samples).read_text(encoding="utf-8")
                   .splitlines() if ln.strip()]
    else:
        common = set.intersection(*keysets) if keysets else set()
        samples = sorted(common)
    if not samples:
        raise SystemExit("no samples (empty entry intersection?)")
    write_dataset_json(args.output, args.task, entries, samples)
    print(f"wrote {args.output}: task={args.task} "
          f"entries={[e['name'] for e in entries]} n={len(samples)}")


if __name__ == "__main__":
    main()
