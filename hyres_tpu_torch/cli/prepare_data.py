"""Data preparation CLI: flatten class directories into one train folder.

Counterpart of ``hyres_tpu/cli/prepare_data.py`` (the reference's
``data/reorganize.py``): every image file under ``--source`` (``.png``,
``.jpg``, ``.jpeg``, ``.bmp``, in sorted path order) is copied, or moved
with ``--move``, into ``--dest``; a name already taken becomes
``{class dir}_{name}``, then ``{class dir}_{k}_{name}``. Nothing is
downloaded: point ``--source`` at a dataset already on disk. The port's
training reads PNG only.

    python -m hyres_tpu_torch.cli.prepare_data --source mini-imagenet/ --dest data/train
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

_EXTS = {".png", ".jpg", ".jpeg", ".bmp"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="flatten class dirs into a flat train dir")
    p.add_argument("--source", type=str, required=True,
                   help="root containing class subdirectories of images")
    p.add_argument("--dest", type=str, required=True, help="flat output dir")
    p.add_argument("--move", action="store_true", help="move instead of copy")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    src, dst = Path(args.source), Path(args.dest)
    dst.mkdir(parents=True, exist_ok=True)
    n = 0
    for f in sorted(src.rglob("*")):
        if not f.is_file() or f.suffix.lower() not in _EXTS:
            continue
        out = dst / f.name
        if out.exists():  # collision: prefix the class directory
            out = dst / f"{f.parent.name}_{f.name}"
            k = 0
            while out.exists():
                k += 1
                out = dst / f"{f.parent.name}_{k}_{f.name}"
        (shutil.move if args.move else shutil.copy2)(f, out)
        n += 1
    print(f"{'moved' if args.move else 'copied'} {n} images to {dst}")


if __name__ == "__main__":
    main()
