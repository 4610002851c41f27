"""Convert an image-folder dataset to an MCRAW container (counterpart of
scripts/convert_to_mcraw.py).

Decodes every frame (PNG / JPEG / PGM) once, through the native
multi-threaded loader (data/native_loader.py) where it builds, else
through data/readers.ImageFolderReader; the container then replays
through mmap with no decode work (native_loader.McrawReader, the app's
`mcraw_path`). Writing the container needs the native library:
mcraw_write raises where it is unavailable.

Usage:
  python -m mcslam_tpu_torch.apps.convert_to_mcraw <dataset_root>
      <out.mcraw> [cam0,cam1]
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    root, out = argv[0], argv[1]
    cam_dirs = argv[2].split(",") if len(argv) > 2 else None

    from mcslam_tpu_torch.data import native_loader
    from mcslam_tpu_torch.data.readers import ImageFolderReader

    idx = ImageFolderReader(root, cam_dirs)
    if native_loader.available():
        reader = native_loader.NativePrefetchReader(idx.rows)
    else:
        reader = idx
    frames, ts = [], []
    while True:
        item = reader.get_next()
        if item is None:
            break
        imgs, t = item
        frames.append(np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8))
        ts.append(t)
    if not frames:
        print("no frames found", file=sys.stderr)
        return 1
    stack = np.stack(frames)
    native_loader.mcraw_write(out, stack, ts)
    print(
        f"wrote {out}: {stack.shape[0]} frames x {stack.shape[1]} cams "
        f"{stack.shape[3]}x{stack.shape[2]} ({stack.nbytes / 1e6:.1f} MB)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
