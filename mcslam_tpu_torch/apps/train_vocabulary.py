"""Train a BoW vocabulary from a dataset's ORB descriptors (counterpart of
scripts/train_vocabulary.py).

Parity (WHAT): the reference ships pre-trained DBoW2 / fbow vocabulary
files (config keys Vocabulary / FBOWVocabulary); this tool makes the
equivalent for this framework's descriptors, whose BRIEF pattern is its
own (OpenCV / DBoW2 vocabularies do not transfer). The extraction
(ops/orb.extract_orb_rig) runs on --device, the card unless the caller
asks for the CPU; the training (loop/vocab.Vocabulary.train) is host
numpy.

Usage:
  python -m mcslam_tpu_torch.apps.train_vocabulary <image_root>
      out_vocab.npz [--k 8] [--depth 4] [--max_frames 200]
      [--num_points 512] [--num_levels 4] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image_root")
    ap.add_argument("out")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max_frames", type=int, default=200)
    ap.add_argument("--num_points", type=int, default=512)
    ap.add_argument("--num_levels", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the extraction runs (default: the card)")
    args = ap.parse_args(argv)

    from mcslam_tpu_torch.data.readers import ImageFolderReader
    from mcslam_tpu_torch.loop.vocab import Vocabulary
    from mcslam_tpu_torch.ops import hamming, orb

    reader = ImageFolderReader(args.image_root)
    descs = []
    n = 0
    while n < args.max_frames:
        nxt = reader.get_next()
        if nxt is None:
            break
        imgs, _ = nxt
        kps = orb.extract_orb_rig(
            torch.from_numpy(imgs).to(args.device),
            num_points=args.num_points, num_levels=args.num_levels,
        )
        descs.append(hamming.desc_to_numpy_u32(kps.desc[kps.valid]))
        n += 1
        if n % 20 == 0:
            print(f"{n} frames, {sum(len(x) for x in descs)} descriptors",
                  file=sys.stderr)
    all_desc = np.concatenate(descs)
    print(f"training k={args.k} depth={args.depth} on {len(all_desc)} "
          f"descriptors", file=sys.stderr)
    vocab = Vocabulary.train(all_desc, k=args.k, depth=args.depth)
    vocab.save(args.out)
    print(f"saved {vocab.num_words}-word vocabulary -> {args.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
