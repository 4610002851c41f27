"""Where the frame build's device ops and device time go, stage by stage,
on one CUDA card.

Builds frame 1 of chip_smoke.py's bench scene (4 cameras, 640x480, 768
keypoints per camera, 4 levels) eagerly with `build_frame`, records the
inputs of its stages, and profiles each stage on those inputs: the ORB
extraction, the intra match (and of it the pair stage, through the
intra_pairs kernel and through its plain version) and the triangulation
stage (and of it triangulate_and_refine, through the tri_refine kernel
and through its plain version). Each line gives the device time and the
count of device ops of one call (torch.profiler, chip_smoke's
device_profile). Run from the repository's root on a machine with a
card and nvcc:

    python3 scripts/frame_stage_split.py
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def stage_split(scene, smi):
    """Print each stage's device time and device ops on frame 1."""
    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda

    def build():
        return frame.build_frame(scene.imgs[1], scene.rig,
                                 **scene.frame_kwargs())

    build()  # the build and the first launches come before the traces
    seen = cs.capture_calls(build)
    stages = cs.capture_calls(build, {
        "orb": (frame.orb, "extract_orb_rig"),
        "intra": (frame.intra_ops, "intra_match"),
        "tri": (frame, "_triangulate_stage")})
    ta, tkw = seen["tri_refine"]
    ia, ikw = seen["intra_pairs"]

    def call(name, fn):
        a, kw = stages[name]
        return lambda: fn(*a, **kw)

    for name, fn in (
            ("frame build (eager)", build),
            ("ORB extraction", call("orb", frame.orb.extract_orb_rig)),
            ("intra match", call("intra", frame.intra_ops.intra_match)),
            ("of which the pair stage, intra_pairs",
             lambda: intra_cuda.intra_pairs(*ia, **ikw)),
            ("of which the pair stage, plain",
             lambda: intra_cuda.intra_pairs_reference(*ia, **ikw)),
            ("triangulation stage", call("tri", frame._triangulate_stage)),
            ("of which tri_refine",
             lambda: triangulation_cuda.tri_refine(*ta, **tkw)),
            ("of which the plain triangulation",
             lambda: triangulation.triangulate_and_refine_reference(*ta,
                                                                    **tkw))):
        dev_ms, n_ops, _ = cs.device_profile(fn)
        print(f"# stage split, {name}: {dev_ms:.3f} ms device time in "
              f"{n_ops:.0f} device ops ({smi})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("frame_stage_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcslam_tpu_torch  # noqa: F401  (sets the f32 matmul policy)

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(f"# {torch.cuda.get_device_name(0)} ({smi}), torch "
          f"{torch.__version__}")
    stage_split(cs.Scene(dev, frames=2), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
