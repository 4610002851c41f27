"""Where the frame build's device ops and device time go, stage by stage,
on one CUDA card.

Builds frame 1 of chip_smoke.py's bench scene (4 cameras, 640x480, 768
keypoints per camera, 4 levels) eagerly with `build_frame`, records the
inputs of its stages, and profiles each stage on those inputs: the ORB
extraction, the intra match (and of it the Sampson gate, the pair stage
and the groups, through the intra_gate, intra_pairs and intra_groups
kernels and through their plain versions) and the triangulation stage
(and of it the gathers and triangulate_and_refine, through the
tri_gather and tri_refine kernels and through their plain versions);
then the rig constants (the pairs' essential matrices, the gate's
threshold and the cameras' world poses), which a tree with
intra.pair_constants makes once per rig and an earlier tree made in
every frame's intra match and triangulation stage. In a tree without
the glue kernels (frontend/intra_cuda.intra_gate) only the pair stage
and tri_refine are split out. The ORB extraction is split into five
parts: the pyramid with its stacking, fast_select, the selection with
the cross-level compaction, patch_gather, and the orientation with the
descriptors. Where the extraction runs them as the orb_pyramid,
orb_select and orb_describe kernels (ops/orb_cuda.py), each part is one
call on its recorded inputs and what the five leave over is printed; in
a tree without those kernels the selection is what the extraction's
time and ops leave after the other four parts. Each line gives the
device time and the count of device ops of one call (torch.profiler,
chip_smoke's device_profile).

Then the tracking half of the eager fast-path frame: frame 1's
`_track_and_map_step` (frame 0's map, the identity prediction, the
production fastpath_frac, the host branch, as chip_smoke phase 14's eager
frame) on the inputs the build hands it, whole and in parts, each part
one call on the inputs the half gave it: the two gates (track_gate,
localmap_gate of frontend/track_cuda; in a tree without those kernels
the two `_gate_factors` calls, the only function of the prologues), the
two matches (hamming_argmin2), the two epilogues (track_epilogue,
localmap_epilogue; none in a tree without them), the two pose_lm calls,
the fast path's score (ransac_cuda.score at K = 1), the draws (the two
`ransac._sample_idx` calls of the graphed frame, K = 512 x 3 and 256 x
6, on the inlier mask as float weights; the eager fast path makes none),
and the pack: what the half leaves after its parts (the fast-path test,
the packing; in a tree without the glue kernels also the projections,
the epilogues and the gathers). To split the parent tree too, copy this
script into its scripts/ and run it there. Run from the repository's
root on a machine with a card and nvcc:

    python3 scripts/frame_stage_split.py [--limit SECONDS]

After its last line the process used to hang in the interpreter's
native finalization (no Python thread but MainThread left; after
torch.profiler's CUDA traces), until a time limit killed it. So it lists
the threads still alive, flushes its output and ends with os._exit,
skipping the finalizers. --limit (default 600 s) is its own time limit:
faulthandler prints every thread's stack 5 s before it, and an alarm
signal ends the process at it, wherever it is.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import pathlib
import signal
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def orb_parts(imgs, kw):
    """([(part, fn)], (rest, extract)) of the ORB extraction of (C, H, W)
    imgs under the extraction keywords kw: each fn one call of its part on
    the inputs a recorded extraction gave it, and the part that is what
    the whole extraction leaves after them."""
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    from mcslam_tpu_torch.ops import image as image_ops, orb

    def extract():
        return orb.extract_orb_rig(imgs, **kw)

    try:
        from mcslam_tpu_torch.ops import orb_cuda
    except ImportError:  # a tree before the ORB kernels
        orb_cuda = None
    if orb_cuda is not None:
        seen = cs.capture_calls(extract, {
            "pyramid": (orb_cuda, "orb_pyramid"),
            "fast_select": (orb, "fast_select"),
            "select": (orb_cuda, "orb_select"),
            "patch_gather": (orb, "patch_gather"),
            "describe": (orb_cuda, "orb_describe")})

        def call(name, fn):
            a, k = seen[name]
            return lambda: fn(*a, **k)

        return [("pyramid + stack", call("pyramid", orb_cuda.orb_pyramid)),
                ("fast_select", call("fast_select", orb.fast_select)),
                ("selection + compaction",
                 call("select", orb_cuda.orb_select)),
                ("patch_gather", call("patch_gather", orb.patch_gather)),
                ("orientation + descriptors",
                 call("describe", orb_cuda.orb_describe))], (
                    "what the five parts leave", extract)
    # the tree before the kernels: the pyramid is build_pyramid and the
    # stacking of extract_orb_levels, the orientation and descriptors two
    # functions of ops/orb.py
    seen = cs.capture_calls(extract, {
        "fast_select": (orb, "fast_select"),
        "patch_gather": (orb, "patch_gather"),
        "orient": (orb, "patch_orientation"),
        "desc": (orb, "compute_descriptors_patch")})
    H0, W0 = imgs.shape[-2:]

    def pyramid():
        levels = image_ops.build_pyramid(imgs, kw["num_levels"], 1.2)
        return torch.cat(
            [F.pad(lv[None], (0, W0 - lv.shape[-1], 0, H0 - lv.shape[-2]),
                   mode="replicate")[0] for lv in levels], dim=0).contiguous()

    def call(name, fn):
        a, k = seen[name]
        return lambda: fn(*a, **k)

    orient = call("orient", orb.patch_orientation)
    desc = call("desc", orb.compute_descriptors_patch)

    def describe():
        orient()
        desc()

    return [("pyramid + stack", pyramid),
            ("fast_select", call("fast_select", orb.fast_select)),
            ("patch_gather", call("patch_gather", orb.patch_gather)),
            ("orientation + descriptors", describe)], (
                "selection + compaction", extract)


def stage_split(scene, smi):
    """Print each stage's device time and device ops on frame 1."""
    import chip_smoke as cs
    import torch

    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import lie, triangulation, triangulation_cuda

    def build():
        return frame.build_frame(scene.imgs[1], scene.rig,
                                 **scene.frame_kwargs())

    build()  # the build and the first launches come before the traces
    glue = ("intra_gate", "intra_groups", "tri_gather") \
        if hasattr(intra_cuda, "intra_gate") else ()
    seen = cs.capture_calls(build, {
        "tri_refine": (triangulation, "triangulate_and_refine"),
        **{n: (intra_cuda, n) for n in ("intra_pairs", *glue)}})
    stages = cs.capture_calls(build, {
        "orb": (frame.orb, "extract_orb_rig"),
        "intra": (frame.intra_ops, "intra_match"),
        "tri": (frame, "_triangulate_stage")})
    ta, tkw = seen["tri_refine"]
    ia, ikw = seen["intra_pairs"]

    def call(name, fn):
        a, kw = stages[name]
        return lambda: fn(*a, **kw)

    def kernel(name, label):
        if name not in glue:
            return []
        a, kw = seen[name]
        return [(f"of which {label}, {name}",
                 lambda: getattr(intra_cuda, name)(*a, **kw)),
                (f"of which {label}, plain", lambda: getattr(
                    intra_cuda, f"{name}_reference")(*a, **kw))]

    rig = scene.rig

    def rig_constants():
        pair_i, pair_j = intra_cuda.camera_pairs(rig.num_cams)
        E = torch.stack([frame.intra_ops.pair_essential(rig, i, j)
                         for i, j in zip(pair_i, pair_j)])
        thr_n = 3.0 / torch.mean(rig.fxycxy[:, 0])
        return E, thr_n * thr_n, lie.se3_inverse(rig.cam_T_ref)

    def show(name, fn):
        dev_ms, n_ops, _ = cs.device_profile(fn)
        print(f"# stage split, {name}: {dev_ms:.3f} ms device time in "
              f"{n_ops:.0f} device ops ({smi})")
        return dev_ms, n_ops

    for name, fn in (
            ("frame build (eager)", build),
            ("ORB extraction", call("orb", frame.orb.extract_orb_rig)),
            ("intra match", call("intra", frame.intra_ops.intra_match)),
            *kernel("intra_gate", "the Sampson gate"),
            ("of which the pair stage, intra_pairs",
             lambda: intra_cuda.intra_pairs(*ia, **ikw)),
            ("of which the pair stage, plain",
             lambda: intra_cuda.intra_pairs_reference(*ia, **ikw)),
            *kernel("intra_groups", "the groups and their top-k"),
            ("triangulation stage", call("tri", frame._triangulate_stage)),
            *kernel("tri_gather", "the gathers"),
            ("of which tri_refine",
             lambda: triangulation_cuda.tri_refine(*ta, **tkw)),
            ("of which the plain triangulation",
             lambda: triangulation.triangulate_and_refine_reference(*ta,
                                                                    **tkw)),
            ("the rig constants (E, thr^2, world_T_cam; "
             + ("made once per rig" if glue else "made in every frame")
             + ")", rig_constants)):
        show(name, fn)

    oa, okw = stages["orb"]
    parts, (rest, extract) = orb_parts(oa[0], okw)
    done_ms = done_ops = 0.0
    for name, fn in parts:
        dev_ms, n_ops = show(f"ORB part, {name}", fn)
        done_ms += dev_ms
        done_ops += n_ops
    dev_ms, n_ops, _ = cs.device_profile(extract)
    print(f"# stage split, ORB part, {rest}: {dev_ms - done_ms:.3f} ms "
          f"device time in {n_ops - done_ops:.0f} device ops (the "
          f"extraction's {dev_ms:.3f} ms in {n_ops:.0f} ops less the parts "
          f"above) ({smi})")


def track_split(scene, smi):
    """Print the device time and device ops of frame 1's tracking half,
    whole and in parts (module docstring)."""
    import chip_smoke as cs
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import pose_opt_cuda, ransac, ransac_cuda
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import match_cuda

    try:
        from mcslam_tpu_torch.frontend import track_cuda
    except ImportError:  # a tree before the tracking glue kernels
        track_cuda = None
    dev = scene.dev
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, _ = cs.seed_map(ff0, dev)
    eye = torch.eye(4, device=dev)

    def step():
        return tk._build_and_track_step(
            torch.Generator(device=dev).manual_seed(0), scene.imgs[1],
            scene.rig, ff0.im_desc, ff0.im_valid, *mapstate, eye,
            **scene.step_kwargs(cs.FASTPATH_FRAC))

    step()
    half = cs.capture_calls(step, {"half": (tk, "_track_and_map_step")})
    ha, hkw = half["half"]
    gen = ha[0]

    def whole():
        gen.manual_seed(0)
        return tk._track_and_map_step(*ha, **hkw)

    targets = {"match": (match_cuda, "hamming_argmin2"),
               "pose_lm": (pose_opt_cuda, "pose_lm"),
               "score": (ransac_cuda, "score")}
    if track_cuda is not None:
        targets.update({n: (track_cuda, n) for n in (
            "track_gate", "localmap_gate", "track_epilogue",
            "localmap_epilogue")})
    else:
        targets["gate_factors"] = (tk, "_gate_factors")
    seen = cs.capture_all(whole, targets)

    def calls(name, fn):
        return [lambda a=a, kw=kw: fn(*a, **kw) for a, kw in seen[name]]

    def both(fns):
        def run():
            for f in fns:
                f()
        return run

    mask = seen["score"][0][0][5].to(torch.float32)
    M = mask.shape[0]
    num_hyp = cs.STEP["num_hyp"]

    def draws():
        return (ransac._sample_idx(gen, num_hyp, 3, M, mask),
                ransac._sample_idx(gen, max(num_hyp // 2, 64), 6, M, mask))

    if track_cuda is not None:
        parts = [("the two gates (track_gate, localmap_gate)",
                  both(calls("track_gate", track_cuda.track_gate)
                       + calls("localmap_gate", track_cuda.localmap_gate))),
                 ("the two epilogues (track_epilogue, localmap_epilogue)",
                  both(calls("track_epilogue", track_cuda.track_epilogue)
                       + calls("localmap_epilogue",
                               track_cuda.localmap_epilogue)))]
    else:
        parts = [("the two gates' _gate_factors",
                  both(calls("gate_factors", tk._gate_factors)))]
    parts += [("the two matches (hamming_argmin2)",
               both(calls("match", match_cuda.hamming_argmin2))),
              ("the two pose_lm calls",
               both(calls("pose_lm", pose_opt_cuda.pose_lm))),
              ("the score (ransac_score, K = 1)",
               both(calls("score", ransac_cuda.score)))]
    done_ms = done_ops = 0.0
    for name, fn in parts:
        dev_ms, n_ops, _ = cs.device_profile(fn)
        done_ms += dev_ms
        done_ops += n_ops
        print(f"# track split, {name}: {dev_ms:.4f} ms device time in "
              f"{n_ops:.0f} device ops ({smi})")
    dev_ms, n_ops, _ = cs.device_profile(draws)
    print(f"# track split, the draws (two ransac._sample_idx, on the graphed "
          f"frame only): {dev_ms:.4f} ms device time in {n_ops:.0f} device "
          f"ops ({smi})")
    dev_ms, n_ops, _ = cs.device_profile(whole)
    rest = ("the fast-path test and the packing" if track_cuda is not None
            else "the projections, the epilogues, the gathers, the "
            "fast-path test and the packing")
    print(f"# track split, the pack and the rest ({rest}): "
          f"{dev_ms - done_ms:.4f} ms device time in {n_ops - done_ops:.0f} "
          f"device ops (the half's less the parts above) ({smi})")
    print(f"# track split, the tracking half of the eager fast-path frame "
          f"(_track_and_map_step, host branch): {dev_ms:.4f} ms device time "
          f"in {n_ops:.0f} device ops ({smi})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--limit", type=float, default=600.0)
    opt = ap.parse_args()
    faulthandler.dump_traceback_later(max(opt.limit - 5, 1))
    signal.alarm(int(opt.limit))
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
    scene = cs.Scene(dev, frames=2)
    stage_split(scene, smi)
    track_split(scene, smi)
    alive = [f"{t.name}{' (daemon)' if t.daemon else ''}"
             for t in threading.enumerate()]
    print(f"# frame_stage_split: done; threads alive: {', '.join(alive)}",
          flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
