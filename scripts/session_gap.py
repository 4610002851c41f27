"""Where the port's session on the card and the same session on the CPU
part, on tests/test_torch_kernels.py::test_session_on_cuda_matches_cpu's
scene (3 cameras, 320x240, 1 pyramid level, 8 frames).

Prints:
- for torch.rsqrt, 1 / torch.sqrt, a float64 sqrt rounded to float32 and
  torch.atan2, on which share of 2^20 inputs the card and the CPU give
  other bits;
- for frames 0 and 3, which fields of build_frame differ between card
  and CPU, and whether the plain triangulation on the CPU, from the
  card's inputs, gives the card kernel's bits;
- per frame of MultiCameraSLAM.process_image on both devices: the
  keyframe flag, keyframes, landmarks, tracked points and the position
  gap;
- frame 1's tracking step from frame 0's map on both devices: each pose
  LM call's inputs card vs CPU, and its pose from the kernel, from the
  plain version on the card and from the plain version on the CPU.
Run from the repository's root on a machine with a card and nvcc:

    python3 scripts/session_gap.py
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NUM_FRAMES = 8
EXTRACT = dict(num_points=512, num_levels=1, max_intra=768)


def scene():
    from mcslam_tpu_torch.data import synthetic

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=3, baseline=0.2, image_size=(320, 240), focal=260.0),
        device="cpu")
    poses = synthetic.smooth_trajectory(NUM_FRAMES, radius=5.0,
                                        step_angle=0.03)
    imgs = synthetic.render_blob_images(rig, poses, synthetic.make_landmarks(
        700, seed=1, depth_range=(4.0, 12.0)), seed=2)
    return rig, imgs


def elementwise(cuda):
    import torch

    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)) * 2 + 1
    for name, f in (("torch.rsqrt", torch.rsqrt),
                    ("1 / torch.sqrt", lambda t: 1.0 / torch.sqrt(t)),
                    ("float64 sqrt to float32",
                     lambda t: torch.sqrt(t.double()).float()),
                    ("torch.atan2", lambda t: torch.atan2(t - 2, 2.5 - t))):
        a, b = f(x), f(x.to(cuda)).cpu()
        print(f"# {name}: card and CPU differ on {int((a != b).sum())} of "
              f"{x.numel()} inputs")


def frame_builds(rig, imgs, cuda):
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.geometry import triangulation

    for k in (0, 3):
        out = []
        for d in ("cpu", cuda):
            def build(d=d):
                return frame.build_frame(torch.from_numpy(imgs[k]).to(d),
                                         rig.to(d), **EXTRACT)
            seen = cs.capture_calls(build, {
                "tri": (triangulation, "triangulate_and_refine")})
            out.append((build(), seen["tri"]))
        (fc, _), (fg, (ta, tkw)) = out
        differ = {f: int((getattr(fc, f) != getattr(fg, f).cpu()).sum())
                  for f in fc._fields}
        print(f"# frame {k} build_frame, elements that differ card vs CPU: "
              f"{differ}")
        cpu = triangulation.triangulate_and_refine_reference(
            *(t.cpu() for t in ta),
            **{n: v.cpu() if torch.is_tensor(v) else v
               for n, v in tkw.items()})
        card = triangulation.triangulate_and_refine(*ta, **tkw)
        print(f"# frame {k}: the plain triangulation on the CPU from the "
              f"card's inputs equals the card kernel: X "
              f"{torch.equal(cpu[0], card[0].cpu())}, ok "
              f"{torch.equal(cpu[1], card[1].cpu())}")


def sessions(rig, imgs, cuda):
    import numpy as np

    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                     local_map_landmarks=1024, kf_translation=0.2,
                     kf_rotation=0.1, min_inter_matches=40)
    rows = []
    for d in ("cpu", cuda):
        slam = MultiCameraSLAM(rig, cfg, device=d)
        r = []
        for k in range(NUM_FRAMES):
            info = slam.process_image(imgs[k], k / 20.0, extract_cfg=EXTRACT)
            _, est = slam.trajectory_arrays()
            r.append((bool(info.get("keyframe")), slam.stats["keyframes"],
                      int(np.asarray(slam.map.valid).sum()),
                      info.get("tracked", 0), est[-1][:3, 3].copy()))
        rows.append(r)
    for k, (c, g) in enumerate(zip(*rows)):
        print(f"# session frame {k}: CPU keyframe {c[0]}, keyframes {c[1]}, "
              f"landmarks {c[2]}, tracked {c[3]} | card keyframe {g[0]}, "
              f"keyframes {g[1]}, landmarks {g[2]}, tracked {g[3]} | position "
              f"gap {np.linalg.norm(c[4] - g[4]):.4g} m")


def first_track(rig, imgs, cuda):
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, pose_opt_cuda

    calls = []
    for d in ("cpu", cuda):
        r = rig.to(d)
        kw = dict(EXTRACT, angle_bins=32)
        ff0 = frame.build_frame(torch.from_numpy(imgs[0]).to(d), r, **kw)
        M = ff0.im_valid.shape[0]
        v0 = ff0.im_valid & ff0.im_has_depth
        ids = torch.arange(M, dtype=torch.int32, device=d)
        cand = torch.nonzero(v0)[:, 0].to(torch.int32)
        cand_ids = torch.zeros(M, dtype=torch.int32, device=d)
        cand_ids[:len(cand)] = cand
        nrm = ff0.im_point3d / ff0.im_point3d.norm(dim=1, keepdim=True)
        seen, orig = [], pose_opt_cuda.pose_lm

        def record(*a, **k):
            out = orig(*a, **k)
            seen.append((a, k, out))
            return out

        pose_opt_cuda.pose_lm = record
        try:
            tk._build_and_track_step(
                torch.Generator(device=d).manual_seed(0),
                torch.from_numpy(imgs[1]).to(d), r, ff0.im_desc, ff0.im_valid,
                torch.where(v0, ids, torch.full_like(ids, -1)),
                ff0.im_point3d, v0, ff0.im_desc, nrm, cand_ids,
                torch.arange(M, device=d) < len(cand), torch.eye(4, device=d),
                fast_threshold=20 / 255, min_threshold=7 / 255, min_z=0.5,
                max_z=40.0, num_hyp=64, px=5.0, max_dist=64, ratio=0.85,
                image_wh=rig.image_size, lm_radius=18.0, lm_max_dist=60,
                gate_px=100.0, fastpath_frac=0.6, fastpath_min=30, **kw)
        finally:
            pose_opt_cuda.pose_lm = orig
        calls.append(seen)
    for i, ((ac, _, oc), (ag, kg, og)) in enumerate(zip(*calls)):
        same = [torch.equal(x, y.cpu()) if torch.is_tensor(x) else x == y
                for x, y in zip(ac, ag)]
        plain_cpu = pose_opt_cuda.pose_lm_reference(
            *(x.cpu() if torch.is_tensor(x) else x for x in ag), **kg)[0]
        plain_card = pose_opt_cuda.pose_lm_reference(*ag, **kg)[0]
        print(f"# frame 1, pose LM call {i}: inputs card vs CPU equal {same}; "
              f"pose max difference: the kernel vs the plain version on the "
              f"card {float((og[0] - plain_card).abs().max()):.3g}, the plain "
              f"version card vs CPU "
              f"{float((plain_card.cpu() - plain_cpu).abs().max()):.3g}, the "
              f"session's two calls {float((og[0].cpu() - oc[0]).abs().max()):.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("session_gap: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcslam_tpu_torch  # noqa: F401  (sets the f32 matmul policy)

    cuda = torch.device("cuda", 0)
    print(f"# {torch.cuda.get_device_name(0)} ({cs.nvidia_smi_line()}), torch "
          f"{torch.__version__}")
    rig, imgs = scene()
    elementwise(cuda)
    frame_builds(rig, imgs, cuda)
    sessions(rig, imgs, cuda)
    first_track(rig, imgs, cuda)
    return 0


if __name__ == "__main__":
    sys.exit(main())
