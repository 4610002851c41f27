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

    python3 scripts/session_gap.py [--record gap.npz]

The first frame whose tracked count differs between the card and the CPU
(`--record PATH` on the card, then `--decide PATH` on a machine with the
JAX package): --record runs the card session eagerly (graphs off, so
that the step's Python runs on every frame; the graphed session's
tracked counts are printed beside it) and the CPU session, recording per
frame the last tracking step's inputs and packed output
(slam._build_and_track_step, or slam._track_and_map_step where a rescue
re-tracks), and saves them. --decide (no card needed) runs the JAX
package's session on the CPU with the same recording, takes the first
frame whose tracked count differs between card and CPU, and prints per
point tracked on one side only: the landmark, the gate that drops it on
the other side (candidate list, frustum, viewing cone, projection
radius, Hamming distance, the argmin among the gated candidates, or the
pose LM's chi-square), each side's value of the gated quantity and its
margin to the gate, in float64 from that side's state (the local map's
input pose for the matching gates, its refined pose for chi-square), the
JAX session's value for the same feature and landmark, and how far the
card-vs-CPU pose difference of that frame moves the quantity.

    python3 scripts/session_gap.py --decide gap.npz
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


SESSION_CFG = dict(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                   local_map_landmarks=1024, kf_translation=0.2,
                   kf_rotation=0.1, min_inter_matches=40)
CHI2 = 5.991  # pose_opt.CHI2_2DOF, the pose LM's inlier gate


def _np(x):
    import numpy as np

    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _u32(desc):
    """(n, 8) descriptor words as uint32 (the port's int32 view, JAX's
    uint32)."""
    import numpy as np

    return np.ascontiguousarray(_np(desc)).view(np.uint32)


def recorded_session(mod, slam, imgs):
    """slam.process_image over imgs with mod._build_and_track_step and
    mod._track_and_map_step (mod: the module of slam's class) recorded ->
    per frame (tracked count, the last step's record or None)."""
    calls = []
    real_b, real_t = mod._build_and_track_step, mod._track_and_map_step

    def rec_build(gen, imgs_, rig, pd, pv, pl, pos, valid, desc, nrm, cand,
                  cvalid, pred, **kw):
        out = real_b(gen, imgs_, rig, pd, pv, pl, pos, valid, desc, nrm, cand,
                     cvalid, pred, **kw)
        _, _, groups, tri, packed = out
        calls.append(dict(
            desc=_u32(groups.desc), fvalid=_np(groups.valid),
            uv=_np(tri[3]), anchor=_np(tri[2]), sigma2=_np(tri[4]),
            pos=_np(pos), mvalid=_np(valid), mdesc=_u32(desc),
            normal=_np(nrm), cand=_np(cand), cvalid=_np(cvalid),
            cam=_np(rig.cam_T_ref), f=_np(rig.fxycxy), packed=_np(packed),
            radius=kw["lm_radius"], max_dist=kw["lm_max_dist"],
            wh=tuple(kw["image_wh"])))
        return out

    def rec_track(*a, **kw):
        out = real_t(*a, **kw)
        names = ("gen", "desc", "fvalid", "uv", "anchor", "sigma2", "p3d",
                 "hd", "pd", "pv", "pl", "pos", "mvalid", "mdesc", "normal",
                 "cand", "cvalid", "cam", "f", "pred", "num_hyp", "px",
                 "md", "ratio", "wh", "radius", "max_dist")
        arg = dict(zip(names, a))
        arg.update(kw)
        calls.append(dict(
            desc=_u32(arg["desc"]), fvalid=_np(arg["fvalid"]),
            uv=_np(arg["uv"]), anchor=_np(arg["anchor"]),
            sigma2=_np(arg["sigma2"]), pos=_np(arg["pos"]),
            mvalid=_np(arg["mvalid"]), mdesc=_u32(arg["mdesc"]),
            normal=_np(arg["normal"]), cand=_np(arg["cand"]),
            cvalid=_np(arg["cvalid"]), cam=_np(arg["cam"]), f=_np(arg["f"]),
            packed=_np(out), radius=arg["radius"], max_dist=arg["max_dist"],
            wh=tuple(arg["wh"])))
        return out

    mod._build_and_track_step, mod._track_and_map_step = rec_build, rec_track
    frames = []
    try:
        for k in range(len(imgs)):
            n0 = len(calls)
            info = slam.process_image(imgs[k], k / 20.0, extract_cfg=EXTRACT)
            frames.append((int(info.get("tracked", 0)),
                           calls[-1] if len(calls) > n0 else None))
    finally:
        mod._build_and_track_step, mod._track_and_map_step = real_b, real_t
    return frames


def record(rig, imgs, cuda, path):
    """The card session (eager) and the CPU session, recorded, to path."""
    import numpy as np

    from mcslam_tpu_torch import slam as tslam

    cfg = tslam.SlamConfig(**SESSION_CFG)
    out = {}
    for side, d in (("cpu", "cpu"), ("card", cuda)):
        slam = tslam.MultiCameraSLAM(rig, cfg, device=d)
        slam.cuda_graphs = False
        for k, (n, rec) in enumerate(recorded_session(tslam, slam, imgs)):
            out[f"{side}/{k}/tracked"] = np.int64(n)
            for key, v in (rec or {}).items():
                out[f"{side}/{k}/{key}"] = np.asarray(v)
        print(f"# recorded the {side} session (eager): tracked per frame "
              f"{[int(out[f'{side}/{k}/tracked']) for k in range(len(imgs))]}",
              flush=True)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)


def load(path, side, n):
    import numpy as np

    z = np.load(path, allow_pickle=False)
    frames = []
    for k in range(n):
        pre = f"{side}/{k}/"
        rec = {key[len(pre):]: z[key] for key in z.files
               if key.startswith(pre) and key != pre + "tracked"}
        for key in ("radius", "max_dist"):
            if key in rec:
                rec[key] = float(rec[key])
        if "wh" in rec:
            rec["wh"] = tuple(int(x) for x in rec["wh"])
        frames.append((int(z[pre + "tracked"]), rec or None))
    return frames


def jax_frames(imgs):
    """The JAX package's session on the CPU, recorded as the port's."""
    from mcslam_tpu import slam as jslam
    from mcslam_tpu.data import synthetic as jsyn

    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=3, baseline=0.2, image_size=(320, 240), focal=260.0))
    slam = jslam.MultiCameraSLAM(rig, jslam.SlamConfig(**SESSION_CFG))
    return recorded_session(jslam, slam, imgs)


def _unpack(rec):
    """(T_track, T_final, lm id per feature (-1: none), inlier flags)
    from a packed step output (tracking_kernels' layout)."""
    import numpy as np

    v = rec["packed"].astype(np.float64)
    M = rec["fvalid"].shape[0]
    off = 21 + 3 * M
    return (v[:16].reshape(4, 4), v[off:off + 16].reshape(4, 4),
            v[off + 16:off + 16 + M].astype(np.int64),
            v[off + 16 + M:off + 16 + 2 * M] > 0.5)


def _popcount(x):
    import numpy as np

    x = x.astype(np.uint64)
    return np.array([bin(int(w)).count("1") for w in x.ravel()]).reshape(
        x.shape).sum(-1)


def gates(rec, i, lm):
    """Feature i against landmark lm under one side's record, in float64:
    {gate: (value, threshold, passes)} in the local map's order, and the
    first gate failed (None: every gate passes)."""
    import numpy as np

    T, T_fin, _, _ = _unpack(rec)
    cand = rec["cand"][rec["cvalid"]]
    out = {}
    out["candidate"] = (float(lm in set(cand.tolist())), 1.0,
                        lm in set(cand.tolist()))
    X = rec["pos"][lm].astype(np.float64)
    a = int(rec["anchor"][i])
    cam = rec["cam"][a].astype(np.float64)
    f = rec["f"][a].astype(np.float64)
    uv = rec["uv"][i].astype(np.float64)

    def project(Twr):
        p = np.linalg.inv(Twr) @ np.append(X, 1.0)
        pc = cam @ p
        z = pc[2]
        return z, pc[:2] / (z if z > 0.05 else 1.0) * f[:2] + f[2:]

    z, proj = project(T)
    w, h = rec["wh"]
    inside = min(proj[0], w - proj[0], proj[1], h - proj[1])
    out["frustum"] = (float(min(z - 0.05, inside)), 0.0,
                      z > 0.05 and 0 <= proj[0] < w and 0 <= proj[1] < h)
    n = rec["normal"][lm].astype(np.float64)
    view = X - T[:3, 3]
    view = view / max(np.linalg.norm(view), 1e-9)
    cosv = float(view @ n)
    has_n = np.linalg.norm(n) > 1e-6
    out["cone"] = (cosv, 0.5, cosv > 0.5 or not has_n)
    d = float(np.linalg.norm(uv - proj))
    out["radius"] = (d, rec["radius"], d * d < rec["radius"] ** 2)
    ham = int(_popcount(rec["desc"][i] ^ rec["mdesc"][lm]))
    out["hamming"] = (float(ham), rec["max_dist"], ham <= rec["max_dist"])
    # the argmin among the candidates that pass the frustum, cone and
    # radius gates: the best other candidate's distance
    best_other = np.inf
    for c in cand.tolist():
        if c == lm:
            continue
        Xc = rec["pos"][c].astype(np.float64)
        p = cam @ (np.linalg.inv(T) @ np.append(Xc, 1.0))
        if p[2] <= 0.05:
            continue
        pr = p[:2] / p[2] * f[:2] + f[2:]
        if not (0 <= pr[0] < w and 0 <= pr[1] < h):
            continue
        nc = rec["normal"][c].astype(np.float64)
        vc = Xc - T[:3, 3]
        vc = vc / max(np.linalg.norm(vc), 1e-9)
        if np.linalg.norm(nc) > 1e-6 and not vc @ nc > 0.5:
            continue
        if np.sum((uv - pr) ** 2) >= rec["radius"] ** 2:
            continue
        best_other = min(best_other, int(_popcount(
            rec["desc"][i] ^ rec["mdesc"][c])))
    out["argmin"] = (float(ham), best_other, ham < best_other)
    _, proj_f = project(T_fin)
    chi2 = float(np.sum((uv - proj_f) ** 2) / float(rec["sigma2"][i]))
    out["chi2"] = (chi2, CHI2, chi2 < CHI2)
    failed = next((g for g, (_, _, ok) in out.items() if not ok), None)
    return out, failed


def decide(path, imgs):
    """The first frame whose tracked count differs between the card and
    the CPU: each point tracked on one side only, its gate and margins
    on the card, the CPU and in JAX."""
    import numpy as np

    n = len(imgs)
    card, cpu = load(path, "card", n), load(path, "cpu", n)
    jax = jax_frames(imgs)
    print("# tracked per frame: card "
          f"{[t for t, _ in card]}, CPU {[t for t, _ in cpu]}, JAX "
          f"{[t for t, _ in jax]}", flush=True)
    k = next((k for k in range(n) if card[k][0] != cpu[k][0]), None)
    if k is None:
        print("# no frame's tracked count differs between card and CPU")
        return
    sides = {"card": card[k][1], "CPU": cpu[k][1], "JAX": jax[k][1]}
    feats_equal = all(np.array_equal(sides["card"][f], sides["CPU"][f])
                      for f in ("desc", "fvalid", "uv", "anchor", "sigma2"))
    un = {s: _unpack(r) for s, r in sides.items()}
    tracked = {s: set(np.flatnonzero((u[2] >= 0) & u[3]).tolist())
               for s, u in un.items()}
    dT = {name: (float(np.linalg.norm(un["card"][j][:3, 3]
                                       - un["CPU"][j][:3, 3])),
                 float(np.degrees(np.arccos(np.clip(
                     (np.trace(un["card"][j][:3, :3].T
                               @ un["CPU"][j][:3, :3]) - 1) / 2, -1, 1)))))
          for j, name in ((0, "local map's input"), (1, "refined"))}
    print(f"# frame {k}: tracked card {card[k][0]}, CPU {cpu[k][0]}, JAX "
          f"{jax[k][0]}; the frame's features equal card vs CPU: "
          f"{feats_equal}; pose difference card vs CPU: " + "; ".join(
              f"{name} {t:.3g} m, {r:.3g} deg" for name, (t, r) in dT.items()),
          flush=True)
    for i in sorted(tracked["card"] ^ tracked["CPU"]):
        on = "card" if i in tracked["card"] else "CPU"
        off = "CPU" if on == "card" else "card"
        lm = int(un[on][2][i])
        g_on, _ = gates(sides[on], i, lm)
        g_off, failed = gates(sides[off], i, lm)
        lm_off = int(un[off][2][i])
        # JAX: its own landmark for the feature where it tracks it, else
        # the landmark nearest the port's position
        jr = sides["JAX"]
        lm_j = int(un["JAX"][2][i])
        if lm_j < 0:
            d = np.linalg.norm(jr["pos"] - sides[on]["pos"][lm], axis=1)
            d[~jr["mvalid"]] = np.inf
            lm_j = int(np.argmin(d))
        g_j, failed_j = gates(jr, i, lm_j)
        gate = failed or "none (another step's decision)"
        print(f"# frame {k} feature {i}: tracked on the {on} only (landmark "
              f"{lm}; the {off} matched it to {lm_off}, inlier "
              f"{bool(un[off][3][i])}); the {off} fails the {gate} gate",
              flush=True)
        for g in g_on:
            (vo, thr, oko), (vf, _, okf), (vj, _, okj) = (g_on[g], g_off[g],
                                                         g_j[g])
            print(f"#   {g} (gate {thr:.6g}): {on} {vo:.6g} (margin "
                  f"{vo - thr:+.4g}, passes {oko}), {off} {vf:.6g} (margin "
                  f"{vf - thr:+.4g}, passes {okf}), card - CPU "
                  f"{(vo - vf) * (1 if on == 'card' else -1):+.4g}; JAX "
                  f"(landmark {lm_j}) {vj:.6g} (margin {vj - thr:+.4g}, "
                  f"passes {okj})", flush=True)
        print(f"#   JAX tracks the feature: {i in tracked['JAX']} (first "
              f"gate failed in JAX: {failed_j})", flush=True)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", help="save the card and CPU sessions' "
                    "tracking steps to this .npz")
    ap.add_argument("--decide", help="analyse a recorded .npz against the "
                    "JAX package's session (no card needed)")
    opt = ap.parse_args()
    rig, imgs = scene()
    if opt.decide:
        decide(opt.decide, imgs)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("session_gap: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcslam_tpu_torch  # noqa: F401  (sets the f32 matmul policy)

    cuda = torch.device("cuda", 0)
    print(f"# {torch.cuda.get_device_name(0)} ({cs.nvidia_smi_line()}), torch "
          f"{torch.__version__}")
    elementwise(cuda)
    frame_builds(rig, imgs, cuda)
    sessions(rig, imgs, cuda)
    first_track(rig, imgs, cuda)
    if opt.record:
        record(rig, imgs, cuda, opt.record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
