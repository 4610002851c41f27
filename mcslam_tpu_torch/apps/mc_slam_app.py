"""CLI application: the full SLAM pipeline driver (counterpart of
mcslam_tpu/apps/mc_slam_app.py).

Parity (WHAT): MCSlamapp (MCApps/src/mc_slam_app.cpp) — flags
--config_file / --log_file / --traj_file (mc_slam_app.cpp:43-48), reader
selection from settings (:75-99), rig construction (:103-104),
frontend/backend wiring (:107-127), the per-frame process loop
(:722-798), and the end-of-run artifact dump (trajectory, map JSON, loop
DB, graph logs; :139-156).

The rig, and with it the session, the depth maps and the fusion, lives on
--device: the card unless the caller asks for the CPU. Readers yield host
images; each frame is uploaded once.

Usage:
  python -m mcslam_tpu_torch.apps.mc_slam_app --config_file cfg
      [--traj_file out] [--live_view live.png] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def build_reader(settings):
    from mcslam_tpu_torch.data import readers

    if settings.raw.get("mcraw_path"):
        # decode-free mmap replay container (apps/convert_to_mcraw.py)
        from mcslam_tpu_torch.data.native_loader import McrawReader

        return McrawReader(settings.raw["mcraw_path"])
    if settings.raw.get("video_streams"):
        paths = [p for p in settings.raw["video_streams"].split(",") if p]
        return readers.VideoReader(paths, shifts=settings.shifts)
    return readers.ImageFolderReader(
        settings.images_path or settings.data_path,
        frame_range=settings.frames_range,
    )


def _postprocess_frame(info, imgs, slam, rig, settings, depth_dir, fuser):
    """Per-frame data products (dense depth / fusion) on keyframes —
    shared by the fused and split process loops. imgs: (C, H, W) on the
    rig's device."""
    if depth_dir is not None and info.get("keyframe") and rig.num_cams >= 2:
        from mcslam_tpu_torch.ops.stereo import depth_from_rig_pair

        depth, dvalid = depth_from_rig_pair(
            imgs, rig, max_disp=int(settings.raw.get("depth_max_disp", 64)),
        )
        kf_id = slam.keyframes[-1].kf_id
        np.save(depth_dir / f"depth_{kf_id:06d}.npy",
                torch.where(dvalid, depth, 0.0).cpu().numpy())
    if fuser is not None and info.get("keyframe"):
        fuser.add_keyframe(imgs, slam.keyframes[-1].world_T_ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description="mcslam_tpu_torch SLAM app")
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--traj_file", default=None)
    ap.add_argument("--log_file", default=None)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument(
        "--live_view", default=None,
        help="PNG path for the live follow-cam view (also writes an "
        "auto-refreshing .html next to it)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the session runs (default: the card)")
    args = ap.parse_args(argv)

    from mcslam_tpu_torch.data import calib, config
    from mcslam_tpu_torch.frontend.frame import build_frame
    from mcslam_tpu_torch.slam import MultiCameraSLAM
    from mcslam_tpu_torch.utils import mapio

    settings = config.parse_cfg(args.config_file)
    frontend = config.load_frontend_params(settings.frontend_params_file)
    backend = config.load_backend_params(settings.backend_params_file)
    slam_cfg, extract_cfg = config.slam_config_from_params(frontend, backend)

    if settings.kalibr:
        rig, imu_params, gps_params = calib.load_kalibr(
            settings.calib_file_path, device=args.device)
    else:
        rig = calib.load_plain_vo_yaml(settings.calib_file_path,
                                       device=args.device)
        imu_params = gps_params = None

    vocab = None
    if settings.raw.get("vocabulary"):
        from mcslam_tpu_torch.loop.vocab import Vocabulary

        try:
            vocab = Vocabulary.load(settings.raw["vocabulary"])
        except (OSError, KeyError, ValueError) as e:
            # report and continue VO-only, as the JAX app does
            print(f"[mc_slam_app] vocabulary load failed: {e}",
                  file=sys.stderr)

    # inertial / GPS wiring (reference FrontEnd ctor reads the imu/gps
    # calibration blocks, FrontEnd.h:263-407): use_imu/use_gps only take
    # effect when the calibration actually carries the sensor block
    imu_p = gps_lever = None
    if settings.use_imu and imu_params:
        from mcslam_tpu_torch.backend.imu import ImuParams

        imu_p = ImuParams(
            accel_noise=imu_params["acc_noise"],
            gyro_noise=imu_params["gyr_noise"],
            accel_walk=imu_params["acc_walk"],
            gyro_walk=imu_params["gyr_walk"],
            g_norm=imu_params["g_norm"],
        )
    if settings.use_gps and gps_params is not None:
        tbg = gps_params.get("Tbg")
        gps_lever = tbg[:3, 3] if tbg is not None else np.zeros(3, np.float32)

    # mesh_devices > 1: window / global solves over a device mesh of that
    # many distinct devices of --device (the CPU repeats), and the
    # camera-sharded frame build when the mesh divides the rig
    mesh = None
    n_mesh = int(settings.raw.get("mesh_devices", 0) or 0)
    if n_mesh > 1:
        from mcslam_tpu_torch.parallel import sharded_ba

        mesh = sharded_ba.make_mesh(n_mesh, args.device)

    slam = MultiCameraSLAM(rig, slam_cfg, vocab=vocab, imu_params=imu_p,
                           gps_lever_arm=gps_lever, mesh=mesh)

    # map-reuse session (reference relocal app mode, mc_slam_app.cpp:347-521):
    # relocalization=true loads the saved map + BoW DB and localizes against
    # it; fast_tracking=true adds per-frame prior-map tracking from the
    # predicted pose (FrontEnd::startTrackingModule, FrontEnd.cpp:1570-1786)
    if settings.relocalization:
        if vocab is None:
            print(
                "[mc_slam_app] relocalization=true needs a vocabulary",
                file=sys.stderr,
            )
            return 2
        map_path = settings.raw.get("map_path")
        db_path = settings.raw.get("database_path")
        if not map_path or not db_path:
            print(
                "[mc_slam_app] relocalization=true needs map_path and "
                "database_path in the config",
                file=sys.stderr,
            )
            return 2
        from mcslam_tpu_torch.loop.reloc import Relocalizer
        from mcslam_tpu_torch.loop.tracking import FastTracker

        reloc = Relocalizer(vocab, rig, map_path, db_path)
        tracker = FastTracker(reloc) if settings.fast_tracking else None
        slam.enable_relocalization(reloc, tracker)

    reader = build_reader(settings)

    log = None
    if args.log_file or settings.raw.get("log_file"):
        log = mapio.GraphLogWriter(args.log_file or settings.raw["log_file"])
        # imu_raw / g / k / m records stream during the run; x/l/e vision
        # records are dumped below at session end
        slam.attach_graph_log(log)

    imu_stream = gps_stream = None
    if settings.use_imu and settings.raw.get("imu_csv"):
        from mcslam_tpu_torch.data.readers import ImuStream

        imu_stream = ImuStream.from_csv(settings.raw["imu_csv"])
    if settings.use_gps and settings.raw.get("gps_csv"):
        from mcslam_tpu_torch.data.readers import GpsStream

        gps_stream = GpsStream.from_csv(settings.raw["gps_csv"])

    # dense depth reconstruction per keyframe (reference DepthReconstructor,
    # calc_depth=1; off the ATE path — depth maps are a data product)
    depth_dir = None
    if settings.calc_depth:
        depth_dir = Path(settings.raw.get("depth_dir") or "depth_out")
        depth_dir.mkdir(parents=True, exist_ok=True)

    # dense fusion: accumulate per-keyframe depth into ONE world-frame
    # voxel cloud (dense_cloud_path=<out.ply|out.npz> in the cfg enables it)
    fuser = None
    cloud_path = settings.raw.get("dense_cloud_path")
    if cloud_path and rig.num_cams >= 2:
        from mcslam_tpu_torch.mapping.dense_fusion import DenseFuser

        fuser = DenseFuser(
            rig,
            voxel=float(settings.raw.get("dense_voxel", 0.1)),
            max_depth=float(settings.raw.get("dense_max_depth", 30.0)),
            max_disp=int(settings.raw.get("depth_max_disp", 64)),
        )

    # live viewer (reference OpenGlViewer::goLive): background follow-cam
    # rendering of the running session to an auto-refreshed PNG/HTML pair
    live = None
    live_path = args.live_view or settings.raw.get("live_view")
    if live_path:
        from mcslam_tpu_torch.viz.viewer import LiveViewer

        live = LiveViewer(
            live_path, slam,
            hz=float(settings.raw.get("live_view_hz", 2.0)),
        ).start()

    def _next():
        """The reader's next (imgs on the rig's device, ts), or None."""
        if args.max_frames and n_read >= args.max_frames:
            return None
        nxt = reader.get_next()
        if nxt is None:
            return None
        return torch.from_numpy(nxt[0]).to(rig.device), nxt[1]

    def _progress():
        if n % 20 == 0:
            fps = n / (time.time() - t_start)
            print(
                f"[mc_slam_app] frame {n} state={slam.state} "
                f"kfs={slam.stats['keyframes']} "
                f"loops={slam.stats['loops']} {fps:.1f} fps",
                file=sys.stderr,
            )

    n = n_read = 0
    t_start = time.time()
    # Fused frontend (default): in INITIALIZED steady state the frame
    # build and the tracking step run as one device program
    # (slam.process_image) with one packed fetch per frame. The split
    # loop builds frame N+1 (queued on the device) before frame N's
    # tracking runs on the host: it takes the camera-sharded build
    # (parallel/sharded_frame, bit-exact) when a mesh divides the rig, and
    # serves fused_frontend=false.
    cam_sharded = mesh is not None and rig.num_cams % n_mesh == 0
    if cam_sharded:
        from mcslam_tpu_torch.parallel import mesh as mesh_mod
        from mcslam_tpu_torch.parallel import sharded_frame

        cam_mesh = mesh_mod.Mesh(mesh.devices, sharded_frame.AXIS)

        def _build(imgs):
            return sharded_frame.sharded_build_frame(cam_mesh, imgs, rig,
                                                     **extract_cfg)
    else:
        def _build(imgs):
            return build_frame(imgs, rig, **extract_cfg)
    fused_frontend = not cam_sharded and str(
        settings.raw.get("fused_frontend", "true")).lower() not in ("false",
                                                                    "0")
    while fused_frontend:
        nxt = _next()
        if nxt is None:
            break
        n_read += 1
        imgs, ts = nxt
        imu_slice = imu_stream.until(ts) if imu_stream else None
        gps_slice = gps_stream.until(ts) if gps_stream else None
        info = slam.process_image(
            imgs, ts, imu=imu_slice, gps=gps_slice, extract_cfg=extract_cfg,
        )
        _postprocess_frame(info, imgs, slam, rig, settings, depth_dir, fuser)
        n += 1
        _progress()

    pending = None  # (ff, ts, imgs) of the not-yet-processed frame
    while not fused_frontend:
        nxt = _next()
        if nxt is not None:
            n_read += 1
            imgs, ts = nxt
            ff = _build(imgs)
        else:
            imgs = ff = ts = None
        if pending is None:
            if ff is None:
                break
            pending = (ff, ts, imgs)
            continue
        p_ff, p_ts, p_imgs = pending
        pending = (ff, ts, imgs) if ff is not None else None
        imu_slice = imu_stream.until(p_ts) if imu_stream else None
        gps_slice = gps_stream.until(p_ts) if gps_stream else None
        info = slam.process_frame(p_ff, p_ts, imu=imu_slice, gps=gps_slice)
        _postprocess_frame(info, p_imgs, slam, rig, settings, depth_dir,
                           fuser)
        n += 1
        _progress()

    if live is not None:
        live.stop()  # final render includes the full session
    if fuser is not None:
        n_pts = (fuser.save_ply(cloud_path) if str(cloud_path).endswith(".ply")
                 else fuser.save_npz(cloud_path))
        print(f"[mc_slam_app] dense cloud: {n_pts} voxels -> {cloud_path}",
              file=sys.stderr)
    traj_path = args.traj_file or settings.raw.get("traj_file", "trajectory.txt")
    slam.write_trajectory(traj_path)
    if settings.raw.get("map_path") and not settings.relocalization:
        # (a reuse session localizes against map_path — don't clobber it)
        mapio.save_map_json(settings.raw["map_path"], slam.keyframes, slam.map)
    if settings.raw.get("database_path") and slam.looper is not None \
            and not settings.relocalization:
        slam.looper.save_database(settings.raw["database_path"])
    if log is not None:
        for kf in slam.keyframes:
            log.pose(kf.kf_id, kf.world_T_ref, kf.timestamp)
            for m in np.nonzero(kf.lm_id >= 0)[0]:
                log.edge(kf.kf_id, int(kf.im_anchor_cam[m]),
                         int(kf.lm_id[m]), float(kf.im_uv[m, 0]),
                         float(kf.im_uv[m, 1]))
        for lid in np.nonzero(slam.map.valid)[0]:
            log.landmark(int(lid), slam.map.pos[lid])
        log.close()
    print(
        f"[mc_slam_app] done: {n} frames, {slam.stats['keyframes']} keyframes,"
        f" trajectory -> {traj_path}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
