"""Map / trajectory visualization (counterpart of
mcslam_tpu/viz/viewer.py: numpy and matplotlib on the host).

Parity (WHAT): the reference's Pangolin OpenGlViewer (OpenGlViewer.cpp):
camera frusta for all poses, map points, a follow view; goLive (:38) runs
the render beside the SLAM session. A GL window makes no sense on a
headless host, so this renders the same content to image files, either
offline from a finished session or live: `LiveViewer` is a background
thread that follow-cam-renders the running session to an atomically
replaced PNG (and an auto-refreshing HTML page) at a fixed rate.

Inputs may be numpy arrays or torch tensors on any device; tensors are
copied to host numpy first.
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np


def _np(x) -> np.ndarray:
    """A host numpy array of x (a torch tensor on any device, an array, or
    a sequence of either)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_np(v) for v in x])
    return np.asarray(x)


def _frustum_segments(pose, scale=0.15, aspect=0.75):
    """Line segments of a camera frustum wireframe in world coords."""
    pose = _np(pose)
    w = scale
    h = scale * aspect
    z = scale * 1.6
    pts = np.array(
        [[0, 0, 0], [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]], np.float64
    )
    pts = pts @ pose[:3, :3].T + pose[:3, 3]
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[i], pts[j]) for i, j in idx]


def render_map(
    path,
    keyframe_poses,
    landmarks=None,
    trajectory=None,
    gt_trajectory=None,
    title="mcslam_tpu map",
    elev=-70.0,
    azim=-90.0,
):
    """Write a 3D overview PNG: frusta (keyframes), points (landmarks),
    lines (trajectories)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    if landmarks is not None and len(landmarks):
        lm = _np(landmarks)
        ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=1, c="k", alpha=0.4,
                   label=f"landmarks ({len(lm)})")
    for pose in _np(keyframe_poses):
        for a, b in _frustum_segments(pose):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "b-", lw=0.6)
    if trajectory is not None and len(trajectory):
        tr = _np(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], "g-", lw=1.5, label="estimate")
    if gt_trajectory is not None and len(gt_trajectory):
        gt = _np(gt_trajectory)
        ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], "r--", lw=1.0,
                label="ground truth")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def render_session(path, slam, gt_poses=None):
    """Render a finished MultiCameraSLAM session to a PNG (finalizes it,
    as trajectory_arrays does)."""
    kf_poses = [kf.world_T_ref for kf in slam.keyframes]
    lms = slam.map.pos[slam.map.valid]
    _, est = slam.trajectory_arrays()
    gt = None if gt_poses is None else _np(gt_poses)[:, :3, 3]
    render_map(
        path, kf_poses, lms, est[:, :3, 3], gt,
        title=f"{slam.stats['keyframes']} KFs, {slam.map.num_valid} landmarks",
    )


class LiveViewer:
    """Live follow-cam view of a RUNNING session (OpenGlViewer::goLive).

    A daemon thread snapshots the driver's host-side state (current pose,
    keyframe poses, valid landmarks, trajectory) every `1/hz` seconds and
    renders a camera-following 3D view to `path` via an atomic replace;
    any image watcher (a browser on the emitted HTML page, `feh -R`)
    shows the session live.

    The snapshot reads only host state, by value: the keyframe poses,
    the landmark map's host mirrors (`map.pos` / `map.valid`, numpy), the
    trajectory list and the current pose. It never calls
    `trajectory_arrays()`, whose `finalize()` would land a pending window
    or global solve (and run the final global BA) from the viewer thread
    in the middle of the session; the view may lag the driver by a frame.

    Usage:
        viewer = LiveViewer("live.png", slam, follow=True).start()
        ... slam.process_image(...) loop ...
        viewer.stop()
    """

    def __init__(self, path, slam, hz: float = 2.0, follow: bool = True,
                 radius: float = 6.0, html: bool = True):
        # where matplotlib is missing, fail here, before the session: the
        # thread swallows render errors, and stop()'s final render would
        # raise only after the whole session ran
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot  # noqa: F401

        self.path = str(path)
        self.slam = slam
        self.hz = float(hz)
        self.follow = follow
        self.radius = float(radius)
        self._stop = threading.Event()
        self._thread = None
        self._frames_rendered = 0
        if html:
            self._write_html()

    def _write_html(self):
        html_path = os.path.splitext(self.path)[0] + ".html"
        name = os.path.basename(self.path)
        period_ms = max(int(1000.0 / self.hz), 200)
        with open(html_path, "w") as f:
            f.write(
                "<!doctype html><title>mcslam live</title>"
                "<body style='margin:0;background:#111'>"
                f"<img id=v src='{name}' style='width:100%'>"
                f"<script>setInterval(()=>{{v.src='{name}?'+Date.now()}},"
                f"{period_ms});</script>"
            )

    def _snapshot(self):
        slam = self.slam
        kfs = list(slam.keyframes)
        kf_poses = np.array(
            [kf.world_T_ref for kf in kfs], np.float64
        ) if kfs else np.zeros((0, 4, 4))
        valid = slam.map.valid.copy()
        lms = slam.map.pos[valid]  # fancy indexing copies
        traj = list(slam.trajectory)
        traj = (np.array([p[:3, 3] for _, p in traj], np.float64) if traj
                else np.zeros((0, 3)))
        cur = np.array(slam.cur_pose, np.float64)
        stats = dict(slam.stats)
        return kf_poses, lms, traj, cur, stats

    def _render_once(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        kf_poses, lms, traj, cur, stats = self._snapshot()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        if len(lms):
            ax.scatter(lms[:, 0], lms[:, 1], lms[:, 2], s=1, c="k",
                       alpha=0.35)
        for pose in kf_poses[-60:]:  # cap frusta for render speed
            for a, b in _frustum_segments(pose):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "b-",
                        lw=0.5)
        if len(traj):
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "g-", lw=1.5)
        for a, b in _frustum_segments(cur, scale=0.3):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "r-", lw=1.2)
        if self.follow:
            # follow-cam: box centered on the current pose, azimuth from
            # the camera's forward (optical-axis) direction in world
            c = cur[:3, 3]
            fwd = cur[:3, 2]
            azim = float(np.degrees(np.arctan2(fwd[1], fwd[0]))) - 180.0
            r = self.radius
            ax.set_xlim(c[0] - r, c[0] + r)
            ax.set_ylim(c[1] - r, c[1] + r)
            ax.set_zlim(c[2] - r, c[2] + r)
            ax.view_init(elev=-60.0, azim=azim)
        else:
            ax.view_init(elev=-70.0, azim=-90.0)
        ax.set_title(
            f"frames {stats.get('frames', 0)}  KFs {stats.get('keyframes', 0)}"
            f"  landmarks {len(lms)}  loops {stats.get('loops', 0)}"
        )
        fig.tight_layout()
        # atomic replace so watchers never read a half-written file
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(suffix=".png", dir=d)
        os.close(fd)
        try:
            fig.savefig(tmp, dpi=100)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
            plt.close(fig)
        self._frames_rendered += 1

    def _run(self):
        while not self._stop.wait(1.0 / self.hz):
            try:
                self._render_once()
            except Exception:  # noqa: BLE001 - keep the session alive
                pass

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, final_render: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if final_render:
            self._render_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def render_tracks(path, img, kp_xy, matched_mask=None):
    """2D feature overlay (the reference's tracked-features window)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_np(img), cmap="gray")
    xy = _np(kp_xy)
    if matched_mask is not None:
        m = _np(matched_mask)
        ax.plot(xy[~m, 0], xy[~m, 1], "r.", ms=2)
        ax.plot(xy[m, 0], xy[m, 1], "g.", ms=3)
    else:
        ax.plot(xy[:, 0], xy[:, 1], "g.", ms=3)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
