"""The port's viewer (mcslam_tpu_torch.viz.viewer) against the JAX
package's (mcslam_tpu.viz.viewer) on the CPU: render_map, render_tracks,
render_session and LiveViewer._render_once write PNGs whose decoded
pixels equal the JAX viewer's for the same inputs (tensors on the port's
side, numpy arrays on JAX's; the live render is fed one snapshot on both
sides). Also the HTML page's text, the follow-cam limits and azimuth,
the port's snapshot (by value, without trajectory_arrays / finalize), the
background thread and stop()'s final render. Exact throughout: the same
matplotlib draws the same figure."""

import time
import types

import matplotlib
import matplotlib.image
import numpy as np
import pytest
import torch

from mcslam_tpu.viz import viewer as jview
from mcslam_tpu_torch.viz import viewer as tview

matplotlib.use("Agg")


def _pixels(path):
    return matplotlib.image.imread(str(path))


def _same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and pa.ndim == 3
    np.testing.assert_array_equal(pa, pb)


def _poses(n, seed=0):
    rng = np.random.RandomState(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 0.1 * i
        T[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        T[i, :3, 3] = [np.sin(a) * 3, 0.1 * rng.randn(), np.cos(a) * 3]
    return T.astype(np.float32)


def _snapshot(seed=1):
    rng = np.random.RandomState(seed)
    kf = _poses(7, seed)
    lms = rng.uniform(-4, 4, (300, 3)).astype(np.float32)
    traj = _poses(12, seed)[:, :3, 3].astype(np.float64)
    cur = _poses(12, seed)[-1].astype(np.float64)
    stats = dict(frames=12, keyframes=7, loops=1)
    return kf.astype(np.float64), lms, traj, cur, stats


class _FakeSlam:
    """The host state a viewer reads: keyframes, the landmark map's host
    mirrors, the trajectory list, the current pose, stats; finalize()
    calls are counted (the port's live snapshot must make none)."""

    def __init__(self, n=6, seed=2):
        rng = np.random.RandomState(seed)
        T = _poses(n, seed)
        self.keyframes = [types.SimpleNamespace(world_T_ref=T[i])
                          for i in range(0, n, 2)]
        self.map = types.SimpleNamespace(
            pos=rng.uniform(-3, 3, (50, 3)).astype(np.float32),
            valid=rng.rand(50) > 0.4)
        self.map.num_valid = int(self.map.valid.sum())
        self.trajectory = [(0.05 * i, T[i]) for i in range(n)]
        self.cur_pose = T[-1]
        self.stats = dict(frames=n, keyframes=len(self.keyframes), loops=0)
        self.finalized = 0

    def finalize(self):
        self.finalized += 1

    def trajectory_arrays(self):
        self.finalize()
        return (np.array([t for t, _ in self.trajectory]),
                np.stack([p for _, p in self.trajectory]))


def test_render_map_matches_jax(tmp_path):
    kf, lms, traj, _, _ = _snapshot()
    gt = traj + 0.05
    jview.render_map(tmp_path / "j.png", kf, lms, traj, gt, title="t")
    tview.render_map(tmp_path / "t.png", [torch.from_numpy(p) for p in kf],
                     torch.from_numpy(lms), torch.from_numpy(traj),
                     torch.from_numpy(gt), title="t")
    _same_png(tmp_path / "j.png", tmp_path / "t.png")
    # evaluate_trajectory's call: no keyframes, no landmarks
    jview.render_map(tmp_path / "j2.png", [], None, traj, gt)
    tview.render_map(tmp_path / "t2.png", [], None, traj, gt)
    _same_png(tmp_path / "j2.png", tmp_path / "t2.png")


def test_render_tracks_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = rng.rand(60, 80).astype(np.float32)
    xy = rng.uniform(0, [80, 60], (40, 2)).astype(np.float32)
    m = rng.rand(40) > 0.5
    for mask in (None, m):
        jview.render_tracks(tmp_path / "j.png", img, xy, mask)
        tview.render_tracks(tmp_path / "t.png", torch.from_numpy(img),
                            torch.from_numpy(xy),
                            None if mask is None else torch.from_numpy(mask))
        _same_png(tmp_path / "j.png", tmp_path / "t.png")


def test_render_session_matches_jax(tmp_path):
    slam = _FakeSlam()
    gt = _poses(6, 9)
    jview.render_session(tmp_path / "j.png", slam, gt)
    tview.render_session(tmp_path / "t.png", slam, torch.from_numpy(gt))
    _same_png(tmp_path / "j.png", tmp_path / "t.png")


@pytest.mark.parametrize("follow", [True, False])
def test_live_render_matches_jax(tmp_path, monkeypatch, follow):
    """One snapshot fed to both live viewers: the same PNG, the same HTML
    page; the follow-cam box is centered on the current pose with the
    azimuth of its optical axis."""
    snap = _snapshot()
    figs = []
    import matplotlib.pyplot as plt

    figure = plt.figure

    def recorded(*a, **kw):
        figs.append(figure(*a, **kw))
        return figs[-1]

    monkeypatch.setattr(plt, "figure", recorded)
    out = {}
    for name, mod in (("j", jview), ("t", tview)):
        v = mod.LiveViewer(tmp_path / f"{name}.png", None, hz=4.0,
                           follow=follow, radius=5.0)
        v._snapshot = lambda: snap
        v._render_once()
        assert v._frames_rendered == 1
        out[name] = (tmp_path / f"{name}.html").read_text()
    _same_png(tmp_path / "j.png", tmp_path / "t.png")
    assert out["t"] == out["j"].replace("j.png", "t.png")
    assert "setInterval" in out["t"] and ",250);" in out["t"]
    ax = figs[-1].axes[0]
    cur = snap[3]
    if follow:
        for lim, c in zip((ax.get_xlim(), ax.get_ylim(), ax.get_zlim()),
                          cur[:3, 3]):
            np.testing.assert_allclose(lim, (c - 5.0, c + 5.0))
        azim = np.degrees(np.arctan2(cur[1, 2], cur[0, 2])) - 180.0
        assert ax.azim == pytest.approx(azim) and ax.elev == -60.0
    else:
        assert (ax.azim, ax.elev) == (-90.0, -70.0)


def test_live_snapshot_is_by_value_and_never_finalizes():
    slam = _FakeSlam()
    kf, lms, traj, cur, stats = tview.LiveViewer(
        "unused.png", slam, html=False)._snapshot()
    assert slam.finalized == 0
    np.testing.assert_array_equal(kf, [k.world_T_ref for k in slam.keyframes])
    np.testing.assert_array_equal(lms, slam.map.pos[slam.map.valid])
    np.testing.assert_array_equal(traj, [p[:3, 3] for _, p in slam.trajectory])
    np.testing.assert_array_equal(cur, slam.cur_pose)
    assert kf.dtype == traj.dtype == cur.dtype == np.float64
    slam.map.pos[:] = 99.0  # the driver mutates its state afterwards
    slam.trajectory.append((9.0, np.eye(4)))
    slam.stats["frames"] = 100
    assert (lms != 99.0).all() and len(traj) == 6 and stats["frames"] == 6
    empty = _FakeSlam()
    empty.keyframes, empty.trajectory = [], []
    kf, _, traj, _, _ = tview.LiveViewer("unused.png", empty,
                                         html=False)._snapshot()
    assert kf.shape == (0, 4, 4) and traj.shape == (0, 3)


def test_live_viewer_thread_and_stop(tmp_path):
    """The background thread renders the running session and swallows a
    render error (the session goes on); stop()'s final render is not
    wrapped, so a broken render surfaces there."""
    slam = _FakeSlam()
    v = tview.LiveViewer(tmp_path / "live.png", slam, hz=20.0).start()
    for _ in range(400):
        if v._frames_rendered:
            break
        time.sleep(0.05)
    assert v._frames_rendered >= 1 and slam.finalized == 0
    slam.cur_pose = None  # the next snapshot fails
    time.sleep(0.2)
    n = v._frames_rendered
    with pytest.raises(Exception):
        v.stop()
    assert v._thread is None and v._frames_rendered == n
    assert _pixels(tmp_path / "live.png").ndim == 3
    assert not list(tmp_path.glob("tmp*.png"))  # atomic replace cleaned up



def test_live_viewer_needs_matplotlib_up_front(tmp_path, monkeypatch):
    """Where matplotlib cannot be imported, the viewer refuses to start
    (no HTML page, no thread), so a session never runs to its end only
    for stop()'s final render to raise."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        tview.LiveViewer(tmp_path / "live.png", _FakeSlam())
    assert not list(tmp_path.iterdir())
