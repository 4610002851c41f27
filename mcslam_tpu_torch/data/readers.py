"""Dataset readers with the reference getNext contract (counterpart of
mcslam_tpu/data/readers.py: the same host numpy; images stay numpy, and
the caller uploads them to its device).

Parity (WHAT): DatasetReaderBase (MCDataUtils/include/
MCDataUtils/DatasetReaderBase.h:29-47): initialize(settings) and getNext
overloads returning synchronized per-camera images + timestamps, optionally
with IMU and GPS message slices up to the image time. Concrete readers:
  * ImageFolderReader — directory-per-camera image sequences with
    nanosecond-timestamp filenames (EuRoC layout), async-start tolerant
    (DatasetReader::read_imgs, DatasetReader.cpp:275-465)
  * VideoReader — per-camera video files with frame shifts (mp4Reader path,
    DatasetReader.cpp:637-686)
  * CSV IMU/GPS streams sliced per frame like RosDataReader::share_imu_data.

All readers emit float32 [0,1] grayscale (C, H, W); the device pipeline is
fed via a double-buffered host prefetcher.
"""

from __future__ import annotations

import os
import threading
import queue
from pathlib import Path

import numpy as np


class ImuStream:
    """Timestamped IMU samples; slices messages in (t_prev, t] per frame."""

    def __init__(self, ts, gyro, accel):
        self.ts = np.asarray(ts, np.float64)
        self.gyro = np.asarray(gyro, np.float64)
        self.accel = np.asarray(accel, np.float64)
        self._cursor = 0

    @staticmethod
    def from_csv(path, fmt="euroc"):
        """EuRoC imu0/data.csv: ns, wx, wy, wz, ax, ay, az."""
        data = np.loadtxt(path, delimiter=",", comments="#")
        ts = data[:, 0] * 1e-9 if fmt == "euroc" else data[:, 0]
        return ImuStream(ts, data[:, 1:4], data[:, 4:7])

    def until(self, t):
        """All samples with cursor < ts <= t (consumed once)."""
        i = self._cursor
        j = np.searchsorted(self.ts, t, side="right")
        self._cursor = j
        return self.ts[i:j], self.gyro[i:j], self.accel[i:j]


class GpsStream:
    """Timestamped geodetic fixes (t, lat, lon, alt)."""

    def __init__(self, ts, lla):
        self.ts = np.asarray(ts, np.float64)
        self.lla = np.asarray(lla, np.float64)
        self._cursor = 0

    @staticmethod
    def from_csv(path, scale_ts=1.0):
        data = np.loadtxt(path, delimiter=",", comments="#")
        return GpsStream(data[:, 0] * scale_ts, data[:, 1:4])

    def until(self, t):
        i = self._cursor
        j = np.searchsorted(self.ts, t, side="right")
        self._cursor = j
        return self.ts[i:j], self.lla[i:j]


def _read_pgm(path) -> np.ndarray:
    """Binary 8-bit PGM (P5, maxval 255) -> (H, W) uint8: the header's
    four whitespace-separated fields (comments allowed between them), one
    whitespace byte, then the raster. Anything else raises."""
    data = Path(path).read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1 or len(data)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated PGM header")
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields
    if magic != b"P5" or int(maxval) != 255:
        raise ValueError(f"{path}: only binary 8-bit PGM (P5, maxval 255) "
                         f"is decoded here, got {magic!r} maxval {maxval!r}")
    w, h = int(w), int(h)
    raster = data[pos + 1:pos + 1 + w * h]
    if len(raster) != w * h:
        raise ValueError(f"{path}: {len(raster)} raster bytes, want {w * h}")
    return np.frombuffer(raster, np.uint8).reshape(h, w)


def _load_gray(path) -> np.ndarray:
    """(H, W) float32 in [0, 1]: PGM decoded here, other formats by cv2."""
    if Path(path).suffix.lower() == ".pgm":
        img = _read_pgm(path)
    else:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read image {path}")
    return img.astype(np.float32) / 255.0


class DatasetReaderBase:
    """Abstract reader (reference DatasetReaderBase contract)."""

    def initialize(self, settings) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def get_next(self):
        """-> (imgs (C, H, W) float32, timestamp) or None at end."""
        raise NotImplementedError

    def get_next_imu(self, imu_stream: ImuStream):
        nxt = self.get_next()
        if nxt is None:
            return None
        imgs, t = nxt
        return imgs, t, imu_stream.until(t)

    def get_next_imu_gps(self, imu_stream: ImuStream, gps_stream: GpsStream):
        nxt = self.get_next()
        if nxt is None:
            return None
        imgs, t = nxt
        return imgs, t, imu_stream.until(t), gps_stream.until(t)


class ImageFolderReader(DatasetReaderBase):
    """Directory-per-camera reader; filenames are timestamps.

    Layout: <root>/<cam_dir>/ *.png|jpg with 19-digit ns (EuRoC) or float
    seconds in the stem. Cameras are synchronized by nearest timestamps
    within `sync_tol` (reference async camera sync, DatasetReader.cpp:275).
    """

    IMG_EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp")

    def __init__(self, root, cam_dirs=None, sync_tol=0.01, frame_range=None):
        self.root = Path(root)
        if cam_dirs is None:
            # only directories that actually hold images qualify as
            # cameras (the dataset root may also contain output dirs —
            # depth maps, logs — which must not be mistaken for a camera)
            def has_images(d):
                base = d / "data" if (d / "data").is_dir() else d
                return any(
                    p.suffix.lower() in self.IMG_EXTS for p in base.iterdir()
                )

            cam_dirs = sorted(
                d.name for d in self.root.iterdir()
                if d.is_dir() and has_images(d)
            )
        if not cam_dirs:
            raise FileNotFoundError(
                f"no camera image directories under {self.root}"
            )
        self.cam_dirs = cam_dirs
        self.sync_tol = sync_tol
        per_cam = []
        for d in cam_dirs:
            base = self.root / d
            if (base / "data").is_dir():  # EuRoC: cam0/data/*.png
                base = base / "data"
            files = sorted(
                p for p in base.iterdir()
                if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".pgm", ".bmp")
            )
            ts = np.array([self._stamp(p) for p in files])
            per_cam.append((ts, files))
        # synchronize on camera 0
        ts0, files0 = per_cam[0]
        rows = []
        for i, t in enumerate(ts0):
            group = [files0[i]]
            ok = True
            for ts_c, files_c in per_cam[1:]:
                j = int(np.argmin(np.abs(ts_c - t)))
                if abs(ts_c[j] - t) > sync_tol:
                    ok = False
                    break
                group.append(files_c[j])
            if ok:
                rows.append((t, group))
        if frame_range:
            lo, hi = frame_range[0], frame_range[1]
            step = frame_range[2] if len(frame_range) > 2 else 1
            rows = rows[lo:hi:step]
        self.rows = rows
        self._idx = 0

    @staticmethod
    def _stamp(p: Path) -> float:
        stem = p.stem
        if stem.isdigit() and len(stem) >= 16:  # nanoseconds
            return int(stem) * 1e-9
        try:
            return float(stem)
        except ValueError:
            return 0.0

    def __len__(self):
        return len(self.rows)

    def get_next(self):
        if self._idx >= len(self.rows):
            return None
        t, files = self.rows[self._idx]
        self._idx += 1
        imgs = np.stack([_load_gray(f) for f in files])
        return imgs, float(t)


class VideoReader(DatasetReaderBase):
    """Per-camera video files with optional per-camera frame shifts."""

    def __init__(self, paths, shifts=None, fps=None):
        import cv2

        self.caps = [cv2.VideoCapture(str(p)) for p in paths]
        for c, p in zip(self.caps, paths):
            if not c.isOpened():
                raise IOError(f"failed to open video {p}")
        self.shifts = shifts or [0] * len(paths)
        for c, s in zip(self.caps, self.shifts):
            for _ in range(s):
                c.read()
        self.fps = fps or self.caps[0].get(cv2.CAP_PROP_FPS) or 20.0
        self._idx = 0
        counts = [
            int(c.get(cv2.CAP_PROP_FRAME_COUNT)) - s
            for c, s in zip(self.caps, self.shifts)
        ]
        self._len = max(0, min(counts))

    def __len__(self):
        return self._len

    def get_next(self):
        import cv2

        frames = []
        for c in self.caps:
            ok, frame = c.read()
            if not ok:
                return None
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            frames.append(frame.astype(np.float32) / 255.0)
        t = self._idx / self.fps
        self._idx += 1
        return np.stack(frames), t


class Prefetcher:
    """Host-side double-buffered prefetch thread: overlaps disk decode with
    device compute (the TPU-native replacement for the reference's rosbag
    producer thread + condition-variable flow control,
    RosbagParser.cpp:199-336)."""

    def __init__(self, reader: DatasetReaderBase, depth: int = 2,
                 transform=None):
        self.reader = reader
        self.q = queue.Queue(maxsize=depth)
        self.transform = transform
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while True:
                item = self.reader.get_next()
                if item is not None and self.transform is not None:
                    item = self.transform(item)
                self.q.put(item)
                if item is None:
                    return
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            self.q.put(e)

    def __iter__(self):
        """The reader's items in order; an error of the reader or the
        transform is raised here, after the items before it."""
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
