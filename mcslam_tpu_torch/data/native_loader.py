"""ctypes bindings for the native C++ image loader (counterpart of
mcslam_tpu/data/native_loader.py, over the same native/loader.cpp).

The host half of the data pipeline: decode threads feeding a bounded
in-order prefetch ring (`NativePrefetchReader`), and MCRAW, a decode-free
replay container of raw uint8 frames written by the library
(`mcraw_write`) and read back through a numpy memmap (`McrawReader`,
which needs no library). Every reader hands host float32
(C, H, W) frames in [0, 1]; the caller uploads them to its device. The
C++ decoders scale 8-bit samples by u8 * float32(1 / 255); McrawReader
converts as readers.ImageFolderReader does (u8 / 255), so a replay
equals the folder it was converted from bit for bit.

The library is built at first use, never at import, from the repo's
native/loader.cpp with native/Makefile's flags:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared -o <out>
        native/loader.cpp -lpng -ljpeg -lpthread

into mcslam_tpu_torch/_build/libmcloader_<hash>.so. The hash covers the
source, the flags and the compiler's resolution of -march=native on this
host (so a library built on another CPU is not loaded here). Concurrent
builds of one hash in several processes are serialized by a file lock;
the library is compiled to a temporary file and moved into place.
`available()` reports whether the library loads, and returns False where
g++, libpng or libjpeg is missing; the caller then picks the Python
readers (data/readers.py).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDLIBS = ["-lpng", "-ljpeg", "-lpthread"]
HEADERS = ("png.h", "jpeglib.h")


class NativeLoaderUnavailable(OSError):
    """The native loader cannot be built or loaded on this host."""


def toolchain() -> dict:
    """What building the library needs, probed without building it:
    {"g++": path or None, "version": str or None, "png.h": bool,
    "jpeglib.h": bool} (each header: whether g++ finds it on its
    include path)."""
    gxx = shutil.which("g++")
    out = {"g++": gxx, "version": None}
    for h in HEADERS:
        out[h] = False
    if gxx is None:
        return out
    out["version"] = subprocess.run(
        [gxx, "-dumpfullversion"], capture_output=True,
        text=True).stdout.strip() or None
    for h in HEADERS:
        out[h] = subprocess.run(
            [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
            input=f"#include <{h}>\n", capture_output=True,
            text=True).returncode == 0
    return out


def _digest(gxx: str) -> str:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    # what -march=native means here: the compiler and this host's CPU
    h.update(subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout.encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile native/loader.cpp into the hashed library unless it
    exists; return its path. Raises NativeLoaderUnavailable when the
    source, g++ or the build fails."""
    if not SOURCE.exists():
        raise NativeLoaderUnavailable(f"no native loader source at {SOURCE}")
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeLoaderUnavailable("g++ not found on PATH")
    out = BUILD_DIR / f"libmcloader_{_digest(gxx)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per hash at a time
        if out.exists():  # another process built it meanwhile
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [gxx, *CXXFLAGS, "-shared", "-o", tmp, str(SOURCE),
                 *LDLIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeLoaderUnavailable(
                    f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_long
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.probe_image.restype = ctypes.c_int
    lib.probe_image.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mcraw_write.restype = ctypes.c_int
    lib.mcraw_write.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds (at first call) and loads."""
    try:
        _load()
        return True
    except OSError:
        return False


def probe_image(path) -> tuple[int, int]:
    """(width, height) of a PNG, JPEG or PGM file."""
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.probe_image(str(path).encode(), ctypes.byref(w), ctypes.byref(h)):
        raise IOError(f"cannot decode {path}")
    return w.value, h.value


class NativePrefetchReader:
    """Reader with the DatasetReaderBase contract backed by the C++ decode
    ring. `rows` is a list of (timestamp, [paths per camera])."""

    def __init__(self, rows, depth: int = 4, threads: int = 2):
        if not rows:
            raise ValueError("empty dataset")
        self.rows = rows
        self.n_cams = len(rows[0][1])
        w, h = probe_image(rows[0][1][0])
        self.width, self.height = w, h
        lib = _load()
        flat = []
        for _, group in rows:
            flat.extend(str(p).encode() for p in group)
        arr = (ctypes.c_char_p * len(flat))(*flat)
        self._keepalive = (arr, flat)
        self._h = lib.loader_create(
            arr, len(rows), self.n_cams, w, h, depth, threads
        )
        self._lib = lib
        self._buf = np.empty((self.n_cams, h, w), np.float32)
        self._done = False

    def __len__(self):
        return len(self.rows)

    def get_next(self):
        if self._done:
            return None
        idx = self._lib.loader_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if idx < 0:
            self._done = True
            if idx == -2:
                raise IOError("native decode failure")
            return None
        return self._buf.copy(), float(self.rows[idx][0])

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def folder_reader(root, cam_dirs=None, depth: int = 4, threads: int = 2):
    """A NativePrefetchReader over an image-folder dataset (the layout
    rules of readers.ImageFolderReader)."""
    from mcslam_tpu_torch.data.readers import ImageFolderReader

    idx = ImageFolderReader(root, cam_dirs)
    return NativePrefetchReader(idx.rows, depth=depth, threads=threads)


# ---- MCRAW: decode-free mmap replay container ------------------------------


def mcraw_write(path, frames: np.ndarray, timestamps=None) -> None:
    """Write an MCRAW container. frames: (F, C, H, W) uint8 (or float in
    [0, 1], quantized). Timestamps (seconds) go to a <path>.ts.npy sidecar."""
    lib = _load()
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    frames = np.ascontiguousarray(frames)
    F, C, H, W = frames.shape
    rc = lib.mcraw_write(
        str(path).encode(), F, C, H, W,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"mcraw_write failed for {path}")
    if timestamps is not None:
        np.save(str(path) + ".ts.npy", np.asarray(timestamps, np.float64))


class McrawReader:
    """DatasetReaderBase-contract reader over an MCRAW container: the
    session's frames mapped as raw bytes; replay pays a u8 -> f32 convert,
    never a PNG / JPEG decode, and needs no library. Timestamps come from
    the <path>.ts.npy sidecar when present, else `fps`.

    The 32-byte header (McrawHeader of native/loader.cpp: magic "MCRW",
    u32 version, n_frames, n_cams, height, width, u64 reserved) is
    checked as mcraw_open checks it (magic, version 1, the file holds
    every frame); the frames are read from a numpy map of the file and
    converted as u8 / 255 in float32, the arithmetic of
    readers.ImageFolderReader, so a replay gives the frames of the
    dataset it was converted from bit for bit. (The library's mcraw_read,
    which the JAX package's reader calls, scales by u8 * float32(1 / 255):
    one ulp away at 126 of the 256 levels, enough to move a session's
    trajectory.)"""

    HEADER = np.dtype([("magic", "S4"), ("version", "<u4"),
                       ("n_frames", "<u4"), ("n_cams", "<u4"),
                       ("height", "<u4"), ("width", "<u4"),
                       ("reserved", "<u8")])

    def __init__(self, path, fps: float = 20.0):
        hdr = np.fromfile(path, self.HEADER, count=1)
        if (len(hdr) == 0 or hdr[0]["magic"] != b"MCRW"
                or hdr[0]["version"] != 1):
            raise IOError(f"not an MCRAW container: {path}")
        shape = tuple(int(hdr[0][k]) for k in ("n_frames", "n_cams",
                                               "height", "width"))
        if os.path.getsize(path) < self.HEADER.itemsize + math.prod(shape):
            raise IOError(f"MCRAW container {path} is truncated")
        self.n_frames, self.n_cams, self.height, self.width = shape
        ts_path = str(path) + ".ts.npy"
        self.timestamps = (
            np.load(ts_path) if os.path.exists(ts_path)
            else np.arange(self.n_frames) / fps
        )
        self._frames = np.memmap(path, np.uint8, "r",
                                 offset=self.HEADER.itemsize, shape=shape)
        self._idx = 0

    def __len__(self):
        return self.n_frames

    def get_next(self):
        if self._idx >= self.n_frames:
            return None
        imgs = np.divide(self._frames[self._idx], np.float32(255.0),
                         dtype=np.float32)
        t = float(self.timestamps[self._idx])
        self._idx += 1
        return imgs, t

    def close(self):
        self._frames = None
