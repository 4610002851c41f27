"""The port's native loader (mcslam_tpu_torch.data.native_loader) on the
CPU: decode against OpenCV over PNG / JPEG / PGM (tests/
test_native_loader.py's check), probe_image, the MCRAW container both
ways with its .ts.npy sidecar, the PGM decode against the port's numpy
reader, the converter app, and the build itself (hashed name in the
port's _build/, safe against a concurrent build of the same hash).

The tests that need the library skip by a probe that builds nothing
(g++ on PATH, png.h and jpeglib.h on its include path); the library is
built inside a fixture. McrawReader needs no library: it is also held to
a container written by numpy in native/loader.cpp's layout, with the
library made unavailable. The JAX package's loader is not used here: its build runs
`make` into mcslam_tpu/native/, which tests/test_native_loader.py may be
doing in another worker.

Tolerances: PNG and PGM decodes within 1.5 / 255 of OpenCV's /255 and
JPEG within a mean of 0.03 (lossy), as the JAX test holds them. MCRAW
frames equal the uint8 frames / 255 bit for bit (McrawReader converts as
the numpy reader does). The C++ decoders scale by u8 * float32(1 / 255)
(native/loader.cpp), one ulp away from u8 / 255 at 126 of the 256
levels: PGM decodes are held to the uint8 raster times that scale bit
for bit, and to the numpy reader's u8 / 255 within 6e-8."""

import threading

import numpy as np
import pytest

from mcslam_tpu_torch.data import native_loader, readers

TOOLCHAIN = native_loader.toolchain()
needs_lib = pytest.mark.skipif(
    not all(TOOLCHAIN[k] for k in ("g++", "png.h", "jpeglib.h")),
    reason=f"no toolchain for the native loader: {TOOLCHAIN}")

SCALE = np.float32(1.0 / 255.0)  # the C++ decoders' u8 -> f32 scale


def _div(u8):
    """u8 / 255 in float32, as readers.ImageFolderReader converts."""
    return u8.astype(np.float32) / 255.0


def _mcraw_bytes(frames: np.ndarray) -> bytes:
    """An MCRAW container of (F, C, H, W) uint8 frames in
    native/loader.cpp's layout: the 32-byte McrawHeader, then the frames."""
    hdr = np.zeros(1, native_loader.McrawReader.HEADER)
    hdr["magic"], hdr["version"] = b"MCRW", 1
    for k, n in zip(("n_frames", "n_cams", "height", "width"), frames.shape):
        hdr[k] = n
    return hdr.tobytes() + np.ascontiguousarray(frames).tobytes()


@pytest.fixture(scope="module")
def lib():
    path = native_loader.build()
    assert path.parent == native_loader.BUILD_DIR
    assert native_loader.available()
    return path


def _write_images(tmp_path, n_frames=6, n_cams=2, w=64, h=48, seed=0):
    import cv2

    rng = np.random.RandomState(seed)
    rows, imgs = [], []
    for i in range(n_frames):
        group, frame_imgs = [], []
        for c in range(n_cams):
            img = (rng.rand(h, w) * 255).astype(np.uint8)
            p = tmp_path / f"f{i}_c{c}{['.png', '.jpg', '.pgm'][i % 3]}"
            cv2.imwrite(str(p), img)
            group.append(p)
            frame_imgs.append(img)
        rows.append((i * 0.05, group))
        imgs.append(frame_imgs)
    return rows, imgs


@needs_lib
def test_native_decode_matches_opencv(lib, tmp_path):
    rows, imgs = _write_images(tmp_path)
    reader = native_loader.NativePrefetchReader(rows, depth=3, threads=2)
    assert len(reader) == 6
    k = 0
    while (nxt := reader.get_next()) is not None:
        frame, ts = nxt
        assert frame.shape == (2, 48, 64) and frame.dtype == np.float32
        assert abs(ts - k * 0.05) < 1e-9
        for c in range(2):
            ref = imgs[k][c].astype(np.float32) / 255.0
            if k % 3 == 1:  # jpeg is lossy
                assert np.abs(frame[c] - ref).mean() < 0.03
            else:
                np.testing.assert_allclose(frame[c], ref, atol=1.5 / 255.0)
        k += 1
    assert k == 6
    reader.close()


@needs_lib
def test_probe_image(lib, tmp_path):
    rows, _ = _write_images(tmp_path, n_frames=3, n_cams=1, w=70, h=33)
    for _, (p,) in rows:
        assert native_loader.probe_image(p) == (70, 33)
    with pytest.raises(IOError):
        native_loader.probe_image(tmp_path / "missing.png")


@needs_lib
def test_mcraw_roundtrip(lib, tmp_path):
    """(F, C, H, W) uint8 frames with timestamps, read back through mmap
    bit for bit; a float input is quantized; without the sidecar the
    stamps come from fps."""
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (5, 2, 32, 40)).astype(np.uint8)
    frames[0, 0, 0, :] = np.arange(40) * 6  # levels 0 .. 234
    ts = np.array([0.0, 0.051, 0.1, 0.152, 0.2])
    path = tmp_path / "session.mcraw"
    native_loader.mcraw_write(path, frames, ts)
    assert path.read_bytes() == _mcraw_bytes(frames)
    assert np.load(str(path) + ".ts.npy").tolist() == ts.tolist()
    reader = native_loader.McrawReader(path)
    assert len(reader) == 5
    assert (reader.n_cams, reader.height, reader.width) == (2, 32, 40)
    k = 0
    while (nxt := reader.get_next()) is not None:
        imgs, t = nxt
        assert t == ts[k]
        np.testing.assert_array_equal(imgs, _div(frames[k]))
        k += 1
    assert k == 5
    reader.close()

    native_loader.mcraw_write(tmp_path / "f.mcraw", frames[:2] / 255.0)
    r2 = native_loader.McrawReader(tmp_path / "f.mcraw", fps=10.0)
    got = [r2.get_next() for _ in range(3)]
    assert got[2] is None and [t for _, t in got[:2]] == [0.0, 0.1]
    np.testing.assert_array_equal(got[1][0], _div(frames[1]))
    with pytest.raises(IOError):
        native_loader.McrawReader(tmp_path / "session.mcraw.ts.npy")


@needs_lib
def test_pgm_decode_matches_the_numpy_reader(lib, tmp_path):
    """A PGM folder dataset through folder_reader (the C++ ring) and the
    port's ImageFolderReader: the same rows, the same uint8 raster."""
    rng = np.random.RandomState(3)
    for c in range(2):
        (tmp_path / f"cam{c}").mkdir()
    for i in range(4):
        for c in range(2):
            img = rng.randint(0, 256, (30, 44)).astype(np.uint8)
            (tmp_path / f"cam{c}" / f"{i * 0.05:.6f}.pgm").write_bytes(
                b"P5\n# comment\n44 30\n255\n" + img.tobytes())
    nat = native_loader.folder_reader(tmp_path)
    ref = readers.ImageFolderReader(tmp_path)
    assert len(nat) == len(ref) == 4
    for t, files in ref.rows:
        a, ta = nat.get_next()
        b, tb = ref.get_next()
        assert ta == tb == t
        raster = np.stack([readers._read_pgm(f) for f in files])
        np.testing.assert_array_equal(a, raster.astype(np.float32) * SCALE)
        assert np.abs(a - b).max() <= 6e-8
    assert nat.get_next() is None
    nat.close()


@needs_lib
def test_convert_to_mcraw_app(lib, tmp_path, capsys):
    """Folder dataset -> the converter app -> the container replays the
    folder's frames, quantized, with its timestamps."""
    import cv2

    from mcslam_tpu_torch.apps import convert_to_mcraw

    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (3, 2, 48, 64)).astype(np.uint8)
    for c in range(2):
        (tmp_path / f"cam{c}").mkdir()
        for i in range(3):
            cv2.imwrite(str(tmp_path / f"cam{c}" / f"{i * 0.05:.6f}.png"),
                        imgs[i, c])
    out = tmp_path / "conv.mcraw"
    assert convert_to_mcraw.main([str(tmp_path), str(out), "cam0,cam1"]) == 0
    assert "3 frames x 2 cams 64x48" in capsys.readouterr().out
    reader = native_loader.McrawReader(out)
    for i in range(3):
        frame, t = reader.get_next()
        assert abs(t - i * 0.05) < 1e-6
        np.testing.assert_array_equal(frame, _div(imgs[i]))
    reader.close()
    assert convert_to_mcraw.main([str(tmp_path)]) == 2


@needs_lib
def test_convert_without_the_library(lib, tmp_path, monkeypatch):
    """Where the library does not build, the converter reads with
    ImageFolderReader and mcraw_write raises, as in the JAX script."""
    from mcslam_tpu_torch.apps import convert_to_mcraw

    (tmp_path / "cam0").mkdir()
    (tmp_path / "cam0" / "0.000000.pgm").write_bytes(
        b"P5\n4 3\n255\n" + bytes(range(12)))
    read = []
    get_next = readers.ImageFolderReader.get_next

    def counted(self):
        read.append(1)
        return get_next(self)

    def unavailable():
        raise native_loader.NativeLoaderUnavailable("g++ not found on PATH")

    monkeypatch.setattr(readers.ImageFolderReader, "get_next", counted)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "build", unavailable)
    assert not native_loader.available()
    with pytest.raises(OSError, match="g\\+\\+"):
        convert_to_mcraw.main([str(tmp_path), str(tmp_path / "x.mcraw")])
    assert len(read) == 2 and not (tmp_path / "x.mcraw").exists()


@needs_lib
def test_build_is_hashed_and_safe_against_concurrent_builds(lib, tmp_path,
                                                            monkeypatch):
    """Two builds of one hash at once: g++ runs once, both get the same
    library, which loads; the name carries the hash and nothing is built
    outside the given build directory."""
    import ctypes
    import subprocess

    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "b")
    compiles = []
    run = subprocess.run

    def counting(cmd, *a, **kw):
        if "-shared" in cmd:
            compiles.append(cmd)
        return run(cmd, *a, **kw)

    monkeypatch.setattr(native_loader.subprocess, "run", counting)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        native_loader.build())) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(compiles) == 1 and len(out) == 2 and out[0] == out[1]
    assert out[0].name == lib.name and out[0].parent == tmp_path / "b"
    assert sorted(p.suffix for p in (tmp_path / "b").iterdir()) == [
        ".lock", ".so"]
    ctypes.CDLL(str(out[0])).probe_image  # noqa: B018 - loads, resolves


def test_mcraw_reader_needs_no_library(tmp_path, monkeypatch):
    """A container written in the layout by numpy replays with the
    library unavailable: the frames bit for bit as u8 / 255, the
    sidecar's stamps; a wrong magic or version, or a truncated file,
    raises IOError as mcraw_open refuses them."""
    def unavailable():
        raise native_loader.NativeLoaderUnavailable("g++ not found on PATH")

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "build", unavailable)
    frames = np.random.RandomState(2).randint(
        0, 256, (3, 2, 12, 20)).astype(np.uint8)
    frames[0, 0, 0] = np.arange(20) * 13  # levels 0 .. 247
    good = _mcraw_bytes(frames)
    path = tmp_path / "s.mcraw"
    path.write_bytes(good)
    np.save(str(path) + ".ts.npy", np.array([0.0, 0.05, 0.11]))
    reader = native_loader.McrawReader(path)
    assert (len(reader), reader.n_cams, reader.height, reader.width) == (
        3, 2, 12, 20)
    for k, t in enumerate([0.0, 0.05, 0.11]):
        imgs, tk = reader.get_next()
        assert tk == t and imgs.dtype == np.float32
        np.testing.assert_array_equal(imgs, _div(frames[k]))
    assert reader.get_next() is None
    reader.close()
    assert not native_loader.available()
    bad_version = bytearray(good)
    bad_version[4] = 2
    for name, data in (("magic", b"MCRX" + good[4:]),
                       ("version", bytes(bad_version)),
                       ("truncated", good[:-1]), ("empty", b"")):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(IOError):
            native_loader.McrawReader(tmp_path / name)
