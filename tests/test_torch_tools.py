"""The port's dataset tools on the CPU: apps.train_vocabulary (its saved
vocabulary equals loop/vocab.Vocabulary.train on the port's own ORB
descriptors of the same images, and the JAX package's
scripts/train_vocabulary.py's on them) and
apps.evaluate_trajectory --plot (the PNG's pixels equal the JAX viewer's
render_map called as the JAX package's scripts/evaluate_trajectory.py
calls it). Exact throughout."""

import matplotlib.image
import numpy as np
import torch

from mcslam_tpu_torch.data import synthetic


def _write_pgm_dataset(root, frames=3):
    """A 2-camera 160x120 blob scene as PGM folders with float-second
    names."""
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(160, 120), focal=110.0), device="cpu")
    poses = synthetic.smooth_trajectory(frames, step_angle=0.03)
    lms = synthetic.make_landmarks(500, depth_range=(4.0, 15.0))
    imgs = synthetic.render_blob_images(rig, poses, lms)
    for c in range(2):
        d = root / f"cam{c}"
        d.mkdir(parents=True)
        for k in range(frames):
            u8 = (np.clip(imgs[k, c], 0, 1) * 255).astype(np.uint8)
            (d / f"{k * 0.05:.6f}.pgm").write_bytes(
                b"P5\n160 120\n255\n" + u8.tobytes())


def test_train_vocabulary_app(tmp_path):
    from mcslam_tpu_torch.apps import train_vocabulary
    from mcslam_tpu_torch.data.readers import ImageFolderReader
    from mcslam_tpu_torch.loop.vocab import Vocabulary
    from mcslam_tpu_torch.ops import hamming, orb

    _write_pgm_dataset(tmp_path / "ds")
    out = tmp_path / "vocab.npz"
    assert train_vocabulary.main([
        str(tmp_path / "ds"), str(out), "--k", "4", "--depth", "2",
        "--max_frames", "2", "--num_points", "128", "--num_levels", "2",
        "--device", "cpu"]) == 0
    reader = ImageFolderReader(tmp_path / "ds")
    descs = []
    for _ in range(2):
        imgs, _ = reader.get_next()
        kps = orb.extract_orb_rig(torch.from_numpy(imgs), num_points=128,
                                  num_levels=2)
        descs.append(hamming.desc_to_numpy_u32(kps.desc[kps.valid]))
    ref = Vocabulary.train(np.concatenate(descs), k=4, depth=2)
    got = Vocabulary.load(out)
    assert got.num_words == ref.num_words == 16
    for name in ("nodes", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)


def test_train_vocabulary_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's tool and the JAX package's scripts/train_vocabulary.py on
    the same images (one pyramid level, where the extractions agree
    exactly, tests/test_torch_ops.py): the frames read, the valid filter
    and the descriptor dtype give the same uint32 rows in the same order
    to Vocabulary.train, and the saved vocabularies are equal."""
    import importlib.util
    import pathlib

    from mcslam_tpu.loop import vocab as jvocab
    from mcslam_tpu_torch.apps import train_vocabulary
    from mcslam_tpu_torch.loop import vocab as tvocab

    spec = importlib.util.spec_from_file_location(
        "jax_train_vocabulary", pathlib.Path(__file__).parent.parent
        / "scripts" / "train_vocabulary.py")
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    fed = {}
    for side, mod in (("jax", jvocab), ("port", tvocab)):
        train = mod.Vocabulary.train

        def recorded(descs, *a, _side=side, _train=train, **kw):
            fed[_side] = np.asarray(descs)
            return _train(descs, *a, **kw)

        monkeypatch.setattr(mod.Vocabulary, "train", staticmethod(recorded))
    _write_pgm_dataset(tmp_path / "ds")
    def args(out):
        return [str(tmp_path / "ds"), str(tmp_path / out), "--k", "4",
                "--depth", "2", "--max_frames", "2", "--num_points", "128",
                "--num_levels", "1"]

    assert jscript.main(args("j.npz")) == 0
    assert train_vocabulary.main(args("t.npz") + ["--device", "cpu"]) == 0
    j, t = fed["jax"], fed["port"]
    assert j.dtype == t.dtype == np.uint32 and j.shape[1] == 8
    np.testing.assert_array_equal(t, j)
    got = tvocab.Vocabulary.load(tmp_path / "t.npz")
    ref = jvocab.Vocabulary.load(tmp_path / "j.npz")
    assert got.num_words == ref.num_words == 16
    for name in ("nodes", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)


def test_evaluate_trajectory_plot_matches_jax(tmp_path, capsys):
    from mcslam_tpu.viz import viewer as jview
    from mcslam_tpu_torch.apps import evaluate_trajectory
    from mcslam_tpu_torch.utils import metrics, tum

    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(4), (20, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.randn(20, 3) * 0.1, axis=0)
    est = poses.copy()
    est[:, :3, 3] += rng.randn(20, 3) * 0.02
    ts = np.arange(20) * 0.05
    tum.write_tum(tmp_path / "gt.txt", ts, poses)
    tum.write_tum(tmp_path / "est.txt", ts, est)
    assert evaluate_trajectory.main([
        str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"), "--plot",
        str(tmp_path / "t.png")]) == 0
    out = capsys.readouterr().out
    assert "ATE RMSE [m]" in out and f"plot -> {tmp_path / 't.png'}" in out
    # scripts/evaluate_trajectory.py:56-63's call on the same rows
    _, pe = tum.read_tum(tmp_path / "est.txt")
    _, pg = tum.read_tum(tmp_path / "gt.txt")
    ate = metrics.ate_rmse(pe, pg)
    jview.render_map(tmp_path / "j.png", [], None, pe[:, :3, 3],
                     pg[:, :3, 3], title=f"ATE {ate:.3f} m")
    np.testing.assert_array_equal(matplotlib.image.imread(tmp_path / "t.png"),
                                  matplotlib.image.imread(tmp_path / "j.png"))
