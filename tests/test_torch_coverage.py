"""The port covers the JAX package: every module of mcslam_tpu/ has a
counterpart of the same path in mcslam_tpu_torch/ (a `*_pallas.py` kernel
module maps to its `*_cuda.py` wrapper module), and every public
top-level function and class, and every public method, of a JAX module
is defined in its counterpart under the same name, except the stated
exceptions below. Both trees are read with `ast`; neither package is
imported."""

import ast
import pathlib

JAX = pathlib.Path(__file__).resolve().parent.parent / "mcslam_tpu"
PORT = JAX.parent / "mcslam_tpu_torch"

# JAX module -> why the port has none
NO_MODULE = {
    # the XLA persistent compilation cache; the port's hashed kernel
    # library (_build.py) is rebuilt only when a source or flag changes,
    # and its captured programs are CUDA graphs made per session
    "utils/compile_cache.py": "the port's program cache is utils/graphs.py",
}
# (JAX module, JAX name) -> the port's name in the counterpart module
RENAMED = {
    ("geometry/geodesy.py", "EnuConverter.to_enu_jnp"):
        "EnuConverter.to_enu_torch",
    ("ops/fast_pallas.py", "fast_select_pallas"): "fast_select",
    ("ops/fast_pallas.py", "fast_corners_pallas"): "fast_corners",
    ("ops/patch_pallas.py", "extract_patches_pallas"): "patch_gather_batched",
    ("ops/patch_pallas.py", "extract_patches_oriented_pallas"):
        "patch_gather_oriented",
    ("ops/patch_pallas.py", "extract_patches_indexed_pallas"): "patch_gather",
    ("frontend/pose_opt_pallas.py", "optimize_pose_pallas"): "pose_lm",
    ("ops/ba_pallas.py", "linearize_payload_pallas"): "ba_linearize",
}


def _counterpart(rel: str) -> str:
    return rel.replace("_pallas.py", "_cuda.py")


def _public_names(path: pathlib.Path) -> set:
    """Public top-level functions and classes, and Class.method for the
    public methods of public classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")}
    return out


def _modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_every_module_has_a_counterpart():
    missing = [m for m in _modules()
               if m not in NO_MODULE and not (PORT / _counterpart(m)).exists()]
    assert not missing, missing
    for m in NO_MODULE:  # a stated exception names a real module, unported
        assert (JAX / m).exists() and not (PORT / _counterpart(m)).exists()


def test_every_public_name_has_a_counterpart():
    missing, renamed_seen = [], set()
    for m in _modules():
        if m in NO_MODULE:
            continue
        ported = _public_names(PORT / _counterpart(m))
        for name in sorted(_public_names(JAX / m)):
            want = RENAMED.get((m, name), name)
            if (m, name) in RENAMED:
                renamed_seen.add((m, name))
                assert name not in ported, (m, name, "is ported as is")
            if want not in ported:
                missing.append(f"{m}: {name}"
                               + (f" (as {want})" if want != name else ""))
    assert not missing, missing
    assert renamed_seen == set(RENAMED), set(RENAMED) - renamed_seen
