"""Dense stereo depth: cost-volume disparity with box or semi-global
aggregation and left-right consistency (counterpart of
mcslam_tpu/ops/stereo.py).

Parity (WHAT): the reference's optional DepthReconstructor
(MCSlam/src/DepthReconstructor.cpp) with vendored libelas / OpenCV
StereoSGBM: rectified stereo pair -> disparity -> depth.

HOW: the disparity search is a (D, H, W) shifted-absolute-difference
cost volume built by one gather, aggregated with the separable box
filter, optionally by 4-path semi-global aggregation, then
winner-take-all with sub-pixel parabola refinement and a left-right
consistency mask. For a parallel-baseline rig (cameras along +x) the
pair is rectified by construction; general rigs rectify through
ops/rectify.RigRectifier first. All of it is plain PyTorch on the
images' device, as the JAX package's is plain XLA, except the SGM
recursion (the JAX package's lax.scan): on the card one CUDA kernel
(csrc/sgm_scan.cu through ops/sgm_cuda), on the CPU its plain version,
a Python loop over the scan axis of a few ops per step.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch.ops import image as image_ops
from mcslam_tpu_torch.ops import sgm_cuda


def _shift_x(img: torch.Tensor, d) -> torch.Tensor:
    """out[y, x] = img[y, x - d] (right image shifted right by d), edge pad.
    d: an int, or a 1-D tensor of D shifts -> (D, H, W) for an (H, W)
    image, one gather."""
    x = torch.arange(img.shape[-1], device=img.device)
    if isinstance(d, int):
        return img if d == 0 else img[..., torch.clamp(x - d, min=0)]
    idx = torch.clamp(x[None, :] - d[:, None], min=0)  # (D, W)
    return img[..., idx].movedim(-2, 0)


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                window: int = 7) -> torch.Tensor:
    """(H, W) rectified pair -> (D, H, W) aggregated SAD cost volume:
    |left - right shifted by d| for every d, box-filtered."""
    shifts = torch.arange(max_disp, device=left.device)
    sad = torch.abs(left[None] - _shift_x(right, shifts))
    box = torch.full((window,), 1.0 / window, dtype=torch.float32,
                     device=left.device)
    return image_ops._sep_conv(sad, box)


def sgm_aggregate(cv: torch.Tensor, p1: float = 0.03, p2: float = 0.2):
    """4-path semi-global aggregation of a (D, H, W) cost volume
    (left/right/up/down; the reference's SGBM MODE_HH runs 8 paths, 4
    axis-aligned ones capture most of the regularization at half the
    scans): on a CUDA volume the csrc/sgm_scan.cu kernel, on a CPU one
    its plain version (ops/sgm_cuda.sgm_aggregate_reference), bit-equal
    to each other."""
    return sgm_cuda.sgm_aggregate(cv, p1, p2)


def disparity(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
              window: int = 7, lr_thresh: float = 1.5, algo: str = "box",
              sgm_p1: float = 0.03, sgm_p2: float = 0.2):
    """Winner-take-all disparity with sub-pixel refinement + LR consistency.

    algo: "box" (aggregated SAD, fastest) or "sgm" (4-path semi-global
    aggregation on top of the box volume — the reference's SGBM/ELAS-grade
    regularization for weakly-textured regions). Ties go to the smallest
    disparity (torch.argmin returns the first minimum, as jnp.argmin).
    Returns (disp (H, W) float32, valid (H, W) bool).
    """
    if algo not in ("box", "sgm"):
        raise ValueError(f"algo={algo!r}: expected 'box' or 'sgm'")
    cv = cost_volume(left, right, max_disp, window)  # (D, H, W)
    if algo == "sgm":
        cv = sgm_aggregate(cv, sgm_p1, sgm_p2)
    D, H, W = cv.shape
    best = torch.argmin(cv, dim=0)  # (H, W)
    # sub-pixel parabola fit around the minimum
    b = torch.clamp(best, 1, D - 2)
    c0, c1, c2 = torch.gather(cv, 0, torch.stack([b - 1, b, b + 1]))
    denom = torch.clamp(c0 - 2 * c1 + c2, min=1e-6)
    frac = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    disp_l = best.to(torch.float32) + torch.where(
        (best > 0) & (best < D - 1), frac, 0.0)

    # right-image disparity for the consistency check: reuse the volume by
    # shifting: cost_r[d, y, x] = cost_l[d, y, x + d]
    dev = cv.device
    idx_x = torch.clamp(torch.arange(W, device=dev)[None, :]
                        + torch.arange(D, device=dev)[:, None], max=W - 1)
    cost_r = torch.gather(cv, 2, idx_x[:, None, :].expand(D, H, W))
    best_r = torch.argmin(cost_r, dim=0).to(torch.float32)
    # project right disparity back to left coords
    x_r = torch.clamp(
        (torch.arange(W, device=dev, dtype=torch.float32)[None, :]
         - torch.round(disp_l)).to(torch.int64), 0, W - 1)
    d_r = torch.gather(best_r, 1, x_r)
    valid = torch.abs(disp_l - d_r) <= lr_thresh
    valid &= best > 0  # zero-disparity band is unreliable
    return disp_l, valid


def disparity_to_depth(disp: torch.Tensor, fx: float, baseline: float,
                       min_disp: float = 0.5) -> torch.Tensor:
    """Z = fx * B / d (reference convertToDepthMap semantics)."""
    return fx * baseline / torch.clamp(disp, min=min_disp)


def depth_from_rig_pair(imgs: torch.Tensor, rig, cam_a: int = 0,
                        cam_b: int = 1, max_disp: int = 64,
                        algo: str = "box", rectifier=None):
    """Rig pair -> depth. A parallel-baseline pair is used directly (it is
    rectified by construction); a general pair is rectified through
    RigRectifier first (reference DepthReconstructor::init stereoRectify +
    remap, DepthReconstructor.cpp:7-22,60-67). Pass a cached `rectifier`
    to amortize the host map construction across frames.

    imgs: (C, H, W) on the rig's device. Returns (depth (H, W), valid
    (H, W)) — in the RECTIFIED cam_a frame for non-parallel rigs.
    """
    from mcslam_tpu_torch.ops.rectify import RigRectifier

    if rectifier is None:
        rectifier = RigRectifier(rig, cam_a, cam_b)
    if rectifier.is_identity:
        cam_T_ref = rig.cam_T_ref.cpu().numpy()
        t = cam_T_ref[cam_b][:3, 3] - cam_T_ref[cam_a][:3, 3]
        baseline = float(abs(t[0]))
        fx = float(rig.fxycxy[cam_a, 0])
        d, valid = disparity(imgs[cam_a], imgs[cam_b], max_disp=max_disp,
                             algo=algo)
        return disparity_to_depth(d, fx, baseline), valid
    la = rectifier.rectify(imgs[cam_a])
    lb = rectifier.rectify_b(imgs[cam_b])
    d, valid = disparity(la, lb, max_disp=max_disp, algo=algo)
    return rectifier.depth_from_disparity(d), valid
