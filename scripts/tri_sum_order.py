"""Probe of the card's float32 rounding that csrc/tri_refine.cu repeats.

Prints, for R = 1..8 rays and several point counts M, which order of
adds `torch.sum(x, dim=0)` takes on a contiguous (R, M) float32 tensor
(the layout of the plain triangulation's components), and whether
`torch.rsqrt` and `1.0 / x` equal CUDA's `rsqrtf` and `__fdiv_rn(1, x)`
on the card. Run on a machine with a card and nvcc:

    python3 scripts/tri_sum_order.py
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

PROBE_CU = r"""
extern "C" __global__ void probe(const float* x, float* rs, float* rc, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) { rs[i] = rsqrtf(x[i]); rc[i] = __fdiv_rn(1.0f, x[i]); }
}
extern "C" int launch(const void* x, void* rs, void* rc, int n, void* s) {
  probe<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(
      (const float*)x, (float*)rs, (float*)rc, n);
  return (int)cudaGetLastError();
}
"""


def orders(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Candidate orders of the sum over dim 0, every add rounded alone."""
    R = x.shape[0]
    zero = torch.zeros_like(x[0])
    seq = zero + x[0]
    for r in range(1, R):
        seq = seq + x[r]
    # four accumulators, element r into r % 4, then folded in order
    acc = [zero + x[r] if r < R else zero for r in range(4)]
    for r in range(4, R):
        acc[r % 4] = acc[r % 4] + x[r]
    vt4 = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    # pairwise over lanes: lane l holds elements l, l + w, ...; then a
    # shuffle-down tree with offsets 1, 2, 4
    w = 1
    while w * 2 <= R:
        w *= 2
    lanes = []
    for lane in range(w):
        v = zero + x[lane]
        for r in range(lane + w, R, w):
            v = v + x[r]
        lanes.append(v)
    off = 1
    while off < w:
        lanes = [lanes[i] + lanes[i + off] if i % (2 * off) == 0 else lanes[i]
                 for i in range(w)]
        off *= 2
    return {"sequential": seq, "four_accumulators": vt4,
            "lane_tree": lanes[0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("tri_sum_order: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, "| torch", torch.__version__, "cuda",
          torch.version.cuda)
    g = torch.Generator(device="cpu").manual_seed(0)
    for layout in ("contiguous (R, M)", "transposed (M, R).T"):
        for R in range(1, 9):
            for M in (37, 2047, 2048, 6000):
                mag = 10.0 ** (torch.rand(R, M, generator=g) * 6 - 3)
                xc = (torch.randn(R, M, generator=g) * mag).to(dev)
                x = (xc if layout.startswith("contiguous")
                     else xc.t().contiguous().t())
                s = torch.sum(x, dim=0)
                hits = [k for k, v in orders(xc).items()
                        if torch.equal(v, s)]
                print(f"sum {layout} R={R} M={M}: {hits or 'NONE'}")
    nvcc = pathlib.Path("/usr/local/cuda/bin/nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "probe.cu"
        so = pathlib.Path(tmp) / "probe.so"
        src.write_text(PROBE_CU)
        subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-fmad=false", "-shared", "-Xcompiler",
                        "-fPIC", "-o", str(so), str(src)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                       ctypes.c_void_p]
        n = 1 << 22
        x = torch.cat([
            1.0 + torch.rand(n // 2, generator=g) * 10.0,
            10.0 ** (torch.rand(n // 2, generator=g) * 60 - 30),
        ]).to(dev)
        rs = torch.empty_like(x)
        rc = torch.empty_like(x)
        err = lib.launch(x.data_ptr(), rs.data_ptr(), rc.data_ptr(), n,
                         torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0, err
        print("rsqrt: torch.rsqrt == rsqrtf at",
              int((torch.rsqrt(x) == rs).sum()), "of", n)
        print("reciprocal: 1.0 / x == __fdiv_rn(1, x) at",
              int(((1.0 / x) == rc).sum()), "of", n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
