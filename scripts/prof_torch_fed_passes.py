"""Where the time of the port's FED octave kernel (B10) goes, on one CUDA card.

    python scripts/prof_torch_fed_passes.py

Builds two copies of coloc_tpu_torch/csrc/fed_octave.cu beside the port's
own library: one in which thread 0 of CTA 0 records clock64() and the
global timer after every barrier (each __syncthreads() and the grid
barrier), and one without the grid barrier (its output is wrong; it shows
what the barriers cost). For each octave of the bench frame (752x480, 4
octaves of 4 sublevels, B=1) it prints, beside the card's name, power limit
and clocks:

  - CTA 0's cycles between consecutive barriers, one launch after warm-up:
    per FED cycle the tile start, the load of the halo, the conductivity,
    the half-grid conductivities, each explicit step, Lx/Ly, the response,
    and the grid barrier;
  - device milliseconds (torch.profiler) of the port's kernel, the
    instrumented copy and the copy without grid barriers, in turns.

The input is a random image with a fixed k^2: the kernel's control flow
does not depend on the data.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from coloc_tpu_torch.ops import _build, diffusion, dispatch  # noqa: E402

H, W = 480, 752
CALLS = 20

MARKS = '''
__device__ unsigned long long g_cycles[2048];
__device__ unsigned long long g_ns[2048];
__device__ int g_marks;
__device__ __forceinline__ void mark() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    const int i = g_marks;
    if (i < 2048) {
      g_cycles[i] = clock64();
      g_ns[i] = ns;
    }
    g_marks = i + 1;
  }
}
'''

READ_MARKS = '''
extern "C" int coloc_fed_marks(void* cycles, void* ns, void* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(cycles, g_cycles, sizeof(g_cycles));
  cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));
  cudaMemcpyFromSymbol(n, g_marks, sizeof(int));
  int zero = 0;
  return cudaMemcpyToSymbol(g_marks, &zero, sizeof(int));
}
'''
GRID_SYNC = "      if (!last || s + 1 < S) grid.sync();"


def variants(src: str) -> dict:
    """The instrumented source and the one without grid barriers."""
    for anchor in ("namespace {\n\nconstexpr int kThreads", GRID_SYNC,
                   "  cg::grid_group grid = cg::this_grid();\n"):
        if anchor not in src:
            raise SystemExit(f"fed_octave.cu has changed: {anchor!r} not found")
    marked = src.replace("namespace {\n\nconstexpr int kThreads",
                         "namespace {\n" + MARKS + "\nconstexpr int kThreads", 1)
    marked = marked.replace("  cg::grid_group grid = cg::this_grid();\n",
                            "  cg::grid_group grid = cg::this_grid();\n  mark();\n", 1)
    marked = marked.replace("__syncthreads();", "__syncthreads(); mark();")
    marked = marked.replace(GRID_SYNC, "      __syncthreads(); mark();\n"
                            "      if (!last || s + 1 < S) { grid.sync(); mark(); }")
    return {"marked": marked + READ_MARKS,
            "no grid barrier": src.replace(GRID_SYNC, "      __syncthreads();")}


def build(name: str, code: str) -> ctypes.CDLL:
    nvcc = _build._nvcc()
    work = Path(tempfile.mkdtemp(prefix="fed-passes-"))
    (work / "fed_octave.cu").write_text(code)
    obj, lib = work / "fed.o", work / "libfed.so"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-c", "-o", str(obj),
                           str(work / "fed_octave.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    subprocess.run([nvcc, *_build._ARCH, "-shared", "-o", str(lib), str(obj)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.coloc_fed_octave.argtypes = _build._SIGNATURES["coloc_fed_octave"]
    dll.coloc_fed_octave.restype = ctypes.c_int
    return dll


def launcher(fn, L, k2, cycles, s4, dev):
    """fn's launch on L's octave, with its own outputs and scratch."""
    nb, h, w = L.shape
    out = torch.empty((4, nb, len(cycles), h, w), device=dev)
    scratch = torch.empty((3, nb, h, w), device=dev)
    plan = diffusion._plan(cycles, s4)
    args = (L.data_ptr(), k2.data_ptr(), *(o.data_ptr() for o in out), scratch.data_ptr(),
            nb, h, w, len(cycles), *(ctypes.addressof(a) for a in plan), dev.index,
            dispatch.stream_handle(dev))

    def run():
        if fn(*args) != 0:
            raise RuntimeError("fed_octave did not launch")
    run.keep = (plan, out, scratch)
    return run


def device_ms(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total / e.count for e in prof.key_averages()
          if "fed_octave_kernel" in e.key and e.count]
    return sum(us) / len(us) / 1e3 if us else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    _build.load()
    libs = {name: build(name, code)
            for name, code in variants((_build.CSRC / "fed_octave.cu").read_text()).items()}
    read = libs["marked"].coloc_fed_marks
    read.argtypes = [ctypes.c_void_p] * 3
    cycles_buf = np.zeros(2048, np.uint64)
    ns_buf = np.zeros(2048, np.uint64)
    n_buf = np.zeros(1, np.int32)
    rng = np.random.default_rng(0)
    L = torch.from_numpy(rng.uniform(0, 1, (1, H, W)).astype(np.float32)).to(dev)
    k2 = torch.tensor([0.002], device=dev)
    for o, (_, cycles, s4) in enumerate(diffusion.octave_schedule(4, 4, 1.6, 0.25)):
        marked = launcher(libs["marked"].coloc_fed_octave, L, k2, cycles, s4, dev)
        nosync = launcher(libs["no grid barrier"].coloc_fed_octave, L, k2, cycles, s4, dev)
        for _ in range(3):
            marked()
        read(cycles_buf.ctypes.data, ns_buf.ctypes.data, n_buf.ctypes.data)
        marked()
        torch.cuda.synchronize()
        read(cycles_buf.ctypes.data, ns_buf.ctypes.data, n_buf.ctypes.data)
        n = int(n_buf[0])
        c = cycles_buf[:n].astype(np.int64)
        t = ns_buf[:n].astype(np.int64)
        print(f"[octave {o}] {tuple(L.shape)}, steps {[len(x) for x in cycles]}: CTA 0 "
              f"{c[-1] - c[0]} cycles, {t[-1] - t[0]} ns from its first to its last barrier")
        print(f"  cycles between barriers: {np.diff(c).tolist()}")
        new = lambda: diffusion._fed_octave_cuda(L, k2, cycles, s4)  # noqa: E731
        ms = {}
        for name, fn in (("kernel", new), ("instrumented", marked), ("no grid barrier", nosync),
                         ("no grid barrier", nosync), ("instrumented", marked), ("kernel", new)):
            ms.setdefault(name, []).append(device_ms(fn))
        print("  device ms: " + "; ".join(f"{k} {np.mean(v):.4f}" for k, v in ms.items()))
        L = diffusion.fed_octave_plain(L, k2, cycles, s4)[0][:, -1, ::2, ::2].contiguous()
    return 0


if __name__ == "__main__":
    sys.exit(main())
