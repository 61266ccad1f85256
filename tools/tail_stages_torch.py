#!/usr/bin/env python
"""Where kernel 7 (csrc/detail_tail.cu) spends its time, on a CUDA card.

  python tools/tail_stages_torch.py

Builds csrc/detail_tail.cu as it is, and variants of it, each into its own
library under the git-ignored mds_tpu_torch/build/tail_stages/, with
clock64 counters at the consumers' stage barriers (the input load, S2_2,
S2_3, S3_1, S3_2, S3_3). Runs each at (1, 64, 256, 512) (the served
frame's /4 feature, random weights) and at two ragged shapes, against
detail_tail_fused_plain (rel max-diff), and prints its device time
(torch.profiler, mean of 10 launches) and its cycles per stage, summed over
a block's tiles and averaged over the blocks, in thousands. Variants:

- "built": the kernel as committed;
- "cluster2": clusters of two blocks on neighbouring tiles, each weight
  slice read from L2 once and multicast into both blocks' slots
  (cp.async.bulk .multicast::cluster), a slot refilled once the consumers
  of both blocks have released it;
- "stream_s3": the S3 stages stream their weight slices through their
  ring without issuing their MMAs: what the stream alone costs (its output
  is wrong by design, its rel meaningless).

The counters cost a few hundred cycles per tile. The card's name, power
limit and SM clock close the output.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "mds_tpu_torch" / "csrc"
OUT = ROOT / "mds_tpu_torch" / "build" / "tail_stages"
STAGES = ["load", "S2_2", "S2_3", "S3_1", "S3_2", "S3_3"]


def instrument(s):
    """A global counter per stage; consumer thread 0 adds the cycles since
    the last stage barrier at each of the tile's six barriers."""
    s = s.replace("namespace {\n\nconstexpr int kT",
                  "__device__ unsigned long long g_stage[8];\nnamespace {\n\nconstexpr int kT", 1)
    loop = re.search(r"\n  for \(int (tile|p) = [^\n]*\n    const (int tx|bool store)", s)
    s = s[:loop.start()] + "\n  long long t_stage = clock64();" + s[loop.start():]
    n = [0]

    def count(_):
        n[0] += 1
        return (f"named_bar_sync(1, kConsumers);\n    if (threadIdx.x == 0) {{ long long t = clock64(); "
                f"atomicAdd(&g_stage[{n[0] - 1}], (unsigned long long)(t - t_stage)); t_stage = t; }}")

    s = re.sub(r"named_bar_sync\(1, kConsumers\);(?:  // the next tile's input overwrites A)?",
               count, s)
    assert n[0] == 6, n[0]
    return s + '''
extern "C" int tail_stage_cycles(void* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stage, sizeof(g_stage));
  if (reset) {
    unsigned long long z[8] = {0};
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stage, z, sizeof(z));
  }
  return (int)e;
}
'''


CLUSTER_PTX = r'''
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t mapa_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t caddr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(caddr)
               : "memory");
}
__device__ __forceinline__ void bulk_g2s_multicast(void* smem, const void* gmem, uint32_t bytes,
                                                   uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
'''


def cluster2(s):
    """The multicast variant (see the module docstring)."""
    def rep(old, new, count=1):
        nonlocal s
        assert s.count(old) == count, old
        s = s.replace(old, new)

    rep('#include "wgmma.cuh"\n', '#include "wgmma.cuh"\nnamespace {' + CLUSTER_PTX + '}\n')
    rep("  int next;\n  uint32_t phase;\n", "  int next;\n  uint32_t phase;\n  uint32_t rank;\n")
    # slice i of a stage: copied by the CTA of rank i % 2 into both CTAs
    rep("""      mbar_arrive_expect_tx(&ring.full[slot], nhs * kSlice);
      for (int nh = 0; nh < nhs; ++nh)
        bulk_g2s(base + (ring.addr(slot) + nh * kSlice - smem_u32(base)),
                 conv + (size_t)(nh * 9 * kcs + sl) * kSlice, kSlice,
                 &ring.full[slot]);""", """      mbar_arrive_expect_tx(&ring.full[slot], nhs * kSlice);
      if ((uint32_t)((g * 9 * kcs + sl) & 1) == ring.rank)
        for (int nh = 0; nh < nhs; ++nh)
          bulk_g2s_multicast(base + (ring.addr(slot) + nh * kSlice - smem_u32(base)),
                             conv + (size_t)(nh * 9 * kcs + sl) * kSlice, kSlice,
                             &ring.full[slot], 0x3);""")
    rep("          if (lane == 0) mbar_arrive(&ring.empty[slot]);",
        "          if (lane == 0) { mbar_arrive(&ring.empty[slot]); mbar_arrive_cluster("
        "mapa_shared(smem_u32(&ring.empty[slot]), ring.rank ^ 1)); }")
    rep("        if (kOut && !in) continue;", "        if (kOut && (!in || !gout)) continue;")
    rep("__global__ void __launch_bounds__(kThreads, 1)",
        "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)")
    rep("          bars + 2 * kSlots, bars + 3 * kSlots, 0, 0};",
        "          bars + 2 * kSlots, bars + 3 * kSlots, 0, 0};\n  r2.rank = r3.rank = cluster_ctarank();")
    rep("kConsumers / 32);", "2 * kConsumers / 32);", 2)
    # B's tail takes the peer's copies too: free once both CTAs' S2_3 are done
    rep("    mbar_init(btail, 1);", "    mbar_init(btail, 2);")
    rep("    if (threadIdx.x == 0) mbar_arrive(btail);  // B's tail may take weights",
        "    if (threadIdx.x == 0) { mbar_arrive(btail); mbar_arrive_cluster("
        "mapa_shared(smem_u32(btail), r2.rank ^ 1)); }")
    rep("  __syncthreads();  // the last block-wide barrier: the roles split here",
        "  cluster_sync();\n  const int pairs = (tiles + 1) / 2, clusters = gridDim.x / 2;")
    rep("      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {",
        "      for (int p = blockIdx.x / 2; p < pairs; p += clusters, ++n) {")
    rep("    }\n    return;\n  }", "    }\n    cluster_sync();\n    return;\n  }")
    rep("""  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx""", """  for (int p = blockIdx.x / 2; p < pairs; p += clusters) {
    const bool store = 2 * p + (int)r2.rank < tiles;
    const int tile = store ? 2 * p + r2.rank : tiles - 1;
    const int tx""")
    rep("        bufA, nullptr, out + (size_t)b * H8 * W8 * 128, bp + kOffB8, r3, q0,",
        "        bufA, nullptr, store ? out + (size_t)b * H8 * W8 * 128 : nullptr, bp + kOffB8,"
        " r3, q0,")
    rep("    named_bar_sync(1, kConsumers);  // the next tile's input overwrites A\n  }\n}",
        "    named_bar_sync(1, kConsumers);  // the next tile's input overwrites A\n  }\n"
        "  cluster_sync();\n}")
    rep("  const long long blocks = tiles < sms ? tiles : sms;",
        "  const long long blocks = 2 * ((tiles + 1) / 2 < sms / 2 ? (tiles + 1) / 2 : sms / 2);")
    return s


def stream_s3(s):
    """The S3 stages (N = 128) wait for and release their weight slices
    without the MMAs: the weight stream's own time (wrong output)."""
    old = ("          if (kN == 128)\n"
           "            wgmma_m64n128k16(acc[i], a[ks & 1][i], sw128_desc(slot_s + ks * 32));\n"
           "          else\n")
    assert s.count(old) == 1
    return s.replace(old, "          if (kN == 64)\n")


VARIANTS = {"built": lambda s: s, "cluster2": cluster2, "stream_s3": stream_s3}


def build():
    from mds_tpu_torch.ops.build import NVCC_FLAGS, _nvcc

    base = (SRC / "detail_tail.cu").read_text()
    procs = {}
    for name, patch in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "detail_tail.cu").write_text(instrument(patch(base)))
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{SRC}", "-shared", "-o", str(d / "lib.so"),
             str(d / "detail_tail.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{log[-4000:]}")
        print(name, "ptxas:", " | ".join(ln.strip() for ln in log.splitlines()
                                         if "registers" in ln or "spill" in ln or "C75" in ln),
              flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.mds_detail_tail_fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.tail_stage_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("tail_stages_torch: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mds_tpu_torch.ops import stem

    libs = build()
    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    def image(b, h, w):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 64)), dtype=torch.float32, device=dev)
        return x.relu().to(torch.bfloat16).permute(0, 3, 1, 2)

    params = []
    for o, i in stem._TAIL_SHAPES:
        params += [torch.tensor(rng.normal(0, np.sqrt(2 / (o * 9)), (o, i, 3, 3)),
                                dtype=torch.float32, device=dev),
                   torch.tensor(rng.normal(1, .1, o), dtype=torch.float32, device=dev),
                   torch.tensor(rng.normal(0, .1, o), dtype=torch.float32, device=dev)]
    wp, bp = stem.pack_detail_tail(*params)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    shapes = [(1, 256, 512), (2, 22, 38), (1, 34, 130)]
    inputs = [image(*s) for s in shapes]
    wants = [stem.detail_tail_fused_plain(y, *params) for y in inputs]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(lib, y):
        b, _, h4, w4 = y.shape
        out = torch.empty((b, 128, h4 // 2, w4 // 2), dtype=torch.bfloat16, device=dev,
                          memory_format=torch.channels_last)
        err = lib.mds_detail_tail_fused(ptr(y), ptr(wp), ptr(bp), ptr(out), b, h4, w4,
                                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out

    for name, lib in libs.items():
        rel = max(((run(lib, y).float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for y, w in zip(inputs, wants))
        cyc = (ctypes.c_ulonglong * 8)()
        y = inputs[0]
        lib.tail_stage_cycles(ctypes.cast(cyc, ctypes.c_void_p), 1)
        for _ in range(10):
            run(lib, y)
        torch.cuda.synchronize()
        lib.tail_stage_cycles(ctypes.cast(cyc, ctypes.c_void_p), 1)
        stages = {s: cyc[i] / 10 / sms / 1e3 for i, s in enumerate(STAGES)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run(lib, y)
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "detail_tail_kernel" in e.name]
        dms = sum(e.device_time_total for e in ev) / max(len(ev), 1) / 1e3
        print(f"{name}: rel {rel:.4g} device_ms {dms:.4f} kcycles per block {stages}",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
