#pragma once
#include "cuda_bf16.h"
// the PTX section of wgmma.cuh, emulated. Shared addresses start 48 bytes
// off the 1024-byte grid (nothing promises the card's base is on it), so the
// kernels' own alignment of their swizzled buffers is exercised.
constexpr uint32_t kShimSharedBase = 48;
inline uint32_t smem_u32(const void* p) {
  return uint32_t(static_cast<const unsigned char*>(p) - shim_smem()) + kShimSharedBase;
}
inline unsigned char* shim_shared(uint32_t a) { return shim_smem() + (a - kShimSharedBase); }

// each lane's row address through the warp's exchange area, then the four
// 8x8 matrices read as the hardware hands them out
inline void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* f = shim_blk->frag.data() + warp * 32 * 6;
  f[lane * 6] = addr;
  shim_blk->wbar[warp]->arrive_and_wait();
  const int gq = lane >> 2, tq = lane & 3;
  for (int m = 0; m < 4; ++m) memcpy(&r[m], shim_shared(f[(m * 8 + gq) * 6]) + tq * 4, 4);
  shim_blk->wbar[warp]->arrive_and_wait();
}

// each lane's row address through the warp's exchange area, then each
// lane's share of every matrix (row l / 4, cols 2 (l % 4), +1) to its row
inline void shim_stmatrix(uint32_t addr, const uint32_t* r, int count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* f = shim_blk->frag.data() + warp * 32 * 6;
  f[lane * 6] = addr;
  shim_blk->wbar[warp]->arrive_and_wait();
  for (int m = 0; m < count; ++m)
    memcpy(shim_shared(f[(m * 8 + (lane >> 2)) * 6]) + (lane & 3) * 4, &r[m], 4);
  shim_blk->wbar[warp]->arrive_and_wait();
}
inline void stmatrix_x4(uint32_t addr, const uint32_t* r) { shim_stmatrix(addr, r, 4); }
inline void stmatrix_x2(uint32_t addr, const uint32_t* r) { shim_stmatrix(addr, r, 2); }
inline void stmatrix_x1(uint32_t addr, uint32_t r) { shim_stmatrix(addr, &r, 1); }

inline uint32_t pack2_relu(float lo, float hi) {
  return pack2(lo > 0.f ? lo : 0.f, hi > 0.f ? hi : 0.f);
}

// bulk copies shared -> global: each is held until a wait completes its
// group and only then reads its source, as late as the hardware may, so a
// stage written again before its wait, or a missing final wait, shows
struct ShimBulkCopy { void* dst; const void* src; uint32_t bytes; int group; };
inline thread_local std::vector<ShimBulkCopy> shim_bulk_copies;
inline thread_local int shim_bulk_open = 0;  // the open group's number
inline void fence_proxy_async() {}
inline void bulk_s2g(void* gmem, const void* smem, uint32_t bytes) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(gmem) % 16 || smem_u32(smem) % 16) {
    fprintf(stderr, "cp.async.bulk stand-in: misaligned store\n");
    abort();
  }
  shim_bulk_copies.push_back({gmem, smem, bytes, shim_bulk_open});
}
inline void bulk_commit() { ++shim_bulk_open; }
inline void shim_bulk_complete(int pending) {
  auto& v = shim_bulk_copies;
  for (auto& c : v)
    if (c.group < shim_bulk_open - pending) memcpy(c.dst, c.src, c.bytes);
  v.erase(std::remove_if(v.begin(), v.end(), [&](const ShimBulkCopy& c) {
            return c.group < shim_bulk_open - pending; }), v.end());
}
template <int N> inline void bulk_wait_read() { shim_bulk_complete(N); }
template <int N> inline void bulk_wait() { shim_bulk_complete(N); }

inline void shim_wg_sync() { shim_blk->wgbar[threadIdx.x / 128]->arrive_and_wait(); }
inline void wgmma_fence() { shim_wg_sync(); }
inline void wgmma_commit() { shim_wg_sync(); }
template <int N> inline void wgmma_wait() { shim_wg_sync(); }
inline void reg_fence(float&) {}

// B(k, n) as the hardware finds it from a descriptor: start address, the
// stride byte offset between 8-row groups, 128-byte rows within a group
// (K-major), then the 128-byte swizzle on the address bits
inline float shim_b(uint64_t desc, int k, int n) {
  if ((desc >> 62) != 1) {
    fprintf(stderr, "wgmma stand-in: only the 128-byte swizzle is emulated\n");
    abort();
  }
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  uint32_t a = start + (n / 8) * sbo + (n % 8) * 128 + k * 2;
  a ^= ((a >> 7) & 7) << 4;
  uint16_t v;
  memcpy(&v, shim_shared(a), 2);
  return __uint_as_float(uint32_t(v) << 16);
}

// D(64xN) += A(64x16, registers) * B(16xN, descriptor), the warpgroup's A
// fragments exchanged through the block's staging area
template <int N>
inline void shim_wgmma(float* d, const uint32_t* a, uint64_t b) {
  const int t = threadIdx.x & 127;
  uint32_t* f = shim_blk->wgfrag.data() + (threadIdx.x / 128) * 128 * 4;
  memcpy(f + t * 4, a, 16);
  shim_wg_sync();
  auto A = [&](int row, int k) {
    const int r = row % 16, lane = (r % 8) * 4 + (k % 8) / 2;
    const uint32_t w = f[((row / 16) * 32 + lane) * 4 + r / 8 + 2 * (k / 8)];
    return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
  };
  const int warp = t / 32, gq = (t % 32) >> 2, tq = t & 3;
  float out[N / 2];
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + gq + 8 * (e / 2), col = 8 * j + 2 * tq + e % 2;
      float s = d[4 * j + e];
      for (int k = 0; k < 16; ++k) s += A(row, k) * shim_b(b, k, col);
      out[4 * j + e] = s;
    }
  shim_wg_sync();
  memcpy(d, out, sizeof(out));
}
inline void wgmma_m64n16k16(float* d, const uint32_t* a, uint64_t b) { shim_wgmma<16>(d, a, b); }
inline void wgmma_m64n32k16(float* d, const uint32_t* a, uint64_t b) { shim_wgmma<32>(d, a, b); }
inline void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t b) { shim_wgmma<64>(d, a, b); }
inline void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t b) { shim_wgmma<128>(d, a, b); }

// mbarriers: arrivals pending, arrivals per phase, phase parity, transfer
// bytes pending, in the barrier's 8 bytes; one lock and condition for all
struct ShimMbar { uint8_t pending, count, phase, pad; int32_t tx; };
static_assert(sizeof(ShimMbar) == 8, "an mbarrier is 8 bytes");
inline std::mutex& shim_mbar_mu() { static std::mutex m; return m; }
inline std::condition_variable& shim_mbar_cv() { static std::condition_variable c; return c; }
inline void shim_mbar_step(ShimMbar* s) {
  if (s->pending == 0 && s->tx == 0) {
    s->phase ^= 1;
    s->pending = s->count;
    shim_mbar_cv().notify_all();
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(shim_mbar_mu());
  *reinterpret_cast<ShimMbar*>(bar) = {uint8_t(count), uint8_t(count), 0, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(shim_mbar_mu());
  auto* s = reinterpret_cast<ShimMbar*>(bar);
  --s->pending;
  shim_mbar_step(s);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(shim_mbar_mu());
  auto* s = reinterpret_cast<ShimMbar*>(bar);
  s->tx += int32_t(bytes);
  --s->pending;
  shim_mbar_step(s);
}
// blocks until the phase of this parity has completed; a wait that sees no
// phase change for 30 s (a schedule fault: an arrival or transfer that never
// comes, a count that never reaches zero) aborts
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(shim_mbar_mu());
  auto* s = reinterpret_cast<ShimMbar*>(bar);
  if (!shim_mbar_cv().wait_for(lk, std::chrono::seconds(30),
                               [&] { return s->phase != parity; })) {
    fprintf(stderr, "mbarrier stand-in: no phase change in 30 s (arrivals pending %d, "
            "transfer bytes pending %d)\n", s->pending, s->tx);
    abort();
  }
  return true;
}
inline void bulk_g2s(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  if (bytes % 16 || reinterpret_cast<uintptr_t>(gmem) % 16 || smem_u32(smem) % 16) {
    fprintf(stderr, "cp.async.bulk stand-in: misaligned copy\n");
    abort();
  }
  memcpy(smem, gmem, bytes);
  std::lock_guard<std::mutex> lk(shim_mbar_mu());
  auto* s = reinterpret_cast<ShimMbar*>(bar);
  s->tx -= int32_t(bytes);
  shim_mbar_step(s);
}
// the 4-d box at (c0, c1, c2, c3) of the tensor map, dense in box order,
// zeros outside the tensor; then the box's bytes, all of them, as completed
// transfer on the mbarrier (a count it was not told to expect leaves its
// phase open, and the wait aborts)
inline void tma_load_4d(void* smem, const CUtensorMap* m, int c0, int c1, int c2, int c3,
                        uint64_t* bar) {
  if (smem_u32(smem) % 128 || m->rank != 4) {
    fprintf(stderr, "cp.async.bulk.tensor stand-in: misaligned box or not a 4-d map\n");
    abort();
  }
  const int64_t c[4] = {c0, c1, c2, c3};
  const uint32_t e = m->esize;
  unsigned char* dst = static_cast<unsigned char*>(smem);
  for (uint32_t i3 = 0; i3 < m->box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m->box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m->box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m->box[0]; ++i0, dst += e) {
          const int64_t at[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          int64_t off = 0;
          bool in = true;
          for (int d = 0; d < 4; ++d) {
            in = in && at[d] >= 0 && at[d] < int64_t(m->dims[d]);
            off += at[d] * int64_t(m->strides[d]);
          }
          if (in) memcpy(dst, m->base + off, e);
          else memset(dst, 0, e);
        }
  const int32_t bytes = int32_t(dst - static_cast<unsigned char*>(smem));
  std::lock_guard<std::mutex> lk(shim_mbar_mu());
  auto* s = reinterpret_cast<ShimMbar*>(bar);
  s->tx -= bytes;
  shim_mbar_step(s);
}

inline void named_bar_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lk(shim_blk->mu);
    auto& p = shim_blk->named[id];
    if (!p) p = std::make_unique<std::barrier<>>(n);
    b = p.get();
  }
  b->arrive_and_wait();
}
