// the asm helpers of mma.cuh, emulated
inline void mma_bf16_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                           uint32_t a3, uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* f = shim_blk->frag.data() + warp * 32 * 6;
  uint32_t mine[6] = {a0, a1, a2, a3, b0, b1};
  memcpy(f + lane * 6, mine, sizeof(mine));
  shim_blk->wbar[warp]->arrive_and_wait();
  auto half = [](uint32_t w, int hi) { return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16)); };
  auto A = [&](int r, int k) { return half(f[((r % 8) * 4 + (k % 8) / 2) * 6 + (r / 8) + 2 * (k / 8)], k % 2); };
  auto B = [&](int k, int n) { return half(f[(n * 4 + (k % 8) / 2) * 6 + 4 + k / 8], k % 2); };
  const int gq = lane >> 2, tq = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = gq + 8 * (i / 2), n = 2 * tq + i % 2;
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    out[i] = s;
  }
  shim_blk->wbar[warp]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
inline void cp_async16(void* smem, const void* gmem, int n) {
  memset(smem, 0, 16); if (n) memcpy(smem, gmem, n);
}
inline void cp_async4(void* smem, const void* gmem, int n) {
  memset(smem, 0, 4); if (n) memcpy(smem, gmem, n);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
