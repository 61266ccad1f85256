// the asm helpers of mma.cuh, emulated
inline void cp_async16(void* smem, const void* gmem, int n) {
  memset(smem, 0, 16); if (n) memcpy(smem, gmem, n);
}
inline void cp_async4(void* smem, const void* gmem, int n) {
  memset(smem, 0, 4); if (n) memcpy(smem, gmem, n);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
