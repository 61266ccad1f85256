#include "cuda_bf16.h"
#include <cstdlib>
thread_local ShimBlock* shim_blk;
thread_local size_t shim_static_off;
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
int shim_sms() { const char* s = getenv("SHIM_SMS"); return s ? atoi(s) : 3; }
