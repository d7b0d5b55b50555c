// K2 conv_head_fwd: the forecaster's conv head, a KxK SAME conv from the top
// cell's h [B,H,W,Cin] to out [B,H,W,Cout] with bias, NHWC.
//
// Replaces the head_pass of the TPU rollout kernel
// (pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py, _rollout_body.head_pass).
// There the head writes its prediction into the output frame and into the
// next step's cell-1 input lane; here the caller passes the output slot
// out[t_o] as `out`, and the same slot is the next step's x, so the
// autoregressive feedback needs no copy.
//
// Accumulates in float32 with the bias seeding the accumulator, and stores the
// result in the element type T (float or bfloat16): the rounding points of
// the TPU head_pass.
//
// What bounds it on the card: bytes. At nowcast_128 (Cin=64, Cout=1) it does
// 1152 FLOP per pixel while reading 128 B (bf16) of h per pixel, ~9 FLOP/B,
// far below the ridge: the least time is h read once, 8.4 MB in bf16.
//
// Design: a block owns a 16x16 pixel tile of one batch item and up to 4
// output channels; one thread per pixel. The tile of h plus its halo is
// staged in shared memory 16 channels at a time with channel-fastest
// (coalesced) loads, so each h element is read from device memory about
// once per block instead of K*K times; the weights of the chunk are staged
// beside it and read as broadcasts. Any H, W, Cin, Cout and odd K.
//
// The C entries launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;     // tile rows
constexpr int TW = 16;     // tile columns
constexpr int CK = 16;     // input channels per shared-memory chunk
constexpr int CO = 4;      // output channels per block
constexpr int NT = TH * TW;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv_head_kernel(const T* __restrict__ h, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int Cin, int Cout, int K, int tiles_w) {
  extern __shared__ float smem[];
  const int IH = TH + K - 1, IW = TW + K - 1, pad = K / 2;
  float* in_s = smem;                 // [CK][IH][IW]
  float* w_s = smem + CK * IH * IW;   // [K*K][CK][CO]

  const int tid = threadIdx.x;
  const int ty = tid / TW, tx = tid % TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * CO;
  const long long b = blockIdx.z;

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = o0 + o < Cout ? to_f(bias[o0 + o]) : 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int idx = tid; idx < CK * IH * IW; idx += NT) {
      const int ci = idx % CK;
      const int p = idx / CK;
      const int r = p / IW, col = p % IW;
      const int gy = ty0 + r - pad, gx = tx0 + col - pad;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ci < Cin)
        v = to_f(h[((b * H + gy) * W + gx) * Cin + c0 + ci]);
      in_s[(ci * IH + r) * IW + col] = v;
    }
    for (int idx = tid; idx < K * K * CK * CO; idx += NT) {
      const int o = idx % CO;
      const int ci = (idx / CO) % CK;
      const int tap = idx / (CO * CK);
      float v = 0.f;
      if (c0 + ci < Cin && o0 + o < Cout)
        v = to_f(w[((long long)tap * Cin + c0 + ci) * Cout + o0 + o]);
      w_s[(tap * CK + ci) * CO + o] = v;
    }
    __syncthreads();
    for (int di = 0; di < K; ++di) {
      for (int dj = 0; dj < K; ++dj) {
        const int tap = di * K + dj;
#pragma unroll
        for (int ci = 0; ci < CK; ++ci) {
          const float a = in_s[(ci * IH + ty + di) * IW + tx + dj];
#pragma unroll
          for (int o = 0; o < CO; ++o) acc[o] += a * w_s[(tap * CK + ci) * CO + o];
        }
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + ty, gx = tx0 + tx;
  if (gy >= H || gx >= W) return;
  const long long pix = (b * H + gy) * W + gx;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    if (o0 + o < Cout) out[pix * Cout + o0 + o] = from_f<T>(acc[o]);
}

template <typename T>
int launch(const void* h, const void* w, const void* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int K, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || K < 1 ||
      K % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int IH = TH + K - 1, IW = TW + K - 1;
  const size_t smem = sizeof(float) * (size_t)(CK * IH * IW + K * K * CK * CO);
  auto kern = conv_head_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Cout + CO - 1) / CO, B);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, Cin, Cout, K,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_head_fwd_f32(const void* h, const void* w,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, int K,
                                 void* stream) {
  return launch<float>(h, w, bias, out, B, H, W, Cin, Cout, K, stream);
}

extern "C" int conv_head_fwd_bf16(const void* h, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int Cin, int Cout, int K,
                                  void* stream) {
  return launch<__nv_bfloat16>(h, w, bias, out, B, H, W, Cin, Cout, K,
                               stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
