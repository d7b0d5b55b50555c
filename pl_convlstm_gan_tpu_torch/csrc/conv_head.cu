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
// far below the ridge: the least time is h read once, 8.4 MB in bf16 at B 4.
// h was written by the last cell just before, so it is read from L2.
//
// Design:
// - A block of 128 threads owns an 8x8 pixel tile of one batch item: 64
//   pixels, so a B 1 step at 128^2 launches 256 blocks (132 SMs). The tile
//   of h plus its halo, all Cin channels, is staged in shared memory once,
//   by 16-byte cp.async copies (zero fill outside the frame: SAME padding):
//   (8 + K - 1)^2 x Cin, 12.8 KB at Cin 64 in bfloat16.
// - Eight lanes share a pixel and split its channel sum: lane l takes the
//   16-byte vectors l, l + 8, ... of each tap (8 channels in bfloat16, 4 in
//   float32), so every shared-memory read is 16 bytes and the 8 lanes read
//   one contiguous 128-byte run; three warp shuffles add the 8 partial sums.
//   Each group of 8 lanes takes 4 pixels, accumulated side by side.
// - The weights are staged beside h as float32 [tap][ci][co] (2.3 KB for the
//   head), while the copies of h fly. The head of the forecaster (Cout 1,
//   K 3) has its own kernel: a lane reads its channels' weights of a tap
//   once, by 16-byte loads, for its 4 pixels. Every other Cout and odd K
//   takes the generic kernel, which loops over the outputs.
// - Shapes: any B, H, W, Cout and odd K; Cin a multiple of 8 (bfloat16) or 4
//   (float32), so that a pixel's channels are whole 16-byte vectors, and h
//   16-byte aligned. Shared memory bounds K and Cin (the wrapper states the
//   rule).
//
// The C entries launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for shapes
// they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TS = 8;              // tile rows and columns
constexpr int NT = 128;            // threads: 16 groups of 8 lanes
constexpr int LANES = 8;           // lanes that share a pixel
constexpr int PX_PER_GROUP = TS * TS / (NT / LANES);
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T as float32 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int tiles_w, int tiles_h) {
  int m = blockIdx.x;
  Tile t;
  t.x0 = (m % tiles_w) * TS;
  m /= tiles_w;
  t.y0 = (m % tiles_h) * TS;
  t.b = m / tiles_h;
  return t;
}

// the tile of h plus its halo, [TS+K-1][TS+K-1][Cin], by 16-byte copies
template <typename T>
__device__ __forceinline__ void stage_h(const T* h, T* hs, const Tile& t, int H,
                                        int W, int Cin, int K) {
  const int nv = Cin / Vec<T>::N, IW = TS + K - 1, pad = K / 2;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(hs));
  for (int idx = threadIdx.x; idx < IW * IW * nv; idx += NT) {
    const int v = idx % nv, pp = idx / nv;
    const int yy = t.y0 + pp / IW - pad, xx = t.x0 + pp % IW - pad;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* src = in ? h + (((long long)t.b * H + yy) * W + xx) * Cin + v * Vec<T>::N : h;
    cp_async16(dst + 16 * idx, src, in);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// the sum over the 8 lanes of a pixel group
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Cout 1, K 3: the weights [tap][ci] in shared memory as float32; a lane
// reads its channels' weights of a tap once for its 4 pixels. VPL = 16-byte
// vectors of h a lane (Cin <= 8 * VPL * Vec<T>::N).
template <typename T, int VPL>
__global__ void __launch_bounds__(NT)
conv_head_c1_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out, int H,
                    int W, int Cin, int tiles_w, int tiles_h) {
  constexpr int K = 3, IW = TS + K - 1, VN = Vec<T>::N;
  extern __shared__ uint4 smem_v[];
  T* const hs = reinterpret_cast<T*>(smem_v);
  float* const ws = reinterpret_cast<float*>(
      smem_v + (IW * IW * Cin * (int)sizeof(T) + 15) / 16);
  const Tile t = tile_of(tiles_w, tiles_h);
  stage_h(h, hs, t, H, W, Cin, K);
  for (int idx = threadIdx.x; idx < K * K * Cin; idx += NT) ws[idx] = to_f(w[idx]);
  const int lane8 = threadIdx.x % LANES, grp = threadIdx.x / LANES;
  const int nv = Cin / VN;
  const float b0 = lane8 == 0 ? to_f(bias[0]) : 0.f;
  wait_staged();

  // the group's 4 pixels side by side: four independent FMA chains
  float acc[PX_PER_GROUP];
#pragma unroll
  for (int k = 0; k < PX_PER_GROUP; ++k) acc[k] = b0;
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = lane8 + LANES * j;
      if (v >= nv) continue;
      float wv[VN];
#pragma unroll
      for (int u = 0; u < VN; u += 4) {
        const float4 q = reinterpret_cast<const float4*>(ws + tap * Cin + v * VN + u)[0];
        wv[u] = q.x, wv[u + 1] = q.y, wv[u + 2] = q.z, wv[u + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < PX_PER_GROUP; ++k) {
        const int p = grp + (NT / LANES) * k;  // a warp: 4 neighbouring pixels
        const T* px = hs + ((p / TS + tap / K) * IW + p % TS + tap % K) * Cin;
        float f[VN];
        Vec<T>::unpack(reinterpret_cast<const uint4*>(px)[v], f);
#pragma unroll
        for (int u = 0; u < VN; ++u) acc[k] = fmaf(f[u], wv[u], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PX_PER_GROUP; ++k) {
    const int p = grp + (NT / LANES) * k;
    const float sum = group_sum(acc[k]);
    const int yy = t.y0 + p / TS, xx = t.x0 + p % TS;
    if (lane8 == 0 && yy < H && xx < W)
      out[((long long)t.b * H + yy) * W + xx] = from_f<T>(sum);
  }
}

// any Cout and odd K: the weights in shared memory as float32 [tap][ci][co]
template <typename T>
__global__ void __launch_bounds__(NT)
conv_head_kernel(const T* __restrict__ h, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int Cin, int Cout, int K, int tiles_w, int tiles_h) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ uint4 smem_v[];
  const int IW = TS + K - 1;
  T* const hs = reinterpret_cast<T*>(smem_v);
  float* const ws = reinterpret_cast<float*>(
      smem_v + (IW * IW * Cin * (int)sizeof(T) + 15) / 16);
  const Tile t = tile_of(tiles_w, tiles_h);
  stage_h(h, hs, t, H, W, Cin, K);
  for (int idx = threadIdx.x; idx < K * K * Cin * Cout; idx += NT) ws[idx] = to_f(w[idx]);
  wait_staged();

  const int lane8 = threadIdx.x % LANES, grp = threadIdx.x / LANES;
  const int nv = Cin / VN;
  for (int k = 0; k < PX_PER_GROUP; ++k) {
    const int p = grp + (NT / LANES) * k;
    const int r = p / TS, col = p % TS;
    const int yy = t.y0 + r, xx = t.x0 + col;
    for (int co = 0; co < Cout; ++co) {
      float acc = lane8 == 0 ? to_f(bias[co]) : 0.f;
      for (int tap = 0; tap < K * K; ++tap) {
        const T* px = hs + ((r + tap / K) * IW + col + tap % K) * Cin;
        for (int v = lane8; v < nv; v += LANES) {
          float f[VN];
          Vec<T>::unpack(reinterpret_cast<const uint4*>(px)[v], f);
#pragma unroll
          for (int u = 0; u < VN; ++u)
            acc = fmaf(f[u], ws[(tap * Cin + v * VN + u) * Cout + co], acc);
        }
      }
      acc = group_sum(acc);
      if (lane8 == 0 && yy < H && xx < W)
        out[(((long long)t.b * H + yy) * W + xx) * Cout + co] = from_f<T>(acc);
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <typename T>
int launch(const void* h, const void* w, const void* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int K, void* stream) {
  constexpr int VN = Vec<T>::N;
  if (B < 1 || H < 1 || W < 1 || Cin < VN || Cin % VN != 0 || Cout < 1 ||
      K < 1 || K % 2 == 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int IW = TS + K - 1;
  const size_t h_bytes = ((size_t)IW * IW * Cin * sizeof(T) + 15) / 16 * 16;
  const int tiles_h = (H + TS - 1) / TS, tiles_w = (W + TS - 1) / TS;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const int nv = Cin / VN;
  int err;
  const size_t smem = h_bytes + sizeof(float) * (size_t)K * K * Cin * Cout;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (Cout == 1 && K == 3 && nv <= 2 * LANES) {
    if (nv <= LANES) {
      if ((err = set_smem(conv_head_c1_kernel<T, 1>, smem))) return err;
      conv_head_c1_kernel<T, 1><<<(unsigned)blocks, NT, smem, st>>>(
          hp, wp, bp, op, H, W, Cin, tiles_w, tiles_h);
    } else {
      if ((err = set_smem(conv_head_c1_kernel<T, 2>, smem))) return err;
      conv_head_c1_kernel<T, 2><<<(unsigned)blocks, NT, smem, st>>>(
          hp, wp, bp, op, H, W, Cin, tiles_w, tiles_h);
    }
  } else {
    if ((err = set_smem(conv_head_kernel<T>, smem))) return err;
    conv_head_kernel<T><<<(unsigned)blocks, NT, smem, st>>>(
        hp, wp, bp, op, H, W, Cin, Cout, K, tiles_w, tiles_h);
  }
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
