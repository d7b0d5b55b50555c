// K2's tile as device functions: the forecaster's conv head over one 8x8
// pixel tile of one batch item, run by 128 threads. Shared by K2's kernels
// (csrc/conv_head.cu, one tile a block) and K5's head phases
// (csrc/rollout_persistent.cu, one tile a warpgroup at a time), so that
// both run the same arithmetic in the same order. The design is set out in
// conv_head.cu's source note. A tile's h is staged (stage_h, by cp.async)
// and the weights (stage_w, as float32), then the tile is computed
// (head_compute_c1 for the forecaster's head, Cout 1 and K 3, or
// head_compute_generic), so that a caller may keep the weights staged
// across tiles and stage the next tiles' h while it computes one. `tid` is
// the thread's index among the 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int HEAD_TS = 8;         // tile rows and columns
constexpr int HEAD_NT = 128;       // threads: 16 groups of 8 lanes
constexpr int HEAD_LANES = 8;      // lanes that share a pixel
constexpr int HEAD_PX_PER_GROUP = HEAD_TS * HEAD_TS / (HEAD_NT / HEAD_LANES);

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

// 16 bytes from src past L1, or zeros when !in (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

struct HeadTileAt {
  int b, y0, x0;
};

// tile m of B x tiles_h x tiles_w, column-fastest
__device__ __forceinline__ HeadTileAt head_tile_at(int m, int tiles_w, int tiles_h) {
  HeadTileAt t;
  t.x0 = (m % tiles_w) * HEAD_TS;
  m /= tiles_w;
  t.y0 = (m % tiles_h) * HEAD_TS;
  t.b = m / tiles_h;
  return t;
}

// the tile of h plus its halo, [TS+K-1][TS+K-1][Cin], by 16-byte copies
template <typename T>
__device__ __forceinline__ void stage_h(const T* h, T* hs, const HeadTileAt& t, int H,
                                        int W, int Cin, int K, int tid) {
  const int nv = Cin / Vec<T>::N, IW = HEAD_TS + K - 1, pad = K / 2;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(hs));
  for (int idx = tid; idx < IW * IW * nv; idx += HEAD_NT) {
    const int v = idx % nv, pp = idx / nv;
    const int yy = t.y0 + pp / IW - pad, xx = t.x0 + pp % IW - pad;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* src = in ? h + (((long long)t.b * H + yy) * W + xx) * Cin + v * Vec<T>::N : h;
    cp_async16_zfill(dst + 16 * idx, src, in);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// the sum over the 8 lanes of a pixel group
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = HEAD_LANES / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shared memory of one tile's h with its halo (16-byte multiple), and
// of the weights as float32
__host__ __device__ __forceinline__ size_t head_h_bytes(int Cin, int K, int elem) {
  const size_t iw = HEAD_TS + K - 1;
  return (iw * iw * Cin * elem + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ size_t head_w_bytes(int Cin, int Cout, int K) {
  return sizeof(float) * (size_t)K * K * Cin * Cout;
}

// the weights HWIO [K][K][Cin][Cout] as float32 in shared memory, by
// `threads` threads
template <typename T>
__device__ __forceinline__ void stage_w(const T* __restrict__ w, float* ws, int n, int tid,
                                        int threads) {
  for (int idx = tid; idx < n; idx += threads) ws[idx] = to_f(w[idx]);
}

// Cout 1, K 3, from a staged tile hs (stage_h) and weights ws (stage_w):
// the weights [tap][ci] as float32; a lane reads its channels' weights of a
// tap once for its 4 pixels. VPL = 16-byte vectors of h a lane (Cin <= 8 *
// VPL * Vec<T>::N).
template <typename T, int VPL>
__device__ __forceinline__ void head_compute_c1(const T* __restrict__ bias,
                                                T* __restrict__ out, int H, int W,
                                                int Cin, const HeadTileAt& t,
                                                const T* hs, const float* ws, int tid) {
  constexpr int K = 3, IW = HEAD_TS + K - 1, VN = Vec<T>::N;
  const int lane8 = tid % HEAD_LANES, grp = tid / HEAD_LANES;
  const int nv = Cin / VN;
  const float b0 = lane8 == 0 ? to_f(bias[0]) : 0.f;

  // the group's 4 pixels side by side: four independent FMA chains
  float acc[HEAD_PX_PER_GROUP];
#pragma unroll
  for (int k = 0; k < HEAD_PX_PER_GROUP; ++k) acc[k] = b0;
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = lane8 + HEAD_LANES * j;
      if (v >= nv) continue;
      float wv[VN];
#pragma unroll
      for (int u = 0; u < VN; u += 4) {
        const float4 q = reinterpret_cast<const float4*>(ws + tap * Cin + v * VN + u)[0];
        wv[u] = q.x, wv[u + 1] = q.y, wv[u + 2] = q.z, wv[u + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < HEAD_PX_PER_GROUP; ++k) {
        const int p = grp + (HEAD_NT / HEAD_LANES) * k;  // a warp: 4 neighbouring pixels
        const T* px = hs + ((p / HEAD_TS + tap / K) * IW + p % HEAD_TS + tap % K) * Cin;
        float f[VN];
        Vec<T>::unpack(reinterpret_cast<const uint4*>(px)[v], f);
#pragma unroll
        for (int u = 0; u < VN; ++u) acc[k] = fmaf(f[u], wv[u], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < HEAD_PX_PER_GROUP; ++k) {
    const int p = grp + (HEAD_NT / HEAD_LANES) * k;
    const float sum = group_sum(acc[k]);
    const int yy = t.y0 + p / HEAD_TS, xx = t.x0 + p % HEAD_TS;
    if (lane8 == 0 && yy < H && xx < W)
      out[((long long)t.b * H + yy) * W + xx] = from_f<T>(sum);
  }
}

// any Cout and odd K, from a staged tile hs and weights ws: the weights as
// float32 [tap][ci][co]
template <typename T>
__device__ __forceinline__ void head_compute_generic(const T* __restrict__ bias,
                                                     T* __restrict__ out, int H, int W,
                                                     int Cin, int Cout, int K,
                                                     const HeadTileAt& t, const T* hs,
                                                     const float* ws, int tid) {
  constexpr int VN = Vec<T>::N;
  const int IW = HEAD_TS + K - 1;
  const int lane8 = tid % HEAD_LANES, grp = tid / HEAD_LANES;
  const int nv = Cin / VN;
  for (int k = 0; k < HEAD_PX_PER_GROUP; ++k) {
    const int p = grp + (HEAD_NT / HEAD_LANES) * k;
    const int r = p / HEAD_TS, col = p % HEAD_TS;
    const int yy = t.y0 + r, xx = t.x0 + col;
    for (int co = 0; co < Cout; ++co) {
      float acc = lane8 == 0 ? to_f(bias[co]) : 0.f;
      for (int tap = 0; tap < K * K; ++tap) {
        const T* px = hs + ((r + tap / K) * IW + col + tap % K) * Cin;
        for (int v = lane8; v < nv; v += HEAD_LANES) {
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

}  // namespace
