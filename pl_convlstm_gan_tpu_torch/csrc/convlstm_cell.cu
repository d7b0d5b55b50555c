// K1 convlstm_cell_fwd: one fused ConvLSTM cell step (forward), NHWC.
//
// Replaces the TPU kernels of pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py
// (_run_kernel / _kernel_body and _run_kernel_tiled / _tiled_kernel_body, the
// forward with save_z=False, and with save_z=True for training) and the
// cell_pass of pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py.
//
// Computes, per pixel p and hidden channel j:
//   z[g] = bias[g*Ch+j] + sum_{tap, ci} in[p+tap][ci] * w[tap][ci][g*Ch+j]
//   with in = concat(x, h) (zero outside the frame: SAME padding)
//   c' = sig(z_f) * c + sig(z_i) * tanh(z_g),  h' = sig(z_o) * tanh(c')
// The conv accumulates in float32, the bias is added in float32 (it seeds the
// accumulator, as in the TPU kernels), the gates run in float32, and h' and c'
// are stored in the operands' type (float32 or bfloat16).
// Training form (save_z=True): when the z pointer is not null, the epilogue
// also stores the pre-activation z = accumulator + bias, rounded once to the
// operands' type, NHWC [B,H,W,4Ch] gate-major (i|f|o|g blocks of Ch), as
// the TPU kernel's z_ref: the residual of the backward pass. A thread
// already holds all four gates of its (pixel, channel) pairs, so this is a
// store in the epilogue and the tiling does not change. The stores are not
// coalesced (a thread writes 4 gates Ch apart); that is left to a later
// change. With a null z nothing more is stored.
//
// What bounds it on the card: operations. At the nowcast_128 shape a launch
// does 2*65536*9*128*256 = 38.7 GFLOP against ~17 MB of traffic in bf16, far
// above the ridge of the tensor cores (~295 FLOP/B) and of the float32 cores.
//
// Design, float32 (on the CUDA cores; the tensor cores would round to TF32):
// - Each block owns an 8x16 pixel tile of one batch item and 32 hidden
//   channels (all four gates of each), i.e. a 128 x 128 slice of z.
// - Each thread owns 4 pixels of one tile row x 4 hidden channels and keeps
//   their 4 gate pre-activations in 64 float registers, so the gate epilogue
//   needs no exchange between threads.
// - The input tile plus its halo is staged in shared memory 8 input channels
//   at a time, read from x and h through two pointers: the concat is fused.
// - The weights do not fit whole (9 x 128 x 256 x 2 B = 590 KB in bf16), so
//   they are staged per input-channel chunk and per kernel row. A warp owns
//   one group of 4 channels, so its weight reads are broadcasts.
// - Any H, W, Cx, Ch (ragged edges masked) and any odd K.
// bfloat16 runs the same tiling on the tensor cores (mma.sync, f32
// accumulation): see convlstm_cell_mma_kernel below. wgmma and TMA, which
// the full tensor-core rate needs, are left to a later change.
//
// Aliasing: c_out may be c (an in-place update): every element of c is read
// and then written by the same thread, and by no other. h_out must differ
// from h and x, because neighbouring blocks read h's halo.
//
// Each C entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TH = 8;            // tile rows
constexpr int TW = 16;           // tile columns
constexpr int PX = 4;            // pixels per thread: columns pcol + 4*k
constexpr int CPT = 4;           // hidden channels per thread
constexpr int NWARP = 8;         // one channel group per warp
constexpr int CB = CPT * NWARP;  // hidden channels per block
constexpr int CK = 8;            // input channels per shared-memory chunk
constexpr int NT = 32 * NWARP;   // threads per block

__device__ __forceinline__ float sigmoid_f(float z) { return 1.f / (1.f + expf(-z)); }

__global__ void __launch_bounds__(NT)
convlstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* c, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ h_out,
                     float* c_out, float* __restrict__ z, int H, int W, int Cx,
                     int Ch, int K, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int IH = TH + K - 1, IW = TW + K - 1, pad = K / 2;
  float* in_s = smem;                 // [CK][IH][IW]
  float* w_s = smem + CK * IH * IW;   // [K][CK][CB][4]

  const int tid = threadIdx.x;
  const int cg = tid / 32;            // channel group (warp)
  const int pg = tid % 32;
  const int prow = pg / 4;            // tile row of this thread's pixels
  const int pcol = pg % 4;            // first column; the others are +4, +8, +12
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int j0 = blockIdx.y * CB;
  const long long b = blockIdx.z;
  const int Cin = Cx + Ch;
  const int Cz = 4 * Ch;

  float acc[PX][CPT][4];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int jj = j0 + cg * CPT + q;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bv = jj < Ch ? bias[g * Ch + jj] : 0.f;
#pragma unroll
      for (int k = 0; k < PX; ++k) acc[k][q][g] = bv;
    }
  }

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // stage concat(x, h)[c0:c0+CK] over the tile plus halo; channel fastest
    for (int idx = tid; idx < CK * IH * IW; idx += NT) {
      const int ci = idx % CK;
      const int p = idx / CK;
      const int r = p / IW, col = p % IW;
      const int gy = ty0 + r - pad, gx = tx0 + col - pad;
      const int cc = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && cc < Cin) {
        const long long pix = (b * H + gy) * W + gx;
        v = cc < Cx ? x[pix * Cx + cc] : h[pix * Ch + (cc - Cx)];
      }
      in_s[(ci * IH + r) * IW + col] = v;
    }
    for (int di = 0; di < K; ++di) {
      // stage w[di, :, c0:c0+CK, gates of channels j0:j0+CB] as [dj][ci][jl][g]
      for (int idx = tid; idx < K * CK * CB * 4; idx += NT) {
        const int jl = idx % CB;
        int rest = idx / CB;
        const int g = rest % 4;
        rest /= 4;
        const int ci = rest % CK;
        const int dj = rest / CK;
        const int cc = c0 + ci, jj = j0 + jl;
        float v = 0.f;
        if (cc < Cin && jj < Ch)
          v = w[((long long)(di * K + dj) * Cin + cc) * Cz + g * Ch + jj];
        w_s[((dj * CK + ci) * CB + jl) * 4 + g] = v;
      }
      __syncthreads();
      for (int dj = 0; dj < K; ++dj) {
#pragma unroll
        for (int ci = 0; ci < CK; ++ci) {
          const float* ip = in_s + (ci * IH + prow + di) * IW + pcol + dj;
          float a[PX];
#pragma unroll
          for (int k = 0; k < PX; ++k) a[k] = ip[4 * k];
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + ((dj * CK + ci) * CB + cg * CPT) * 4);
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const float4 wv = wp[q];
#pragma unroll
            for (int k = 0; k < PX; ++k) {
              acc[k][q][0] += a[k] * wv.x;
              acc[k][q][1] += a[k] * wv.y;
              acc[k][q][2] += a[k] * wv.z;
              acc[k][q][3] += a[k] * wv.w;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  const int gy = ty0 + prow;
  if (gy >= H) return;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int gx = tx0 + pcol + 4 * k;
    if (gx >= W) continue;
    const long long pix = (b * H + gy) * W + gx;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int jj = j0 + cg * CPT + q;
      if (jj >= Ch) continue;
      const long long o = pix * Ch + jj;
      if (z != nullptr) {
#pragma unroll
        for (int g = 0; g < 4; ++g) z[pix * Cz + g * Ch + jj] = acc[k][q][g];
      }
      const float ig = sigmoid_f(acc[k][q][0]);
      const float fg = sigmoid_f(acc[k][q][1]);
      const float og = sigmoid_f(acc[k][q][2]);
      const float gg = tanhf(acc[k][q][3]);
      const float cn = fg * c[o] + ig * gg;
      c_out[o] = cn;
      h_out[o] = og * tanhf(cn);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the same tile (8x16 pixels x 32 hidden channels, 256 threads) as
// an implicit GEMM on the tensor cores, mma.sync m16n8k16 (bf16 x bf16 ->
// f32). M = the tile's 128 pixels, N = 4 gates x 32 channels, K = taps x
// input channels. The N columns are ordered gate-major within each group of
// 8 channels, so a thread's accumulator fragments hold all four gates of the
// same (pixel, channel) pairs: the gate epilogue still needs no exchange.
// - Warp w owns tile rows 2*(w%4) and 2*(w%4)+1 (two m16 tiles: 16 pixels of
//   one row each) and channels 16*(w/4) .. +15 (two n8 groups x 4 gates).
// - Input channels are staged 32 at a time (two k16 steps per tap) as
//   [pixel][channel] bf16 rows padded to 40, and the weights per kernel row
//   as [dj][gate*32 + channel][input channel], padded to 40: every fragment
//   load is one conflict-free 32-bit shared-memory read.
// ---------------------------------------------------------------------------
constexpr int MK = 32;        // input channels per chunk
constexpr int MKP = MK + 8;   // padded row length (bf16) in shared memory
constexpr int MN = 4 * CB;    // GEMM columns per block (4 gates x 32 channels)

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT)
convlstm_cell_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ h,
                         const __nv_bfloat16* c,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ h_out,
                         __nv_bfloat16* c_out, __nv_bfloat16* __restrict__ z,
                         int H, int W, int Cx, int Ch, int K, int tiles_w) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem4);  // [IH*IW][MKP]
  const int IH = TH + K - 1, IW = TW + K - 1, pad = K / 2;
  __nv_bfloat16* w_s = in_s + IH * IW * MKP;                       // [K*MN][MKP]
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gq = lane % 4;     // fragment row group / column pair
  const int wm = warp % 4, wn = warp / 4;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int j0 = blockIdx.y * CB;
  const long long b = blockIdx.z;
  const int Cin = Cx + Ch;
  const int Cz = 4 * Ch;

  // acc[mt][cgp][g][e]: tile row 2*wm+mt; channel j0 + 16*wn + 8*cgp + 2*gq +
  // (e & 1); pixel column gr + 8*(e >> 1); gate g
  float acc[2][2][4][4];
#pragma unroll
  for (int cgp = 0; cgp < 2; ++cgp)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = j0 + 16 * wn + 8 * cgp + 2 * gq + e;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bv = jj < Ch ? __bfloat162float(bias[g * Ch + jj]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][cgp][g][e] = bv;
          acc[mt][cgp][g][e + 2] = bv;
        }
      }
    }

  for (int c0 = 0; c0 < Cin; c0 += MK) {
    for (int idx = tid; idx < IH * IW * MK; idx += NT) {
      const int ci = idx % MK;
      const int p = idx / MK;
      const int gy = ty0 + p / IW - pad, gx = tx0 + p % IW - pad;
      const int cc = c0 + ci;
      __nv_bfloat16 v = zero;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && cc < Cin) {
        const long long pix = (b * H + gy) * W + gx;
        v = cc < Cx ? x[pix * Cx + cc] : h[pix * Ch + (cc - Cx)];
      }
      in_s[p * MKP + ci] = v;
    }
    for (int di = 0; di < K; ++di) {
      for (int idx = tid; idx < K * MK * MN; idx += NT) {
        const int jl = idx % CB;
        int rest = idx / CB;
        const int g = rest % 4;
        rest /= 4;
        const int ci = rest % MK;
        const int dj = rest / MK;
        const int cc = c0 + ci, jj = j0 + jl;
        __nv_bfloat16 v = zero;
        if (cc < Cin && jj < Ch)
          v = w[((long long)(di * K + dj) * Cin + cc) * Cz + g * Ch + jj];
        w_s[(dj * MN + g * CB + jl) * MKP + ci] = v;
      }
      __syncthreads();
      for (int dj = 0; dj < K; ++dj) {
#pragma unroll
        for (int ks = 0; ks < MK / 16; ++ks) {
          const int k0 = ks * 16 + 2 * gq;
          uint32_t bf[2][4][2];
#pragma unroll
          for (int cgp = 0; cgp < 2; ++cgp)
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const __nv_bfloat16* bp =
                  w_s + (dj * MN + g * CB + 16 * wn + 8 * cgp + gr) * MKP + k0;
              bf[cgp][g][0] = *reinterpret_cast<const uint32_t*>(bp);
              bf[cgp][g][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
            }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* ap =
                in_s + ((2 * wm + mt + di) * IW + gr + dj) * MKP + k0;
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(ap);
            af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * MKP);
            af[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
            af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * MKP + 8);
#pragma unroll
            for (int cgp = 0; cgp < 2; ++cgp)
#pragma unroll
              for (int g = 0; g < 4; ++g)
                mma_bf16_16816(acc[mt][cgp][g], af, bf[cgp][g][0], bf[cgp][g][1]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = ty0 + 2 * wm + mt;
    if (gy >= H) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gx = tx0 + gr + 8 * (e >> 1);
      if (gx >= W) continue;
      const long long pix = (b * H + gy) * W + gx;
#pragma unroll
      for (int cgp = 0; cgp < 2; ++cgp) {
        const int jj = j0 + 16 * wn + 8 * cgp + 2 * gq + (e & 1);
        if (jj >= Ch) continue;
        const long long o = pix * Ch + jj;
        if (z != nullptr) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            z[pix * Cz + g * Ch + jj] = __float2bfloat16(acc[mt][cgp][g][e]);
        }
        const float ig = sigmoid_f(acc[mt][cgp][0][e]);
        const float fg = sigmoid_f(acc[mt][cgp][1][e]);
        const float og = sigmoid_f(acc[mt][cgp][2][e]);
        const float gg = tanhf(acc[mt][cgp][3][e]);
        const float cn = fg * __bfloat162float(c[o]) + ig * gg;
        c_out[o] = __float2bfloat16(cn);
        h_out[o] = __float2bfloat16(og * tanhf(cn));
      }
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kern, size_t smem, const void* x, const void* h,
           const void* c, const void* w, const void* bias, void* h_out,
           void* c_out, void* z, int B, int H, int W, int Cx, int Ch, int K,
           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cx < 1 || Ch < 1 || K < 1 ||
      K % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Ch + CB - 1) / CB, B);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(h_out),
      static_cast<T*>(c_out), static_cast<T*>(z), H, W, Cx, Ch, K, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z may be null (serving: h' and c' only) or [B,H,W,4Ch] (training).
extern "C" int convlstm_cell_fwd_f32(const void* x, const void* h,
                                     const void* c, const void* w,
                                     const void* bias, void* h_out,
                                     void* c_out, void* z, int B, int H, int W,
                                     int Cx, int Ch, int K, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(CK * (TH + K - 1) * (TW + K - 1) +
                                               K * CK * CB * 4);
  return launch<float>(convlstm_cell_kernel, smem, x, h, c, w, bias,
                       h_out, c_out, z, B, H, W, Cx, Ch, K, stream);
}

extern "C" int convlstm_cell_fwd_bf16(const void* x, const void* h,
                                      const void* c, const void* w,
                                      const void* bias, void* h_out,
                                      void* c_out, void* z, int B, int H,
                                      int W, int Cx, int Ch, int K,
                                      void* stream) {
  const size_t smem = sizeof(__nv_bfloat16) * MKP *
                      (size_t)((TH + K - 1) * (TW + K - 1) + K * MN);
  return launch<__nv_bfloat16>(convlstm_cell_mma_kernel, smem, x, h, c, w,
                               bias, h_out, c_out, z, B, H, W, Cx, Ch, K,
                               stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
