// K6 cell_backward: the ConvLSTM cell's gate backward, one pass over pixels.
//
// Replaces no TPU kernel of its own: on the TPU this is XLA's fusion of the
// gate algebra of _bwd (pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py
// :336-385), which the port ran as 38 eager PyTorch launches a call
// (ConvLSTMCellFn.backward in ops/kernels/convlstm_kernel.py;
// cell_backward_plain there is that code and this kernel's oracle).
//
// Computes, per pixel p and hidden channel j, in float32 from the forward's
// residuals z ([P, 4Ch] gate-major, i|f|o|g blocks of Ch, as K1 writes it),
// c, c' and the incoming gradients dh', dc' ([P, Ch]):
//   i, f, o = sigmoid(z_i, z_f, z_o),  g = tanh(z_g),  tc = tanh(c')
//   dc = dc' + dh' * o * (1 - tc * tc)
//   dz = [dc * g * i * (1 - i), dc * c * f * (1 - f),
//         dh' * tc * o * (1 - o), dc * i * (1 - g * g)]
//   dc_prev = dc * f
// and stores dz [P, 4Ch] in float32, dc_prev [P, Ch] rounded once to T,
// xh = concat(x, h) [P, Cx+Ch] in float32 (the input of the backward's
// convs) and db[n] = sum_p dz[p, n] rounded once to T.
// Each operation is the one the eager sequence does, in its order and with
// its rounding: __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from
// contracting a * b + c into one FMA, sigmoid is 1 / (1 + expf(-x)) with
// IEEE division (ATen's CUDA sigmoid), tanh is tanhf, and nothing is built
// with fast math. So dz and dc_prev equal the eager sequence's on the card
// up to the ulps by which expf / tanhf of two CUDA versions may differ; db
// is summed in another (fixed) order than ATen's reduction.
//
// What bounds it on the card: bytes. At nowcast_128's cells (B 4, 128^2,
// Ch 64, bf16) a pixel reads 1280 B (z 512; c, c', dh', dc', x, h 128 each)
// and writes 1664 B (dz 1024, dc_prev 128, xh 512): 193 MB a call, 57.6 us
// at 3.35 TB/s; cell 1 (Cx 1) 168 MB, 50 us. It does ~40 FLOP and 5
// transcendentals a pixel and channel, far below the ridge.
//
// Design:
// - A thread takes one pixel x V hidden channels: V = 8 where Ch % 8 == 0
//   and every operand is 16-byte aligned, else 1 (the scalar variant). With
//   V = 8 it loads each gate of z and each of c, c', dh', dc', h as one
//   16-byte vector in bf16 (two in float32) and stores dz (two vectors a
//   gate) and dc_prev likewise. Neighbouring threads take neighbouring
//   channel groups of one pixel, so a warp reads and writes whole 128-byte
//   runs. Everything stays in registers.
// - The same thread stores its h channels, and every G-th vector of x's, as
//   float32 into xh: 16-byte stores where Cx % 8 == 0 and x is aligned,
//   else element by element (cell 1's single channel of x).
// - db without float atomics, so that two launches give the same bits:
//   each thread sums its 4V columns of dz over its pixels (a fixed
//   grid-stride order), the block sums its threads' sums in shared memory
//   in a fixed order into one row of partials [blocks, 4Ch], and the last
//   block to finish (a counter, which that block resets for the next
//   launch) sums the rows in a fixed order and stores db. The grid depends
//   only on the shape and on the caller's cap (2 blocks an SM), so every
//   launch sums in the same order.
// - 256 threads a block, grid-stride over pixels with as few strides as the
//   cap allows; more than 256 channel groups split over blockIdx.y.
// - On an H100 this runs at ~65 % of the byte bound (PERF.md's kernel table).
//   Four channels a thread at 3 or 4 blocks an SM, and db's running sums
//   in shared memory instead of registers, came within 5 % of it either
//   way; what holds it there is not separated.
//
// The C entries launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for what
// they do not take). The caller allocates dz, dc_prev, xh, db, the
// partials [max_blocks, 4Ch] and the counter (one uint32, zero before the
// first launch; the kernel leaves it zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;            // threads a block
constexpr int MAX_PAD = 31;        // shared-memory row padding (bank spread)

struct Args {
  const void* z;
  const void* c;
  const void* cn;                  // c'
  const void* dh;                  // dh'
  const void* dc;                  // dc'
  const void* x;
  const void* h;
  float* dz;
  void* dc_prev;
  float* xh;
  void* db;
  float* partials;
  unsigned int* counter;
  long long P;                     // pixels: B * H * W
  int Cx, Ch;
  int G;                           // channel groups of V channels
  int Gb;                          // groups a block takes: min(G, NT)
  int ppb;                         // pixels a block takes at once: NT / Gb
  int pad;                         // row padding of the block's sums
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive values of T as float32 (V = 8: one 16-byte load in bf16,
// two in float32; the bf16 -> float32 widening is exact)
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
}

// V float32 values to float32 storage (V = 8: two 16-byte stores)
template <int V>
__device__ __forceinline__ void store_f(float* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = f[0];
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// V float32 values rounded once to T (V = 8: 16-byte stores)
template <typename T, int V>
__device__ __forceinline__ void store_t(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1 || sizeof(T) == 4) {
    if constexpr (V == 1) {
      p[0] = from_f<T>(f[0]);
    } else {
      store_f<V>(reinterpret_cast<float*>(p), f);
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ATen's CUDA sigmoid for float: one / (one + exp(-a)), IEEE division
__device__ __forceinline__ float sigmoid_f(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

template <typename T, int V, bool XV>
__global__ void __launch_bounds__(NT, 2)
cell_backward_kernel(const Args a) {
  __shared__ float red[4 * V * (NT + MAX_PAD)];
  __shared__ bool last;
  const T* __restrict__ z = static_cast<const T*>(a.z);
  const T* __restrict__ c = static_cast<const T*>(a.c);
  const T* __restrict__ cn = static_cast<const T*>(a.cn);
  const T* __restrict__ dh = static_cast<const T*>(a.dh);
  const T* __restrict__ dc = static_cast<const T*>(a.dc);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ h = static_cast<const T*>(a.h);
  T* __restrict__ dc_prev = static_cast<T*>(a.dc_prev);
  const int tid = threadIdx.x;
  const int qb = tid % a.Gb, r = tid / a.Gb;
  const int q = blockIdx.y * a.Gb + qb;          // this thread's channel group
  const int Ch = a.Ch, Cx = a.Cx, C4 = 4 * a.Ch, Cxh = a.Cx + a.Ch;

  float acc[4][V];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.0f;

  if (q < a.G && r < a.ppb) {
    const long long stride = (long long)gridDim.x * a.ppb;
    for (long long p = (long long)blockIdx.x * a.ppb + r; p < a.P; p += stride) {
      const size_t pc = (size_t)p * Ch + (size_t)q * V;    // [P, Ch] operands
      const size_t pz = (size_t)p * C4 + (size_t)q * V;    // z, dz: gate g at + g Ch
      float zi[V], zf[V], zo[V], zg[V], cv[V], cnv[V], dhv[V], dcv[V], hv[V];
      load_v<T, V>(z + pz, zi);
      load_v<T, V>(z + pz + Ch, zf);
      load_v<T, V>(z + pz + 2 * Ch, zo);
      load_v<T, V>(z + pz + 3 * Ch, zg);
      load_v<T, V>(c + pc, cv);
      load_v<T, V>(cn + pc, cnv);
      load_v<T, V>(dh + pc, dhv);
      load_v<T, V>(dc + pc, dcv);
      load_v<T, V>(h + pc, hv);
      float dcp[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float i = sigmoid_f(zi[e]), f = sigmoid_f(zf[e]);
        const float o = sigmoid_f(zo[e]), g = tanhf(zg[e]);
        const float tc = tanhf(cnv[e]);
        // dc_tot = dc' + dh * o * (1 - tc * tc), as (dh * o) * (1 - tc*tc)
        const float dct = __fadd_rn(
            dcv[e], __fmul_rn(__fmul_rn(dhv[e], o),
                              __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        const float d_o = __fmul_rn(dhv[e], tc);
        const float d_f = __fmul_rn(dct, cv[e]);
        dcp[e] = __fmul_rn(dct, f);
        const float d_i = __fmul_rn(dct, g);
        const float d_g = __fmul_rn(dct, i);
        // the gates' dz, each as (d * s) * (1 - s); the cell gate's
        // d * (1 - g * g); stored over the z values they came from
        zi[e] = __fmul_rn(__fmul_rn(d_i, i), __fsub_rn(1.0f, i));
        zf[e] = __fmul_rn(__fmul_rn(d_f, f), __fsub_rn(1.0f, f));
        zo[e] = __fmul_rn(__fmul_rn(d_o, o), __fsub_rn(1.0f, o));
        zg[e] = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(g, g)));
        acc[0][e] = __fadd_rn(acc[0][e], zi[e]);
        acc[1][e] = __fadd_rn(acc[1][e], zf[e]);
        acc[2][e] = __fadd_rn(acc[2][e], zo[e]);
        acc[3][e] = __fadd_rn(acc[3][e], zg[e]);
      }
      store_f<V>(a.dz + pz, zi);
      store_f<V>(a.dz + pz + Ch, zf);
      store_f<V>(a.dz + pz + 2 * Ch, zo);
      store_f<V>(a.dz + pz + 3 * Ch, zg);
      store_t<T, V>(dc_prev + pc, dcp);
      float* __restrict__ row = a.xh + (size_t)p * Cxh;
      const T* __restrict__ xp = x + (size_t)p * Cx;
      if constexpr (XV) {
        store_f<V>(row + Cx + q * V, hv);
        for (int j = q; j < Cx / 8; j += a.G) {
          float xv[8];
          load_v<T, 8>(xp + 8 * j, xv);
          store_f<8>(row + 8 * j, xv);
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) row[Cx + q * V + e] = hv[e];
        for (int j = q; j < Cx; j += a.G) row[j] = to_f(xp[j]);
      }
    }
  }

  // the block's sums: red[(g V + e) (NT + pad) + tid], then each column
  // (g, e, group) summed over the block's pixel rows r in order
  const int rs = NT + a.pad;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) red[(g * V + e) * rs + tid] = acc[g][e];
  __syncthreads();
  for (int col = tid; col < 4 * V * a.Gb; col += NT) {
    const int ge = col / a.Gb, qq = col % a.Gb;
    const int qg = blockIdx.y * a.Gb + qq;
    float s = 0.0f;
    for (int rr = 0; rr < a.ppb; ++rr) s = __fadd_rn(s, red[ge * rs + rr * a.Gb + qq]);
    if (qg < a.G)
      a.partials[(size_t)blockIdx.x * C4 + (ge / V) * Ch + qg * V + ge % V] = s;
  }

  // the last block sums the rows of every block, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nb = gridDim.x;
  T* const db = static_cast<T*>(a.db);
  for (int col = tid; col < C4; col += NT) {
    const float* pp = a.partials + col;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int b = 0;
#pragma unroll 4
    for (; b + 4 <= nb; b += 4) {
      s0 = __fadd_rn(s0, __ldcg(pp + (size_t)b * C4));
      s1 = __fadd_rn(s1, __ldcg(pp + (size_t)(b + 1) * C4));
      s2 = __fadd_rn(s2, __ldcg(pp + (size_t)(b + 2) * C4));
      s3 = __fadd_rn(s3, __ldcg(pp + (size_t)(b + 3) * C4));
    }
    for (; b < nb; ++b) s0 = __fadd_rn(s0, __ldcg(pp + (size_t)b * C4));
    db[col] = from_f<T>(__fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3)));
  }
  if (tid == 0) *a.counter = 0u;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* z, const void* c, const void* c_next,
           const void* dh_next, const void* dc_next, const void* x,
           const void* h, void* dz, void* dc_prev, void* xh, void* db,
           void* partials, void* counter, long long P, int Cx, int Ch,
           int max_blocks, void* stream) {
  if (P < 1 || Cx < 1 || Ch < 1 || max_blocks < 1 || Ch > (1 << 24) ||
      !z || !c || !c_next || !dh_next || !dc_next || !x || !h || !dz ||
      !dc_prev || !xh || !db || !partials || !counter)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Ch % 8 == 0 && aligned16(z) && aligned16(c) &&
                   aligned16(c_next) && aligned16(dh_next) &&
                   aligned16(dc_next) && aligned16(h) && aligned16(dz) &&
                   aligned16(dc_prev) && aligned16(xh);
  const bool xvec = vec && Cx % 8 == 0 && aligned16(x);
  Args a;
  a.z = z, a.c = c, a.cn = c_next, a.dh = dh_next, a.dc = dc_next;
  a.x = x, a.h = h;
  a.dz = static_cast<float*>(dz);
  a.dc_prev = dc_prev;
  a.xh = static_cast<float*>(xh);
  a.db = db;
  a.partials = static_cast<float*>(partials);
  a.counter = static_cast<unsigned int*>(counter);
  a.P = P, a.Cx = Cx, a.Ch = Ch;
  a.G = vec ? Ch / 8 : Ch;
  a.Gb = a.G < NT ? a.G : NT;
  a.ppb = NT / a.Gb;
  a.pad = a.Gb < 32 ? a.Gb : 0;
  const int gy = (a.G + a.Gb - 1) / a.Gb;
  // the fewest grid strides the cap allows, spread evenly over the blocks
  const long long units = (P + a.ppb - 1) / a.ppb;
  const long long strides = (units + max_blocks - 1) / max_blocks;
  const long long gx = (units + strides - 1) / strides;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xvec)
    cell_backward_kernel<T, 8, true><<<grid, NT, 0, st>>>(a);
  else if (vec)
    cell_backward_kernel<T, 8, false><<<grid, NT, 0, st>>>(a);
  else
    cell_backward_kernel<T, 1, false><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z [P, 4Ch]; c, c_next, dh_next, dc_next, h, dc_prev [P, Ch]; x [P, Cx];
// dz [P, 4Ch] and xh [P, Cx+Ch] float32; db [4Ch]; partials float32
// [max_blocks, 4Ch]; counter one uint32. All but dz, xh and partials in T.
extern "C" int cell_backward_f32(const void* z, const void* c,
                                 const void* c_next, const void* dh_next,
                                 const void* dc_next, const void* x,
                                 const void* h, void* dz, void* dc_prev,
                                 void* xh, void* db, void* partials,
                                 void* counter, long long P, int Cx, int Ch,
                                 int max_blocks, void* stream) {
  return launch<float>(z, c, c_next, dh_next, dc_next, x, h, dz, dc_prev, xh,
                       db, partials, counter, P, Cx, Ch, max_blocks, stream);
}

extern "C" int cell_backward_bf16(const void* z, const void* c,
                                  const void* c_next, const void* dh_next,
                                  const void* dc_next, const void* x,
                                  const void* h, void* dz, void* dc_prev,
                                  void* xh, void* db, void* partials,
                                  void* counter, long long P, int Cx, int Ch,
                                  int max_blocks, void* stream) {
  return launch<__nv_bfloat16>(z, c, c_next, dh_next, dc_next, x, h, dz,
                               dc_prev, xh, db, partials, counter, P, Cx, Ch,
                               max_blocks, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
