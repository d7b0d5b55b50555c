// K3 tap_loop_kernel and K4 tap_k1152_kernel: the tap-structure experiment.
//
// Replace the TPU kernels of experiments/pallas_tap_structure.py: taps_kernel
// (:15, pallas_call :48) and big_kernel (:25, pallas_call :52). The question
// they ask: does one contraction of K = 9*128 = 1152 beat nine of K = 128,
// the two ways to write the 3x3 conv of the ConvLSTM cell (one im2col GEMM,
// or an implicit GEMM over 9 taps)?
//
// Both compute out[M, N] = bf16(float32 sum of REPS repetitions), bf16
// operands, f32 accumulators in registers:
//   K3: a repetition adds the 9 products a9[t] @ w9[t], a9 [9, M, K] and
//       w9 [9, K, N], one by one into the accumulator;
//   K4: a repetition adds the one product abig @ wbig, abig [M, 9K] and
//       wbig [9K, N].
// As in the TPU kernels (acc = acc + dot(...)), each product is formed on its
// own, in a fresh float32 partial sum, and then added to the carried
// accumulator: K3 adds 9 partial sums a repetition, K4 one.
//
// What bounds it on the card: operations. At the experiment's shape (M 1024,
// K 128, N 256, REPS 64) both do 2*1024*1152*256*64 = 38.65 GFLOP on 3.5 MB
// of operands and output: 0.039 ms at the 989 TFLOP/s of the bf16 tensor
// cores, 1 us of memory traffic.
//
// Design, one code path for both kernels (tap_body below), so that the
// structure of the contraction is the only difference:
// - One block per 64 x 32 output tile: 16 x 8 = 128 blocks, one wave on
//   97 % of the 132 SMs (64 x 64 tiles would give 64 blocks, half the card).
//   4 warps, each a 32 x 16 sub-tile: 2 x 2 mma.sync m16n8k16 tiles (bf16 x
//   bf16 -> f32).
// - The block stages its operands once, whole, into shared memory, as the
//   TPU kernels find theirs in VMEM: its 64 rows of A as [row][9K] (a9's 9
//   tap slices side by side) and its 32 columns of B transposed as
//   [column][9K]. Rows are padded by 8 bf16 (2,320 bytes at 9K = 1152), so
//   the 8 row addresses of an ldmatrix fall on distinct banks. 222,720 bytes
//   of the 227 KB a block may use.
// - The REPS loop then reloads the fragments from shared memory (ldmatrix)
//   and issues the mma.sync of every repetition; both are asm volatile, so
//   the compiler can neither hoist them out of the loop nor merge
//   repetitions. K3 runs 9 segments of K/16 = 8 k-steps a repetition, K4 one
//   segment of 72: the same fragment loads and mma's, the same tiles.
// wgmma and TMA belong to the K1 redesign this experiment informs.
//
// Each C entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;             // output rows per block
constexpr int BN = 32;             // output columns per block
constexpr int WM = 32;             // rows per warp (2 m16 tiles)
constexpr int WN = 16;             // columns per warp (2 n8 tiles)
constexpr int NT = 32 * (BM / WM) * (BN / WN);   // 128 threads
constexpr int PAD = 8;             // bf16 of padding per shared-memory row
constexpr int TAPS = 9;
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[M, N] = bf16(sum over reps and SEGS segments of A_seg @ B_seg), where
// the contraction of length KT is cut into SEGS segments of KT / SEGS. A's
// element (row m, k) lies at a[(k / seg) * a_seg_stride + m * a_row_stride +
// k % seg] (a9: seg K, a_seg_stride M*K, a_row_stride K; abig: seg KT,
// a_row_stride KT). B is [KT, N] row-major for both (w9 [9, K, N] is laid out
// as wbig [9K, N]).
template <int SEGS>
__device__ __forceinline__ void tap_body(const __nv_bfloat16* __restrict__ a,
                                         const __nv_bfloat16* __restrict__ w,
                                         __nv_bfloat16* __restrict__ out,
                                         int N, int KT, long long a_seg_stride,
                                         int a_row_stride, int reps) {
  extern __shared__ float4 smem4[];
  const int LD = KT + PAD;
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BM][LD]
  __nv_bfloat16* b_s = a_s + BM * LD;                              // [BN][LD]
  const int seg = KT / SEGS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // stage A, 8 bf16 (16 bytes) a load; a vector never straddles a segment
  const int kv = KT / 8;
  for (int idx = tid; idx < BM * kv; idx += NT) {
    const int r = idx / kv, k = (idx % kv) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        a + (k / seg) * a_seg_stride + (long long)(m0 + r) * a_row_stride + k % seg);
    *reinterpret_cast<uint4*>(a_s + r * LD + k) = v;
  }
  // stage B transposed: b_s[n][k] = w[k][n0 + n]
  constexpr int NV = BN / 8;
  for (int idx = tid; idx < KT * NV; idx += NT) {
    const int k = idx / NV, n = (idx % NV) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(w + (long long)k * N + n0 + n);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) b_s[(n + i) * LD + k] = e[i];
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % (BM / WM)) * WM, wn = (warp / (BM / WM)) * WN;
  // ldmatrix row addresses of this lane. A, an m16 x k16 tile: matrices 0-3
  // are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
  // k 8-15), giving the a0..a3 fragments. B, two n8 x k16 tiles: (n 0-7, k
  // 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), giving b0, b1 of
  // the first tile and b0, b1 of the second.
  const int a_row = lane % 8 + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);
  const __nv_bfloat16* a_p0 = a_s + (wm + a_row) * LD + a_col;
  const __nv_bfloat16* a_p1 = a_p0 + 16 * LD;
  const __nv_bfloat16* b_p = b_s + (wn + b_row) * LD + b_col;

  // acc[mt][nt][e]: row wm + 16*mt + lane/4 + 8*(e >> 1), column wn + 8*nt +
  // 2*(lane % 4) + (e & 1)
  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int rep = 0; rep < reps; ++rep) {
    for (int s = 0; s < SEGS; ++s) {
      float part[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
      const int k_end = (s + 1) * seg;
#pragma unroll 8
      for (int k = s * seg; k < k_end; k += 16) {
        uint32_t af0[4], af1[4], bf[4];
        ldmatrix_x4(af0, a_p0 + k);
        ldmatrix_x4(af1, a_p1 + k);
        ldmatrix_x4(bf, b_p + k);
        mma_bf16_16816(part[0][0], af0, bf[0], bf[1]);
        mma_bf16_16816(part[0][1], af0, bf[2], bf[3]);
        mma_bf16_16816(part[1][0], af1, bf[0], bf[1]);
        mma_bf16_16816(part[1][1], af1, bf[2], bf[3]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  }

  const int gr = lane / 4, gq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const long long row = m0 + wm + 16 * mt + gr;
      const int col = n0 + wn + 8 * nt + 2 * gq;
      *reinterpret_cast<__nv_bfloat162*>(out + row * N + col) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * N + col) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

__global__ void __launch_bounds__(NT)
tap_loop_kernel(const __nv_bfloat16* __restrict__ a9,
                const __nv_bfloat16* __restrict__ w9,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int reps) {
  tap_body<TAPS>(a9, w9, out, N, TAPS * K, (long long)M * K, K, reps);
}

__global__ void __launch_bounds__(NT)
tap_k1152_kernel(const __nv_bfloat16* __restrict__ abig,
                 const __nv_bfloat16* __restrict__ wbig,
                 __nv_bfloat16* __restrict__ out, int KT, int N, int reps) {
  tap_body<1>(abig, wbig, out, N, KT, 0, KT, reps);
}

size_t smem_bytes(int KT) {
  return sizeof(__nv_bfloat16) * (size_t)(BM + BN) * (size_t)(KT + PAD);
}

// the shapes the tiling takes: whole tiles, whole k16 steps per segment, and
// both operand slices in one block's shared memory
bool shape_ok(int M, int N, int KT, int seg, int reps) {
  return M > 0 && N > 0 && seg > 0 && reps >= 0 && M % BM == 0 &&
         N % BN == 0 && seg % 16 == 0 && M / BM <= 65535 &&
         smem_bytes(KT) <= (size_t)MAX_SMEM;
}

template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// K3: a9 [9, M, K], w9 [9, K, N], out [M, N], all bf16 and contiguous.
extern "C" int tap_loop_bf16(const void* a9, const void* w9, void* out, int M,
                             int K, int N, int reps, void* stream) {
  if (!shape_ok(M, N, TAPS * K, K, reps))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(TAPS * K);
  const cudaError_t e = prepare(tap_loop_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / BN, M / BM);
  tap_loop_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a9), static_cast<const __nv_bfloat16*>(w9),
      static_cast<__nv_bfloat16*>(out), M, K, N, reps);
  return static_cast<int>(cudaGetLastError());
}

// K4: abig [M, KT], wbig [KT, N], out [M, N], all bf16 and contiguous.
extern "C" int tap_k1152_bf16(const void* abig, const void* wbig, void* out,
                              int M, int KT, int N, int reps, void* stream) {
  if (!shape_ok(M, N, KT, KT, reps))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(KT);
  const cudaError_t e = prepare(tap_k1152_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / BN, M / BM);
  tap_k1152_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(abig),
      static_cast<const __nv_bfloat16*>(wbig), static_cast<__nv_bfloat16*>(out),
      KT, N, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
