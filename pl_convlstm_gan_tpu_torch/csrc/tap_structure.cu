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
// accumulator: K3 adds 9 partial sums a repetition, K4 one. Every
// repetition's products are issued on the tensor cores.
//
// What bounds it on the card: operations. At the experiment's shape (M 1024,
// K 128, N 256, REPS 64) both do 2*1024*1152*256*64 = 38.65 GFLOP on 3.5 MB
// of operands and output: 0.039 ms at the 989 TFLOP/s of the bf16 tensor
// cores, 1 us of memory traffic.
//
// Design, one code path for both kernels (tap_body below), so that the
// structure of the contraction is the only difference:
// - A 64 x 64 output tile per cluster of 2 blocks, split along the
//   contraction: 16 x 4 tiles, 128 blocks, one wave on 97 % of the 132 SMs.
//   Block rank r of the pair takes k-blocks (64 wide) r, r + 2, r + 4, ...:
//   one 64-column half of every tap of K3, one 128-byte swizzle span. A
//   block is one warpgroup (128 threads) issuing wgmma.mma_async m64n64k16
//   (bf16 x bf16 -> f32), both operands read from shared memory by
//   descriptor, the sums in registers (32 f32 a thread per set).
// - Why the pair: a 64 x 32 tile (one block per SM, all of K) would read 3
//   KB of shared memory a k16 step (24 clocks at 128 B a clock) for 16
//   clocks of tensor-core work; at 64 x 64 a step reads 4 KB for 32 clocks,
//   and half of K keeps a block's operands inside its shared memory.
// - The operands stay resident, as the TPU kernels find theirs in VMEM:
//   thread 0 stages the block's 64 rows of A and 64 columns of B, for its
//   k-blocks, once, by TMA (cp.async.bulk.tensor) with one mbarrier's
//   completion, both in the 128-byte swizzle: A K-major (8 KB a k-block, as
//   K1's tiles), B as it lies in w9 / wbig, N-major, one 128-byte row of 64
//   columns a k (8 KB a k-block), read by wgmma through the instruction's
//   transpose bit: no transpose pass. 9 k-blocks a block at 9K = 1152:
//   147,456 bytes. The REPS loop then reads shared memory only.
// - A segment is one fresh partial: K3's is one tap (its block's half: 1
//   k-block, 4 k16 steps), K4's the whole contraction (9 k-blocks, 36
//   steps). A segment's first wgmma has scale-d = 0 (the fresh partial
//   sum), the rest add to it; the segment is one commit group. Before its
//   partial is added to the accumulator the group must be complete
//   (wgmma.wait_group): K3 waits 9 times a repetition, K4 once. That
//   difference is the experiment's question on this card. Two partial sets
//   alternate, so segment s + 1's wgmmas are in flight while segment s's
//   partial is waited for and added.
// - A segment is unrolled at compile time (K3 and K4 are the two
//   instantiations of one template), and the loop over segments goes by
//   pairs, so the same partial set is in flight at its head on every path.
//   With a run-time loop over a segment's k-blocks, or an odd trip count
//   inside the loop, ptxas cannot tell which group a wait retires: it
//   inserts warpgroup.arrive and serializes the wgmmas (C7514 / C7515),
//   and the kernels ran at 170-330 TFLOP/s instead of ~800 on an H100.
// - The pair's sum: rank 1 leaves its accumulator in its shared memory,
//   rank 0 reads it over distributed shared memory (mapa, ld.shared::
//   cluster) between two cluster barriers, adds it to its own and stores
//   bf16. The summation order changes only inside float32.
//
// Each C entry encodes its two TMA maps on the host per launch, launches on
// the given stream, allocates nothing, and returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;                 // output rows a tile: the wgmma's M
constexpr int BN = 64;                 // output columns a tile: the wgmma's N
constexpr int BK = 64;                 // contraction a k-block
constexpr int PAIR = 2;                // blocks a tile (a cluster), split along K
constexpr int NT = 128;                // one warpgroup
constexpr int TAPS = 9;
constexpr int K3_SEG = 128;            // K3's segment: one tap
constexpr int KT = TAPS * K3_SEG;      // the contraction, K4's one segment
constexpr int A_TILE = BM * BK * 2;    // bytes of A a k-block (8 KB)
constexpr int B_TILE = BK * BN * 2;    // bytes of B a k-block (8 KB)
constexpr int RED_BYTES = BM * BN * 4; // rank 1's accumulator for rank 0
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may use

// d (+)= A B for a 64 x 16 A tile (K-major) and a 16 x 64 B tile (N-major:
// transpose bit set); d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// one segment into the fresh partial p: the block's k-blocks kb0 .. kb0 +
// SEG_KB - 1, one commit group. Both tiles are 128-byte swizzled with 8-row
// groups 1024 B apart, so sw128_desc describes A (K-major) and B (N-major,
// transpose bit) alike; a k16 step is +32 bytes in A and +16 rows in B.
template <int SEG_KB>
__device__ __forceinline__ void issue_segment(float (&p)[32], uint64_t da0,
                                              uint64_t db0, int kb0) {
  uint64_t da = da0 + (uint64_t)kb0 * (A_TILE >> 4);
  uint64_t db = db0 + (uint64_t)kb0 * (B_TILE >> 4);
  // opaque: each segment adds its offsets to two registers, rather than
  // the compiler keeping all 8 * SEG_KB descriptors live across the loop
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int kb = 0; kb < SEG_KB; ++kb) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n64k16(p, da + kb * (A_TILE >> 4) + 2 * k,
                      db + kb * (B_TILE >> 4) + (16 * BN * 2 >> 4) * k,
                      kb > 0 || k > 0);
  }
  wgmma_commit();
}

// acc += the partial of the segment before the one just issued
__device__ __forceinline__ void retire(float (&acc)[32], float (&done)[32]) {
  wgmma_wait<1>();
  fence_acc(done);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += done[i];
  fence_acc(done);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct TapArgs {
  __nv_bfloat16* out;
  int M, N, reps;
};

// out[M, N] = bf16(sum over reps and SEGS segments of A_seg @ B_seg). A
// segment is seg = 2 * SEG_KB k-blocks of 64, SEG_KB a block; the
// contraction KT = SEGS * seg = 1152 either way. Rank r of the pair stages
// k-blocks j = 2 i + r (i = 0 .. 8): A's at (64 j % seg, (64 j / seg) * M
// + m0) of the 2-D map tm_a [SEGS * M, seg] (a9 with its taps stacked;
// abig as it is), B's the 64 rows 64 j.. of tm_b [KT, N] at column n0.
template <int SEGS, int SEG_KB>
__device__ __forceinline__ void tap_body(const CUtensorMap* tm_a,
                                         const CUtensorMap* tm_b,
                                         const TapArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  // [A k-blocks][B k-blocks][mbarrier][rank 1's accumulator], from a
  // 1024-byte boundary (the 128-byte swizzle's atom)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr int n_kb = SEGS * SEG_KB;
  constexpr int seg = PAIR * SEG_KB * BK;
  const uint32_t b_base = base + n_kb * A_TILE;
  const uint32_t bar = b_base + n_kb * B_TILE;
  float* const red = reinterpret_cast<float*>(smem_raw + (bar + 16 - raw));
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / PAIR) * BN;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, n_kb * (A_TILE + B_TILE));
    for (int i = 0; i < n_kb; ++i) {
      const int k = (PAIR * i + (int)rank) * BK;
      tma_load_2d(base + i * A_TILE, tm_a, bar, k % seg, (k / seg) * a.M + m0);
      tma_load_2d(b_base + i * B_TILE, tm_b, bar, n0, k);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);

  const uint64_t da0 = sw128_desc(base), db0 = sw128_desc(b_base);
  float acc[32], p0[32], p1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = p0[i] = p1[i] = 0.f;
  // segment g takes the block's k-blocks (g % SEGS) * SEG_KB ..; partial
  // set g % 2. By pairs: p0's group alone is in flight at the loop's head.
  const long long total = (long long)a.reps * SEGS;
  if (total > 0) {
    issue_segment<SEG_KB>(p0, da0, db0, 0);
    long long g = 1;
    for (; g + 1 < total; g += 2) {
      issue_segment<SEG_KB>(p1, da0, db0, (int)(g % SEGS) * SEG_KB);
      retire(acc, p0);
      issue_segment<SEG_KB>(p0, da0, db0, (int)((g + 1) % SEGS) * SEG_KB);
      retire(acc, p1);
    }
    if (g < total) {                   // an even count: the last into p1
      issue_segment<SEG_KB>(p1, da0, db0, (int)(g % SEGS) * SEG_KB);
      retire(acc, p0);
      wgmma_wait<0>();
      fence_acc(p1);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += p1[i];
    } else {
      wgmma_wait<0>();
      fence_acc(p0);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += p0[i];
    }
  }

  // the pair's sum: each thread of rank 0 adds what the same thread of
  // rank 1 holds, 4 values a 16-byte access
  const int tid = threadIdx.x;
  if (rank == 1) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      reinterpret_cast<float4*>(red)[q * NT + tid] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  cluster_sync();
  if (rank == 0) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(smem_addr(red)), "r"(1u));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[4];
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(remote + 16 * (q * NT + tid)));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * q + e] += v[e];
    }
    // acc[i]: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column
    // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the tile
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const long long row = m0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(a.out + row * a.N + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
  cluster_sync();                      // rank 1's shared memory outlives the read
}

__global__ void __cluster_dims__(PAIR, 1, 1) __launch_bounds__(NT, 1)
tap_loop_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const TapArgs a) {
  tap_body<TAPS, K3_SEG / (PAIR * BK)>(&tm_a, &tm_b, a);
}

__global__ void __cluster_dims__(PAIR, 1, 1) __launch_bounds__(NT, 1)
tap_k1152_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, const TapArgs a) {
  tap_body<1, KT / (PAIR * BK)>(&tm_a, &tm_b, a);
}

// [A k-blocks][B k-blocks][mbarrier, padded to 16][rank 1's accumulator]
// past the alignment slack: 164,880 bytes
constexpr size_t SMEM_BYTES =
    1024 + (size_t)(KT / (PAIR * BK)) * (A_TILE + B_TILE) + 16 + RED_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "a block's operands must stay resident");

// the shapes the kernels take: whole tiles, the compiled contraction and
// segment (seg_want), reps >= 0
bool shape_ok(int M, int N, int kt, int seg, int seg_want, int reps) {
  return M > 0 && N > 0 && reps >= 0 && M % BM == 0 && N % BN == 0 &&
         M / BM <= 65535 && kt == KT && seg == seg_want;
}

// A as a 2-D map [segs * M, seg], B [KT, N]; boxes of 64 x one k-block in
// the 128-byte swizzle
template <typename Kernel>
int launch(Kernel kern, const void* a_ptr, const void* w, void* out, int M,
           int N, int seg, int segs, int seg_want, int reps, void* stream) {
  if (!shape_ok(M, N, seg * segs, seg, seg_want, reps))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_a, tm_b;
  const cuuint64_t a_dims[2] = {(cuuint64_t)seg, (cuuint64_t)segs * M};
  const cuuint64_t a_strides[1] = {2ull * seg};
  const cuuint32_t a_box[2] = {BK, BM};
  int err = encode_map(&tm_a, a_ptr, 2, a_dims, a_strides, a_box);
  if (!err) {
    const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)KT};
    const cuuint64_t b_strides[1] = {2ull * N};
    const cuuint32_t b_box[2] = {BN, BK};
    err = encode_map(&tm_b, w, 2, b_dims, b_strides, b_box);
  }
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  TapArgs a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M, a.N = N, a.reps = reps;
  const dim3 grid(PAIR * (N / BN), M / BM);
  kern<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(tm_a, tm_b, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: a9 [9, M, K], w9 [9, K, N], out [M, N], all bf16, contiguous and
// 16-byte aligned; K = 128.
extern "C" int tap_loop_bf16(const void* a9, const void* w9, void* out, int M,
                             int K, int N, int reps, void* stream) {
  return launch(tap_loop_kernel, a9, w9, out, M, N, K, TAPS, K3_SEG, reps, stream);
}

// K4: abig [M, KT], wbig [KT, N], out [M, N], all bf16, contiguous and
// 16-byte aligned; KT = 1152.
extern "C" int tap_k1152_bf16(const void* abig, const void* wbig, void* out,
                              int M, int kt, int N, int reps, void* stream) {
  return launch(tap_k1152_kernel, abig, wbig, out, M, N, kt, 1, KT, reps, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
