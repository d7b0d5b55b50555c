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
// are stored in the operands' type (float32 or bfloat16), each rounded once.
// Training form (save_z=True): when the z pointer is not null, the epilogue
// also stores the pre-activation z = accumulator + bias, rounded once to the
// operands' type, NHWC [B,H,W,4Ch] gate-major (i|f|o|g blocks of Ch), as
// the TPU kernel's z_ref: the residual of the backward pass. With a null z
// nothing more is stored.
//
// What bounds it on the card: operations. At the nowcast_128 shape a launch
// does 2*65536*9*128*256 = 38.7 GFLOP against ~17 MB of traffic in bf16, far
// above the ridge of the tensor cores (~295 FLOP/B) and of the float32 cores.
//
// bfloat16 (convlstm_cell_wgmma_kernel): one implicit GEMM on wgmma.
// - M = output pixels, 128 a block: one 128-pixel image row, or 2x64, 4x32,
//   ... rows x columns when W is narrower (the smallest power of two >= W,
//   8 to 128, so a narrow frame does not waste the tile). N = 4Ch GEMM
//   columns, 256 a block (64 hidden channels, all four gates; Ch = 256
//   takes four blocks). K = every tap x every input channel, in k-blocks of
//   64 channels (128 bytes, one swizzle span) of one tap, all chained into
//   one f32 accumulator seeded with the bias: no per-tap partial sums, and
//   the pipeline runs on across tap boundaries. nowcast_128's (64, 64)
//   cells take 18 k-blocks (K = 1152).
// - 288 threads: two consumer warpgroups, each wgmma.mma_async m64n256k16
//   (bf16 x bf16 -> f32, both operands from shared memory) on its 64
//   pixels, 128 f32 accumulators a thread; one producer warp whose lane 0
//   keeps TMA loads in flight. 288 threads leave 224 registers a thread,
//   so no setmaxnreg is needed.
// - Staging is asynchronous, in a ring of up to 4 stages of 48 KB (A 16 KB
//   of pixels x 64 channels, B 32 KB of 256 columns x 64 channels; 192 KB),
//   with full/empty mbarriers: loads for k-block k+3 run while the
//   consumers multiply k. A is the input rows of one tap shifted by
//   (di, dj): a 4-D TMA box over NHWC (C, W, H, B) whose out-of-bounds zero
//   fill gives the SAME padding and the ragged edges for free. The maps are
//   encoded on the host per launch (the h buffers ping-pong) and passed as
//   __grid_constant__ kernel parameters. Both tiles land 128-byte swizzled,
//   the layout wgmma's descriptors read without bank conflicts.
// - The weights are packed once by the host (ops/kernels/convlstm_kernel.py
//   pack_cell_weight), not gathered by every block: bf16 [4Ch][K_total],
//   K-major in the k-block order above, one 2-D TMA box per k-block. Its
//   rows are gate-interleaved in groups of 32: row 32q + 8g + e holds gate g
//   of hidden channel 8q + e. wgmma's accumulator gives a thread columns
//   8i + 2(lane%4) + {0,1}, i = 4q + g, so each thread holds all four gates
//   of its (pixel, channel) pairs and the gate epilogue needs no exchange.
// - x whose rows are not a multiple of 16 bytes (Cx % 8 != 0: cell 1's
//   1-channel frames, the ragged test's Cx = 3) cannot be described to TMA.
//   Such x is folded: all K*K taps x Cx channels of a pixel form the first
//   ceil(K*K*Cx/64) k-blocks (one for cell 1: 9 of 64 values used, against
//   9 x 64 for h), gathered by the consumer threads into a region of their
//   own before the main loop, while the first TMA loads are in flight.
// - Epilogue: gates in f32 from the registers; c is read, and h', c' and z
//   leave, through padded shared-memory tiles in 16-byte accesses: a warp
//   writes whole 128-byte rows (this also coalesces z's store).
// - Shapes: any B, H, W, Cx, odd K; Ch a multiple of 8 (the wrapper raises
//   otherwise). Every operand but bias (and folded x) 16-byte aligned.
// - What bounds it: L2 traffic more than the tensor cores. Each block streams
//   the whole packed weight (590 KB at (64, 64)) and K*K shifted A tiles
//   from L2: ~300 MB + ~150 MB a launch at nowcast_128's B 4 against the
//   39 us compute bound; a 128 x 256 tile does 85 FLOP a byte of L2. A
//   cluster of 2 along M with TMA multicast of B (each block loading half
//   of B for both) was built and was right, but 1.55x slower at (64, 64)
//   on an H100 and spilled: the blocks of a pair run in lockstep through
//   the shared empty barriers (PERF.md, PR 5). It is not in this kernel.
//
// float32 (convlstm_cell_kernel, on the CUDA cores; the tensor cores would
// round to TF32):
// - Each block owns an 8x16 pixel tile of one batch item and 32 hidden
//   channels (all four gates of each), i.e. a 128 x 128 slice of z.
// - Each thread owns 4 pixels of one tile row x 4 hidden channels and keeps
//   their 4 gate pre-activations in 64 float registers, so the gate epilogue
//   needs no exchange between threads.
// - The input tile plus its halo is staged in shared memory 8 input channels
//   at a time, read from x and h through two pointers: the concat is fused.
// - The weights do not fit whole (9 x 128 x 256 x 4 B = 1.2 MB), so they are
//   staged per input-channel chunk and per kernel row. A warp owns one
//   group of 4 channels, so its weight reads are broadcasts.
// - Any H, W, Cx, Ch (ragged edges masked) and any odd K. z is stored with
//   4-byte stores, 4 gates Ch apart (not coalesced).
//
// Aliasing: c_out may be c (an in-place update): every element of c is read
// before any element of c' is written, by the block that owns both. h_out
// must differ from h and x, because neighbouring blocks read h's halo.
//
// Each C entry launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for shapes
// it does not take). The bfloat16 entry calls the driver's
// cuTensorMapEncodeTiled (linked with -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

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
// bfloat16: the implicit GEMM on wgmma with TMA staging (see the note above).
// ---------------------------------------------------------------------------
constexpr int BM = 128;                       // pixels a block
constexpr int BN = 256;                       // GEMM columns a block
constexpr int BK = 64;                        // input channels a k-block
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BN * BK * 2;          // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;            // 227 KB a block
constexpr int NT_GEMM = 2 * 128 + 32;         // two consumer warpgroups + producer
constexpr int LD_HC = 64 + 8;                 // padded epilogue row of h', c'
constexpr int LD_Z = 4 * 64 + 8;              // padded epilogue row of z
constexpr int EPI_WG_BYTES = 2 * (2 * 64 * LD_HC + 64 * LD_Z);   // per warpgroup

struct GemmArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* c;
  const __nv_bfloat16* bias;
  __nv_bfloat16* h_out;
  __nv_bfloat16* c_out;
  __nv_bfloat16* z;
  int H, W, Cx, Ch, K;
  int bw_log2;                                // tile: 2^bw_log2 columns x BM >> bw_log2 rows
  int tiles_w, tiles_h;
  int n_fold, n_x, n_h, n_kb, stages;         // k-blocks: folded x; per tap x, h; all
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (SBO), LBO unused; start address >> 4.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[i] of a consumer thread: pixel row 16*(warp%4) + lane/4 + 8*((i/2)%2) of
// its warpgroup's 64, GEMM column 8*(i/4) + 2*(lane%4) + i%2, i.e. gate
// (i/4)%4 of hidden channel j0 + 8*(i/16) + 2*(lane%4) + i%2.
__global__ void __launch_bounds__(NT_GEMM, 1)
convlstm_cell_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_h,
                           const __grid_constant__ CUtensorMap tm_w,
                           const GemmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // [stages][A | B], [n_fold][A], full[stages], empty[stages]; the
  // epilogue reuses the front once the ring is drained
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the 128-byte swizzle's atom
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t fold_base = base + a.stages * STAGE_BYTES;
  const uint32_t full_bar = fold_base + a.n_fold * A_BYTES;
  const uint32_t empty_bar = full_bar + 8 * a.stages;

  const int bw = 1 << a.bw_log2;
  int m = blockIdx.x;
  const int x0 = (m % a.tiles_w) * bw;
  m /= a.tiles_w;
  const int y0 = (m % a.tiles_h) * (BM >> a.bw_log2);
  const int b = m / a.tiles_h;
  const int pad = a.K / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                              // the producer
    if (lane == 0) {
      const int per_tap = a.n_x + a.n_h;
      for (int kb = 0; kb < a.n_kb; ++kb) {
        const int s = kb % a.stages;
        mbar_wait(empty_bar + 8 * s, ((kb / a.stages) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * s;
        const uint32_t st = base + s * STAGE_BYTES;
        if (kb < a.n_fold) {                    // A is the folded x
          mbar_expect_tx(full, B_BYTES);
        } else {
          const int j = kb - a.n_fold, tap = j / per_tap, part = j % per_tap;
          const int dx = tap % a.K - pad, dy = tap / a.K - pad;
          mbar_expect_tx(full, A_BYTES + B_BYTES);
          if (part < a.n_x)
            tma_load_4d(st, &tm_x, full, part * BK, x0 + dx, y0 + dy, b);
          else
            tma_load_4d(st, &tm_h, full, (part - a.n_x) * BK, x0 + dx, y0 + dy, b);
        }
        tma_load_2d(st + A_BYTES, &tm_w, full, kb * BK, blockIdx.y * BN);
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies tile rows 64*wg .. 64*wg + 63
  const int wg = warp / 4;
  const int j0 = blockIdx.y * (BN / 4);
  if (a.n_fold > 0) {
    // x of all taps, tap-major and channel-minor, zero-padded: 8 values (16
    // bytes) a store, swizzled as TMA would have written them. Consecutive
    // threads take consecutive pixels; a chunk's 8 loads are unconditional
    // (clamped index, then a select) so that they are all in flight at once.
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(a.x);
    const int n_val = a.K * a.K * a.Cx;
    const int n_real = (n_val + 7) / 8;        // chunks that hold values
    for (int idx = threadIdx.x; idx < a.n_fold * 8 * BM; idx += 256) {
      const int r = idx % BM, chunk = idx / BM;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (chunk < n_real) {
        const int gy = y0 + (r >> a.bw_log2), gx = x0 + (r & (bw - 1));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = chunk * 8 + e;
          const int t = kk / a.Cx, ci = kk - t * a.Cx;
          const int yy = gy + t / a.K - pad, xx = gx + t % a.K - pad;
          const bool in = kk < n_val && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
          const uint32_t val =
              xs[in ? (((long long)b * a.H + yy) * a.W + xx) * a.Cx + ci : 0];
          v[e / 2] |= (in ? val : 0u) << (16 * (e % 2));
        }
      }
      *reinterpret_cast<uint4*>(smem + (fold_base - base) + (chunk / 8) * A_BYTES +
                                r * 128 + (((chunk % 8) ^ (r & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1, 256);
  }

  // the accumulators, seeded with the bias (after the gather, which then
  // has the registers to itself)
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int j = j0 + 8 * (i / 16) + 2 * (lane % 4) + i % 2;
    d[i] = j < a.Ch ? __bfloat162float(a.bias[((i / 4) % 4) * a.Ch + j]) : 0.f;
  }
  fence_acc(d);
  for (int kb = 0; kb < a.n_kb; ++kb) {
    const int s = kb % a.stages;
    mbar_wait(full_bar + 8 * s, (kb / a.stages) & 1);
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t a_tile =
        (kb < a.n_fold ? fold_base + kb * A_BYTES : st) + wg * (A_BYTES / 2);
    const uint64_t da = sw128_desc(a_tile), db = sw128_desc(st + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)        // +32 bytes along K each
      wgmma_m64n256k16(d, da + 2 * k, db + 2 * k);
    wgmma_commit();
    if (kb > 0) {                              // k-block kb-1 is done: free it
      wgmma_wait<1>();
      mbar_arrive(empty_bar + 8 * ((kb - 1) % a.stages));
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  bar_sync(1, 256);                            // both warpgroups left the ring

  __nv_bfloat16* const cs =
      reinterpret_cast<__nv_bfloat16*>(smem + wg * EPI_WG_BYTES);   // c, then c'
  __nv_bfloat16* const hs = cs + 64 * LD_HC;                         // h'
  __nv_bfloat16* const zs = hs + 64 * LD_HC;                         // z
  const int t128 = threadIdx.x % 128;
  const int Cz = 4 * a.Ch;
  // the pixel of row r of this warpgroup, or -1 outside the frame
  auto pixel = [&](int r) -> long long {
    const int rr = 64 * wg + r;
    const int gy = y0 + (rr >> a.bw_log2), gx = x0 + (rr & (bw - 1));
    return gy < a.H && gx < a.W ? ((long long)b * a.H + gy) * a.W + gx : -1;
  };
  for (int idx = t128; idx < 64 * 8; idx += 128) {
    const int r = idx / 8, j = j0 + 8 * (idx % 8);
    const long long p = pixel(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p >= 0 && j < a.Ch) v = *reinterpret_cast<const uint4*>(a.c + p * a.Ch + j);
    *reinterpret_cast<uint4*>(cs + r * LD_HC + 8 * (idx % 8)) = v;
  }
  bar_sync(2 + wg, 128);

  const int wr = 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + 8 * half;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int cl = 8 * q + 2 * (lane % 4);
      const __nv_bfloat162 cv = *reinterpret_cast<const __nv_bfloat162*>(cs + r * LD_HC + cl);
      float cn[2], hn[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * q + 2 * half + e;   // gate g at i + 4g
        const float ig = sigmoid_f(d[i]), fg = sigmoid_f(d[i + 4]);
        const float og = sigmoid_f(d[i + 8]), gg = tanhf(d[i + 12]);
        cn[e] = fg * (e ? __high2float(cv) : __low2float(cv)) + ig * gg;
        hn[e] = og * tanhf(cn[e]);
      }
      *reinterpret_cast<__nv_bfloat162*>(cs + r * LD_HC + cl) =
          __floats2bfloat162_rn(cn[0], cn[1]);
      *reinterpret_cast<__nv_bfloat162*>(hs + r * LD_HC + cl) =
          __floats2bfloat162_rn(hn[0], hn[1]);
      if (a.z != nullptr) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int i = 16 * q + 4 * g + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(zs + r * LD_Z + 64 * g + cl) =
              __floats2bfloat162_rn(d[i], d[i + 1]);
        }
      }
    }
  }
  bar_sync(2 + wg, 128);

  for (int idx = t128; idx < 64 * 8; idx += 128) {
    const int r = idx / 8, j = j0 + 8 * (idx % 8);
    const long long p = pixel(r);
    if (p < 0 || j >= a.Ch) continue;
    *reinterpret_cast<uint4*>(a.h_out + p * a.Ch + j) =
        *reinterpret_cast<const uint4*>(hs + r * LD_HC + 8 * (idx % 8));
    *reinterpret_cast<uint4*>(a.c_out + p * a.Ch + j) =
        *reinterpret_cast<const uint4*>(cs + r * LD_HC + 8 * (idx % 8));
  }
  if (a.z != nullptr) {
    for (int idx = t128; idx < 64 * 32; idx += 128) {
      const int r = idx / 32, g = (idx / 8) % 4, j = j0 + 8 * (idx % 8);
      const long long p = pixel(r);
      if (p < 0 || j >= a.Ch) continue;
      *reinterpret_cast<uint4*>(a.z + p * Cz + g * a.Ch + j) =
          *reinterpret_cast<const uint4*>(zs + r * LD_Z + 64 * g + 8 * (idx % 8));
    }
  }
}

// A bf16 tensor map: `rank` dims (innermost first), byte strides of dims
// 1.., box `box`, 128-byte swizzle, zero fill out of bounds.
int encode_map(CUtensorMap* map, const void* ptr, unsigned rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// NHWC [B, H, W, C] as a 4-D map (C, W, H, B), box (64, tile columns, tile
// rows, 1): one k-block of one tap
int encode_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C,
                int bw_log2) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t row = 2ull * C;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {BK, 1u << bw_log2, (cuuint32_t)(BM >> bw_log2), 1};
  return encode_map(map, ptr, 4, dims, strides, box);
}


}  // namespace

// z may be null (serving: h' and c' only) or [B,H,W,4Ch] (training).
extern "C" int convlstm_cell_fwd_f32(const void* x, const void* h,
                                     const void* c, const void* w,
                                     const void* bias, void* h_out,
                                     void* c_out, void* z, int B, int H, int W,
                                     int Cx, int Ch, int K, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cx < 1 || Ch < 1 || K < 1 ||
      K % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t)(CK * (TH + K - 1) * (TW + K - 1) +
                                               K * CK * CB * 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        convlstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Ch + CB - 1) / CB, B);
  convlstm_cell_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(h_out),
      static_cast<float*>(c_out), static_cast<float*>(z), H, W, Cx, Ch, K,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// w is the packed weight [4Ch][K_total] of pack_cell_weight, not HWIO.
extern "C" int convlstm_cell_fwd_bf16(const void* x, const void* h,
                                      const void* c, const void* w,
                                      const void* bias, void* h_out,
                                      void* c_out, void* z, int B, int H,
                                      int W, int Cx, int Ch, int K,
                                      void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cx < 1 || Ch < 8 || Ch % 8 != 0 || K < 1 ||
      K % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.c = static_cast<const __nv_bfloat16*>(c);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.h_out = static_cast<__nv_bfloat16*>(h_out);
  a.c_out = static_cast<__nv_bfloat16*>(c_out);
  a.z = static_cast<__nv_bfloat16*>(z);
  a.H = H, a.W = W, a.Cx = Cx, a.Ch = Ch, a.K = K;
  const bool fold = Cx % 8 != 0;
  a.n_fold = fold ? (K * K * Cx + BK - 1) / BK : 0;
  a.n_x = fold ? 0 : (Cx + BK - 1) / BK;
  a.n_h = (Ch + BK - 1) / BK;
  a.n_kb = a.n_fold + K * K * (a.n_x + a.n_h);
  a.bw_log2 = 3;
  while ((1 << a.bw_log2) < W && a.bw_log2 < 7) ++a.bw_log2;
  a.tiles_w = (W + (1 << a.bw_log2) - 1) >> a.bw_log2;
  const int bh = BM >> a.bw_log2;
  a.tiles_h = (H + bh - 1) / bh;
  // the ring takes what the folded x leaves, at most 4 stages
  const size_t fixed = 1024 + (size_t)a.n_fold * A_BYTES;
  a.stages = MAX_STAGES;
  while (a.stages > 2 && fixed + (size_t)a.stages * (STAGE_BYTES + 16) > SMEM_LIMIT)
    --a.stages;
  const size_t smem = fixed + (size_t)a.stages * (STAGE_BYTES + 16);
  if (smem > SMEM_LIMIT ||
      (size_t)a.stages * STAGE_BYTES + a.n_fold * A_BYTES < 2 * EPI_WG_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap tm_x, tm_h, tm_w;
  memset(&tm_x, 0, sizeof(tm_x));   // unused when x is folded
  int err = encode_nhwc(&tm_h, h, B, H, W, Ch, a.bw_log2);
  if (!err && !fold) err = encode_nhwc(&tm_x, x, B, H, W, Cx, a.bw_log2);
  if (!err) {
    const cuuint64_t k_total = (cuuint64_t)a.n_kb * BK;
    const cuuint64_t dims[2] = {k_total, 4ull * Ch};
    const cuuint64_t strides[1] = {2 * k_total};
    const cuuint32_t box[2] = {BK, BN};
    err = encode_map(&tm_w, w, 2, dims, strides, box);
  }
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      convlstm_cell_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * a.tiles_h * a.tiles_w, (4 * Ch + BN - 1) / BN);
  convlstm_cell_wgmma_kernel<<<grid, NT_GEMM, smem,
                               static_cast<cudaStream_t>(stream)>>>(tm_x, tm_h,
                                                                   tm_w, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
