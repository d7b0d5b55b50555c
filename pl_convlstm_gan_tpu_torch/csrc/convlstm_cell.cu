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
// bfloat16 (convlstm_cell_wgmma_kernel): one implicit GEMM on wgmma. Its
// tile (producer, consumers, epilogue) is the device code of cell_tile.cuh,
// which K5 (rollout_persistent.cu) runs too; this kernel is one tile a block.
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
// float32 (convlstm_cell_f32_kernel, on the CUDA cores: the tensor cores
// would round to TF32 and move the rounding points of ops/convlstm.py):
// - What bounds it: the FFMA issue rate. (64, 64) at nowcast_128's B 4 is
//   38.7 GFLOP, 0.58 ms at the 67 TFLOP/s float32 peak, against ~84 MB of
//   traffic (25 us). A thread can issue one instruction a cycle, so every
//   shared-memory load between FFMAs costs an FFMA: the design keeps loads
//   at ~1 in 11 instructions and keeps staging off the FFMAs' path.
// - The same implicit GEMM as the bfloat16 kernel, on SIMT: M = output
//   pixels, 128 a block (8 rows x 16 columns, so frames whose width is a
//   multiple of 16 waste nothing); N = 128 packed columns (32 hidden channels, all
//   four gates); K = taps x input channels, chained into one f32
//   accumulator seeded with the bias. 256 threads, each an 8 x 8 register
//   tile (CUTLASS's SIMT sgemm shape): pixels 4tm..4tm+3 and 64+4tm..+3,
//   columns 4tn..4tn+3 and 64+4tn..+3.
// - The weights are packed once by the host (pack_cell_weight_f32), K-major
//   [K_rows][N_pad] with N gate-interleaved: column 4j + g is gate g of
//   hidden channel j, so one 16-byte load gives a thread all four gates of
//   a channel and the gate epilogue needs no exchange. N_pad pads Ch to a
//   multiple of 32 with zeros, so a block never masks a weight load.
// - K is walked in chunks of 8 input channels. A chunk of x or h is staged
//   once as a halo tile [8][rows + K-1][cols + K-1] (rows padded to 16
//   bytes) and read by all K*K taps; its weights are the chunk's K*K*8 rows.
//   Staging is asynchronous: cp.async into a ring of 2 stages, chunk q + 1
//   loading while chunk q is multiplied (4-byte copies with zero fill for
//   the halo, which gives SAME padding and the ragged edges; 16-byte
//   copies for the weights). Two blocks fit on an SM at K = 3.
// - Inner loop, per (input channel, kernel row): a thread loads a window of
//   4 + K - 1 inputs per pixel group with 16-byte loads and reuses it over
//   the K taps of the row; per tap two 16-byte weight loads feed 64 FFMAs.
// - x whose channels are not a multiple of 8 (cell 1's 1-channel frames,
//   the ragged test's Cx = 3) is folded as in the bfloat16 kernel: all K*K
//   taps x Cx channels of a pixel form the first ceil(K*K*Cx/8) chunks of
//   8 rows (2 for cell 1, 16 rows for 9 values, not 9 x 8), gathered as
//   [8][128 pixels] without a halo.
// - Epilogue: gates in f32 from the registers; c is read and h', c' and z
//   are stored straight from the registers: the 8 lanes of a warp that
//   share a pixel hold 8 consecutive channels, so each store instruction
//   covers whole 32-byte sectors (z: per gate), with no shared-memory pass.
// - Shapes: any B, H, W, Cx, Ch; K in {1, 3, 5} (a template parameter: the
//   window and the weight rows of a chunk are sized at compile time; K = 7
//   would not fit two stages in shared memory). The packed weight must be
//   16-byte aligned.
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

#include "cell_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the implicit GEMM on the CUDA cores (see the note above).
// ---------------------------------------------------------------------------
constexpr int F_PG = 2;            // groups of 4 pixels a thread, 64 apart
constexpr int F_BM = 64 * F_PG;    // pixels a block
constexpr int F_BW_LOG2 = 4;       // a block's tile: 16 columns x 8 rows
constexpr int F_BN = 128;          // packed columns a block: 32 channels x 4 gates
constexpr int F_CK = 8;            // input channels (or folded rows) a chunk
constexpr int F_NT = 256;          // threads: 16 x 16, each 8 pixels x 8 columns
constexpr int F_STAGES = 2;

struct F32Args {
  const float* x;
  const float* h;
  const float* c;
  const float* w;                  // packed [K_rows][n_pad]
  const float* bias;
  float* h_out;
  float* c_out;
  float* z;
  int H, W, Cx, Ch, n_pad;
  int tiles_w, tiles_h;
  int n_fold, n_xc, n_hc;          // chunks: folded x, x, h
};

// The geometry of a float32 block: a tile of 2^F_BW_LOG2 columns x
// F_BM >> F_BW_LOG2 rows, its halo for a KxK kernel (rows padded to 16 bytes)
// and the floats of one ring stage (A region, then the chunk's weights).
// Compile-time, so that the staging loops divide by constants.
template <int K>
struct F32Tile {
  static constexpr int BW = 1 << F_BW_LOG2, BH = F_BM >> F_BW_LOG2;
  static constexpr int IH = BH + K - 1, IWR = BW + K - 1, IW = (IWR + 3) & ~3;
  static constexpr int PLANE = IH * IW;
  static constexpr int A_FLOATS = F_CK * PLANE > F_CK * F_BM ? F_CK * PLANE : F_CK * F_BM;
  static constexpr int STAGE_FLOATS = A_FLOATS + K * K * F_CK * F_BN;
};

// 4 bytes from src, or zeros when !in (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int K>
__global__ void __launch_bounds__(F_NT, 2)
convlstm_cell_f32_kernel(const F32Args a) {
  using G = F32Tile<K>;
  constexpr int PAD = K / 2, bw = G::BW, bh = G::BH, IW = G::IW, plane = G::PLANE;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  int m = blockIdx.x;
  const int x0 = (m % a.tiles_w) * bw;
  m /= a.tiles_w;
  const int y0 = (m % a.tiles_h) * bh;
  const long long b = m / a.tiles_h;
  const int n0 = blockIdx.y * F_BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp is 4 pixel groups x 8 column groups: the 8 lanes that share
  // pixels hold 8 consecutive channels (coalesced epilogue, one 128-byte
  // row of weights a load)
  const int tn = lane % 8 + 8 * (warp % 2);
  const int tm = lane / 8 + 4 * (warp / 2);
  const int n_chunks = a.n_fold + a.n_xc + a.n_hc;

  // stage chunk q into ring slot s. A thread's copies keep one channel (or
  // folded row group) and step through pixels by a constant, so the
  // addressing is a few integer operations a copy.
  auto load_chunk = [&](int q, int s) {
    float* const st = smem + s * G::STAGE_FLOATS;
    const uint32_t st_a = smem_addr(st);
    int rows;
    const float* wrow;
    if (q < a.n_fold) {               // folded x: A [8 rows][128 pixels]
      const int p = tid % F_BM;
      const int py = y0 + (p >> F_BW_LOG2), px = x0 + (p & (bw - 1));
#pragma unroll
      for (int j = 0; j < F_CK * F_BM / F_NT; ++j) {
        const int e = tid / F_BM + (F_NT / F_BM) * j;
        const int kk = q * F_CK + e;
        const int t = kk / a.Cx, ci = kk - t * a.Cx;
        const int yy = py + t / K - PAD, xx = px + t % K - PAD;
        const bool in = t < K * K && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
        cp_async4(st_a + 4 * (e * F_BM + p),
                  in ? a.x + ((b * a.H + yy) * a.W + xx) * a.Cx + ci : a.x, in);
      }
      rows = F_CK;
      wrow = a.w + (long long)q * F_CK * a.n_pad;
    } else {                          // x or h: A halo [8][IH][IW]
      const int hq = q - a.n_fold;
      const bool is_x = hq < a.n_xc;
      const int C = is_x ? a.Cx : a.Ch;
      const int e = tid % F_CK;       // a warp reads 4 pixels x 32 bytes
      const int c = (is_x ? hq : hq - a.n_xc) * F_CK + e;
      const float* const src = (is_x ? a.x : a.h) + c;
      const bool c_in = c < C;
      const uint32_t dst = st_a + 4 * e * plane;
      for (int pp = tid / F_CK; pp < G::IH * G::IWR; pp += F_NT / F_CK) {
        const int r = pp / G::IWR, col = pp % G::IWR;
        const int yy = y0 + r - PAD, xx = x0 + col - PAD;
        const bool in = c_in && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
        cp_async4(dst + 4 * (r * IW + col),
                  in ? src + ((b * a.H + yy) * a.W + xx) * C : a.h, in);
      }
      rows = K * K * F_CK;
      wrow = a.w + ((long long)a.n_fold * F_CK + (long long)hq * K * K * F_CK) * a.n_pad;
    }
    // the chunk's weight rows: a warp copies one 512-byte row slice
    const float* wsrc = wrow + (long long)(tid / 32) * a.n_pad + n0 + 4 * (tid % 32);
    uint32_t dst = smem_addr(st + G::A_FLOATS) + 16 * tid;
    for (int r = 0; r < rows; r += F_NT / 32) {
      cp_async16(dst, wsrc);
      dst += 16 * F_NT;
      wsrc += (long long)(F_NT / 32) * a.n_pad;
    }
  };

  // accumulators acc[pixel i][column e]: pixel 64(i/4) + 4tm + i%4; column
  // 4tn + e (e < 4) or 64 + 4tn + e - 4, i.e. gate e % 4 of channel
  // n0/4 + tn (+16 for e >= 4); seeded with the bias
  float acc[4 * F_PG][8];
#pragma unroll
  for (int hc = 0; hc < 2; ++hc) {
    const int j = n0 / 4 + tn + 16 * hc;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bv = j < a.Ch ? a.bias[g * a.Ch + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4 * F_PG; ++i) acc[i][4 * hc + g] = bv;
    }
  }
  // the first tile row and column of each of the thread's pixel groups
  int pr[F_PG], pc[F_PG];
#pragma unroll
  for (int g = 0; g < F_PG; ++g) {
    const int p0 = 64 * g + 4 * tm;
    pr[g] = p0 >> F_BW_LOG2;
    pc[g] = p0 & (bw - 1);
  }

  load_chunk(0, 0);
  cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) load_chunk(q + 1, (q + 1) % F_STAGES);
    cp_async_commit();
    cp_async_wait<1>();               // all but the newest group: chunk q
    __syncthreads();
    const float* const sa = smem + (q % F_STAGES) * G::STAGE_FLOATS;
    const float* const sb = sa + G::A_FLOATS;
    if (q < a.n_fold) {
#pragma unroll
      for (int e = 0; e < F_CK; ++e) {
        float av[4 * F_PG];
#pragma unroll
        for (int g = 0; g < F_PG; ++g) {
          const float4 t = reinterpret_cast<const float4*>(sa + e * F_BM)[16 * g + tm];
          av[4 * g] = t.x, av[4 * g + 1] = t.y, av[4 * g + 2] = t.z, av[4 * g + 3] = t.w;
        }
        const float4 b0 = reinterpret_cast<const float4*>(sb + e * F_BN)[tn];
        const float4 b1 = reinterpret_cast<const float4*>(sb + e * F_BN)[16 + tn];
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4 * F_PG; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
      }
    } else {
#pragma unroll 2
      for (int e = 0; e < F_CK; ++e) {
#pragma unroll
        for (int di = 0; di < K; ++di) {
          float win[F_PG][4 + K - 1];   // inputs of columns pc .. pc + 4 + K - 2
#pragma unroll
          for (int g = 0; g < F_PG; ++g) {
            const float* src = sa + e * plane + (pr[g] + di) * IW + pc[g];
            const float4 t = *reinterpret_cast<const float4*>(src);
            win[g][0] = t.x, win[g][1] = t.y, win[g][2] = t.z, win[g][3] = t.w;
            if constexpr (K == 3) {
              const float2 u = *reinterpret_cast<const float2*>(src + 4);
              win[g][4] = u.x, win[g][5] = u.y;
            } else if constexpr (K == 5) {
              const float4 u = *reinterpret_cast<const float4*>(src + 4);
              win[g][4] = u.x, win[g][5] = u.y, win[g][6] = u.z, win[g][7] = u.w;
            }
          }
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const float4* brow = reinterpret_cast<const float4*>(
                sb + ((di * K + dj) * F_CK + e) * F_BN);
            const float4 b0 = brow[tn], b1 = brow[16 + tn];
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4 * F_PG; ++i)
#pragma unroll
              for (int n = 0; n < 8; ++n)
                acc[i][n] = fmaf(win[i / 4][i % 4 + dj], bv[n], acc[i][n]);
          }
        }
      }
    }
    __syncthreads();                  // slot q % 2 is free for chunk q + 2
  }

  const int Cz = 4 * a.Ch;
#pragma unroll
  for (int i = 0; i < 4 * F_PG; ++i) {
    const int p = 64 * (i / 4) + 4 * tm + i % 4;
    const int yy = y0 + (p >> F_BW_LOG2), xx = x0 + (p & (bw - 1));
    if (yy >= a.H || xx >= a.W) continue;
    const long long pix = (b * a.H + yy) * a.W + xx;
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int j = n0 / 4 + tn + 16 * hc;
      if (j >= a.Ch) continue;
      const float* const zz = &acc[i][4 * hc];
      if (a.z != nullptr) {
#pragma unroll
        for (int g = 0; g < 4; ++g) a.z[pix * Cz + g * a.Ch + j] = zz[g];
      }
      const float ig = sigmoid_f(zz[0]), fg = sigmoid_f(zz[1]);
      const float og = sigmoid_f(zz[2]), gg = tanhf(zz[3]);
      const long long o = pix * a.Ch + j;
      const float cn = fg * a.c[o] + ig * gg;
      a.c_out[o] = cn;
      a.h_out[o] = og * tanhf(cn);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the implicit GEMM on wgmma with TMA staging (see the note above).
// The tile's producer and consumers are cell_tile.cuh's, which K5 shares.
// ---------------------------------------------------------------------------
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
  const CellTileAt t = cell_tile_at(a, blockIdx.x, blockIdx.y);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == 8) {                  // the producer
    if (threadIdx.x % 32 == 0)
      cell_tile_produce(a, &tm_x, &tm_h, &tm_w, t, base, full_bar, empty_bar, 0);
    return;
  }
  cell_tile_consume(a, t, smem, smem + (fold_base - base), full_bar, empty_bar, 0,
                    smem);
}

// The shared-memory attribute is set on every launch: it belongs to the
// current device, and a process may launch on several.
template <int K>
int launch_f32(F32Args a, int B, int H, int W, cudaStream_t stream) {
  using G = F32Tile<K>;
  const size_t smem = sizeof(float) * (size_t)F_STAGES * G::STAGE_FLOATS;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      convlstm_cell_f32_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.tiles_w = (W + G::BW - 1) / G::BW;
  a.tiles_h = (H + G::BH - 1) / G::BH;
  const long long blocks = (long long)B * a.tiles_h * a.tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, a.n_pad / F_BN);
  convlstm_cell_f32_kernel<K><<<grid, F_NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z may be null (serving: h' and c' only) or [B,H,W,4Ch] (training). w is
// the packed weight [K_rows][N_pad] of pack_cell_weight_f32, not HWIO.
extern "C" int convlstm_cell_fwd_f32(const void* x, const void* h,
                                     const void* c, const void* w,
                                     const void* bias, void* h_out,
                                     void* c_out, void* z, int B, int H, int W,
                                     int Cx, int Ch, int K, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cx < 1 || Ch < 1 ||
      (K != 1 && K != 3 && K != 5) || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a;
  a.x = static_cast<const float*>(x);
  a.h = static_cast<const float*>(h);
  a.c = static_cast<const float*>(c);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.z = static_cast<float*>(z);
  a.H = H, a.W = W, a.Cx = Cx, a.Ch = Ch;
  a.n_pad = 4 * ((Ch + 31) / 32 * 32);
  const bool fold = Cx % F_CK != 0;
  a.n_fold = fold ? (K * K * Cx + F_CK - 1) / F_CK : 0;
  a.n_xc = fold ? 0 : Cx / F_CK;
  a.n_hc = (Ch + F_CK - 1) / F_CK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1) return launch_f32<1>(a, B, H, W, st);
  if (K == 3) return launch_f32<3>(a, B, H, W, st);
  return launch_f32<5>(a, B, H, W, st);
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
  cell_geometry(a, H, W, Cx, Ch, K);
  const bool fold = a.n_fold > 0;
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
  if (!err) err = encode_packed(&tm_w, w, a);
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
