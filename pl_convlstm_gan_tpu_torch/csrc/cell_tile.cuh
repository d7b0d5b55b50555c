// The bfloat16 cell tile: one 128-pixel x 256-column tile of the fused
// ConvLSTM cell step as device functions, shared by K1's
// convlstm_cell_wgmma_kernel (csrc/convlstm_cell.cu, one tile a block) and
// K5's rollout_persistent_kernel (csrc/rollout_persistent.cu, many tiles of
// many phases a block), so that both run the same arithmetic in the same
// order. The design (implicit GEMM on wgmma, the TMA ring, the folded x, the
// gate epilogue) is set out in convlstm_cell.cu's source note.
//
// The ring position runs on across tiles: a caller that walks several tiles
// passes the count of k-blocks its ring has already taken (g0), so that the
// full/empty mbarriers' phase bits stay in step without re-initialisation.
// A tile releases every ring slot it took, its last one included.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float sigmoid_f(float z) { return 1.f / (1.f + expf(-z)); }

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
constexpr int EPI_WG_BYTES_NO_Z = 2 * (2 * 64 * LD_HC);         // without z

struct GemmArgs {
  const __nv_bfloat16* x;                     // read only where x is folded
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

// The geometry of a layer of cells, set on the host: k-blocks, tiles, the
// ring's stages (the pointers are left to the caller).
inline void cell_geometry(GemmArgs& a, int H, int W, int Cx, int Ch, int K) {
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

// The packed weight [4Ch][K_total] as a 2-D map, box (64, 256): one k-block
// of one N-block
int encode_packed(CUtensorMap* map, const void* w, const GemmArgs& a) {
  const cuuint64_t k_total = (cuuint64_t)a.n_kb * BK;
  const cuuint64_t dims[2] = {k_total, 4ull * a.Ch};
  const cuuint64_t strides[1] = {2 * k_total};
  const cuuint32_t box[2] = {BK, BN};
  return encode_map(map, w, 2, dims, strides, box);
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

// Where a tile lies: its first column and row, its batch item, its N-block.
struct CellTileAt {
  int x0, y0, b, nb;
};

// Tile m along M (B x tiles_h x tiles_w, column-fastest) of N-block nb.
__device__ __forceinline__ CellTileAt cell_tile_at(const GemmArgs& a, int m, int nb) {
  CellTileAt t;
  t.x0 = (m % a.tiles_w) << a.bw_log2;
  m /= a.tiles_w;
  t.y0 = (m % a.tiles_h) * (BM >> a.bw_log2);
  t.b = m / a.tiles_h;
  t.nb = nb;
  return t;
}

// The bytes k-block kb brings into its ring stage: A (but for a folded
// k-block, which the consumers gather) and B.
__device__ __forceinline__ uint32_t cell_kblock_bytes(const GemmArgs& a, int kb) {
  return kb < a.n_fold ? B_BYTES : A_BYTES + B_BYTES;
}

// A's TMA load of k-block kb (a tap's x or h, shifted by the tap; none for
// a folded k-block) into stage address st, completing on `full`.
__device__ __forceinline__ void cell_load_a(const GemmArgs& a, const CUtensorMap* tm_x,
                                            const CUtensorMap* tm_h,
                                            const CellTileAt& t, int kb, uint32_t st,
                                            uint32_t full) {
  if (kb < a.n_fold) return;
  const int per_tap = a.n_x + a.n_h, pad = a.K / 2;
  const int j = kb - a.n_fold, tap = j / per_tap, part = j % per_tap;
  const int dx = tap % a.K - pad, dy = tap / a.K - pad;
  if (part < a.n_x)
    tma_load_4d(st, tm_x, full, part * BK, t.x0 + dx, t.y0 + dy, t.b);
  else
    tma_load_4d(st, tm_h, full, (part - a.n_x) * BK, t.x0 + dx, t.y0 + dy, t.b);
}

// B's TMA load of k-block kb: the packed weight's k-block of the tile's
// N-block, into stage address st.
__device__ __forceinline__ void cell_load_b(const CUtensorMap* tm_w, const CellTileAt& t,
                                            int kb, uint32_t st, uint32_t full) {
  tma_load_2d(st + A_BYTES, tm_w, full, kb * BK, t.nb * BN);
}

// The producer of one tile (one thread): k-blocks kb_begin .. n_kb - 1 into
// the ring at positions g0 + kb, each once its stage is free.
__device__ __forceinline__ void cell_tile_produce(const GemmArgs& a,
                                                  const CUtensorMap* tm_x,
                                                  const CUtensorMap* tm_h,
                                                  const CUtensorMap* tm_w,
                                                  const CellTileAt& t, uint32_t base,
                                                  uint32_t full_bar, uint32_t empty_bar,
                                                  uint32_t g0, int kb_begin = 0) {
  for (int kb = kb_begin; kb < a.n_kb; ++kb) {
    const uint32_t g = g0 + kb;
    const uint32_t s = g % a.stages;
    mbar_wait(empty_bar + 8 * s, ((g / a.stages) & 1) ^ 1);
    const uint32_t full = full_bar + 8 * s;
    const uint32_t st = base + s * STAGE_BYTES;
    mbar_expect_tx(full, cell_kblock_bytes(a, kb));
    cell_load_a(a, tm_x, tm_h, t, kb, st, full);
    cell_load_b(tm_w, t, kb, st, full);
  }
}

// The consumers of one tile (threads 0..255, two warpgroups): the folded x
// gathered into fold_smem (when n_fold > 0), the k-blocks at ring positions
// g0 .. g0 + n_kb - 1 multiplied into the bias-seeded accumulators, then the
// gate epilogue through epi_smem (2 x EPI_WG_BYTES, or 2 x
// EPI_WG_BYTES_NO_Z without z). With a null epi_smem the epilogue runs in
// the ring stage of the last k-block (without z only: it fits one stage),
// which is released after the epilogue instead of before it, so that the
// producer can fill the other stages meanwhile. `ring` is the ring's first
// stage. Data that other blocks wrote during the same launch (the folded x,
// c) is read past L1 (ld.global.cg).
//
// d[i] of a consumer thread: pixel row 16*(warp%4) + lane/4 + 8*((i/2)%2) of
// its warpgroup's 64, GEMM column 8*(i/4) + 2*(lane%4) + i%2, i.e. gate
// (i/4)%4 of hidden channel j0 + 8*(i/16) + 2*(lane%4) + i%2.
__device__ __forceinline__ void cell_tile_consume(const GemmArgs& a, const CellTileAt& t,
                                                  uint8_t* ring, uint8_t* fold_smem,
                                                  uint32_t full_bar, uint32_t empty_bar,
                                                  uint32_t g0, uint8_t* epi_smem) {
  const uint32_t base = smem_addr(ring);
  const int bw = 1 << a.bw_log2;
  const int x0 = t.x0, y0 = t.y0, b = t.b;
  const int pad = a.K / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t fold_base = smem_addr(fold_smem);

  // the consumers: warpgroup wg multiplies tile rows 64*wg .. 64*wg + 63
  const int wg = warp / 4;
  const int j0 = t.nb * (BN / 4);
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
          const int tp = kk / a.Cx, ci = kk - tp * a.Cx;
          const int yy = gy + tp / a.K - pad, xx = gx + tp % a.K - pad;
          const bool in = kk < n_val && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
          const uint32_t val =
              __ldcg(xs + (in ? (((long long)b * a.H + yy) * a.W + xx) * a.Cx + ci : 0));
          v[e / 2] |= (in ? val : 0u) << (16 * (e % 2));
        }
      }
      *reinterpret_cast<uint4*>(fold_smem + (chunk / 8) * A_BYTES + r * 128 +
                                (((chunk % 8) ^ (r & 7)) << 4)) =
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
    const uint32_t g = g0 + kb;
    const uint32_t s = g % a.stages;
    mbar_wait(full_bar + 8 * s, (g / a.stages) & 1);
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
      mbar_arrive(empty_bar + 8 * ((g - 1) % a.stages));
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  const uint32_t last = (g0 + a.n_kb - 1) % a.stages;             // the last k-block
  const bool hold = epi_smem == nullptr;
  if (hold)
    epi_smem = ring + last * STAGE_BYTES;
  else
    mbar_arrive(empty_bar + 8 * last);
  bar_sync(1, 256);                            // both warpgroups left the ring

  __nv_bfloat16* const cs =
      reinterpret_cast<__nv_bfloat16*>(epi_smem + wg * (a.z != nullptr ? EPI_WG_BYTES
                                                                       : EPI_WG_BYTES_NO_Z));
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
    if (p >= 0 && j < a.Ch) v = __ldcg(reinterpret_cast<const uint4*>(a.c + p * a.Ch + j));
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
  if (hold) {                                  // before TMA writes the stage again
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(empty_bar + 8 * last);
  }
}

}  // namespace
