// K5 rollout_persistent_bf16: a whole bfloat16 rollout of the ConvLSTM
// forecaster (its cells and its conv head, every step) in one cooperative
// launch, NHWC.
//
// Replaces the TPU kernel pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py
// _launch_rollout (:505, _rollout_body :232), which runs a cold rollout
// (rollout_pallas :672) or a warm one (rollout_pallas_from_state :706) in
// one launch with the state resident on-chip. It serves the same three
// calls of ops/kernels/rollout_kernel.py: rollout_kernel,
// rollout_kernel_from_state and observe_kernel.
//
// What it computes: the phases of rollout_schedule (rollout_kernel.py), an
// int32 table in device memory, one row a phase: cell k at step t (x from a
// frame, from an output slot of the head, or from the h of cell k - 1; h
// read from the seed or one ping-pong buffer and written to the other; c
// read from the seed or the cell's buffer and written in place), or the head
// at step t (the top cell's h -> an output slot, which the next step's cell
// 0 reads back as its x). The seeds are only read; the final state is in
// the last buffers each cell wrote. The Python walk of the same table
// through K1 and K2 (or their plain versions) is the reference: each phase's
// arithmetic, and its order, is theirs, so the results are equal bit for
// bit (no split-K, no atomics on data).
//
// What bounds it on the card: operations. A nowcast_128 forecast(30) at
// B 1 is 90 cell phases of 2*16384*9*128*256 = 9.7 GFLOP (the first cell
// of each step fewer), 0.754 ms at the bf16 peak (PERF.md, P4's row); a
// request at B 4 is 72 cell and 20 head phases, 2.405 ms. On top of that
// come a grid-wide barrier between phases and the host's one launch.
//
// Design (Hopper: 132 SMs of 227 KB shared memory, not a TPU core's ~9 MB
// of VMEM per batch item, so the state stays in device memory and L2):
// - One cooperative launch (cudaLaunchCooperativeKernel) of 288-thread
//   blocks, as K1: two consumer warpgroups and one producer warp. The grid
//   is min(the largest phase's tile count, SMs x blocks that fit on an SM):
//   at ~200 KB of shared memory one block an SM. A block walks its tiles of
//   phase p (tile i, i + grid, ...), then meets every other block at a
//   grid-wide barrier (a counter at gpu scope, release/acquire), then phase
//   p + 1. The cooperative launch refuses a grid that cannot be co-resident,
//   so the barrier cannot deadlock.
// - A cell phase runs K1's bf16 tile body (cell_tile.cuh, shared with
//   convlstm_cell.cu's convlstm_cell_wgmma_kernel): the implicit GEMM of 128
//   pixels x 256 gate-interleaved columns x taps * channels in k-blocks of
//   64, a TMA ring with full/empty mbarriers fed by the producer, wgmma by
//   the consumers, the folded x of cell 0, the gate epilogue. The epilogue
//   runs in the ring stage of the tile's last k-block, which it releases
//   after its stores (K1 reuses the front of the drained ring), so the
//   producer fills the other stages for the next tile meanwhile: 4 stages
//   of 48 KB at nowcast_128, as K1. A tile takes ~25 us on an H100 at any
//   batch, ~2.5x its share of the tensor cores' time: each tile streams
//   the cell's whole packed weight (590 KB at (64, 64)) from L2 (K1's
//   note), which K1's tile (ROADMAP B12), not this schedule, would change.
// - A head phase runs K2's tile (head_tile.cuh, shared with conv_head.cu),
//   each consumer warpgroup one 8x8 tile at a time in a ring stage (where
//   two tiles of a wide head do not fit a stage, one warpgroup in a scratch
//   region of its own). K2 keeps ~13 of its blocks on an SM and K5 two
//   warpgroups, so a head phase takes about twice K2's launch at B 4 and
//   B 8 (PERF.md). Staging the next tiles during a tile's sums, and the
//   weights once a launch, were tried and did not shorten it: a tile seems
//   bound by the 8 warps' own instruction latency.
// - Once per launch, not per phase: every TMA map is encoded on the host
//   (each cell's seed h, its two ping-pong h buffers and its packed weight;
//   the maps of cell k - 1's h buffers are cell k's x maps), 4 a cell, and
//   passed as one __grid_constant__ parameter; the shared-memory attribute
//   is set once per device and process; the wrapper checks its arguments
//   once per call.
// - The fill hides behind the barrier: a cell phase's weights depend on no
//   earlier phase, so the producer issues the first `stages` weight k-blocks
//   of its next cell phase before it waits for the barrier, and their A
//   tiles (x, h) after it.
//
// Memory-model traps, and what the kernel does about each:
// 1. h is written by generic stores in one phase and read by TMA (the async
//    proxy) in a later one: every consumer thread issues
//    fence.proxy.async.global after its stores of a phase, and the producer
//    issues it again after its acquire of the barrier, before its first TMA
//    load of the phase.
// 2. Generic loads read data that other blocks wrote during this launch:
//    the folded frame gathered from the head's output, the head's staging of
//    h, and c. The ping-pong buffers come back every two steps, so a stale
//    L1 line is a real risk: all three are read past L1 (ld.global.cg and
//    cp.async.cg).
// 3. The mbarrier ring's phase bits run on across tiles and phases: one
//    running k-block count for the whole launch, in the producer and the
//    consumers alike, and no barrier is re-initialised while live; a tile
//    releases its last ring slot too.
// 4. A grid larger than can be co-resident is refused by the cooperative
//    launch (its error is returned), never shrunk silently.
//
// Shapes: 1 to 4 cells over frames of C channels with C % 8 != 0 (cell 0's
// x is folded and gathered, so the frames and the head's outputs need no
// TMA maps), each cell as K1 bf16 takes it (Ch a multiple of 8, odd K), the
// head as K2 bf16 takes it (3x3, Ch_top -> C); everything within 227 KB of
// shared memory (ops/kernels/rollout_kernel.py persistent_misfit states the
// rules). Every h buffer 16-byte aligned.
//
// The C entry launches on the given stream, allocates nothing (the barrier
// counter is the caller's, zeroed here by cudaMemsetAsync), and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// it does not take. It calls the driver's cuTensorMapEncodeTiled (linked
// with -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "cell_tile.cuh"
#include "head_tile.cuh"

namespace {

constexpr int MAX_CELLS = 4;
constexpr int MAP_W = 3;             // maps a cell: h seed, h ping 0, h ping 1, weight
constexpr int N_COLS = 10;           // the phase table's columns (rollout_kernel.py)
enum { KIND, CELL, STEP, X_FROM, X_INDEX, H_READ, H_WRITE, C_READ, C_WRITE, OUT_SLOT };
enum { CELL_PHASE = 0, HEAD_PHASE = 1 };
enum { FROM_FRAME = 0, FROM_OUT = 1, FROM_H = 2 };
enum { HEAD_C1_1 = 0, HEAD_C1_2 = 1, HEAD_GENERIC = 2 };
constexpr int HEAD_K = 3;

struct CellLayer {
  GemmArgs a;                        // the geometry; pointers are set per phase
  const __nv_bfloat16* bias;
  __nv_bfloat16* h[3];               // seed (only read), ping 0, ping 1
  const __nv_bfloat16* c_seed;       // only read
  __nv_bfloat16* c_buf;              // written from step 0 on, in place after
  int n_m;                           // tiles along M: B x tiles_h x tiles_w
  int n_tiles;                       // n_m x N-blocks
};

struct Params {
  CUtensorMap maps[MAX_CELLS][MAP_W + 1];
  CellLayer cells[MAX_CELLS];
  const int* table;                  // [n_phases][N_COLS]
  const __nv_bfloat16* frames;       // [T_in][B][H][W][C]
  __nv_bfloat16* out;                // [n_out][B][H][W][C]
  const __nv_bfloat16* head_w;       // HWIO [3][3][Ch_top][C]
  const __nv_bfloat16* head_b;
  unsigned* counter;                 // the grid barrier's arrivals, zeroed
  long long frame_elems;             // B * H * W * C
  int n_phases, n_cells;
  int H, W, C, head_cin, head_tiles_w, head_tiles_h, head_tiles, head_variant;
  int head_in_ring;                  // 1: both warpgroups' head tiles in the ring's
                                     // last stage; 0: one warpgroup's in the scratch
  int stages;
  uint32_t head_bytes;               // one head tile: h with its halo, weights
  uint32_t fold_off, scratch_off, bar_off;               // from the base
  long long* stamps;                 // null, or block 0's clock: [1 + 2 n_phases]
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// until every block has passed `target` / gridDim.x barriers
__device__ __forceinline__ void wait_counter(const unsigned* p, unsigned target) {
  while (ld_acquire(p) < target) {
  }
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct SyncWarpgroup {
  int id;
  __device__ __forceinline__ void operator()() const { bar_sync(id, 128); }
};

// A warpgroup's tiles of a head phase (tile first, first + stride, ...),
// one at a time in `smem`: K2's tile body (h and the weights staged, then
// the sums).
__device__ __forceinline__ void head_phase(const Params& p, const __nv_bfloat16* h,
                                           __nv_bfloat16* out, int first, int stride,
                                           uint8_t* smem, int tid, SyncWarpgroup sync) {
  __nv_bfloat16* const hs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* const ws = reinterpret_cast<float*>(smem + head_h_bytes(p.head_cin, HEAD_K, 2));
  for (int i = first; i < p.head_tiles; i += stride) {
    const HeadTileAt t = head_tile_at(i, p.head_tiles_w, p.head_tiles_h);
    stage_h(h, hs, t, p.H, p.W, p.head_cin, HEAD_K, tid);
    stage_w(p.head_w, ws, HEAD_K * HEAD_K * p.head_cin * p.C, tid, HEAD_NT);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    sync();
    if (p.head_variant == HEAD_C1_1)
      head_compute_c1<__nv_bfloat16, 1>(p.head_b, out, p.H, p.W, p.head_cin, t, hs, ws,
                                        tid);
    else if (p.head_variant == HEAD_C1_2)
      head_compute_c1<__nv_bfloat16, 2>(p.head_b, out, p.H, p.W, p.head_cin, t, hs, ws,
                                        tid);
    else
      head_compute_generic<__nv_bfloat16>(p.head_b, out, p.H, p.W, p.head_cin, p.C,
                                          HEAD_K, t, hs, ws, tid);
    sync();                                       // the next tile restages
  }
}

// The consumers' grid-wide barrier after a phase (threads 0..255): their
// stores first (and ordered before any TMA read or write of them), then one
// arrival of the block, then every block's.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  fence_proxy_async_global();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // head tiles' stages
  bar_sync(1, 256);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    wait_counter(counter, target);
    __threadfence();
  }
  bar_sync(1, 256);
}

// The cell phase of `row` as K1's arguments: the layer's geometry with this
// phase's x (read where it is folded), c, h' and c'.
__device__ __forceinline__ GemmArgs phase_args(const Params& p, const int* row) {
  const int k = row[CELL];
  const CellLayer& L = p.cells[k];
  GemmArgs a = L.a;
  if (row[X_FROM] == FROM_FRAME)
    a.x = p.frames + row[X_INDEX] * p.frame_elems;
  else if (row[X_FROM] == FROM_OUT)
    a.x = p.out + row[X_INDEX] * p.frame_elems;
  else
    a.x = p.cells[k - 1].h[row[X_INDEX]];
  a.c = row[C_READ] == 0 ? L.c_seed : L.c_buf;
  a.bias = L.bias;
  a.h_out = L.h[row[H_WRITE]];
  a.c_out = L.c_buf;
  a.z = nullptr;
  return a;
}

// The producer (one thread): every cell phase's k-blocks of this block's
// tiles, in the consumers' order. Before the phase's barrier it issues the
// weights of the first `stages` k-blocks of its first tile; after it, their
// A tiles and the rest.
__device__ __forceinline__ void produce(const Params& p, uint32_t base, uint32_t full_bar,
                                        uint32_t empty_bar) {
  const int grid = gridDim.x;
  uint32_t g = 0;                                 // the ring's running position
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const int* row = p.table + ph * N_COLS;
    if (row[KIND] != CELL_PHASE) continue;
    const int k = row[CELL];
    const CellLayer& L = p.cells[k];
    if ((int)blockIdx.x >= L.n_tiles) continue;
    const GemmArgs a = phase_args(p, row);
    const CUtensorMap* tm_x = &p.maps[k > 0 ? k - 1 : 0][k > 0 ? row[X_INDEX] : 0];
    const CUtensorMap* tm_h = &p.maps[k][row[H_READ]];
    const CUtensorMap* tm_w = &p.maps[k][MAP_W];
    const int first = blockIdx.x;
    const CellTileAt t = cell_tile_at(a, first % L.n_m, first / L.n_m);
    // after a head phase, whose tiles may lie in the ring's last stage
    const int room = ph > 0 && p.table[(ph - 1) * N_COLS + KIND] == HEAD_PHASE
                         ? a.stages - p.head_in_ring
                         : a.stages;
    const int pre = a.n_kb < room ? a.n_kb : room;
    for (int kb = 0; kb < pre; ++kb) {           // weights: no wait on any phase
      const uint32_t s = (g + kb) % a.stages;
      mbar_wait(empty_bar + 8 * s, (((g + kb) / a.stages) & 1) ^ 1);
      mbar_expect_tx(full_bar + 8 * s, cell_kblock_bytes(a, kb));
      cell_load_b(tm_w, t, kb, base + s * STAGE_BYTES, full_bar + 8 * s);
    }
    if (ph > 0) {                                 // every phase before this one
      wait_counter(p.counter, (unsigned)ph * grid);
      fence_proxy_async_global();
    }
    for (int kb = 0; kb < pre; ++kb) {
      const uint32_t s = (g + kb) % a.stages;
      cell_load_a(a, tm_x, tm_h, t, kb, base + s * STAGE_BYTES, full_bar + 8 * s);
    }
    cell_tile_produce(a, tm_x, tm_h, tm_w, t, base, full_bar, empty_bar, g, pre);
    g += a.n_kb;
    for (int i = first + grid; i < L.n_tiles; i += grid) {
      cell_tile_produce(a, tm_x, tm_h, tm_w, cell_tile_at(a, i % L.n_m, i / L.n_m), base,
                        full_bar, empty_bar, g);
      g += a.n_kb;
    }
  }
}

// The consumers (threads 0..255): every phase's tiles of this block, then
// the barrier. A cell tile's epilogue runs in the ring stage of its last
// k-block; the head's tiles run in the stage that follows the ring's next
// stages - 1 positions (free until the producer passes the barrier after
// the head phase), or in the scratch region where two tiles of a wide head
// do not fit a stage.
__device__ __forceinline__ void consume(const Params& p, uint8_t* ring,
                                        uint32_t full_bar, uint32_t empty_bar) {
  const int grid = gridDim.x;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  uint8_t* const fold = ring + p.fold_off;
  const SyncWarpgroup sync{2 + wg};
  const bool stamp = p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) p.stamps[0] = globaltimer();
  uint32_t g = 0;
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const int* row = p.table + ph * N_COLS;
    if (row[KIND] == CELL_PHASE) {
      const CellLayer& L = p.cells[row[CELL]];
      const GemmArgs a = phase_args(p, row);
      for (int i = blockIdx.x; i < L.n_tiles; i += grid) {
        cell_tile_consume(a, cell_tile_at(a, i % L.n_m, i / L.n_m), ring, fold, full_bar,
                          empty_bar, g, nullptr);
        g += a.n_kb;
      }
    } else {
      const __nv_bfloat16* h = p.cells[p.n_cells - 1].h[row[X_INDEX]];
      __nv_bfloat16* out = p.out + row[OUT_SLOT] * p.frame_elems;
      const int n = p.head_in_ring ? 2 : 1;      // warpgroups that take tiles
      uint8_t* const smem =
          p.head_in_ring
              ? ring + ((g + p.stages - 1) % p.stages) * STAGE_BYTES + wg * p.head_bytes
              : ring + p.scratch_off;
      if (wg < n) head_phase(p, h, out, n * blockIdx.x + wg, n * grid, smem, tid, sync);
    }
    if (stamp) p.stamps[1 + 2 * ph] = globaltimer();
    if (ph + 1 < p.n_phases) grid_barrier(p.counter, (unsigned)(ph + 1) * grid);
    if (stamp) p.stamps[2 + 2 * ph] = globaltimer();
  }
}

__global__ void __launch_bounds__(NT_GEMM, 1)
rollout_persistent_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // [stages][A | B] (a stage also holds a tile's epilogue, or head tiles),
  // [n_fold][A], the scratch of a wide head's tile (or none),
  // full[stages], empty[stages]
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the 128-byte swizzle's atom
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + p.bar_off;
  const uint32_t empty_bar = full_bar + 8 * p.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == 8) {                    // the producer
    if (threadIdx.x % 32 == 0) produce(p, base, full_bar, empty_bar);
    return;
  }
  consume(p, smem, full_bar, empty_bar);
}

constexpr int MAX_DEVICES = 64;
bool smem_set[MAX_DEVICES];
int sm_count[MAX_DEVICES];

}  // namespace

// table: device int32 [n_phases][10] (rollout_schedule); cell_ptrs: host
// array of 7 pointers a cell (packed weight [4Ch][K_total], bias [4Ch], h
// seed, h ping 0, h ping 1, c seed, c buffer; each [B,H,W,Ch]); cell_dims:
// host array of (Cx, Ch) a cell; frames [T_in,B,H,W,C]; out [n_out,B,H,W,C];
// head_w HWIO [3,3,Ch_top,C], head_b [C]; counter: one device uint32;
// info (host, 5 ints): grid, blocks an SM, shared memory bytes, stages, SMs;
// stamps: null, or device int64 [1 + 2 n_phases] that block 0 fills with
// %globaltimer (ns) at its start, and after each phase's tiles and after
// the barrier that follows them.
extern "C" int rollout_persistent_bf16(const int* table, int n_phases, int n_cells,
                                       const void* frames, void* out,
                                       const void* const* cell_ptrs,
                                       const int* cell_dims, const void* head_w,
                                       const void* head_b, int B, int H, int W, int C,
                                       int K, void* counter, int* info, void* stamps,
                                       void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_cells < 1 || n_cells > MAX_CELLS || n_phases < 1 || B < 1 || H < 1 || W < 1 ||
      C < 1 || C % 8 == 0 || K < 1 || K % 2 == 0)
    return bad;
  Params p;
  memset(&p, 0, sizeof(p));
  p.table = static_cast<const int*>(table);
  p.frames = static_cast<const __nv_bfloat16*>(frames);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.head_w = static_cast<const __nv_bfloat16*>(head_w);
  p.head_b = static_cast<const __nv_bfloat16*>(head_b);
  p.counter = static_cast<unsigned*>(counter);
  p.frame_elems = (long long)B * H * W * C;
  p.n_phases = n_phases, p.n_cells = n_cells;
  p.H = H, p.W = W, p.C = C;

  int max_fold = 0;
  long long max_units = 0;
  int cx = C;
  for (int k = 0; k < n_cells; ++k) {
    const int Cx = cell_dims[2 * k], Ch = cell_dims[2 * k + 1];
    if (Cx != cx || Ch < 8 || Ch % 8 != 0) return bad;
    CellLayer& L = p.cells[k];
    cell_geometry(L.a, H, W, Cx, Ch, K);
    L.n_m = B * L.a.tiles_h * L.a.tiles_w;
    L.n_tiles = L.n_m * ((4 * Ch + BN - 1) / BN);
    const void* const* ptr = cell_ptrs + 7 * k;
    L.bias = static_cast<const __nv_bfloat16*>(ptr[1]);
    for (int i = 0; i < 3; ++i) {
      L.h[i] = static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[2 + i]));
      if (reinterpret_cast<uintptr_t>(L.h[i]) % 16) return bad;
      const int err = encode_nhwc(&p.maps[k][i], L.h[i], B, H, W, Ch, L.a.bw_log2);
      if (err) return err;
    }
    L.c_seed = static_cast<const __nv_bfloat16*>(ptr[5]);
    L.c_buf = static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[6]));
    const int err = encode_packed(&p.maps[k][MAP_W], ptr[0], L.a);
    if (err) return err;
    if (L.a.n_fold > max_fold) max_fold = L.a.n_fold;
    if (L.n_tiles > max_units) max_units = L.n_tiles;
    cx = Ch;
  }
  if (p.cells[0].a.n_fold == 0) return bad;      // cell 0's x must be folded

  p.head_cin = cx;
  p.head_tiles_w = (W + HEAD_TS - 1) / HEAD_TS;
  p.head_tiles_h = (H + HEAD_TS - 1) / HEAD_TS;
  const long long head_tiles = (long long)B * p.head_tiles_w * p.head_tiles_h;
  if (head_tiles > 0x7fffffffLL || cx % 8 != 0) return bad;
  p.head_tiles = (int)head_tiles;
  const int nv = cx / 8;
  p.head_variant = C == 1 && nv <= HEAD_LANES       ? HEAD_C1_1
                   : C == 1 && nv <= 2 * HEAD_LANES ? HEAD_C1_2
                                                    : HEAD_GENERIC;

  // shared memory: the ring takes what the rest leaves, 2 to 4 stages; the
  // head's tiles lie in one of its stages (both warpgroups'), or, where two
  // tiles do not fit a stage, one warpgroup's in a scratch region (the
  // ring keeps the room a second would take)
  const size_t head_bytes =
      (head_h_bytes(cx, HEAD_K, 2) + head_w_bytes(cx, C, HEAD_K) + 15) / 16 * 16;
  const size_t rest = 1024 + (size_t)max_fold * A_BYTES + 16 * MAX_STAGES;
  size_t scratch = 0;
  p.head_in_ring = 2 * head_bytes <= STAGE_BYTES;
  if (!p.head_in_ring) scratch = head_bytes;
  const size_t fixed = rest + scratch;
  const long long head_units = p.head_in_ring ? (head_tiles + 1) / 2 : head_tiles;
  if (head_units > max_units) max_units = head_units;
  int stages = MAX_STAGES;
  while (stages > 2 && fixed + (size_t)stages * STAGE_BYTES > SMEM_LIMIT) --stages;
  const size_t smem = fixed + (size_t)stages * STAGE_BYTES;
  if (smem > SMEM_LIMIT) return bad;
  p.stages = stages;
  for (int k = 0; k < n_cells; ++k) p.cells[k].a.stages = stages;
  p.fold_off = stages * STAGE_BYTES;
  p.scratch_off = p.fold_off + max_fold * A_BYTES;
  p.head_bytes = (uint32_t)head_bytes;
  p.bar_off = p.scratch_off + (uint32_t)scratch;
  p.stamps = static_cast<long long*>(stamps);

  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES) return bad;
  if (!smem_set[dev]) {                           // once a device and process
    e = cudaFuncSetAttribute(rollout_persistent_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rollout_persistent_kernel,
                                                    NT_GEMM, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long capacity = (long long)per_sm * sm_count[dev];
  const int grid = (int)(max_units < capacity ? max_units : capacity);
  if (info != nullptr) {
    info[0] = grid, info[1] = per_sm, info[2] = (int)smem, info[3] = stages;
    info[4] = sm_count[dev];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rollout_persistent_kernel),
                                  dim3(grid), dim3(NT_GEMM), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
