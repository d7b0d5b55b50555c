// K8 traj_warp: TrajGRU's learned-flow warp of the hidden state
// (models/trajgru.py), forward and backward, one launch each a cell-step.
//
// Replaces no TPU kernel: the JAX package has no TrajGRU. No kernel of the
// port computes a data-dependent bilinear gather, and the plain path (h
// repeated L times, then F.grid_sample in NCHW) writes the hidden state L
// times over before the gather starts. Its plain version is
// ops/kernels/traj_warp_kernel.py's traj_warp_plain.
//
// Layouts: NHWC, every operand contiguous. h [B, H, W, C] in T, flows
// [B, H, W, 2L] in T with (u_l, v_l) at channels (2l, 2l + 1). For pixel
// (x, y) of row b and link l, in float32:
//
//   sx = x + u_l   sy = y + v_l   x0 = floor(sx)   y0 = floor(sy)
//   fx = sx - x0   fy = sy - y0   gx = 1 - fx      gy = 1 - fy
//   S[b, y, x, l C + c] = ((gx gy h00 + fx gy h10) + gx fy h01) + fx fy h11
//
// with h00 = h[b, y0, x0, c], h10 = h[b, y0, x0 + 1, c], h01 = h[b, y0 + 1,
// x0, c], h11 = h[b, y0 + 1, x0 + 1, c], a tap outside the frame reading 0
// (F.grid_sample's bilinear sampling with align_corners=True and zero
// padding, at pixel coordinates). S [B, H, W, L C] is written in T, rounded
// once, link-major: the layout the 1x1 link conv reads. Each operation is
// the plain version's, in its order (__fmul_rn / __fadd_rn keep nvcc from
// contracting a * b + c); a tap outside the frame is still multiplied (by
// 0), so a NaN flow gives NaN as the plain version does. So the forward
// equals its plain version bit for bit.
//
// Backward, from gS [B, H, W, L C] in T, into float32 buffers the caller
// zeroes and casts to T once:
//   dh[tap] += w_tap gS          (a gather's gradient is a scatter)
//   du_l = sum_c gS (gy (h10 - h00) + fy (h11 - h01))
//   dv_l = sum_c gS (gx (h01 - h00) + fx (h11 - h10))
// The atomics' order changes from run to run, so the backward matches the
// plain version to float32 rounding, not bit for bit.
//
// What bounds it: bytes. A cell-step writes the stack S (L C values a
// pixel) and reads h (C) and the flows (2L); the backward reads gS, h and
// the flows and adds into dh. At TrajGRU's HKO-7 widths the stacks are
// 1.79 GB a forward at B 4 (the 96^2 layers' 61 MB a step). A pixel's four
// taps are neighbours, and neighbouring pixels' taps overlap, so most tap
// reads hit L1 or L2.
//
// Design. Forward: a segment of SEG lanes (a power of two up to 32) takes
// one (pixel, link) pair, neighbouring segments neighbouring rows of S;
// each lane takes V = 8 channels at a time (one 16-byte access a tap in
// bf16, two in float32) where C % 8 == 0 and the pointers are 16-byte
// aligned, else V = 1, and strides over the row's chunks by SEG. So a warp
// reads and writes whole runs of each row. 256 threads a block,
// grid-stride.
// Backward: the scatter is what costs. With flows of a few pixels, the
// taps of all L links of neighbouring pixels land on the same few pixels,
// and global atomics on one address serialise in L2 (one atomic a tap and
// channel took 1.65 ms at 96^2 x 64, L 13, 70 times the byte bound). So a
// block takes an 8 x 8 tile of pixels and a group of at most 64 channels,
// adds its taps into a shared float32 copy of dh over the tile and a
// 2-pixel ring (taps further out go to dh directly), and adds the copy
// into dh at the end, 16 bytes an atomic. Each warp owns its own V-channel
// slices of the copy and its lanes take neighbouring pixels of one link:
// the lanes of a warp that add to the same pixel in one instruction
// (__match_any_sync) sum their values by shuffles, and the first adds the
// sum with plain shared loads and stores, so no shared atomic is needed
// (shared float atomics, measured, took 85 % of the kernel's time). The flows' gradient of a pair is summed over each lane's V
// channels and over the slices in shared memory, and added into dflows
// once a block.
//
// The C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what they
// do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;                // threads a block
constexpr long long MAX_BLOCKS = 4096;  // more pairs stride (forward)
// the backward's tiles: TILE x TILE pixels, a HALO-pixel ring, channel
// groups of at most CG, each shared pixel padded by PAD floats (16-byte
// rows that start on other banks)
constexpr int TILE = 8, HALO = 2, SPAN = TILE + 2 * HALO;
constexpr int CG = 64, PAD = 4, ROW = CG + PAD;
constexpr int LINKS = 16;   // links a pass of the flows' gradient

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive values of T as float32, or zeros where p is null (V = 8:
// one 16-byte load in bf16, two in float32; the widening is exact)
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&f)[V]) {
  if (p == nullptr) {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = 0.0f;
  } else if constexpr (V == 1) {
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

// V float32 values rounded once to T (V = 8: 16-byte stores)
template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
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

// w f[e] added into the float32 row at p: V = 8 as two 16-byte atomics
// (sm_90's vector atomicAdd; p 16-byte aligned), else one a value
template <int V>
__device__ __forceinline__ void add_v(float* p, float w, const float (&f)[V]) {
  if constexpr (V == 8) {
    float4* q = reinterpret_cast<float4*>(p);
    atomicAdd(q, make_float4(w * f[0], w * f[1], w * f[2], w * f[3]));
    atomicAdd(q + 1, make_float4(w * f[4], w * f[5], w * f[6], w * f[7]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) atomicAdd(p + e, w * f[e]);
  }
}

struct Args {
  const void* h;       // [B, H, W, C]
  const void* flows;   // [B, H, W, 2L]
  const void* gs;      // [B, H, W, L C], backward
  void* s;             // [B, H, W, L C], forward
  float* dh;           // [B, H, W, C] float32, backward (zeroed by the caller)
  float* dflows;       // [B, H, W, 2L] float32, backward (zeroed by the caller)
  int B, H, W, C, L;
  int seg;             // lanes a (pixel, link) pair
  int cg;              // the backward's channels a block
};

// one pair's sampling: the four taps' offsets in h (-1 outside the frame)
// and weights
struct Taps {
  long long o[4];      // 00, 10, 01, 11
  int tx[4], ty[4];    // their pixel coordinates, where o >= 0
  float w[4];
  float fx, fy, gx, gy;
};

template <typename T>
__device__ __forceinline__ Taps taps_of(const Args& a, long long p, int l) {
  const T* fl = static_cast<const T*>(a.flows) + p * 2 * a.L + 2 * l;
  const int px = (int)(p % a.W);
  const int py = (int)((p / a.W) % a.H);
  const long long row = p / ((long long)a.W * a.H) * a.H;
  const float sx = __fadd_rn((float)px, to_f(fl[0]));
  const float sy = __fadd_rn((float)py, to_f(fl[1]));
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  Taps t;
  t.fx = __fsub_rn(sx, x0), t.fy = __fsub_rn(sy, y0);
  t.gx = __fsub_rn(1.0f, t.fx), t.gy = __fsub_rn(1.0f, t.fy);
  t.w[0] = __fmul_rn(t.gx, t.gy), t.w[1] = __fmul_rn(t.fx, t.gy);
  t.w[2] = __fmul_rn(t.gx, t.fy), t.w[3] = __fmul_rn(t.fx, t.fy);
  const float wm = (float)(a.W - 1), hm = (float)(a.H - 1);
  const bool vx[2] = {x0 >= 0.0f && x0 <= wm, x1 >= 0.0f && x1 <= wm};
  const bool vy[2] = {y0 >= 0.0f && y0 <= hm, y1 >= 0.0f && y1 <= hm};
  const float xs[2] = {x0, x1}, ys[2] = {y0, y1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ix = k & 1, iy = k >> 1;
    const bool in = vx[ix] && vy[iy];
    t.tx[k] = in ? (int)xs[ix] : 0;
    t.ty[k] = in ? (int)ys[iy] : 0;
    t.o[k] = in ? ((row + t.ty[k]) * a.W + t.tx[k]) * a.C : -1;
  }
  return t;
}

template <typename T>
__device__ __forceinline__ const T* at(const T* base, long long o, int c) {
  return o < 0 ? nullptr : base + o + c;
}

template <typename T, int V>
__global__ void __launch_bounds__(NT) traj_warp_fwd_kernel(const Args a) {
  const T* __restrict__ h = static_cast<const T*>(a.h);
  T* __restrict__ s = static_cast<T*>(a.s);
  const int seg = a.seg, per_warp = 32 / seg;
  const int lane = threadIdx.x & 31, j = lane % seg;
  const long long pairs = (long long)a.B * a.H * a.W * a.L;
  const long long warps = (long long)gridDim.x * (NT / 32);
  const int chunks = a.C / V;
  for (long long base = ((long long)blockIdx.x * NT + threadIdx.x) / 32 * per_warp;
       base < pairs; base += warps * per_warp) {
    const long long n = base + lane / seg;
    if (n >= pairs) continue;
    const long long p = n / a.L;
    const int l = (int)(n % a.L);
    const Taps t = taps_of<T>(a, p, l);
    T* out = s + (p * a.L + l) * a.C;
    for (int k = j; k < chunks; k += seg) {
      const int c = k * V;
      float v00[V], v10[V], v01[V], v11[V], r[V];
      load_v<T, V>(at(h, t.o[0], c), v00);
      load_v<T, V>(at(h, t.o[1], c), v10);
      load_v<T, V>(at(h, t.o[2], c), v01);
      load_v<T, V>(at(h, t.o[3], c), v11);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float acc = __fadd_rn(__fmul_rn(t.w[0], v00[e]), __fmul_rn(t.w[1], v10[e]));
        acc = __fadd_rn(acc, __fmul_rn(t.w[2], v01[e]));
        r[e] = __fadd_rn(acc, __fmul_rn(t.w[3], v11[e]));
      }
      store_v<T, V>(out + c, r);
    }
  }
}

// The backward, one block a TILE x TILE tile of one row's pixels and one
// group of at most CG channels, all L links (the design note above). Warp
// w owns slices w, w + 8, ... of V channels of the group, so no other warp
// touches its part of the shared copy; its 32 lanes take 32 pairs at a
// time; the lanes that add to one tap pixel in one instruction sum their
// values by shuffles, and one of them adds the sum. The flows'
// gradient of each pair collects in shared memory over the slices, links
// LINKS at a time, and goes into dflows at the end of each pass.
template <typename T, int V>
__global__ void __launch_bounds__(NT) traj_warp_bwd_kernel(const Args a) {
  __shared__ __align__(16) float acc[SPAN * SPAN * ROW];
  __shared__ float flw[TILE * TILE * LINKS * 2];
  const T* __restrict__ h = static_cast<const T*>(a.h);
  const T* __restrict__ gs = static_cast<const T*>(a.gs);
  const int tiles_x = (a.W + TILE - 1) / TILE, tiles_y = (a.H + TILE - 1) / TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * TILE;
  const long long b = blockIdx.x / (tiles_x * tiles_y);
  const int c0 = blockIdx.y * a.cg;
  const int cw = min(a.cg, a.C - c0);          // this group's channels
  const int stride = cw + PAD;                 // floats a shared pixel
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int slices = cw / V;
  for (int i = threadIdx.x; i < SPAN * SPAN * stride; i += NT) acc[i] = 0.0f;
  for (int l0 = 0; l0 < a.L; l0 += LINKS) {
    const int links = min(LINKS, a.L - l0);
    const int pairs = TILE * TILE * links;
    for (int i = threadIdx.x; i < pairs * 2; i += NT) flw[i] = 0.0f;
    __syncthreads();
    for (int sl = warp; sl < slices; sl += NT / 32) {
      const int c = sl * V;                    // within the group
      for (int base = 0; base < pairs; base += 32) {
        // neighbouring lanes take neighbouring pixels of one link
        const int n = base + lane;
        const int l = l0 + n / (TILE * TILE), lp = n % (TILE * TILE);
        const int x = x0 + lp % TILE, y = y0 + lp / TILE;
        const bool live = n < pairs && x < a.W && y < a.H;
        const long long p = (b * a.H + y) * a.W + x;
        Taps t;
        float gv[V];
        int local[4];
        if (live) {
          t = taps_of<T>(a, p, l);
          load_v<T, V>(gs + (p * a.L + l) * a.C + c0 + c, gv);
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int lx = t.tx[k4] - x0 + HALO, ly = t.ty[k4] - y0 + HALO;
            local[k4] = (t.o[k4] >= 0 && lx >= 0 && lx < SPAN && ly >= 0 &&
                         ly < SPAN)
                            ? (ly * SPAN + lx) * stride + c
                            : -1;
          }
        } else {
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) local[k4] = -1, t.o[k4] = -1, t.w[k4] = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) gv[e] = 0.0f;
        }
        float v[4][V];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          load_v<T, V>(at(h, t.o[k4], c0 + c), v[k4]);
        if (live) {
          float du = 0.0f, dv = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            du += gv[e] * (t.gy * (v[1][e] - v[0][e]) + t.fy * (v[3][e] - v[2][e]));
            dv += gv[e] * (t.gx * (v[2][e] - v[0][e]) + t.fx * (v[3][e] - v[1][e]));
          }
          atomicAdd(&flw[2 * n], du);
          atomicAdd(&flw[2 * n + 1], dv);
        }
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          // the lanes that add to the same shared pixel in this instruction
          // (a lane with nothing to add there is a group of its own): the
          // first of them adds the group's sum, taken by shuffles
          const int at_px = local[k4] >= 0 ? local[k4] : -1 - lane;
          const unsigned same = __match_any_sync(0xffffffffu, at_px);
          float mine[V], sum[V];
#pragma unroll
          for (int e = 0; e < V; ++e) mine[e] = sum[e] = t.w[k4] * gv[e];
          const int rounds = (int)__reduce_max_sync(0xffffffffu, __popc(same)) - 1;
          unsigned rest = same & ~(1u << lane);
          for (int r = 0; r < rounds; ++r) {
            const int src = rest ? __ffs(rest) - 1 : lane;
            rest &= rest - 1;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float o = __shfl_sync(0xffffffffu, mine[e], src);
              if (src != lane) sum[e] += o;
            }
          }
          if (local[k4] >= 0) {
            if (lane == __ffs(same) - 1) {
              float* r = acc + local[k4];
#pragma unroll
              for (int e = 0; e < V; ++e) r[e] += sum[e];
            }
          } else if (live && t.o[k4] >= 0) {
            add_v<V>(a.dh + t.o[k4] + c0 + c, t.w[k4], gv);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pairs; i += NT) {
      const int l = l0 + i / (TILE * TILE), lp = i % (TILE * TILE);
      const int x = x0 + lp % TILE, y = y0 + lp / TILE;
      if (x >= a.W || y >= a.H) continue;
      float* d = a.dflows + ((b * a.H + y) * a.W + x) * 2 * a.L + 2 * l;
      atomicAdd(d, flw[2 * i]);
      atomicAdd(d + 1, flw[2 * i + 1]);
    }
    __syncthreads();
  }
  // the block's copy into dh: V values a thread at a time, skipping those
  // no tap changed
  for (int i = threadIdx.x; i < SPAN * SPAN * slices; i += NT) {
    const int px = i / slices, c = (i % slices) * V;
    const int gx = x0 - HALO + px % SPAN, gy = y0 - HALO + px / SPAN;
    if (gx < 0 || gx >= a.W || gy < 0 || gy >= a.H) continue;
    float v[V];
    bool any = false;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = acc[px * stride + c + e];
      any |= v[e] != 0.0f;
    }
    if (any) add_v<V>(a.dh + ((b * a.H + gy) * a.W + gx) * a.C + c0 + c, 1.0f, v);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// lanes a pair: the smallest power of two >= the row's chunks, at most 32
int seg_for(int chunks) {
  int seg = 1;
  while (seg < chunks && seg < 32) seg *= 2;
  return seg;
}

unsigned grid_for(const Args& a) {
  const long long pairs = (long long)a.B * a.H * a.W * a.L;
  const long long warps = (pairs + 32 / a.seg - 1) / (32 / a.seg);
  const long long blocks = (warps + NT / 32 - 1) / (NT / 32);
  return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

Args args(const void* h, const void* flows, const void* gs, void* s,
          void* dh, void* dflows, int B, int H, int W, int C, int L) {
  Args a;
  a.h = h, a.flows = flows, a.gs = gs, a.s = s;
  a.dh = static_cast<float*>(dh), a.dflows = static_cast<float*>(dflows);
  a.B = B, a.H = H, a.W = W, a.C = C, a.L = L, a.seg = 1, a.cg = CG;
  return a;
}

bool shape_ok(const Args& a) {
  return a.B > 0 && a.H > 0 && a.W > 0 && a.C > 0 && a.L > 0 && a.h &&
         a.flows;
}

template <typename T>
int launch_fwd(Args a, void* stream) {
  if (!shape_ok(a) || !a.s) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.C % 8 == 0 && aligned16(a.h) && aligned16(a.s)) {
    a.seg = seg_for(a.C / 8);
    traj_warp_fwd_kernel<T, 8><<<grid_for(a), NT, 0, st>>>(a);
  } else {
    a.seg = seg_for(a.C);
    traj_warp_fwd_kernel<T, 1><<<grid_for(a), NT, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(Args a, void* stream) {
  if (!shape_ok(a) || !a.gs || !a.dh || !a.dflows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = a.C % 8 == 0 && aligned16(a.h) && aligned16(a.gs) &&
                   aligned16(a.dh);
  // channel groups of equal width (a multiple of 8 on the vector path), at
  // most CG
  const int groups = (a.C + CG - 1) / CG;
  a.cg = (a.C + groups - 1) / groups;
  if (vec) a.cg = (a.cg + 7) / 8 * 8;
  const long long tiles = (long long)((a.W + TILE - 1) / TILE) *
                          ((a.H + TILE - 1) / TILE) * a.B;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)tiles, (unsigned)((a.C + a.cg - 1) / a.cg));
  if (vec)
    traj_warp_bwd_kernel<T, 8><<<grid, NT, 0, st>>>(a);
  else
    traj_warp_bwd_kernel<T, 1><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: h [B, H, W, C] and flows [B, H, W, 2L] in T; writes S [B, H, W,
// L C] in T.
#define TRAJ_FWD(NAME, T)                                                    \
  extern "C" int NAME(const void* h, const void* flows, void* s, int B,      \
                      int H, int W, int C, int L, void* stream) {            \
    return launch_fwd<T>(args(h, flows, nullptr, s, nullptr, nullptr, B, H,  \
                              W, C, L),                                      \
                         stream);                                            \
  }
TRAJ_FWD(traj_warp_fwd_f32, float)
TRAJ_FWD(traj_warp_fwd_bf16, __nv_bfloat16)

// Backward: the forward's operands and gS [B, H, W, L C] in T; adds into dh
// [B, H, W, C] and dflows [B, H, W, 2L], both float32 and zeroed by the
// caller.
#define TRAJ_BWD(NAME, T)                                                    \
  extern "C" int NAME(const void* h, const void* flows, const void* gs,      \
                      void* dh, void* dflows, int B, int H, int W, int C,    \
                      int L, void* stream) {                                 \
    return launch_bwd<T>(args(h, flows, gs, nullptr, dh, dflows, B, H, W, C, \
                              L),                                            \
                         stream);                                            \
  }
TRAJ_BWD(traj_warp_bwd_f32, float)
TRAJ_BWD(traj_warp_bwd_bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
