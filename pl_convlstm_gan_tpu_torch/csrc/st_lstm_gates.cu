// K7 st_lstm_gates: the gate passes of PredRNN-V2's spatiotemporal LSTM
// cell (models/predrnn.py), forward and backward, one pass over pixels each.
//
// Replaces no TPU kernel: the JAX package has no PredRNN. Run eagerly, the
// cell's gate algebra is ~25 elementwise launches forward and ~50 backward
// a cell and step, 76 cell-steps a train step at the KTH widths, and the
// step would time PyTorch's dispatcher rather than the model. Its plain
// versions are ops/kernels/st_gates_kernel.py's *_plain functions.
//
// Layouts: NHWC, P = B * H * W pixels, F hidden channels; every operand
// contiguous, one row of channels a pixel. x_cat [P, 7F] holds conv_x's
// i f g i' f' g' o, h_cat [P, 4F] conv_h's i f g o, m_cat [P, 3F] conv_m's
// i f g. In float32, per pixel and channel (sig(a) = 1 / (1 + exp(-a))):
//
// Pass A:  i  = sig(xi + hi)   f  = sig((xf + hf) + 1)   g  = tanh(xg + hg)
//          i' = sig(xi' + mi)  f' = sig((xf' + mf) + 1)  g' = tanh(xg' + mg)
//          dc = i g   c' = f c + dc   dm = i' g'   m' = f' m + dm
//          oxh = xo + ho
//   writes mem [P, 2F] = c' | m' and c', m' [P, F] again (the convs read
//   mem, the next cell-steps c' and m'), dc, dm (the decoupling loss's
//   inputs) and oxh in float32; c', m', dc and dm may be absent.
// Pass B:  h' = sig(oxh + om) tanh(last), om = conv_o(mem), last =
//   conv_last(mem).
// Pass A backward, from the saved operands and the gradients of its
//   outputs (an absent one is zero):
//          dcn = g_mem[:F] + g_c'   ddc = g_dc + dcn
//          di = ddc g i (1 - i)   df = dcn c f (1 - f)   dg = ddc i (1 - g g)
//          dc_prev = dcn f, and the primed gates and dm_prev likewise from
//          g_mem[F:], g_m', g_dm and m
//   writes dx_cat [P, 7F] = di df dg di' df' dg' do (do = g_oxh),
//   dh_cat [P, 4F] = di df dg do, dm_cat [P, 3F] = di' df' dg', and
//   dc_prev, dm_prev (each may be absent).
// Pass B backward: o = sig(oxh + om), tl = tanh(last); do = gh tl o (1 - o),
//   dl = gh o (1 - tl tl); writes d_oxh (float32), d_om = do and d_last.
//
// Each operation is the one the plain version does, in its order:
// __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting a * b + c
// into one FMA, division is IEEE, nothing is built with fast math; results
// are rounded once to T. So the kernel equals its plain version on the card
// up to the ulps of expf / tanhf.
//
// What bounds it: bytes. At the KTH widths (B 8, 32 x 32 patched pixels,
// F 128, bf16) pass A reads 16 and writes 6 bf16 values and one float32 a
// pixel and channel (50 MB a call, 15 us at 3.35 TB/s; the benchmark's
// bound counts c' and m' once, 46 MB and 13.8 us), pass B 10 bytes
// read and 2 written (3.1 us); backward A 36 bf16 values and one float32
// (80 MB, 24 us), backward B 18 bytes (5.6 us). It does ~60 FLOP and 7
// transcendentals a pixel and channel, far below the ridge.
//
// Design: a thread takes one pixel x V channels, V = 8 where F % 8 == 0
// and every operand is 16-byte aligned (one 16-byte access a gate in bf16,
// two in float32), else 1. Neighbouring threads take neighbouring channel
// groups of one pixel, so a warp reads and writes whole 128-byte runs of
// each gate. A pass goes through its two gate paths (c, then m) in turn, so
// that fewer values are live at once. 256 threads a block, grid-stride.
//
// The C entries launch on the given stream, allocate nothing and return
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what they
// do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int NT = 256;            // threads a block
constexpr int MAX_BLOCKS = 65535;  // the grid's cap; more pixels stride

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

// V float32 values rounded once to T (V = 8: 16-byte stores); nothing
// where p is null
template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&f)[V]) {
  if (p == nullptr) return;
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

// ATen's CUDA sigmoid for float: one / (one + exp(-a)), IEEE division
__device__ __forceinline__ float sigmoid_f(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// the pointer at offset o, or null where the base is null
template <typename P>
__device__ __forceinline__ P* at(P* base, long long o) {
  return base == nullptr ? nullptr : base + o;
}

struct ArgsA {
  const void* xc;      // x_cat [P, 7F]
  const void* hc;      // h_cat [P, 4F]
  const void* mc;      // m_cat [P, 3F]
  const void* c;       // [P, F]
  const void* m;       // [P, F]
  void* mem;           // [P, 2F]
  void* cn;            // c' [P, F] or null
  void* mn;            // m' [P, F] or null
  void* dcv;           // dc [P, F] or null
  void* dmv;           // dm [P, F] or null
  float* oxh;          // [P, F]
  long long P;
  int F;
};

// one gate path of pass A: s = sig(x_s + y_s), f = sig((x_f + y_f) + 1),
// g = tanh(x_g + y_g); d = s g, out = f prev + d
template <int V>
__device__ __forceinline__ void path_fwd(const float (&xs)[V], const float (&xf)[V],
                                         const float (&xg)[V], const float (&ys)[V],
                                         const float (&yf)[V], const float (&yg)[V],
                                         const float (&prev)[V], float (&d)[V],
                                         float (&out)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float i = sigmoid_f(__fadd_rn(xs[e], ys[e]));
    const float f = sigmoid_f(__fadd_rn(__fadd_rn(xf[e], yf[e]), 1.0f));
    const float g = tanhf(__fadd_rn(xg[e], yg[e]));
    d[e] = __fmul_rn(i, g);
    out[e] = __fadd_rn(__fmul_rn(f, prev[e]), d[e]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NT) st_gates_a_fwd_kernel(const ArgsA a) {
  const T* __restrict__ xc = static_cast<const T*>(a.xc);
  const T* __restrict__ hc = static_cast<const T*>(a.hc);
  const T* __restrict__ mc = static_cast<const T*>(a.mc);
  const T* __restrict__ c = static_cast<const T*>(a.c);
  const T* __restrict__ m = static_cast<const T*>(a.m);
  T* mem = static_cast<T*>(a.mem);
  T* cn = static_cast<T*>(a.cn);
  T* mn = static_cast<T*>(a.mn);
  T* dcv = static_cast<T*>(a.dcv);
  T* dmv = static_cast<T*>(a.dmv);
  const int F = a.F, G = a.F / V;
  const long long n = a.P * G;
  for (long long idx = (long long)blockIdx.x * NT + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * NT) {
    const long long p = idx / G;
    const int j = (int)(idx - p * G) * V;
    const T* x = xc + p * 7 * F + j;
    const T* h = hc + p * 4 * F + j;
    const T* mm = mc + p * 3 * F + j;
    const long long pf = p * F + j, pm = p * 2 * F + j;
    {   // the c path: conv_x's and conv_h's i f g with c
      float xs[V], xf[V], xg[V], ys[V], yf[V], yg[V], prev[V], d[V], out[V];
      load_v<T, V>(x, xs);
      load_v<T, V>(x + F, xf);
      load_v<T, V>(x + 2 * F, xg);
      load_v<T, V>(h, ys);
      load_v<T, V>(h + F, yf);
      load_v<T, V>(h + 2 * F, yg);
      load_v<T, V>(c + pf, prev);
      path_fwd<V>(xs, xf, xg, ys, yf, yg, prev, d, out);
      store_v<T, V>(mem + pm, out);
      store_v<T, V>(at(cn, pf), out);
      store_v<T, V>(at(dcv, pf), d);
    }
    {   // the m path: conv_x's i' f' g' and conv_m's i f g with m
      float xs[V], xf[V], xg[V], ys[V], yf[V], yg[V], prev[V], d[V], out[V];
      load_v<T, V>(x + 3 * F, xs);
      load_v<T, V>(x + 4 * F, xf);
      load_v<T, V>(x + 5 * F, xg);
      load_v<T, V>(mm, ys);
      load_v<T, V>(mm + F, yf);
      load_v<T, V>(mm + 2 * F, yg);
      load_v<T, V>(m + pf, prev);
      path_fwd<V>(xs, xf, xg, ys, yf, yg, prev, d, out);
      store_v<T, V>(mem + pm + F, out);
      store_v<T, V>(at(mn, pf), out);
      store_v<T, V>(at(dmv, pf), d);
    }
    {   // oxh = xo + ho, float32
      float xo[V], ho[V];
      load_v<T, V>(x + 6 * F, xo);
      load_v<T, V>(h + 3 * F, ho);
#pragma unroll
      for (int e = 0; e < V; ++e) xo[e] = __fadd_rn(xo[e], ho[e]);
      store_v<float, V>(a.oxh + pf, xo);
    }
  }
}

struct ArgsABwd {
  const void* xc;
  const void* hc;
  const void* mc;
  const void* c;
  const void* m;
  const void* g_mem;   // [P, 2F] or null
  const void* g_cn;    // [P, F] or null
  const void* g_mn;
  const void* g_dc;
  const void* g_dm;
  const float* g_oxh;  // [P, F] float32 or null
  void* dxc;           // [P, 7F]
  void* dhc;           // [P, 4F]
  void* dmc;           // [P, 3F]
  void* dc_prev;       // [P, F] or null
  void* dm_prev;       // [P, F] or null
  long long P;
  int F;
};

// one gate path of pass A's backward (see the header): writes the three
// pre-activation gradients over xs, xf, xg and the previous state's
// gradient into dprev
template <int V>
__device__ __forceinline__ void path_bwd(float (&xs)[V], float (&xf)[V], float (&xg)[V],
                                         const float (&ys)[V], const float (&yf)[V],
                                         const float (&yg)[V], const float (&prev)[V],
                                         const float (&g_mem)[V], const float (&g_out)[V],
                                         const float (&g_d)[V], float (&dprev)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float i = sigmoid_f(__fadd_rn(xs[e], ys[e]));
    const float f = sigmoid_f(__fadd_rn(__fadd_rn(xf[e], yf[e]), 1.0f));
    const float g = tanhf(__fadd_rn(xg[e], yg[e]));
    const float dout = __fadd_rn(g_mem[e], g_out[e]);
    const float dd = __fadd_rn(g_d[e], dout);
    xs[e] = __fmul_rn(__fmul_rn(__fmul_rn(dd, g), i), __fsub_rn(1.0f, i));
    xf[e] = __fmul_rn(__fmul_rn(__fmul_rn(dout, prev[e]), f), __fsub_rn(1.0f, f));
    xg[e] = __fmul_rn(__fmul_rn(dd, i), __fsub_rn(1.0f, __fmul_rn(g, g)));
    dprev[e] = __fmul_rn(dout, f);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NT) st_gates_a_bwd_kernel(const ArgsABwd a) {
  const T* __restrict__ xc = static_cast<const T*>(a.xc);
  const T* __restrict__ hc = static_cast<const T*>(a.hc);
  const T* __restrict__ mc = static_cast<const T*>(a.mc);
  const T* __restrict__ c = static_cast<const T*>(a.c);
  const T* __restrict__ m = static_cast<const T*>(a.m);
  const T* g_mem = static_cast<const T*>(a.g_mem);
  const T* g_cn = static_cast<const T*>(a.g_cn);
  const T* g_mn = static_cast<const T*>(a.g_mn);
  const T* g_dc = static_cast<const T*>(a.g_dc);
  const T* g_dm = static_cast<const T*>(a.g_dm);
  T* dxc = static_cast<T*>(a.dxc);
  T* dhc = static_cast<T*>(a.dhc);
  T* dmc = static_cast<T*>(a.dmc);
  T* dc_prev = static_cast<T*>(a.dc_prev);
  T* dm_prev = static_cast<T*>(a.dm_prev);
  const int F = a.F, G = a.F / V;
  const long long n = a.P * G;
  for (long long idx = (long long)blockIdx.x * NT + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * NT) {
    const long long p = idx / G;
    const int j = (int)(idx - p * G) * V;
    const long long px = p * 7 * F + j, ph = p * 4 * F + j, pmc = p * 3 * F + j;
    const long long pf = p * F + j, pm = p * 2 * F + j;
    {   // the c path
      float xs[V], xf[V], xg[V], ys[V], yf[V], yg[V], prev[V], gm[V], go[V],
          gd[V], dprev[V];
      load_v<T, V>(xc + px, xs);
      load_v<T, V>(xc + px + F, xf);
      load_v<T, V>(xc + px + 2 * F, xg);
      load_v<T, V>(hc + ph, ys);
      load_v<T, V>(hc + ph + F, yf);
      load_v<T, V>(hc + ph + 2 * F, yg);
      load_v<T, V>(c + pf, prev);
      load_v<T, V>(at(g_mem, pm), gm);
      load_v<T, V>(at(g_cn, pf), go);
      load_v<T, V>(at(g_dc, pf), gd);
      path_bwd<V>(xs, xf, xg, ys, yf, yg, prev, gm, go, gd, dprev);
      store_v<T, V>(dxc + px, xs);
      store_v<T, V>(dxc + px + F, xf);
      store_v<T, V>(dxc + px + 2 * F, xg);
      store_v<T, V>(dhc + ph, xs);
      store_v<T, V>(dhc + ph + F, xf);
      store_v<T, V>(dhc + ph + 2 * F, xg);
      store_v<T, V>(at(dc_prev, pf), dprev);
    }
    {   // the m path
      float xs[V], xf[V], xg[V], ys[V], yf[V], yg[V], prev[V], gm[V], go[V],
          gd[V], dprev[V];
      load_v<T, V>(xc + px + 3 * F, xs);
      load_v<T, V>(xc + px + 4 * F, xf);
      load_v<T, V>(xc + px + 5 * F, xg);
      load_v<T, V>(mc + pmc, ys);
      load_v<T, V>(mc + pmc + F, yf);
      load_v<T, V>(mc + pmc + 2 * F, yg);
      load_v<T, V>(m + pf, prev);
      load_v<T, V>(at(g_mem, pm + F), gm);
      load_v<T, V>(at(g_mn, pf), go);
      load_v<T, V>(at(g_dm, pf), gd);
      path_bwd<V>(xs, xf, xg, ys, yf, yg, prev, gm, go, gd, dprev);
      store_v<T, V>(dxc + px + 3 * F, xs);
      store_v<T, V>(dxc + px + 4 * F, xf);
      store_v<T, V>(dxc + px + 5 * F, xg);
      store_v<T, V>(dmc + pmc, xs);
      store_v<T, V>(dmc + pmc + F, xf);
      store_v<T, V>(dmc + pmc + 2 * F, xg);
      store_v<T, V>(at(dm_prev, pf), dprev);
    }
    {   // the output gate's gradient, as pass B's backward gave it
      float d_o[V];
      load_v<float, V>(at(a.g_oxh, pf), d_o);
      store_v<T, V>(dxc + px + 6 * F, d_o);
      store_v<T, V>(dhc + ph + 3 * F, d_o);
    }
  }
}

struct ArgsB {
  const float* oxh;    // [P, F] float32
  const void* om;      // conv_o(mem) [P, F]
  const void* last;    // conv_last(mem) [P, F]
  const void* gh;      // backward: the gradient of h' [P, F]
  void* h;             // forward: h' [P, F]
  float* d_oxh;        // backward: [P, F] float32
  void* d_om;          // backward: [P, F]
  void* d_last;        // backward: [P, F]
  long long P;
  int F;
};

template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(NT) st_gates_b_kernel(const ArgsB a) {
  const T* __restrict__ om = static_cast<const T*>(a.om);
  const T* __restrict__ last = static_cast<const T*>(a.last);
  const long long n = a.P * (a.F / V);
  for (long long idx = (long long)blockIdx.x * NT + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * NT) {
    const long long pf = idx * V;     // rows of F channels: p * F + j
    float ox[V], ov[V], lv[V];
    load_v<float, V>(a.oxh + pf, ox);
    load_v<T, V>(om + pf, ov);
    load_v<T, V>(last + pf, lv);
    if constexpr (!BWD) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        ox[e] = __fmul_rn(sigmoid_f(__fadd_rn(ox[e], ov[e])), tanhf(lv[e]));
      store_v<T, V>(static_cast<T*>(a.h) + pf, ox);
    } else {
      float gv[V];
      load_v<T, V>(static_cast<const T*>(a.gh) + pf, gv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float o = sigmoid_f(__fadd_rn(ox[e], ov[e]));
        const float tl = tanhf(lv[e]);
        ox[e] = __fmul_rn(__fmul_rn(__fmul_rn(gv[e], tl), o), __fsub_rn(1.0f, o));
        lv[e] = __fmul_rn(__fmul_rn(gv[e], o), __fsub_rn(1.0f, __fmul_rn(tl, tl)));
      }
      store_v<float, V>(a.d_oxh + pf, ox);
      store_v<T, V>(static_cast<T*>(a.d_om) + pf, ox);
      store_v<T, V>(static_cast<T*>(a.d_last) + pf, lv);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// every non-null pointer 16-byte aligned and F a multiple of 8
bool vector_ok(int F, std::initializer_list<const void*> ptrs) {
  if (F % 8 != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return false;
  return true;
}

unsigned grid_for(long long threads) {
  const long long blocks = (threads + NT - 1) / NT;
  return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename T>
int launch_a_fwd(const ArgsA& a, void* stream) {
  if (a.P < 1 || a.F < 1 || !a.xc || !a.hc || !a.mc || !a.c || !a.m ||
      !a.mem || !a.oxh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector_ok(a.F, {a.xc, a.hc, a.mc, a.c, a.m, a.mem, a.cn, a.mn, a.dcv,
                      a.dmv, a.oxh}))
    st_gates_a_fwd_kernel<T, 8><<<grid_for(a.P * (a.F / 8)), NT, 0, st>>>(a);
  else
    st_gates_a_fwd_kernel<T, 1><<<grid_for(a.P * a.F), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_a_bwd(const ArgsABwd& a, void* stream) {
  if (a.P < 1 || a.F < 1 || !a.xc || !a.hc || !a.mc || !a.c || !a.m ||
      !a.dxc || !a.dhc || !a.dmc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector_ok(a.F, {a.xc, a.hc, a.mc, a.c, a.m, a.g_mem, a.g_cn, a.g_mn,
                      a.g_dc, a.g_dm, a.g_oxh, a.dxc, a.dhc, a.dmc,
                      a.dc_prev, a.dm_prev}))
    st_gates_a_bwd_kernel<T, 8><<<grid_for(a.P * (a.F / 8)), NT, 0, st>>>(a);
  else
    st_gates_a_bwd_kernel<T, 1><<<grid_for(a.P * a.F), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BWD>
int launch_b(const ArgsB& a, void* stream) {
  if (a.P < 1 || a.F < 1 || !a.oxh || !a.om || !a.last ||
      (BWD ? (!a.gh || !a.d_oxh || !a.d_om || !a.d_last) : !a.h))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector_ok(a.F, {a.oxh, a.om, a.last, a.gh, a.h, a.d_oxh, a.d_om,
                      a.d_last}))
    st_gates_b_kernel<T, 8, BWD><<<grid_for(a.P * (a.F / 8)), NT, 0, st>>>(a);
  else
    st_gates_b_kernel<T, 1, BWD><<<grid_for(a.P * a.F), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ArgsA args_a(const void* xc, const void* hc, const void* mc, const void* c,
             const void* m, void* mem, void* cn, void* mn, void* dcv,
             void* dmv, void* oxh, long long P, int F) {
  ArgsA a;
  a.xc = xc, a.hc = hc, a.mc = mc, a.c = c, a.m = m, a.mem = mem;
  a.cn = cn, a.mn = mn, a.dcv = dcv, a.dmv = dmv;
  a.oxh = static_cast<float*>(oxh);
  a.P = P, a.F = F;
  return a;
}

ArgsABwd args_a_bwd(const void* xc, const void* hc, const void* mc,
                    const void* c, const void* m, const void* g_mem,
                    const void* g_cn, const void* g_mn, const void* g_dc,
                    const void* g_dm, const void* g_oxh, void* dxc, void* dhc,
                    void* dmc, void* dc_prev, void* dm_prev, long long P,
                    int F) {
  ArgsABwd a;
  a.xc = xc, a.hc = hc, a.mc = mc, a.c = c, a.m = m;
  a.g_mem = g_mem, a.g_cn = g_cn, a.g_mn = g_mn, a.g_dc = g_dc, a.g_dm = g_dm;
  a.g_oxh = static_cast<const float*>(g_oxh);
  a.dxc = dxc, a.dhc = dhc, a.dmc = dmc, a.dc_prev = dc_prev;
  a.dm_prev = dm_prev;
  a.P = P, a.F = F;
  return a;
}

ArgsB args_b(const void* oxh, const void* om, const void* last,
             const void* gh, void* h, void* d_oxh, void* d_om, void* d_last,
             long long P, int F) {
  ArgsB a;
  a.oxh = static_cast<const float*>(oxh);
  a.om = om, a.last = last, a.gh = gh, a.h = h;
  a.d_oxh = static_cast<float*>(d_oxh);
  a.d_om = d_om, a.d_last = d_last;
  a.P = P, a.F = F;
  return a;
}

}  // namespace

// Pass A: x_cat [P, 7F], h_cat [P, 4F], m_cat [P, 3F], c, m [P, F] in T;
// writes mem [P, 2F], c', m', dc, dm [P, F] in T (the last four may be
// null) and oxh [P, F] in float32.
#define ST_A_FWD(NAME, T)                                                    \
  extern "C" int NAME(const void* xc, const void* hc, const void* mc,        \
                      const void* c, const void* m, void* mem, void* cn,     \
                      void* mn, void* dcv, void* dmv, void* oxh, long long P, \
                      int F, void* stream) {                                 \
    return launch_a_fwd<T>(                                                  \
        args_a(xc, hc, mc, c, m, mem, cn, mn, dcv, dmv, oxh, P, F), stream); \
  }
ST_A_FWD(st_gates_a_fwd_f32, float)
ST_A_FWD(st_gates_a_fwd_bf16, __nv_bfloat16)

// Pass A's backward: the forward's operands, the gradients of mem, c', m',
// dc, dm (T, each may be null) and of oxh (float32, may be null); writes
// dx_cat, dh_cat, dm_cat and dc_prev, dm_prev (these two may be null).
#define ST_A_BWD(NAME, T)                                                    \
  extern "C" int NAME(const void* xc, const void* hc, const void* mc,        \
                      const void* c, const void* m, const void* g_mem,       \
                      const void* g_cn, const void* g_mn, const void* g_dc,  \
                      const void* g_dm, const void* g_oxh, void* dxc,        \
                      void* dhc, void* dmc, void* dc_prev, void* dm_prev,    \
                      long long P, int F, void* stream) {                    \
    return launch_a_bwd<T>(                                                  \
        args_a_bwd(xc, hc, mc, c, m, g_mem, g_cn, g_mn, g_dc, g_dm, g_oxh,   \
                   dxc, dhc, dmc, dc_prev, dm_prev, P, F),                   \
        stream);                                                             \
  }
ST_A_BWD(st_gates_a_bwd_f32, float)
ST_A_BWD(st_gates_a_bwd_bf16, __nv_bfloat16)

// Pass B: oxh [P, F] float32, om and last [P, F] in T; writes h' in T.
#define ST_B_FWD(NAME, T)                                                    \
  extern "C" int NAME(const void* oxh, const void* om, const void* last,     \
                      void* h, long long P, int F, void* stream) {           \
    return launch_b<T, false>(                                               \
        args_b(oxh, om, last, nullptr, h, nullptr, nullptr, nullptr, P, F),  \
        stream);                                                             \
  }
ST_B_FWD(st_gates_b_fwd_f32, float)
ST_B_FWD(st_gates_b_fwd_bf16, __nv_bfloat16)

// Pass B's backward: gh, the gradient of h' in T, and the forward's
// operands; writes d_oxh in float32, d_om and d_last in T.
#define ST_B_BWD(NAME, T)                                                    \
  extern "C" int NAME(const void* gh, const void* oxh, const void* om,       \
                      const void* last, void* d_oxh, void* d_om,             \
                      void* d_last, long long P, int F, void* stream) {      \
    return launch_b<T, true>(                                                \
        args_b(oxh, om, last, gh, nullptr, d_oxh, d_om, d_last, P, F),       \
        stream);                                                             \
  }
ST_B_BWD(st_gates_b_bwd_f32, float)
ST_B_BWD(st_gates_b_bwd_bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
