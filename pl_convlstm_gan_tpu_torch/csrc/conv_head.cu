// K2 conv_head_fwd: the forecaster's conv head, a KxK SAME conv from the top
// cell's h [B,H,W,Cin] to out [B,H,W,Cout] with bias, NHWC.
//
// Replaces the head_pass of the TPU rollout kernel
// (pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py, _rollout_body.head_pass).
// There the head writes its prediction into the output frame and into the
// next step's cell-1 input lane; here the caller passes the output slot
// out[t_o] as `out`, and the same slot is the next step's x, so the
// autoregressive feedback needs no copy.
//
// Accumulates in float32 with the bias seeding the accumulator, and stores the
// result in the element type T (float or bfloat16): the rounding points of
// the TPU head_pass.
//
// What bounds it on the card: bytes. At nowcast_128 (Cin=64, Cout=1) it does
// 1152 FLOP per pixel while reading 128 B (bf16) of h per pixel, ~9 FLOP/B,
// far below the ridge: the least time is h read once, 8.4 MB in bf16 at B 4.
// h was written by the last cell just before, so it is read from L2.
//
// Design (the tile is the device code of head_tile.cuh, which K5's head
// phases run too; this kernel is one tile a block):
// - A block of 128 threads owns an 8x8 pixel tile of one batch item: 64
//   pixels, so a B 1 step at 128^2 launches 256 blocks (132 SMs). The tile
//   of h plus its halo, all Cin channels, is staged in shared memory once,
//   by 16-byte cp.async copies (zero fill outside the frame: SAME padding):
//   (8 + K - 1)^2 x Cin, 12.8 KB at Cin 64 in bfloat16.
// - Eight lanes share a pixel and split its channel sum: lane l takes the
//   16-byte vectors l, l + 8, ... of each tap (8 channels in bfloat16, 4 in
//   float32), so every shared-memory read is 16 bytes and the 8 lanes read
//   one contiguous 128-byte run; three warp shuffles add the 8 partial sums.
//   Each group of 8 lanes takes 4 pixels, accumulated side by side.
// - The weights are staged beside h as float32 [tap][ci][co] (2.3 KB for the
//   head), while the copies of h fly. The head of the forecaster (Cout 1,
//   K 3) has its own kernel: a lane reads its channels' weights of a tap
//   once, by 16-byte loads, for its 4 pixels. Every other Cout and odd K
//   takes the generic kernel, which loops over the outputs.
// - Shapes: any B, H, W, Cout and odd K; Cin a multiple of 8 (bfloat16) or 4
//   (float32), so that a pixel's channels are whole 16-byte vectors, and h
//   16-byte aligned. Shared memory bounds K and Cin (the wrapper states the
//   rule).
//
// The C entries launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for shapes
// they do not take).

#include "head_tile.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;

template <typename T, int VPL>
__global__ void __launch_bounds__(HEAD_NT)
conv_head_c1_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out, int H,
                    int W, int Cin, int tiles_w, int tiles_h) {
  extern __shared__ uint4 smem_v[];
  T* const hs = reinterpret_cast<T*>(smem_v);
  float* const ws = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem_v) + head_h_bytes(Cin, 3, sizeof(T)));
  const HeadTileAt t = head_tile_at(blockIdx.x, tiles_w, tiles_h);
  stage_h(h, hs, t, H, W, Cin, 3, threadIdx.x);
  stage_w(w, ws, 9 * Cin, threadIdx.x, HEAD_NT);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  head_compute_c1<T, VPL>(bias, out, H, W, Cin, t, hs, ws, threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(HEAD_NT)
conv_head_kernel(const T* __restrict__ h, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int Cin, int Cout, int K, int tiles_w, int tiles_h) {
  extern __shared__ uint4 smem_v[];
  T* const hs = reinterpret_cast<T*>(smem_v);
  float* const ws = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem_v) + head_h_bytes(Cin, K, sizeof(T)));
  const HeadTileAt t = head_tile_at(blockIdx.x, tiles_w, tiles_h);
  stage_h(h, hs, t, H, W, Cin, K, threadIdx.x);
  stage_w(w, ws, K * K * Cin * Cout, threadIdx.x, HEAD_NT);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  head_compute_generic<T>(bias, out, H, W, Cin, Cout, K, t, hs, ws, threadIdx.x);
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <typename T>
int launch(const void* h, const void* w, const void* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int K, void* stream) {
  constexpr int VN = Vec<T>::N;
  if (B < 1 || H < 1 || W < 1 || Cin < VN || Cin % VN != 0 || Cout < 1 ||
      K < 1 || K % 2 == 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + HEAD_TS - 1) / HEAD_TS, tiles_w = (W + HEAD_TS - 1) / HEAD_TS;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const int nv = Cin / VN;
  int err;
  const size_t smem = head_h_bytes(Cin, K, (int)sizeof(T)) + head_w_bytes(Cin, Cout, K);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (Cout == 1 && K == 3 && nv <= 2 * HEAD_LANES) {
    if (nv <= HEAD_LANES) {
      if ((err = set_smem(conv_head_c1_kernel<T, 1>, smem))) return err;
      conv_head_c1_kernel<T, 1><<<(unsigned)blocks, HEAD_NT, smem, st>>>(
          hp, wp, bp, op, H, W, Cin, tiles_w, tiles_h);
    } else {
      if ((err = set_smem(conv_head_c1_kernel<T, 2>, smem))) return err;
      conv_head_c1_kernel<T, 2><<<(unsigned)blocks, HEAD_NT, smem, st>>>(
          hp, wp, bp, op, H, W, Cin, tiles_w, tiles_h);
    }
  } else {
    if ((err = set_smem(conv_head_kernel<T>, smem))) return err;
    conv_head_kernel<T><<<(unsigned)blocks, HEAD_NT, smem, st>>>(
        hp, wp, bp, op, H, W, Cin, Cout, K, tiles_w, tiles_h);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_head_fwd_f32(const void* h, const void* w,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, int K,
                                 void* stream) {
  return launch<float>(h, w, bias, out, B, H, W, Cin, Cout, K, stream);
}

extern "C" int conv_head_fwd_bf16(const void* h, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int Cin, int Cout, int K,
                                  void* stream) {
  return launch<__nv_bfloat16>(h, w, bias, out, B, H, W, Cin, Cout, K,
                               stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
