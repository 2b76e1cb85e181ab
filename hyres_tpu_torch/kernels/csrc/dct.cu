// Blockwise JPEG DCT kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two Pallas TPU kernels of hyres_tpu/kernels/dct.py:
//   hyk_fdct_quant   <- fdct_quant_blocks / _fdct_kernel
//       out[n, uv] = clip(round_half_away((sum_xy (x[n, xy] - 128) *
//                    m[xy, uv]) * (1 / q[uv])), -1023, 1023)   (int32)
//   hyk_dequant_idct <- dequant_idct_blocks / _idct_kernel
//       out[n, xy] = clip(sum_uv (c[n, uv] * q[uv]) * m[uv, xy] + 128,
//                    0, 255)                                     (float)
// Both are one (N, 64) @ (64, 64) product with the Kronecker DCT matrix m
// (KRON^T forward, KRON inverse) between an elementwise prologue and
// epilogue. One launch takes every plane of a request (at most three:
// Y, Cb, Cr), each read and written in place: K1 reads the (B, H, W)
// float pixel plane and writes (B, H/8, W/8, 8, 8) int32 coefficients;
// K2 reads (B, H/8, W/8, 8, 8) int8, int16 or int32 coefficients and
// writes the (B, H, W) float plane. The planes' addresses and quant
// tables travel by value in the kernel's parameters, so a call copies
// nothing between host and device.
//
// What bounds them: the main path's three planes of a 768x512 image are
// 9,216 blocks. K1 moves 8 bytes a coefficient (4.7 MB, 1.41 us at
// 3.35 TB/s); K2 from int8 moves 5 (2.9 MB, 0.88 us) and is bound by its
// 64 FP32 FMAs a coefficient (75 MFLOP, 1.13 us at 67 TFLOP/s).
//
// Design: a persistent grid of two CTAs an SM walks tiles of kTile
// blocks across all planes. Each thread owns one output column c for its
// whole life and holds that column of m (64 floats) in registers, loaded
// once per CTA through the read-only path. A tile's rows are staged in
// shared memory with 16-byte cp.async copies, double-buffered so the
// next tile's copy overlaps this tile's FMAs; one pass applies the
// prologue (level shift or dequantization) once per element. The 32
// threads of a warp share their rows, so each row read is a broadcast
// float4: 16 LDS.128 per 64 FMAs of a row, and a thread keeps kRows
// independent sums in flight.
//
// Numerics are bit-identical to a plain per-coefficient loop: every
// output is acc = fmaf(x[k], m[k][c], acc) for k = 0..63 in order, from
// 0.0f, with the same prologue and epilogue (1 / q by precise division).
// No TF32 and no tensor cores: the quantizer's .5 ties would move.
// Launched on the caller's stream; each launcher returns a cudaError_t
// (cudaErrorInvalidValue for arguments it refuses) so the Python wrapper
// can raise.

#include <cuda_runtime.h>
#include <stdint.h>

// One plane of a call, as the host gives it.
struct HykDctPlane {
  const void* in;      // K1: (B, H, W) float; K2: (B, H/8, W/8, 8, 8) coefficients
  void* out;           // K1: (B, H/8, W/8, 8, 8) int32; K2: (B, H, W) float, contiguous
  int64_t in_bstride;  // elements between the input's images; each image contiguous
  int32_t B, H, W;     // H and W multiples of 8
  int32_t pad;
};

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;            // 4 groups of 64 columns
constexpr int kGroups = kThreads / 64;
constexpr int kRows = 4;                 // blocks a thread sums at once
constexpr int kTile = kGroups * kRows;   // blocks a tile
constexpr int kCtasPerSm = 2;

// One plane in the kernel's parameters. Blocks are numbered across the
// planes of a call in order; the plane's own start at `first`.
struct PlaneArgs {
  const void* in;
  void* out;
  int64_t in_bstride;  // elements between the input's images
  int32_t first;       // first block of the plane in the call's count
  int32_t nblk;        // blocks an image: (H / 8) * (W / 8)
  int32_t nw;          // blocks a block row: W / 8
  int32_t W;
};

struct DctArgs {
  PlaneArgs pl[kMaxPlanes];
  float q[kMaxPlanes][64];  // each plane's quant table, natural order
  const float* m;           // (64, 64) right-multiply matrix, row k
  int32_t total;            // blocks of all planes
  int32_t ntiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Plane of block g (g < total). An empty plane shares its `first` with
// the next one, so it is never picked; an unused slot starts at total.
__device__ __forceinline__ int plane_of(const DctArgs& a, int g) {
  return (g >= a.pl[1].first) + (g >= a.pl[2].first);
}

// kForward: K1 (In = float pixels, int32 coefficients out).
// Otherwise K2 (In = int8/int16/int32 coefficients, float pixels out).
template <bool kForward, typename In>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
dct_kernel(const __grid_constant__ DctArgs a) {
  constexpr int kPerChunk = 16 / sizeof(In);         // elements a cp.async
  constexpr int kChunksPerBlock = 64 / kPerChunk;    // K1: 8 rows x 2
  constexpr int kChunks = kTile * kChunksPerBlock;
  __shared__ __align__(16) In raw[2][kTile * 64];
  __shared__ __align__(16) float xs[kTile * 64];
  __shared__ float qs[kMaxPlanes * 64];  // K1: 1 / q; K2: q

  const int tid = threadIdx.x;
  const int c = tid & 63;     // this thread's output column
  const int grp = tid >> 6;   // its rows of a tile: grp * kRows + j

  // stage tile `tile`'s rows into raw[s]: one group per call, empty past
  // the last tile. K1 reads a block row as two 16-byte halves of a plane
  // row; K2 a whole block, which is contiguous.
  auto issue = [&](int tile, int s) {
    if (tile < a.ntiles) {
      for (int ch = tid; ch < kChunks; ch += kThreads) {
        const int row = ch / kChunksPerBlock;
        const int part = ch % kChunksPerBlock;
        const int g = tile * kTile + row;
        if (g >= a.total) break;
        const PlaneArgs& pl = a.pl[plane_of(a, g)];
        const int l = g - pl.first;
        const int b = l / pl.nblk;
        const int rem = l - b * pl.nblk;
        const In* src = static_cast<const In*>(pl.in) + b * pl.in_bstride;
        if (kForward) {
          const int bi = rem / pl.nw;
          const int bj = rem - bi * pl.nw;
          src += static_cast<int64_t>(8 * bi + (part >> 1)) * pl.W + 8 * bj +
                 kPerChunk * (part & 1);
        } else {
          src += static_cast<int64_t>(rem) * 64 + kPerChunk * part;
        }
        cp_async16(&raw[s][row * 64 + kPerChunk * part], src);
      }
    }
    cp_async_commit();
  };

  issue(blockIdx.x, 0);
  issue(blockIdx.x + gridDim.x, 1);

  float m[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) m[k] = __ldg(a.m + k * 64 + c);
  for (int i = tid; i < kMaxPlanes * 64; i += kThreads) {
    const float q = a.q[i >> 6][i & 63];
    qs[i] = kForward ? 1.0f / q : q;
  }

  int s = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x, s ^= 1) {
    cp_async_wait<1>();  // this tile's group; the next may stay in flight
    __syncthreads();     // ... for every thread; xs is free again
    const int g0 = tile * kTile;
    for (int i = tid; i < kTile * 64; i += kThreads) {
      const int g = g0 + (i >> 6);
      if (g >= a.total) break;
      const float v = static_cast<float>(raw[s][i]);
      // forward: level shift; inverse: dequantize
      xs[i] = kForward ? v - 128.0f : v * qs[plane_of(a, g) * 64 + (i & 63)];
    }
    __syncthreads();
    issue(tile + 2 * gridDim.x, s);

    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
    const float4* x4 = reinterpret_cast<const float4*>(xs + grp * kRows * 64);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 v = x4[j * 16 + kk];  // the same address across the warp
        acc[j] = fmaf(v.x, m[4 * kk + 0], acc[j]);
        acc[j] = fmaf(v.y, m[4 * kk + 1], acc[j]);
        acc[j] = fmaf(v.z, m[4 * kk + 2], acc[j]);
        acc[j] = fmaf(v.w, m[4 * kk + 3], acc[j]);
      }
    }

#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int g = g0 + grp * kRows + j;
      if (g >= a.total) break;
      const int p = plane_of(a, g);
      const PlaneArgs& pl = a.pl[p];
      const int l = g - pl.first;
      if (kForward) {
        const float v = __fmul_rn(acc[j], qs[p * 64 + c]);
        float rv = floorf(fabsf(v) + 0.5f);
        rv = v < 0.0f ? -rv : rv;
        rv = fminf(fmaxf(rv, -1023.0f), 1023.0f);
        static_cast<int32_t*>(pl.out)[static_cast<int64_t>(l) * 64 + c] =
            static_cast<int32_t>(rv);
      } else {
        const int b = l / pl.nblk;
        const int rem = l - b * pl.nblk;
        const int bi = rem / pl.nw;
        const int bj = rem - bi * pl.nw;
        const int64_t at = static_cast<int64_t>(b) * pl.nblk * 64 +
                           static_cast<int64_t>(8 * bi + (c >> 3)) * pl.W + 8 * bj + (c & 7);
        static_cast<float*>(pl.out)[at] = fminf(fmaxf(acc[j] + 128.0f, 0.0f), 255.0f);
      }
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return cache[dev];
}

template <bool kForward, typename In>
int launch(const HykDctPlane* planes, int n_planes, const float* qtables, const void* m,
           void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes) return cudaErrorInvalidValue;
  DctArgs a = {};
  int64_t total = 0;
  for (int i = 0; i < kMaxPlanes; ++i) {
    PlaneArgs& pl = a.pl[i];
    pl.first = static_cast<int32_t>(total);
    if (i >= n_planes) continue;
    const HykDctPlane& h = planes[i];
    if (h.B < 0 || h.H < 0 || h.W < 0 || h.H % 8 || h.W % 8) return cudaErrorInvalidValue;
    pl.in = h.in;
    pl.out = h.out;
    pl.in_bstride = h.in_bstride;
    pl.nw = h.W / 8;
    pl.nblk = (h.H / 8) * pl.nw;
    pl.W = h.W;
    for (int k = 0; k < 64; ++k) a.q[i][k] = qtables[i * 64 + k];
    total += static_cast<int64_t>(h.B) * pl.nblk;
    if (total >= (int64_t{1} << 31) - kTile) return cudaErrorInvalidValue;
  }
  if (total == 0) return cudaSuccess;
  a.m = static_cast<const float*>(m);
  a.total = static_cast<int32_t>(total);
  a.ntiles = static_cast<int32_t>((total + kTile - 1) / kTile);
  const int cap = kCtasPerSm * sm_count();
  const int grid = a.ntiles < cap ? a.ntiles : cap;
  dct_kernel<kForward, In><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 on n_planes planes (at most 3) in one launch. qtables: n_planes x 64
// host floats, plane i's table at i * 64. m: device (64, 64) KRON^T.
int hyk_fdct_quant(const HykDctPlane* planes, int n_planes, const float* qtables,
                   const void* m, void* stream) {
  return launch<true, float>(planes, n_planes, qtables, m, stream);
}

// K2 on n_planes planes of in_bytes-wide (1, 2 or 4) integer coefficients.
// m: device (64, 64) KRON.
int hyk_dequant_idct(const HykDctPlane* planes, int n_planes, const float* qtables,
                     int in_bytes, const void* m, void* stream) {
  switch (in_bytes) {
    case 1: return launch<false, int8_t>(planes, n_planes, qtables, m, stream);
    case 2: return launch<false, int16_t>(planes, n_planes, qtables, m, stream);
    case 4: return launch<false, int32_t>(planes, n_planes, qtables, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
