// Windowed multi-head self-attention for Hopper (sm_90a): kernel K7, plain
// C interface.
//
// The core of the Swin / SCUNet window attention (WMSA) that TCM's
// transformer blocks run, type W (windows in place) or SW (windows over
// the image rolled by (-p/2, -p/2)). It reads qkv, the (B, H, W, 3C)
// float output of one Linear(C -> 3C) on the unrolled image: q, k and v
// are its channel thirds, head h owning channels [h d, (h + 1) d) of each
// ((threeh c) layout). For each window of p x p tokens and each head:
//
//   S[i, j] = (q_i . k_j) * scale + bias[head, i, j]
//   S[i, j] = -inf          (SW only, i and j on two sides of the wrap)
//   o_i     = sum_j softmax(S[i, :])_j v_j
//
// and writes o as (B, H, W, C) in image order, the heads concatenated. The
// roll, the window partition and its inverse are index arithmetic: token
// (r, c) of window (wr, wc) of the rolled image is pixel ((wr p + r +
// shift) mod H, (wc p + c + shift) mod W), and its output goes back to that
// pixel, so the roll back is free. bias is the relative-position table
// already gathered to (heads, p^2, p^2). The SW mask is SCUNet's
// generate_mask (Swin's region mask): in the last row of windows a query
// row r and a key row r' are split when one is below p - p/2 and the
// other is not, and the same for columns in the last column of windows.
//
// Design: one thread a query, a group of p^2 threads a (window, head)
// item, kThreads / p^2 items a CTA, the items of one window's heads next
// to each other. The group stages its item's k and v rows (p^2 x d
// floats each) in shared memory; each thread keeps its q row and its
// p^2 scores in registers, takes the row max, exponentiates, and sums
// e_j v_j against the staged v rows, dividing by the sum once at the end.
// A group's threads read the same k or v element at once (a broadcast).
// Every output comes from a fixed order of float32 operations that only
// its own window's data enters, so results are deterministic and the
// same whatever the batch or the window's place in the grid. No TF32:
// plain FMAs in float32.
//
// What bounds it: at TCM's first stage (768x512 image: 384 x 256 tokens,
// C = 128, 16 heads of 8, p = 8) a call reads qkv once (151 MB) and
// writes o once (50 MB): 60 us at 3.35 TB/s; QK^T and PV are 3.2 GFLOP,
// 48 us at 67 TFLOP/s. Launched on the caller's stream; the launcher
// returns a cudaError_t (cudaErrorInvalidValue for arguments it refuses).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int P, int D>
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                   float* __restrict__ out, int H, int W, int C, int heads, int nwr,
                   int nwc, int shifted, float scale, long long items) {
  constexpr int P2 = P * P;
  constexpr int kItems = kThreads / P2;
  constexpr int kStride = P2 * D + 4;  // floats an item; +4 moves items off one bank
  constexpr int kSplit = P - P / 2;    // SCUNet's s = p - shift
  __shared__ __align__(16) float ks[kItems * kStride];
  __shared__ __align__(16) float vs[kItems * kStride];

  const int g = threadIdx.x / P2;
  const int i = threadIdx.x % P2;
  const long long item = (long long)blockIdx.x * kItems + g;
  const bool live = item < items;
  const int shift = shifted ? P / 2 : 0;

  long long t = live ? item : 0;
  const int hh = (int)(t % heads);
  t /= heads;
  const int wc = (int)(t % nwc);
  t /= nwc;
  const int wr = (int)(t % nwr);
  const long long b = t / nwr;
  const int r = i / P, c = i % P;
  int y = wr * P + r + shift;
  int x = wc * P + c + shift;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
  const long long pix = (b * H + y) * W + x;
  const float* tok = qkv + pix * 3 * C + hh * D;

  float q[D];
  float* kdst = ks + g * kStride + i * D;
  float* vdst = vs + g * kStride + i * D;
  if (live) {
#pragma unroll
    for (int e = 0; e < D; e += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(tok + e);
      q[e] = qq.x;
      q[e + 1] = qq.y;
      q[e + 2] = qq.z;
      q[e + 3] = qq.w;
      *reinterpret_cast<float4*>(kdst + e) = *reinterpret_cast<const float4*>(tok + C + e);
      *reinterpret_cast<float4*>(vdst + e) = *reinterpret_cast<const float4*>(tok + 2 * C + e);
    }
  }
  __syncthreads();
  if (!live) return;

  // which side of the wrap a token lies on, in the last row / column of windows
  const bool row_cut = shifted && wr == nwr - 1;
  const bool col_cut = shifted && wc == nwc - 1;
  const bool ri = r >= kSplit, ci = c >= kSplit;
  const float* brow = bias + ((long long)hh * P2 + i) * P2;
  const float* kk = ks + g * kStride;
  const float* vv = vs + g * kStride;

  float s[P2];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < P2; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc = fmaf(q[e], kk[j * D + e], acc);
    const bool cut =
        (row_cut && ((j / P >= kSplit) != ri)) || (col_cut && ((j % P >= kSplit) != ci));
    s[j] = cut ? -INFINITY : __fadd_rn(__fmul_rn(acc, scale), __ldg(brow + j));
    m = fmaxf(m, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < P2; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }
  float o[D];
#pragma unroll
  for (int e = 0; e < D; ++e) o[e] = 0.f;
#pragma unroll
  for (int j = 0; j < P2; ++j) {
#pragma unroll
    for (int e = 0; e < D; ++e) o[e] = fmaf(s[j], vv[j * D + e], o[e]);
  }
  const float inv = 1.f / sum;
  float* dst = out + pix * C + hh * D;
#pragma unroll
  for (int e = 0; e < D; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(o[e] * inv, o[e + 1] * inv, o[e + 2] * inv, o[e + 3] * inv);
}

template <int P, int D>
int launch(const float* qkv, const float* bias, float* out, int B, int H, int W, int C,
           int shifted, float scale, cudaStream_t stream) {
  constexpr int kItems = kThreads / (P * P);
  const int heads = C / D, nwr = H / P, nwc = W / P;
  const long long items = (long long)B * nwr * nwc * heads;
  const long long grid = (items + kItems - 1) / kItems;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_attn_kernel<P, D><<<(unsigned)grid, kThreads, 0, stream>>>(
      qkv, bias, out, H, W, C, heads, nwr, nwc, shifted, scale, items);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7 on qkv (B, H, W, 3C) float, contiguous -> out (B, H, W, C) float,
// contiguous; bias (C / d, p^2, p^2) float. p in {4, 8}, d in {8, 16, 32},
// H and W multiples of p, C a multiple of d. shifted: 0 for W, 1 for SW.
int hyk_window_attn(const float* qkv, const float* bias, float* out, int B, int H, int W,
                    int C, int p, int d, int shifted, float scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % d || H % p || W % p)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HYK_K7(PP, DD) \
  if (p == PP && d == DD) return launch<PP, DD>(qkv, bias, out, B, H, W, C, shifted, scale, s);
  HYK_K7(4, 8) HYK_K7(4, 16) HYK_K7(4, 32) HYK_K7(8, 8) HYK_K7(8, 16) HYK_K7(8, 32)
#undef HYK_K7
  return cudaErrorInvalidValue;
}

}  // extern "C"
