// Lane-parallel rANS kernels for Hopper (sm_90a), plain C interface.
//
// Replace the three Pallas TPU kernels of hyres_tpu/coding/pallas_rans.py:
//   hyk_rans_encode  <- _encode_call / _encode_kernel  (K3)
//       per lane, a reverse-time rANS encode of a (T, lanes) plane: push k
//       uniform low bits, then the symbol's (start, freq) by exact
//       u32 / u16 division; renorm words go straight to their final stream
//       slots, back-filled from `cap` downward in decoder read order
//       (step ascending, then [high, low], then lane ascending). Several
//       planes of different lanes, T and cap share one launch.
//   hyk_rans_decode(gauss=1) <- _decode_call / _decode_kernel  (K4)
//       forward decode of segment-table gaussian planes: h = rank of the
//       slot among the row's 128 bounds, state update, renorm read, pop of
//       the k low bits, second renorm read; sym = (h << k | low) - c.
//   hyk_rans_decode(gauss=0) <- _eb_decode_call / _eb_decode_kernel  (K5)
//       the same decode for factorized-prior planes: sym = rank + offset,
//       no low bits.
//
// Layout: one CTA per (plane, image), one thread per lane. Each thread
// keeps its lane's u32 state in a register. The plane's shared stream
// pointer advances by the block-wide count of lanes that renormalise:
// __ballot_sync/__popc inside a warp, warp totals through shared memory
// (double-buffered, so one __syncthreads per renorm round).
//
// What bounds them: the scan is serial in time. A 768x512 request's y
// half-plane is T = 4,608 dependent steps of 128 lanes, so the kernels sit
// at the latency of one step (a few shared-memory and L2 round trips and
// two block barriers) times T, orders of magnitude above the bytes they
// move (about 5 MB per y plane). The design does the simple thing: inputs
// of the next step are loaded before the current step computes, the
// decode tables live in shared memory, and the rank is a binary search
// over the row's non-decreasing bounds, which equals the TPU kernel's
// count of bounds <= slot.
//
// The TPU kernels compare integer-valued f32 and divide by limbs because
// Mosaic lacks u32 division and u32<->f32 casts; here every coder
// quantity is uint32_t, with plain / and %. The wire is the same by
// exactness. Launched on the caller's stream; each launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kMaxWarps = 8;   // lanes <= 256
constexpr int kEscMax = 256;   // escape side-list capacity
constexpr uint32_t kRenormBase = 1u << 16;
constexpr uint32_t kGaussB = 65504u;  // [kGaussB, 2^16) is the escape bin

}  // namespace

extern "C" {

// One plane of a fused encode launch: B images, each its own CTA.
// Inputs (B, T, lanes) int32; outputs stream (B, cap) int16 (u16 bits),
// states (B, lanes) int32 (u32 bits), n_renorm (B,) int32.
struct HykEncPlane {
  const int32_t* start;
  const int32_t* freq;
  const int32_t* low;
  const int32_t* ks;
  int16_t* stream;
  int32_t* states;
  int32_t* n_renorm;
  int32_t T;
  int32_t lanes;
  int32_t cap;
  int32_t B;
  int32_t first_block;
};

}  // extern "C"

namespace {

struct EncArgs {
  HykEncPlane p[kMaxPlanes];
  int32_t n_planes;
};

// Block-wide exclusive rank of `need` and its total. Every thread of the
// block calls it (threads past the plane's lanes pass need = false).
// cnt: 2 * kMaxWarps ints of shared memory, alternated by `buf`.
__device__ __forceinline__ void block_rank(bool need, int* cnt, int& buf,
                                           int nwarps, int& rank, int& total) {
  const int lid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  if (lid == 0) cnt[buf * kMaxWarps + warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w) {
    if (w < nwarps) {
      const int c = cnt[buf * kMaxWarps + w];
      before += w < warp ? c : 0;
      total += c;
    }
  }
  buf ^= 1;
  rank = before + __popc(ballot & ((1u << lid) - 1u));
}

__global__ void encode_kernel(const EncArgs args) {
  __shared__ int cnt[2 * kMaxWarps];
  int pi = 0;
  while (pi + 1 < args.n_planes &&
         static_cast<int>(blockIdx.x) >= args.p[pi + 1].first_block) {
    ++pi;
  }
  const HykEncPlane& P = args.p[pi];
  const int b = blockIdx.x - P.first_block;
  const int lanes = P.lanes;
  const int lane = threadIdx.x;
  const bool active = lane < lanes;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int64_t in0 = static_cast<int64_t>(b) * P.T * lanes;
  int16_t* out = P.stream + static_cast<int64_t>(b) * P.cap;

  uint32_t state = kRenormBase;
  int wp = P.cap;  // next free slot + 1, filling downward; < 0 on overflow
  int buf = 0;

  auto load = [&](int t, uint32_t& st, uint32_t& fr, uint32_t& lo,
                  uint32_t& k) {
    if (active && t >= 0) {
      const int64_t i = in0 + static_cast<int64_t>(t) * lanes + lane;
      st = static_cast<uint32_t>(P.start[i]);
      fr = static_cast<uint32_t>(P.freq[i]);
      lo = static_cast<uint32_t>(P.low[i]);
      k = static_cast<uint32_t>(P.ks[i]);
    } else {  // exact identity step: never renormalises, state unchanged
      st = 0u;
      fr = kRenormBase;
      lo = 0u;
      k = 16u;
    }
  };
  auto push_words = [&](bool need, uint32_t word) {
    int rank, total;
    block_rank(need, cnt, buf, nwarps, rank, total);
    const int pos = wp - total + rank;
    if (need && pos >= 0) out[pos] = static_cast<int16_t>(word);
    wp -= total;
  };

  uint32_t st, fr, lo, k;
  load(P.T - 1, st, fr, lo, k);
  for (int t = P.T - 1; t >= 0; --t) {
    uint32_t nst, nfr, nlo, nk;
    load(t - 1, nst, nfr, nlo, nk);
    // push LOW first (the decoder pops high, then low)
    const uint32_t freq_l = 1u << k;
    const bool need_l = (state >> 16) >= freq_l;
    const uint32_t emit_l = state & 0xFFFFu;
    if (need_l) state >>= 16;
    state = ((state >> k) << 16) + (lo << k) + (state & (freq_l - 1u));
    push_words(need_l, emit_l);
    // push HIGH: exact u32 / u16
    const bool need_h = (state >> 16) >= fr;
    const uint32_t emit_h = state & 0xFFFFu;
    if (need_h) state >>= 16;
    state = ((state / fr) << 16) + (state % fr) + st;
    push_words(need_h, emit_h);
    st = nst;
    fr = nfr;
    lo = nlo;
    k = nk;
  }

  if (active) {
    P.states[static_cast<int64_t>(b) * lanes + lane] =
        static_cast<int32_t>(state);
  }
  const int n = P.cap - wp;  // exact renorm word count, even past the cap
  if (threadIdx.x == 0) P.n_renorm[b] = n;
  __syncthreads();
  if (wp > 0) {
    // move [wp, cap) to the front; a round's writes land below every
    // later round's reads, so two barriers per round make it safe
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int16_t v = i < n ? out[wp + i] : int16_t(0);
      __syncthreads();
      if (i < n) out[i] = v;
      __syncthreads();
    }
    for (int i = n + threadIdx.x; i < P.cap; i += blockDim.x) out[i] = 0;
  }
}

// K4 (kGauss) and K5 (!kGauss). Shared memory: the bounds table
// (rows, cols) as u32, then per row [c | offset] and [k].
template <bool kGauss>
__global__ void decode_kernel(const int32_t* __restrict__ idx,
                              const int32_t* __restrict__ bounds,
                              const int32_t* __restrict__ aux, int aux_stride,
                              int rows, int cols,
                              const uint16_t* __restrict__ stream, int64_t S,
                              const int32_t* __restrict__ states,
                              const int32_t* __restrict__ esc_pos,
                              const int32_t* __restrict__ esc_val,
                              int32_t* __restrict__ out, int T, int lanes) {
  extern __shared__ uint32_t smem[];
  __shared__ int cnt[2 * kMaxWarps];
  uint32_t* sb = smem;
  int32_t* s_c = reinterpret_cast<int32_t*>(smem + rows * cols);
  int32_t* s_k = s_c + rows;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    sb[i] = static_cast<uint32_t>(bounds[i]);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_c[r] = aux[r * aux_stride];
    s_k[r] = kGauss ? aux[r * aux_stride + 2] : 0;
  }
  __syncthreads();

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int64_t padded = static_cast<int64_t>(T) * lanes;
  const int32_t* rowp = idx + b * padded;
  const uint16_t* sp = stream + b * S;
  int32_t* op = out + b * padded;
  uint32_t state = static_cast<uint32_t>(states[b * lanes + lane]);
  int64_t ptr = 0;
  int buf = 0;

  auto renorm = [&](uint32_t st) -> uint32_t {
    const bool need = st < kRenormBase;
    int rank, total;
    block_rank(need, cnt, buf, nwarps, rank, total);
    if (need) {
      const int64_t i = ptr + rank;
      const uint32_t word = i < S ? static_cast<uint32_t>(sp[i]) : 0u;
      st = (st << 16) | word;
    }
    ptr += total;
    return st;
  };

  // table rows are clamped into range: a corrupt index never reads
  // outside the shared-memory table
  auto clamp_row = [rows](int r) { return r < 0 ? 0 : (r >= rows ? rows - 1 : r); };
  int row = clamp_row(rowp[lane]);
  for (int t = 0; t < T; ++t) {
    const int next =
        t + 1 < T ? clamp_row(rowp[static_cast<int64_t>(t + 1) * lanes + lane]) : 0;
    const uint32_t* br = sb + row * cols;
    const uint32_t slot = state & 0xFFFFu;
    uint32_t start, freq;
    int v = 0;
    if (kGauss && slot >= kGaussB) {
      start = kGaussB;
      freq = kRenormBase - kGaussB;
    } else {
      // largest v with br[v] <= slot (br[0] = 0, non-decreasing row)
      int n = cols;
      while (n > 1) {
        const int half = n >> 1;
        if (br[v + half] <= slot) {
          v += half;
          n -= half;
        } else {
          n = half;
        }
      }
      start = br[v];
      freq = br[v + 1] - start;
    }
    state = freq * (state >> 16) + (slot - start);
    state = renorm(state);
    int32_t sym;
    if (kGauss) {
      const uint32_t ks = 16u - static_cast<uint32_t>(s_k[row]);
      const uint32_t slot2 = state & 0xFFFFu;
      const int32_t lowv = static_cast<int32_t>(slot2 >> ks);
      state = ((state >> 16) << ks) + (slot2 & ((1u << ks) - 1u));
      state = renorm(state);
      sym = ((v << s_k[row]) | lowv) - s_c[row];
    } else {
      sym = v + s_c[row];
    }
    op[static_cast<int64_t>(t) * lanes + lane] = sym;
    row = next;
  }
  __syncthreads();
  // substitute escaped values from the side list (padding positions drop)
  for (int i = threadIdx.x; i < kEscMax; i += blockDim.x) {
    const int32_t p = esc_pos[b * kEscMax + i];
    if (p >= 0 && p < padded) op[p] = esc_val[b * kEscMax + i];
  }
}

template <bool kGauss>
int launch_decode(const int32_t* idx, const int32_t* bounds,
                  const int32_t* aux, int aux_stride, int rows, int cols,
                  const uint16_t* stream, int64_t S, const int32_t* states,
                  const int32_t* esc_pos, const int32_t* esc_val,
                  int32_t* out, int B, int T, int lanes, cudaStream_t cs) {
  const size_t smem = static_cast<size_t>(rows) * cols * 4 + rows * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<kGauss>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<kGauss><<<B, lanes, smem, cs>>>(
      idx, bounds, aux, aux_stride, rows, cols, stream, S, states, esc_pos,
      esc_val, out, T, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3: planes[0..n_planes) in one launch of sum(B) CTAs of `threads`
// threads (the largest lanes among the planes, a multiple of 32).
int hyk_rans_encode(const HykEncPlane* planes, int n_planes, int threads,
                    void* stream) {
  if (n_planes <= 0 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncArgs args;
  int blocks = 0;
  for (int i = 0; i < n_planes; ++i) {
    args.p[i] = planes[i];
    args.p[i].first_block = blocks;
    blocks += planes[i].B;
  }
  args.n_planes = n_planes;
  if (blocks == 0) return 0;
  encode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// K4 (gauss != 0) / K5: idx (B, T, lanes) int32 table rows; bounds
// (rows, cols) int32; aux (rows, aux_stride) int32 with c (K4) or the
// offset (K5) in column 0 and k (K4) in column 2; stream (B, S) u16;
// states (B, lanes) u32 bits; esc_pos/esc_val (B, 256) int32
// -> out (B, T, lanes) int32 symbols.
int hyk_rans_decode(int gauss, const void* idx, const void* bounds,
                    const void* aux, int aux_stride, int rows, int cols,
                    const void* stream, int64_t S, const void* states,
                    const void* esc_pos, const void* esc_val, void* out,
                    int B, int T, int lanes, void* cuda_stream) {
  if (B <= 0 || T <= 0) return 0;
  const auto cs = static_cast<cudaStream_t>(cuda_stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* ax = static_cast<const int32_t*>(aux);
  const auto* sm = static_cast<const uint16_t*>(stream);
  const auto* st = static_cast<const int32_t*>(states);
  const auto* ep = static_cast<const int32_t*>(esc_pos);
  const auto* ev = static_cast<const int32_t*>(esc_val);
  auto* o = static_cast<int32_t*>(out);
  return gauss ? launch_decode<true>(i, bd, ax, aux_stride, rows, cols, sm, S,
                                     st, ep, ev, o, B, T, lanes, cs)
               : launch_decode<false>(i, bd, ax, aux_stride, rows, cols, sm,
                                      S, st, ep, ev, o, B, T, lanes, cs);
}

}  // extern "C"
