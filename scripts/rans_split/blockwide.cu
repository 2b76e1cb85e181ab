// clock64 split of the block-barrier K3/K4 (one CTA a plane and image,
// one thread a lane; csrc/rans.cu at commit c21c0ca) with spans in the
// step loop; K4 waits for its next-row load in a span of its own. Built
// and run by scripts/torch_rans_ab.py --split; not part of the package.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kMaxPlanes = 8;
constexpr int kMaxWarps = 8;
constexpr int kEscMax = 256;
constexpr uint32_t kRenormBase = 1u << 16;
constexpr uint32_t kGaussB = 65504u;
constexpr int kSpans = 16;
__device__ __forceinline__ long long clk() { return clock64(); }
__device__ __forceinline__ void sink(uint32_t v) {
  uint32_t o;
  asm volatile("add.u32 %0, %1, 1;" : "=r"(o) : "r"(v));
}
}  // namespace

extern "C" {
struct HykEncPlane {
  const int32_t* start; const int32_t* freq; const int32_t* low; const int32_t* ks;
  int16_t* stream; int32_t* states; int32_t* n_renorm;
  uint8_t* work;  // unused here: the descriptor layout of csrc/rans.cu
  int32_t T; int32_t lanes; int32_t cap; int32_t B; int32_t first_block;
};
}

namespace {
struct EncArgs { HykEncPlane p[kMaxPlanes]; int32_t n_planes; };

// spans: [a] ballot + counter store, [a+1] barrier, [a+2] counter loop
__device__ __forceinline__ void block_rank(bool need, int* cnt, int& buf, int nwarps,
                                           int& rank, int& total, long long* acc, int a) {
  const int lid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c0 = clk();
  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  if (lid == 0) cnt[buf * kMaxWarps + warp] = __popc(ballot);
  const long long c1 = clk();
  __syncthreads();
  const long long c2 = clk();
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
  sink(rank);
  sink(total);
  const long long c3 = clk();
  acc[a] += c1 - c0;
  acc[a + 1] += c2 - c1;
  acc[a + 2] += c3 - c2;
}

__device__ void flush(const long long* acc, unsigned long long* prof, int active) {
  // prof[0..kSpans): sums over active threads; [kSpans, 2 kSpans): thread 0
  for (int i = 0; i < kSpans; ++i) {
    if (active) atomicAdd(prof + i, static_cast<unsigned long long>(acc[i]));
    if (threadIdx.x == 0) prof[kSpans + i] = static_cast<unsigned long long>(acc[i]);
  }
  if (active) atomicAdd(prof + 2 * kSpans, 1ull);
}

// K3 spans: 0 input wait, 1 input loads sent, 2 low push, 3-5 rank1,
// 6 store1, 7 high push (division), 8-10 rank2, 11 store2, 12 whole loop
__global__ void encode_kernel(const EncArgs args, unsigned long long* prof) {
  __shared__ int cnt[2 * kMaxWarps];
  long long acc[kSpans];
  for (int i = 0; i < kSpans; ++i) acc[i] = 0;
  int pi = 0;
  while (pi + 1 < args.n_planes && static_cast<int>(blockIdx.x) >= args.p[pi + 1].first_block) ++pi;
  const HykEncPlane& P = args.p[pi];
  const int b = blockIdx.x - P.first_block;
  const int lanes = P.lanes;
  const int lane = threadIdx.x;
  const bool active = lane < lanes;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int64_t in0 = static_cast<int64_t>(b) * P.T * lanes;
  int16_t* out = P.stream + static_cast<int64_t>(b) * P.cap;
  uint32_t state = kRenormBase;
  int wp = P.cap;
  int buf = 0;
  auto load = [&](int t, uint32_t& st, uint32_t& fr, uint32_t& lo, uint32_t& k) {
    if (active && t >= 0) {
      const int64_t i = in0 + static_cast<int64_t>(t) * lanes + lane;
      st = static_cast<uint32_t>(P.start[i]);
      fr = static_cast<uint32_t>(P.freq[i]);
      lo = static_cast<uint32_t>(P.low[i]);
      k = static_cast<uint32_t>(P.ks[i]);
    } else {
      st = 0u; fr = kRenormBase; lo = 0u; k = 16u;
    }
  };
  uint32_t st, fr, lo, k;
  load(P.T - 1, st, fr, lo, k);
  const long long L0 = clk();
  for (int t = P.T - 1; t >= 0; --t) {
    const long long c0 = clk();
    sink(st); sink(fr); sink(lo); sink(k);
    const long long c1 = clk();
    uint32_t nst, nfr, nlo, nk;
    load(t - 1, nst, nfr, nlo, nk);
    const long long c2 = clk();
    const uint32_t freq_l = 1u << k;
    const bool need_l = (state >> 16) >= freq_l;
    const uint32_t emit_l = state & 0xFFFFu;
    if (need_l) state >>= 16;
    state = ((state >> k) << 16) + (lo << k) + (state & (freq_l - 1u));
    sink(state);
    const long long c3 = clk();
    int rank, total;
    block_rank(need_l, cnt, buf, nwarps, rank, total, acc, 3);
    const long long c4 = clk();
    {
      const int pos = wp - total + rank;
      if (need_l && pos >= 0) out[pos] = static_cast<int16_t>(emit_l);
      wp -= total;
    }
    const long long c5 = clk();
    const bool need_h = (state >> 16) >= fr;
    const uint32_t emit_h = state & 0xFFFFu;
    if (need_h) state >>= 16;
    state = ((state / fr) << 16) + (state % fr) + st;
    sink(state);
    const long long c6 = clk();
    block_rank(need_h, cnt, buf, nwarps, rank, total, acc, 8);
    const long long c7 = clk();
    {
      const int pos = wp - total + rank;
      if (need_h && pos >= 0) out[pos] = static_cast<int16_t>(emit_h);
      wp -= total;
    }
    const long long c8 = clk();
    acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2;
    acc[6] += c5 - c4; acc[7] += c6 - c5; acc[11] += c8 - c7;
    (void)c4; (void)c7;
    st = nst; fr = nfr; lo = nlo; k = nk;
  }
  acc[12] += clk() - L0;
  if (active) P.states[static_cast<int64_t>(b) * lanes + lane] = static_cast<int32_t>(state);
  const int n = P.cap - wp;
  if (threadIdx.x == 0) P.n_renorm[b] = n;
  __syncthreads();
  const long long M0 = clk();
  if (wp > 0) {
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int16_t v = i < n ? out[wp + i] : int16_t(0);
      __syncthreads();
      if (i < n) out[i] = v;
      __syncthreads();
    }
    for (int i = n + threadIdx.x; i < P.cap; i += blockDim.x) out[i] = 0;
  }
  __syncthreads();
  acc[13] += clk() - M0;
  acc[14] = P.T;
  if (blockIdx.x == gridDim.x - 1) flush(acc, prof, active);
}

// K4 spans: 0 search, 1 state update, 2-4 rank1, 5 stream read 1, 6 low pop,
// 7-9 rank2, 10 stream read 2, 11 symbol store, 12 whole loop
__global__ void decode_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ bounds,
                              const int32_t* __restrict__ aux, int aux_stride, int rows, int cols,
                              const uint16_t* __restrict__ stream, int64_t S,
                              const int32_t* __restrict__ states, int32_t* __restrict__ out,
                              int T, int lanes, unsigned long long* prof) {
  extern __shared__ uint32_t smem[];
  __shared__ int cnt[2 * kMaxWarps];
  long long acc[kSpans];
  for (int i = 0; i < kSpans; ++i) acc[i] = 0;
  uint32_t* sb = smem;
  int32_t* s_c = reinterpret_cast<int32_t*>(smem + rows * cols);
  int32_t* s_k = s_c + rows;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) sb[i] = static_cast<uint32_t>(bounds[i]);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_c[r] = aux[r * aux_stride];
    s_k[r] = aux[r * aux_stride + 2];
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
  auto renorm = [&](uint32_t st, int a) -> uint32_t {
    const bool need = st < kRenormBase;
    int rank, total;
    block_rank(need, cnt, buf, nwarps, rank, total, acc, a);
    const long long c0 = clk();
    if (need) {
      const int64_t i = ptr + rank;
      const uint32_t word = i < S ? static_cast<uint32_t>(sp[i]) : 0u;
      st = (st << 16) | word;
    }
    ptr += total;
    sink(st);
    acc[a + 3] += clk() - c0;
    return st;
  };
  auto clamp_row = [rows](int r) { return r < 0 ? 0 : (r >= rows ? rows - 1 : r); };
  int row = clamp_row(rowp[lane]);
  const long long L0 = clk();
  for (int t = 0; t < T; ++t) {
    const long long cn = clk();
    const int next = t + 1 < T ? clamp_row(rowp[static_cast<int64_t>(t + 1) * lanes + lane]) : 0;
    sink(next);
    const long long c0 = clk();
    acc[13] += c0 - cn;
    const uint32_t* br = sb + row * cols;
    const uint32_t slot = state & 0xFFFFu;
    uint32_t start, freq;
    int v = 0;
    if (slot >= kGaussB) {
      start = kGaussB;
      freq = kRenormBase - kGaussB;
    } else {
      int n = cols;
      while (n > 1) {
        const int half = n >> 1;
        if (br[v + half] <= slot) { v += half; n -= half; } else { n = half; }
      }
      start = br[v];
      freq = br[v + 1] - start;
    }
    sink(start); sink(freq);
    const long long c1 = clk();
    state = freq * (state >> 16) + (slot - start);
    sink(state);
    const long long c2 = clk();
    state = renorm(state, 2);
    const long long c3 = clk();
    const uint32_t ks = 16u - static_cast<uint32_t>(s_k[row]);
    const uint32_t slot2 = state & 0xFFFFu;
    const int32_t lowv = static_cast<int32_t>(slot2 >> ks);
    state = ((state >> 16) << ks) + (slot2 & ((1u << ks) - 1u));
    sink(state);
    const long long c4 = clk();
    state = renorm(state, 7);
    const long long c5 = clk();
    const int32_t sym = ((v << s_k[row]) | lowv) - s_c[row];
    op[static_cast<int64_t>(t) * lanes + lane] = sym;
    row = next;
    const long long c6 = clk();
    acc[0] += c1 - c0; acc[1] += c2 - c1; acc[6] += c4 - c3; acc[11] += c6 - c5;
  }
  acc[12] += clk() - L0;
  acc[14] = T;
  if (blockIdx.x == gridDim.x - 1) flush(acc, prof, 1);
}
}  // namespace

extern "C" {
int split_encode(const HykEncPlane* planes, int n_planes, void* prof) {
  const int threads = planes[0].lanes;
  EncArgs args;
  int blocks = 0;
  for (int i = 0; i < n_planes; ++i) {
    args.p[i] = planes[i];
    args.p[i].first_block = blocks;
    blocks += planes[i].B;
  }
  args.n_planes = n_planes;
  encode_kernel<<<blocks, threads>>>(args, static_cast<unsigned long long*>(prof));
  return static_cast<int>(cudaGetLastError());
}
int split_decode(const void* idx, const void* bounds, const void* aux, int aux_stride, int rows,
                int cols, const void* stream, int64_t S, const void* states, void* out, int B,
                int T, int lanes, void* prof) {
  const size_t smem = static_cast<size_t>(rows) * cols * 4 + rows * 8;
  cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  decode_kernel<<<B, lanes, smem>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(aux), aux_stride, rows, cols,
      static_cast<const uint16_t*>(stream), S, static_cast<const int32_t*>(states),
      static_cast<int32_t*>(out), T, lanes, static_cast<unsigned long long*>(prof));
  return static_cast<int>(cudaGetLastError());
}
}
extern "C" const char* split_names_enc() {
  return "input wait,input loads sent,low push,rank1 ballot+store,rank1 barrier,rank1 counter loop,"
         "store1,high push (div),rank2 ballot+store,rank2 barrier,rank2 counter loop,store2,loop total,"
         "back-fill move,,";
}
extern "C" const char* split_names_dec() {
  return "search,state update,rank1 ballot+store,rank1 barrier,rank1 counter loop,stream read1,"
         "low pop,rank2 ballot+store,rank2 barrier,rank2 counter loop,stream read2,symbol store,"
         "loop total,next-row load (forced wait),,";
}

extern "C" const char* split_names(int k4) { return k4 ? split_names_dec() : split_names_enc(); }
