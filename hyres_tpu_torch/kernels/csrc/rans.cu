// Lane-parallel rANS kernels for Hopper (sm_90a), plain C interface.
//
// Replace the three Pallas TPU kernels of hyres_tpu/coding/pallas_rans.py:
//   hyk_rans_encode  <- _encode_call / _encode_kernel  (K3)
//       per lane, a reverse-time rANS encode of a (T, lanes) plane: push k
//       uniform low bits, then the symbol's (start, freq) by exact
//       u32 / u16 division; the renorm words land from offset 0 in
//       decoder read order (step ascending, then [high, low], then lane
//       ascending). Several planes of different lanes, T and cap share
//       one launch.
//   hyk_rans_decode(gauss=1) <- _decode_call / _decode_kernel  (K4)
//       forward decode of segment-table gaussian planes: h = rank of the
//       slot among the row's 128 bounds, state update, renorm read, pop of
//       the k low bits, second renorm read; sym = (h << k | low) - c.
//   hyk_rans_decode(gauss=0) <- _eb_decode_call / _eb_decode_kernel  (K5)
//       the same decode for factorized-prior planes: sym = rank + offset,
//       no low bits.
// and, for Gaussian-mixture planes (Cheng2020 with K components; no TPU
// kernel codes them):
//   hyk_gmm_rows  (K6)
//       one coding row an element from its (logits, means, scales), in
//       integer arithmetic after a fixed-point rounding of the floats (see
//       the K6 section), so that encoder and decoder build equal rows.
//   hyk_gmm_decode
//       K4's step on per-element rows streamed from global memory through
//       a shared-memory ring, instead of a shared-memory table: the
//       kGmmRow kind of K4's kernel template.
//
// What bounds them: the scan is serial in time. A 768x512 request's y
// half-plane is T = 4,608 dependent steps of 128 lanes, so each kernel
// sits at T times the time of one step, orders of magnitude above the
// bytes it moves (about 5 MB per y plane). The designs work on the step:
// no block barrier inside the step loop, every operand of a step already
// in registers or shared memory, and as few instructions a step as the
// one warp that runs it can dispatch.
//
// K4 and K5: one warp per (plane, image), one kernel template. Thread j
// holds lanes L*j .. L*j + L - 1 (L = lanes / 32 <= 8) in registers, so
// its table rows and output symbols are one 16-byte access a step where
// L % 4 == 0 (8-byte where L % 2 == 0). A renorm round's rank comes from
// one register ballot per sub-lane (the lanes of lower threads, then the
// thread's own lower sub-lanes), which keeps lane-ascending order. The
// table rows stream through a shared-memory ring kAhead steps ahead with
// cp.async (each thread copies and reads only its own lanes', so a
// cp.async.wait_group a step is the only wait); the stream sits in a
// shared-memory ring of kChunks chunks, refilled with cp.async a chunk at
// a time as the read pointer crosses one (words past S arrive as 0). The
// rank search is narrowed by a per-row LUT over slot >> shift, built in
// the prologue by the whole block, whose other warps then exit: a
// branch-free binary search over [lut[s], lut[s + 1]], the warp's
// sub-lanes in lockstep, its first probe unconditional (one suffices on
// typical data), keeping br[v] and br[v + n] so no load follows it. A
// 65536 sentinel column closes every row (so K4's escape bin ranks like
// any segment). A K4 step's chain: a LUT load, two bound loads, the
// short search, two ballot rounds, two shared-memory stream reads; a K5
// step has one round and no low bits. K5 tables too large for the LUT
// layout (see decode_kind) take the same step with a search over the
// whole row, read from global memory.
// K3: one CTA per (plane, image), one warp per 32 lanes, two phases (see
// the K3 section): the lanes' states never depend on each other, only
// where their words land, so each warp runs its lanes with no barrier,
// its words going to a staging stream of its own with per-push counts,
// and the block interleaves the staging streams in decoder order after
// one barrier. A warp's step is the state chain, two ballots and stores;
// the division is a float reciprocal estimate, off by at most one, and
// one fixup (divmod_u16), not the ~20 instructions of u32 / and %.
//
// The TPU kernels compare integer-valued f32 and divide by limbs because
// Mosaic lacks u32 division and u32<->f32 casts; here every coder
// quantity is uint32_t, with exact division. The wire is the same by
// exactness. Launched on the caller's stream; each launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 16;  // EncArgs: 88 bytes a plane, a 4 KB parameter limit
constexpr int kMaxWarps = 8;   // lanes <= 256
constexpr int kEscMax = 256;   // escape side-list capacity
constexpr uint32_t kRenormBase = 1u << 16;
constexpr uint32_t kGaussB = 65504u;  // [kGaussB, 2^16) is the escape bin
constexpr unsigned kFull = 0xffffffffu;

// K4/K5 pipeline: table rows kAhead steps in flight, in a ring of kSlots
// steps (each thread reuses a slot only after it read it)
constexpr int kAhead = 8;
constexpr int kSlots = 16;
// The mixture decode's: a head and 32 u16 bounds an element (64 bytes a
// row), fewer steps in flight so that 256 lanes' ring fits shared memory
constexpr int kGmmSeg = 32;
constexpr int kGmmRowBytes = kGmmSeg * 2;
constexpr int kGmmAhead = 6;
constexpr int kGmmSlots = 8;  // > kGmmAhead
// Rank LUTs: per row and bucket s of 2^shift slots, the byte pair
// (lut[s], lut[s + 1]) as one u16 (2^(16 - shift) + 1 entries, the last
// for the bucket past the top). K4's over slot >> 6 takes 2052 bytes a
// row; K5's over slot >> 8, 516, so that 128 rows fit beside the rings.
constexpr int kGaussLutShift = 6;
constexpr int kEbLutShift = 8;
// K4/K5 stream ring: kChunks chunks of 2048 words. A step reads at most
// 2 * 256 words, so chunk cur + 1 must be in place while the pointer is
// in chunk cur; a chunk is requested 5 chunks (>= 20 steps) before that,
// far more than the kAhead steps a cp.async group may stay in flight.
constexpr int kChunkLog2 = 11;
constexpr int kChunkWords = 1 << kChunkLog2;
constexpr int kChunks = 8;
constexpr int kRingWords = kChunks * kChunkWords;
constexpr int kPrologueThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB a block

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
  uint8_t* work;  // hyk_rans_encode_work(T, lanes, cap) bytes an image
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

// -- cp.async and warp primitives -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes, of which the first src_bytes come from src and the rest are 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread j of a warp holds lanes L*j .. L*j + L - 1 (its sub-lanes i).

// Warp-wide exclusive rank of need[i] in lane order and the round's
// total, from one register ballot per sub-lane: the lanes of lower
// threads, then the thread's own lower sub-lanes.
template <int L>
__device__ __forceinline__ int warp_rank(const bool (&need)[L], int (&rank)[L]) {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const unsigned ballot = __ballot_sync(kFull, need[i]);
    before += __popc(ballot & lt);
    total += __popc(ballot);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    rank[i] = before;
    before += need[i];
  }
  return total;
}

// A thread's L consecutive int32 from device to shared memory: 16-byte
// cp.async where L % 4 == 0 (both addresses 16-byte aligned), 8-byte where
// L % 2 == 0, else 4-byte.
template <int L>
__device__ __forceinline__ void cp_lanes(int32_t* dst, const int32_t* src) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 4) cp_async16(dst + i, src + i, 16);
  } else if constexpr (L % 2 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 2) cp_async8(dst + i, src + i);
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) cp_async4(dst + i, src + i);
  }
}

// A thread's L consecutive int32 from shared memory (16-byte aligned
// for L % 4 == 0, 8-byte for L % 2 == 0).
template <int L>
__device__ __forceinline__ void lds_lanes(uint32_t (&v)[L], const int32_t* src) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      const int4 x = *reinterpret_cast<const int4*>(src + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else if constexpr (L % 2 == 0) {
#pragma unroll
    for (int i = 0; i < L; i += 2) {
      const int2 x = *reinterpret_cast<const int2*>(src + i);
      v[i] = x.x;
      v[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = src[i];
  }
}

__device__ __forceinline__ float rcp_approx(uint32_t d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__uint2float_rn(d)));
  return r;
}

// q = n / d and r = n % d for d in [1, 2^16] and n < d * 2^16, given
// rcp = rcp_approx(d): the float estimate of n / d < 2^16 is within 0.05
// of it, so its truncation is off by at most one, and one fixup each way
// makes it exact (held against plain division for every d by the card
// tests, through hyk_divmod_check).
__device__ __forceinline__ uint32_t divmod_u16(uint32_t n, uint32_t d, float rcp,
                                               uint32_t& r) {
  uint32_t q = __float2uint_rz(__uint2float_rz(n) * rcp);
  int32_t rem = static_cast<int32_t>(n - q * d);
  if (rem < 0) {
    --q;
    rem += static_cast<int32_t>(d);
  } else if (rem >= static_cast<int32_t>(d)) {
    ++q;
    rem -= static_cast<int32_t>(d);
  }
  r = static_cast<uint32_t>(rem);
  return q;
}

__global__ void divmod_check_kernel(const uint32_t* n, const uint32_t* d, uint32_t* q,
                                    uint32_t* r, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) q[i] = divmod_u16(n[i], d[i], rcp_approx(d[i]), r[i]);
}

// -- K3 ---------------------------------------------------------------------
//
// Two phases in one CTA per (plane, image), W = lanes / 32 warps.
//   1. Warp w runs lanes 32w .. 32w + 31 through every step with no
//      block barrier: each push's renorm words take their rank in the
//      warp from a register ballot and go to the warp's own staging
//      stream, back-filled from `cap` downward (so in decoder order), and
//      lane 0 records the warp's word count for the (step, push).
//   2. After one __syncthreads the whole block interleaves the W staging
//      streams into the plane's stream in decoder read order (step
//      ascending, [high, low], then lane ascending = warp ascending): a
//      block-wide scan of the counts gives every (step, push, warp) its
//      offset in the stream and in its staging stream.
// Work buffer (per plane and image, hyk_rans_encode_work bytes): staging
// (W, cap) u16, then counts (T, 2, 8) u8 (high push first; warps padded
// to 8).

constexpr int kEncAhead = 16;  // steps of inputs in flight a warp
constexpr int kEncSlots = 32;  // ring slots a warp (> kEncAhead, power of 2)

__host__ __device__ inline int64_t align16(int64_t x) { return (x + 15) & ~int64_t(15); }

__host__ __device__ inline int64_t enc_work_bytes(int T, int lanes, int cap) {
  return align16(int64_t(lanes / 32) * cap * 2) + align16(int64_t(T) * 2 * 8);
}

__host__ __device__ inline int enc_smem_bytes(int max_lanes) {
  // words a warp | scan of (total, per-warp sums) a thread | input rings
  return static_cast<int>(64 + align16(9 * max_lanes * 4) +
                          (max_lanes / 32) * kEncSlots * 4 * 32 * 4);
}

// Phase 1 for warp w. ring: kEncSlots steps of [start | freq | low | ks],
// 32 int32 each; stage: the warp's staging stream (cap words). Returns
// the warp's exact word count. The inputs are 16-byte aligned: a step's
// 512 bytes are one 16-byte cp.async a thread, not four 4-byte copies of
// its own lanes (copy instructions are dear to a warp that dispatches every
// one of a step), so the warp reads them after a __syncwarp.
__device__ __forceinline__ int encode_warp(const HykEncPlane& P, int b, int w, int32_t* ring,
                                           uint16_t* stage, uint8_t* counts) {
  const int j = threadIdx.x & 31;
  const int T = P.T, lanes = P.lanes;
  const int64_t in0 = static_cast<int64_t>(b) * T * lanes + 32 * w + j;
  const int32_t* src[4] = {P.start + in0, P.freq + in0, P.low + in0, P.ks + in0};
  // one cp.async group per step (empty past the plane's first step):
  // thread j copies 16 bytes, lanes 4 (j % 8) .. + 3 of array j / 8
  const int32_t* vsrc = src[j >> 3] - j + 4 * (j & 7);
  auto fetch = [&](int t) {
    if (t >= 0) {
      cp_async16(ring + (t & (kEncSlots - 1)) * 128 + 32 * (j >> 3) + 4 * (j & 7),
                 vsrc + static_cast<int64_t>(t) * lanes, 16);
    }
    cp_async_commit();
  };
  struct In {
    uint32_t st, fr, lo, k;
  };
  auto read = [&](int t) {
    const int32_t* slot = ring + (t & (kEncSlots - 1)) * 128 + j;
    return In{static_cast<uint32_t>(slot[0]), static_cast<uint32_t>(slot[32]),
              static_cast<uint32_t>(slot[64]), static_cast<uint32_t>(slot[96])};
  };
  // inputs two steps deep in registers: the shared loads of step t - 2
  // and the reciprocal of step t - 1 land while step t computes (steps
  // before 0 read stale slots, never used)
  for (int a = 0; a < kEncAhead; ++a) fetch(T - 1 - a);
  cp_async_wait<kEncAhead - 2>();
  __syncwarp();
  In cur = read(T - 1), nxt = read(T - 2);
  float rcp = rcp_approx(cur.fr);
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  uint32_t state = kRenormBase;
  int wp = P.cap;  // next free staging slot + 1, filling downward
  uint8_t* cnt = counts + w + static_cast<int64_t>(T - 1) * 16;

  for (int t = T - 1; t >= 0; --t, cnt -= 16) {
    fetch(t - kEncAhead);
    cp_async_wait<kEncAhead - 2>();
    __syncwarp();  // the other threads' copies of step t - 2
    const In raw = read(t - 2);
    const float nrcp = rcp_approx(nxt.fr);
    // push LOW first (the decoder pops high, then low)
    const uint32_t freq_l = 1u << cur.k;
    bool need = (state >> 16) >= freq_l;
    uint32_t emit = state & 0xFFFFu;
    if (need) state >>= 16;
    state = ((state >> cur.k) << 16) + (cur.lo << cur.k) + (state & (freq_l - 1u));
    unsigned ballot = __ballot_sync(kFull, need);
    int total = __popc(ballot);
    int pos = wp - total + __popc(ballot & lt);
    if (need && pos >= 0) stage[static_cast<uint32_t>(pos)] = static_cast<uint16_t>(emit);
    wp -= total;
    if (j == 0) cnt[8] = static_cast<uint8_t>(total);
    // push HIGH: exact u32 / u16 (state < freq << 16 after the renorm)
    need = (state >> 16) >= cur.fr;
    emit = state & 0xFFFFu;
    if (need) state >>= 16;
    uint32_t r;
    const uint32_t q = divmod_u16(state, cur.fr, rcp, r);
    state = (q << 16) + r + cur.st;
    ballot = __ballot_sync(kFull, need);
    total = __popc(ballot);
    pos = wp - total + __popc(ballot & lt);
    if (need && pos >= 0) stage[static_cast<uint32_t>(pos)] = static_cast<uint16_t>(emit);
    wp -= total;
    if (j == 0) cnt[0] = static_cast<uint8_t>(total);
    cur = nxt;
    nxt = raw;
    rcp = nrcp;
  }
  cp_async_wait<0>();
  P.states[static_cast<int64_t>(b) * lanes + 32 * w + j] = static_cast<int32_t>(state);
  return P.cap - wp;
}

__global__ void __launch_bounds__(256) encode_kernel(const EncArgs args) {
  extern __shared__ __align__(16) unsigned char shm[];
  int pi = 0;
  while (pi + 1 < args.n_planes &&
         static_cast<int>(blockIdx.x) >= args.p[pi + 1].first_block) {
    ++pi;
  }
  const HykEncPlane P = args.p[pi];
  const int b = blockIdx.x - P.first_block;
  const int W = P.lanes >> 5;
  const int tid = threadIdx.x, nthr = blockDim.x, w = tid >> 5;
  const int T = P.T, cap = P.cap;
  uint8_t* scr = P.work + b * enc_work_bytes(T, P.lanes, cap);
  uint16_t* staging = reinterpret_cast<uint16_t*>(scr);
  uint8_t* counts8 = scr + align16(int64_t(W) * cap * 2);
  const uint64_t* counts = reinterpret_cast<const uint64_t*>(counts8);
  int* s_n = reinterpret_cast<int*>(shm);
  int* scan = reinterpret_cast<int*>(shm + 64);  // [9][nthr]
  int32_t* ring = reinterpret_cast<int32_t*>(shm + 64 + align16(9 * nthr * 4));

  // phase 1
  if (w < W) {
    const int n = encode_warp(P, b, w, ring + w * kEncSlots * 128,
                              staging + static_cast<int64_t>(w) * cap, counts8);
    if ((tid & 31) == 0) s_n[w] = n;
  }
  __syncthreads();

  // phase 2: thread i takes step-pushes [g0, g1) in decoder order (2t:
  // high push of step t, 2t + 1: low), scans, then copies its words
  int n_w[kMaxWarps], n = 0;
#pragma unroll
  for (int v = 0; v < kMaxWarps; ++v) {
    n_w[v] = v < W ? s_n[v] : 0;
    n += n_w[v];
  }
  if (tid == 0) P.n_renorm[b] = n;  // exact renorm word count, even past the cap
  const int drop = n > cap ? n - cap : 0;  // on overflow the last cap words stay
  const int64_t G = 2 * static_cast<int64_t>(T);
  const int64_t per = (G + nthr - 1) / nthr;
  const int64_t g0 = min(G, per * tid), g1 = min(G, g0 + per);
  int sum[kMaxWarps + 1] = {};
  for (int64_t g = g0; g < g1; ++g) {
    const uint64_t c = counts[g];
#pragma unroll
    for (int v = 0; v < kMaxWarps; ++v) {
      if (v < W) sum[v] += static_cast<int>((c >> (8 * v)) & 0xFF);
    }
  }
#pragma unroll
  for (int v = 0; v < kMaxWarps; ++v) sum[kMaxWarps] += sum[v];
  // block-wide inclusive scan of the nine sums (Hillis-Steele)
#pragma unroll
  for (int v = 0; v <= kMaxWarps; ++v) scan[v * nthr + tid] = sum[v];
  __syncthreads();
  for (int off = 1; off < nthr; off <<= 1) {
    int add[kMaxWarps + 1];
#pragma unroll
    for (int v = 0; v <= kMaxWarps; ++v) add[v] = tid >= off ? scan[v * nthr + tid - off] : 0;
    __syncthreads();
#pragma unroll
    for (int v = 0; v <= kMaxWarps; ++v) scan[v * nthr + tid] += add[v];
    __syncthreads();
  }
  // exclusive offsets: in the stream, and in each warp's staging stream
  // (whose words sit at [cap - n_w, cap), decoder order)
  int64_t at = scan[kMaxWarps * nthr + tid] - sum[kMaxWarps];
  int64_t from[kMaxWarps];
#pragma unroll
  for (int v = 0; v < kMaxWarps; ++v) {
    from[v] = static_cast<int64_t>(v) * cap + cap - n_w[v] + scan[v * nthr + tid] - sum[v];
  }
  int16_t* out = P.stream + static_cast<int64_t>(b) * cap;
  for (int64_t g = g0; g < g1; ++g) {
    const uint64_t c = counts[g];
#pragma unroll
    for (int v = 0; v < kMaxWarps; ++v) {
      const int m = v < W ? static_cast<int>((c >> (8 * v)) & 0xFF) : 0;
      for (int q = 0; q < m; ++q) {
        if (at + q >= drop) out[at + q - drop] = static_cast<int16_t>(staging[from[v] + q]);
      }
      at += m;
      from[v] += m;
    }
  }
  for (int64_t i = n - drop + tid; i < cap; i += nthr) out[i] = 0;
}

// -- K4 and K5 --------------------------------------------------------------
//
// One kernel template, decode_warp_kernel<L, K>, for the three decoders. K
// says which decode it runs and how it narrows the rank search:
//   kGaussLut  K4: bounds in shared memory with a 65536 sentinel column,
//              a LUT over slot >> 6; the escape bin's symbol is 0; a low-bit
//              pop and a second renorm round; sym = (h << k | low) - c.
//   kEbLut     K5 where the table fits: the same bounds, a LUT over slot
//              >> 8 (kEbLutShift); one renorm round; sym = h + offset.
//   kEbScan    K5 for any other table (cols > 255, whose ranks do not fit
//              the LUT's bytes, or more rows than its layout holds): a
//              branch-free search over the whole row, bounds read from the
//              table in global memory (the L1 keeps a small table).
//   kGmmRow    the mixture decode: no table; each element's head and 32
//              bounds (K6's row) stream from global memory through the
//              row ring beside its table index's place, and a fixed
//              search of 5 probes ranks the slot among them (bound 31 is
//              never probed: a slot ranked there lies in segment 31 of a
//              32-segment row, whose upper bound is kGaussB); the escape
//              bin's symbol is lo; the rest is K4's, with (c, k) from the
//              head.
// A K5 row ends in 2^17 padding past its CDF's 65536
// (coding/device_rans.py build_device_tables), so no slot ranks at its
// last column and every rank's next bound lies inside the row.

enum DecodeKind { kGaussLut, kEbLut, kEbScan, kGmmRow };

__host__ __device__ constexpr bool has_lut(int kind) {
  return kind == kGaussLut || kind == kEbLut;
}
__host__ __device__ constexpr int lut_shift(int kind) {
  return kind == kGaussLut ? kGaussLutShift : kEbLutShift;
}
__host__ __device__ constexpr int lut_len(int kind) { return (1 << (16 - lut_shift(kind))) + 1; }
// bytes a LUT row: the byte pairs of lut_len entries, 4-byte aligned
__host__ __device__ constexpr int lut_stride(int kind) {
  return has_lut(kind) ? (2 * lut_len(kind) + 3) & ~3 : 0;
}
// the row ring: steps in flight, steps it holds, bytes a lane a step
__host__ __device__ constexpr int ring_ahead(int kind) {
  return kind == kGmmRow ? kGmmAhead : kAhead;
}
__host__ __device__ constexpr int ring_slots(int kind) {
  return kind == kGmmRow ? kGmmSlots : kSlots;
}
__host__ __device__ constexpr int ring_lane_bytes(int kind) {
  return kind == kGmmRow ? 4 + kGmmRowBytes : 4;
}

// Shared-memory layout of a warp decoder: bounds (rows, cols + 1) u32 with
// the sentinel column (kinds with a LUT) | (c, k) or (offset, 0) a row |
// the LUT, lut_stride bytes a row | row ring (slots, lanes) int32, then for
// kGmmRow (slots, lanes, 32) u16 bounds | stream ring kRingWords u16.
struct DecodeLayout {
  int ck, lut, rows, ring, bytes;
};

__host__ __device__ inline DecodeLayout decode_layout(int kind, int rows, int cols, int lanes) {
  DecodeLayout g;
  g.ck = has_lut(kind) ? static_cast<int>(align16(rows * (cols + 1) * 4)) : 0;
  g.lut = static_cast<int>(align16(g.ck + rows * 8));
  g.rows = static_cast<int>(align16(g.lut + rows * lut_stride(kind)));
  g.ring = static_cast<int>(align16(g.rows + ring_slots(kind) * lanes * ring_lane_bytes(kind)));
  g.bytes = g.ring + kRingWords * 2;
  return g;
}

// Shared memory of the layout for a table of any size (int64: the int
// layout above is sized only where it fits); kMaxSmem + 1 where it does not.
inline int decode_smem(int kind, int rows, int cols, int lanes) {
  const int64_t table = has_lut(kind) ? int64_t(rows) * (cols + 1) * 4 : 0;
  const int64_t per_row = 8 + lut_stride(kind);
  if (table + int64_t(rows) * per_row > kMaxSmem) return kMaxSmem + 1;
  const int bytes = decode_layout(kind, rows, cols, lanes).bytes;
  return bytes > kMaxSmem ? kMaxSmem + 1 : bytes;
}

// The decoder a table takes: K4 its LUT; K5 a LUT where the ranks fit its
// bytes and the layout fits shared memory, else the search over the row.
inline int decode_kind(int gauss, int rows, int cols, int lanes) {
  if (gauss) return kGaussLut;
  return cols <= 255 && decode_smem(kEbLut, rows, cols, lanes) <= kMaxSmem ? kEbLut : kEbScan;
}

// Stream chunk c (words [c * kChunkWords, +kChunkWords), 0 past S) into
// its ring slot, by thread tid of nthr: cp.async where the stream is
// 16-byte aligned, else plain loads.
__device__ __forceinline__ void fill_chunk(uint16_t* ring, const uint16_t* sp, int64_t S,
                                           int64_t c, bool vec, int tid, int nthr) {
  uint16_t* dst = ring + (c & (kChunks - 1)) * kChunkWords;
  const int64_t w0 = c * kChunkWords;
  for (int g = tid; g < kChunkWords / 8; g += nthr) {
    const int64_t w = w0 + 8 * g;
    const int64_t left = S - w;
    if (vec) {
      const int bytes = left >= 8 ? 16 : (left > 0 ? static_cast<int>(left) * 2 : 0);
      cp_async16(dst + 8 * g, bytes > 0 ? sp + w : sp, bytes);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[8 * g + k] = k < left ? sp[w + k] : uint16_t(0);
    }
  }
}

template <int K>
__device__ __forceinline__ int lut_ceil(uint32_t x) {
  constexpr int kShift = lut_shift(K);
  return static_cast<int>(min((x >> kShift) + ((x & ((1u << kShift) - 1u)) != 0u),
                              static_cast<uint32_t>(lut_len(K))));
}

// K4, K5 or the mixture decode on one warp per (plane, image); the block's
// other warps help build the tables, then exit. L = lanes / 32 sub-lanes a
// thread. idx (kGmmRow: the heads), grows (kGmmRow only: the rows, else
// null) and out are 16-byte aligned.
template <int L, int K>
__global__ void __launch_bounds__(kPrologueThreads) decode_warp_kernel(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ params, int params_stride, int rows, int cols,
    const uint16_t* __restrict__ grows, const uint16_t* __restrict__ stream, int64_t S,
    const int32_t* __restrict__ states, const int32_t* __restrict__ esc_pos,
    const int32_t* __restrict__ esc_val, int32_t* __restrict__ out, int T) {
  constexpr bool kGauss = K == kGaussLut;
  constexpr bool kLut = has_lut(K);
  constexpr bool kRow = K == kGmmRow;
  constexpr int kLen = lut_len(K);
  constexpr int kStride = lut_stride(K);
  constexpr int kAh = ring_ahead(K);
  constexpr int kSl = ring_slots(K);
  constexpr int lanes = 32 * L;
  extern __shared__ __align__(16) unsigned char shm[];
  const DecodeLayout lay = decode_layout(K, rows, cols, lanes);
  const int bs = kLut ? cols + 1 : cols;  // row stride of the bounds read
  uint32_t* sb = reinterpret_cast<uint32_t*>(shm);
  const uint32_t* tab = kLut ? sb : reinterpret_cast<const uint32_t*>(bounds);
  int2* s_ck = reinterpret_cast<int2*>(shm + lay.ck);
  uint8_t* lut = shm + lay.lut;
  int32_t* rring = reinterpret_cast<int32_t*>(shm + lay.rows);
  uint16_t* grring = reinterpret_cast<uint16_t*>(shm + lay.rows + kSl * lanes * 4);
  uint16_t* ring = reinterpret_cast<uint16_t*>(shm + lay.ring);

  const int b = blockIdx.x;
  const int64_t padded = static_cast<int64_t>(T) * lanes;
  const uint16_t* sp = stream + b * S;
  const bool vec = (reinterpret_cast<uintptr_t>(sp) & 15) == 0;

  // prologue (whole block): table with its sentinels, (c, k), zeroed LUT,
  // the ring's first kChunks chunks; then the LUT: lut[r][s] = largest v
  // with bounds[r][v] <= s << shift (0 if none), filled per (row, v) over
  // the buckets its segment covers, and lut[r][kLen - 1] = the largest v
  // with bounds[r][v] <= 0xFFFF. For a non-decreasing row, the rank of
  // any slot in bucket s lies in [lut[r][s], lut[r][s + 1]], the bytes 2s
  // and 2s + 1 of the row (one u16 load). In K4 a slot in the escape bin
  // [kGaussB, 2^16) ranks at the segment that ends at kGaussB, the next
  // bound being 65536, so its (start, freq) is the escape bin's (kGaussB,
  // 2^16 - kGaussB) with no branch.
  const int tid = threadIdx.x, nthr = blockDim.x;
  if constexpr (kLut) {
    for (int i = tid; i < rows * bs; i += nthr) {
      const int r = i / bs, v = i - r * bs;
      sb[i] = v < cols ? static_cast<uint32_t>(bounds[r * cols + v]) : kRenormBase;
    }
  }
  for (int r = tid; r < rows; r += nthr) {
    s_ck[r] = make_int2(params[r * params_stride], kGauss ? params[r * params_stride + 2] : 0);
  }
  if constexpr (kLut) {
    for (int i = tid; i < rows * kStride / 4; i += nthr) {
      reinterpret_cast<uint32_t*>(lut)[i] = 0u;
    }
  }
  for (int c = 0; c < kChunks; ++c) fill_chunk(ring, sp, S, c, vec, tid, nthr);
  cp_async_commit();
  __syncthreads();
  if constexpr (kLut) {
    for (int i = tid; i < rows * bs; i += nthr) {
      const int r = i / bs, v = i - r * bs;
      const int s0 = v == 0 ? 0 : lut_ceil<K>(sb[i]);
      const int s1 = v + 1 < bs ? lut_ceil<K>(sb[i + 1]) : kLen - 1;
      for (int s = s0; s < min(s1, kLen - 1); ++s) {
        lut[r * kStride + 2 * s] = static_cast<uint8_t>(v);
        if (s > 0) lut[r * kStride + 2 * s - 1] = static_cast<uint8_t>(v);
      }
    }
    for (int r = tid; r < rows; r += nthr) {
      int v = 0;
      for (int n = bs; n > 1;) {
        const int half = n >> 1;
        if (sb[r * bs + v + half] <= 0xFFFFu) {
          v += half;
          n -= half;
        } else {
          n = half;
        }
      }
      lut[r * kStride + 2 * (kLen - 1)] = static_cast<uint8_t>(v);
      lut[r * kStride + 2 * (kLen - 1) - 1] = static_cast<uint8_t>(v);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid >= 32) return;

  // -- one warp from here on: no block barrier --
  const int j = tid;
  const int32_t* rsrc = idx + b * padded + L * j;  // rows of the next copy
  const uint16_t* gsrc = kRow ? grows + (b * padded + L * j) * kGmmSeg : nullptr;
  int32_t* o = out + b * padded + L * j;  // this step's symbols
  uint32_t state[L];
#pragma unroll
  for (int i = 0; i < L; ++i) state[i] = static_cast<uint32_t>(states[b * lanes + L * j + i]);
  // one cp.async group per step: the rows kAh steps ahead (and a
  // stream chunk when the read pointer crossed one); empty past T
  int fetched = 0;
  auto fetch_rows = [&]() {
    if (fetched < T) {
      const int s = fetched & (kSl - 1);
      cp_lanes<L>(rring + s * lanes + L * j, rsrc);
      rsrc += lanes;
      if constexpr (kRow) {
        uint16_t* dst = grring + (s * lanes + L * j) * kGmmSeg;
#pragma unroll
        for (int q = 0; q < L * kGmmRowBytes / 16; ++q) cp_async16(dst + 8 * q, gsrc + 8 * q, 16);
        gsrc += lanes * kGmmSeg;
      }
    }
    ++fetched;
    cp_async_commit();
  };
  // a step's rows, clamped into the table (a corrupt index never reads
  // outside it), as offsets into the LUT and the bounds, and (c, k) or
  // (offset, 0); kGmmRow's: the offsets of the elements' bounds in the
  // ring, and (c, k) from the heads
  struct Rows {
    int lut[L], br[L];
    int2 ck[L];
  };
  auto read_rows = [&](int t, Rows& r) {
    const int s = t & (kSl - 1);
    uint32_t raw[L];
    lds_lanes<L>(raw, rring + s * lanes + L * j);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if constexpr (kRow) {
        r.br[i] = (s * lanes + L * j + i) * kGmmSeg;
        r.ck[i] = make_int2(32768 - static_cast<int>(raw[i] & 0xFFFFu),
                            static_cast<int>((raw[i] >> 16) & 0xFu));
      } else {
        const int row = min(max(static_cast<int>(raw[i]), 0), rows - 1);
        r.lut[i] = row * kStride;
        r.br[i] = row * bs;
        r.ck[i] = s_ck[row];
      }
    }
  };
  for (int t = 0; t < kAh; ++t) fetch_rows();
  cp_async_wait<kAh - 1>();
  Rows ra, rb;
  read_rows(0, ra);

  // stream read pointer (words; < 2^31, as it advances by at most
  // 2 * lanes a step over T * lanes < 2^30 symbols)
  uint32_t ptr = 0;
  uint32_t chunk = 0;  // ring holds chunks [chunk, chunk + kChunks)

  // one step on rows `cur`, reading the next step's into `nxt`
  auto step = [&](int t, const Rows& cur, Rows& nxt) {
    const uint32_t c = ptr >> kChunkLog2;
    if (c != chunk) {  // warp-uniform, at most one chunk a step
      __syncwarp();    // chunk c + 1 visible; chunk c - 1 read out
      fill_chunk(ring, sp, S, c + kChunks - 1, vec, j, 32);
      chunk = c;
    }
    fetch_rows();
    cp_async_wait<kAh - 1>();
    read_rows(t + 1, nxt);  // past T: stale rows, clamped, unused

    // rank: the LUT bounds v to [lo, hi] (without one, [0, cols - 1]); a
    // branch-free binary search over it, the warp's sub-lanes in lockstep,
    // keeps br[v] and br[v + n] (kGmmRow: the bounds around the slot, the
    // upper one the least rejected probe, or kGaussB past the last)
    uint32_t slot[L], blo[L], bhi[L];
    int v[L], n[L];
    if constexpr (kRow) {  // kGmmRow: 5 probes over the ring's 32 bounds
#pragma unroll
      for (int i = 0; i < L; ++i) {
        slot[i] = state[i] & 0xFFFFu;
        v[i] = 0;
        blo[i] = 0;
        bhi[i] = kGaussB;
      }
#pragma unroll
      for (int half = kGmmSeg / 2; half >= 1; half >>= 1) {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const uint32_t m = grring[cur.br[i] + v[i] + half - 1];
          const bool le = m <= slot[i];
          v[i] += le ? half : 0;
          blo[i] = le ? m : blo[i];
          bhi[i] = le ? bhi[i] : min(bhi[i], m);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        slot[i] = state[i] & 0xFFFFu;
        if constexpr (kLut) {
          const uint32_t e = *reinterpret_cast<const uint16_t*>(lut + cur.lut[i] +
                                                                2 * (slot[i] >> lut_shift(K)));
          const int lo = e & 0xFF, hi = e >> 8;
          v[i] = lo;
          n[i] = hi - lo + 1;
          blo[i] = tab[cur.br[i] + lo];
          bhi[i] = tab[cur.br[i] + hi + 1];
        } else {
          v[i] = 0;
          n[i] = cols;
          blo[i] = tab[cur.br[i]];
          bhi[i] = tab[cur.br[i] + cols - 1];
        }
      }
      bool more;
      do {  // the first probe unconditionally: on typical data one suffices
        uint32_t m[L];
        int half[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          half[i] = n[i] >> 1;
          m[i] = tab[cur.br[i] + v[i] + half[i]];
        }
        more = false;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const bool go = n[i] > 1;
          const bool le = m[i] <= slot[i];
          v[i] += go && le ? half[i] : 0;
          blo[i] = go && le ? m[i] : blo[i];
          bhi[i] = go && !le ? m[i] : bhi[i];
          n[i] = go ? (le ? n[i] - half[i] : half[i]) : n[i];
          more |= n[i] > 1;
        }
      } while (__any_sync(kFull, more));
    }
    bool need[L];
    int rank[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if constexpr (kGauss) {
        if (slot[i] >= kGaussB) v[i] = 0;  // the escape bin's symbol is 0 here
      }
      if constexpr (kRow) {
        if (slot[i] >= kGaussB) {  // the escape bin: its symbol is lo here
          v[i] = 0;
          blo[i] = kGaussB;
          bhi[i] = kRenormBase;
        }
      }
      state[i] = (bhi[i] - blo[i]) * (state[i] >> 16) + (slot[i] - blo[i]);
      need[i] = state[i] < kRenormBase;
    }
    int total = warp_rank<L>(need, rank);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (need[i]) state[i] = (state[i] << 16) | ring[(ptr + rank[i]) & (kRingWords - 1)];
    }
    ptr += total;
    int32_t sym[L];
    if constexpr (kGauss || kRow) {  // pop the k low bits, then a second round
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const uint32_t ks = 16u - static_cast<uint32_t>(cur.ck[i].y);
        const uint32_t slot2 = state[i] & 0xFFFFu;
        sym[i] = ((v[i] << cur.ck[i].y) | static_cast<int32_t>(slot2 >> ks)) - cur.ck[i].x;
        state[i] = ((state[i] >> 16) << ks) + (slot2 & ((1u << ks) - 1u));
        need[i] = state[i] < kRenormBase;
      }
      total = warp_rank<L>(need, rank);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (need[i]) state[i] = (state[i] << 16) | ring[(ptr + rank[i]) & (kRingWords - 1)];
      }
      ptr += total;
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) sym[i] = v[i] + cur.ck[i].x;
    }
    if constexpr (L % 4 == 0) {
#pragma unroll
      for (int i = 0; i < L; i += 4) {
        *reinterpret_cast<int4*>(o + i) = make_int4(sym[i], sym[i + 1], sym[i + 2], sym[i + 3]);
      }
    } else if constexpr (L % 2 == 0) {
#pragma unroll
      for (int i = 0; i < L; i += 2) *reinterpret_cast<int2*>(o + i) = make_int2(sym[i], sym[i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) o[i] = sym[i];
    }
    o += lanes;
  };
  // two steps an iteration, the rows ping-ponging between ra and rb
  int t = 0;
  for (; t + 1 < T; t += 2) {
    step(t, ra, rb);
    step(t + 1, rb, ra);
  }
  if (t < T) step(t, ra, rb);
  cp_async_wait<0>();
  __syncwarp();
  // substitute escaped values from the side list (padding positions drop)
  int32_t* op = out + b * padded;
  for (int i = j; i < kEscMax; i += 32) {
    const int32_t p = esc_pos[b * kEscMax + i];
    if (p >= 0 && p < padded) op[p] = esc_val[b * kEscMax + i];
  }
}

template <int L, int K>
int launch_decode_warp(const int32_t* idx, const int32_t* bounds, const int32_t* params,
                       int params_stride, int rows, int cols, const uint16_t* grows,
                       const uint16_t* stream, int64_t S, const int32_t* states,
                       const int32_t* esc_pos, const int32_t* esc_val, int32_t* out, int B,
                       int T, cudaStream_t cs) {
  const int smem = decode_smem(K, rows, cols, 32 * L);
  if (smem > kMaxSmem || (has_lut(K) && cols > 255)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      decode_warp_kernel<L, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_warp_kernel<L, K><<<B, kPrologueThreads, smem, cs>>>(
      idx, bounds, params, params_stride, rows, cols, grows, stream, S, states, esc_pos,
      esc_val, out, T);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_decode_lanes(int kind, const int32_t* idx, const int32_t* bounds,
                        const int32_t* params, int params_stride, int rows, int cols,
                        const uint16_t* stream, int64_t S, const int32_t* states,
                        const int32_t* esc_pos, const int32_t* esc_val, int32_t* out, int B,
                        int T, cudaStream_t cs) {
  auto launch = kind == kGaussLut ? launch_decode_warp<L, kGaussLut>
                : kind == kEbLut  ? launch_decode_warp<L, kEbLut>
                                  : launch_decode_warp<L, kEbScan>;
  return launch(idx, bounds, params, params_stride, rows, cols, nullptr, stream, S, states,
                esc_pos, esc_val, out, B, T, cs);
}

// -- K6 and the mixture decode ----------------------------------------------
//
// K6: one thread an element. The element's K (<= kGmmMaxK) logits, means
// and scales are cleaned (NaN to 0, or to the scale floor; clamped) and
// rounded to fixed point (means and scales in 1/4096, logit gaps in 1/256:
// exact products by powers of two, then round-half-even), and everything
// after is integer arithmetic, so kernels/rans.py gmm_rows_ref gives the
// same bits on the CPU:
//   e_k = EXP[gap_k] (2^16 at the largest logit); lo .. hi, the symbols that
//   cover every weighted component's mean +- 6.109 scales (1564 / 256), split
//   into nseg <= 32 segments of 2^k symbols; F(x) = sum_k e_k Phi((x - mu_k)
//   / s_k) at each segment edge x, with (x - mq) / sq as (x - mq) * (2^40 /
//   sq) >> 28 in 1/4096 and Phi read from the table (2^28, steps of 1/256,
//   linear in 16ths); bounds floor(GAUSS_B (F_j - F_0) / (F_nseg - F_0)),
//   every segment at least one slot, the excess off the first widest.
// The row is the cumulative bounds of segments 0 .. nseg - 1 as u16, 0xFFFF
// past them; the head (lo + 32768) | k << 16 | nseg << 20.
//
// The decode is decode_warp_kernel's kGmmRow kind (above).

constexpr int kGmmMaxK = 4;
constexpr int kGmmExpLen = 3072;
constexpr int kGmmPhiT = 8;
constexpr int kGmmPhiLen = 2 * kGmmPhiT * 256 + 1;
constexpr int kGmmTBits = 12;
constexpr int64_t kGmmTailQ = 1564;
constexpr int kGmmSymBound = 32000;
constexpr int32_t kGmmPadHead = 32768 | (1 << 20);

__device__ __forceinline__ float gmm_clean(float v, float nan_to, float lo, float hi) {
  return isnan(v) ? nan_to : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int64_t gmm_phi(int64_t u, const int32_t* phi) {
  constexpr int64_t span = int64_t(kGmmPhiT) << kGmmTBits;
  u = min(max(u, -span), span) + span;
  const int i = static_cast<int>(u >> 4), f = static_cast<int>(u & 15);
  const int64_t a = phi[i], b = phi[min(i + 1, kGmmPhiLen - 1)];
  return a + (((b - a) * f) >> 4);
}

__global__ void __launch_bounds__(256) gmm_rows_kernel(
    const float* __restrict__ params, int K, int M, int P, int padded, int B,
    const int32_t* __restrict__ phi_g, const int32_t* __restrict__ exp_g,
    int32_t* __restrict__ heads, uint4* __restrict__ rows, int32_t* __restrict__ widest) {
  __shared__ int32_t phi[kGmmPhiLen];
  __shared__ int32_t ex[kGmmExpLen];
  for (int i = threadIdx.x; i < kGmmPhiLen; i += blockDim.x) phi[i] = phi_g[i];
  for (int i = threadIdx.x; i < kGmmExpLen; i += blockDim.x) ex[i] = exp_g[i];
  __syncthreads();
  const int64_t total = static_cast<int64_t>(B) * padded;
  const int n = P * M;
  int support = 0;  // the widest coded support (nseg << k) of this thread's rows
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; g < total;
       g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(g / padded);
    const int i = static_cast<int>(g - static_cast<int64_t>(b) * padded);
    uint32_t w[kGmmSeg / 2];
    int32_t head = kGmmPadHead;
#pragma unroll
    for (int q = 0; q < kGmmSeg / 2; ++q) w[q] = 0xFFFFFFFFu;
    if (i >= n) {
      w[0] = kGaussB | 0xFFFF0000u;
    } else {
      const int pix = i / M, c = i - pix * M;
      const float* p = params + (static_cast<int64_t>(b) * P + pix) * 3 * K * M + c;
      float l[kGmmMaxK];
      float lmax = -1e4f;
      for (int k = 0; k < K; ++k) {
        l[k] = gmm_clean(p[k * M], 0.f, -1e4f, 1e4f);
        lmax = fmaxf(lmax, l[k]);
      }
      int64_t e[kGmmMaxK], mq[kGmmMaxK], r[kGmmMaxK];
      int64_t lo = int64_t(1) << 40, hi = -(int64_t(1) << 40);
      for (int k = 0; k < K; ++k) {
        const int64_t d = __float2ll_rn(__fmul_rn(__fsub_rn(lmax, l[k]), 256.f));
        e[k] = ex[min(max(d, int64_t(0)), int64_t(kGmmExpLen - 1))];
        mq[k] = __float2ll_rn(__fmul_rn(gmm_clean(p[(K + k) * M], 0.f, -32000.f, 32000.f), 4096.f));
        const int64_t sq =
            __float2ll_rn(__fmul_rn(gmm_clean(p[(2 * K + k) * M], 0.11f, 0.11f, 32000.f), 4096.f));
        r[k] = (int64_t(1) << 40) / sq;
        if (e[k] > 0) {
          lo = min(lo, (mq[k] * 256 - kGmmTailQ * sq) >> 20);
          hi = max(hi, -((-(mq[k] * 256 + kGmmTailQ * sq)) >> 20));
        }
      }
      lo = min(max(lo, int64_t(-kGmmSymBound)), int64_t(kGmmSymBound));
      hi = min(max(hi, int64_t(-kGmmSymBound)), int64_t(kGmmSymBound));
      const int64_t L = max(hi, lo) - lo + 1;
      int ks = 0;
      while (((L + (int64_t(1) << ks) - 1) >> ks) > kGmmSeg) ++ks;
      const int nseg = static_cast<int>((L + (int64_t(1) << ks) - 1) >> ks);
      int64_t F[kGmmSeg + 1];
      for (int j = 0; j <= nseg; ++j) {
        const int64_t x = (lo + (int64_t(j) << ks)) * 4096 - 2048;
        int64_t acc = 0;
        for (int k = 0; k < K; ++k) acc += e[k] * gmm_phi(((x - mq[k]) * r[k]) >> 28, phi);
        F[j] = acc;
      }
      const int64_t den = F[nseg] - F[0];
      int32_t f[kGmmSeg];
      int64_t prev = 0, sum = 0;
      int widest = 0;
      for (int j = 0; j < nseg; ++j) {
        const int64_t nb = den > 0 ? min(max(F[j + 1] - F[0], int64_t(0)), den) * kGaussB / den
                                   : int64_t(kGaussB) * (j + 1) / nseg;
        f[j] = static_cast<int32_t>(max(nb - prev, int64_t(1)));
        prev = nb;
        sum += f[j];
        if (f[j] > f[widest]) widest = j;
      }
      f[widest] -= static_cast<int32_t>(sum - kGaussB);
      uint32_t cum = 0;
      for (int j = 0; j < nseg; ++j) {
        cum += static_cast<uint32_t>(f[j]);
        w[j >> 1] = (j & 1) ? (w[j >> 1] & 0xFFFFu) | (cum << 16)
                            : (w[j >> 1] & 0xFFFF0000u) | cum;
      }
      head = static_cast<int32_t>((lo + 32768) | (int64_t(ks) << 16) | (int64_t(nseg) << 20));
      support = max(support, nseg << ks);
    }
    heads[g] = head;
#pragma unroll
    for (int q = 0; q < kGmmSeg / 8; ++q) {
      rows[g * (kGmmSeg / 8) + q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  }
  support = __reduce_max_sync(kFull, support);
  if ((threadIdx.x & 31) == 0 && widest != nullptr && support > 0) atomicMax(widest, support);
}

}  // namespace

extern "C" {

// K3: planes[0..n_planes) in one launch of sum(B) CTAs of max_lanes
// threads, the largest lanes among the planes (a multiple of 32, at most
// 256); each plane's work buffer holds B * hyk_rans_encode_work bytes.
int hyk_rans_encode(const HykEncPlane* planes, int n_planes, int max_lanes,
                    void* stream) {
  if (n_planes <= 0 || n_planes > kMaxPlanes || max_lanes <= 0 || max_lanes % 32 ||
      max_lanes > 32 * kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncArgs args;
  int blocks = 0;
  for (int i = 0; i < n_planes; ++i) {
    if (planes[i].lanes <= 0 || planes[i].lanes % 32 || planes[i].lanes > max_lanes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    args.p[i] = planes[i];
    args.p[i].first_block = blocks;
    blocks += planes[i].B;
  }
  args.n_planes = n_planes;
  if (blocks == 0) return 0;
  const int smem = enc_smem_bytes(max_lanes);
  const cudaError_t e = cudaFuncSetAttribute(
      encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<blocks, max_lanes, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Work-buffer bytes K3 needs for one image of a (T, lanes) plane of cap words.
int64_t hyk_rans_encode_work(int T, int lanes, int cap) {
  return enc_work_bytes(T, lanes, cap);
}

// K3's division, alone: q[i] = n[i] / d[i], r[i] = n[i] % d[i] for d in
// [1, 2^16] and n < d << 16, u32 bits (for the card tests).
int hyk_divmod_check(const void* n, const void* d, void* q, void* r, int count,
                     void* stream) {
  if (count <= 0) return 0;
  divmod_check_kernel<<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(n), static_cast<const uint32_t*>(d),
      static_cast<uint32_t*>(q), static_cast<uint32_t*>(r), count);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a K4 (gauss != 0) or K5 launch needs for this table and
// lanes, in the layout the launch picks; the launch fails above 227 KB.
int hyk_rans_decode_smem(int gauss, int rows, int cols, int lanes) {
  return decode_smem(decode_kind(gauss, rows, cols, lanes), rows, cols, lanes);
}

// K4 (gauss != 0) / K5: idx (B, T, lanes) int32 table rows; bounds
// (rows, cols) int32; aux (rows, aux_stride) int32 with c (K4) or the
// offset (K5) in column 0 and k (K4) in column 2; stream (B, S) u16;
// states (B, lanes) u32 bits; esc_pos/esc_val (B, 256) int32
// -> out (B, T, lanes) int32 symbols. idx and out 16-byte aligned.
int hyk_rans_decode(int gauss, const void* idx, const void* bounds,
                    const void* aux, int aux_stride, int rows, int cols,
                    const void* stream, int64_t S, const void* states,
                    const void* esc_pos, const void* esc_val, void* out,
                    int B, int T, int lanes, void* cuda_stream) {
  if (B <= 0 || T <= 0) return 0;
  const int kind = decode_kind(gauss, rows, cols, lanes);
  const auto cs = static_cast<cudaStream_t>(cuda_stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* bd = static_cast<const int32_t*>(bounds);
  const auto* ax = static_cast<const int32_t*>(aux);
  const auto* sm = static_cast<const uint16_t*>(stream);
  const auto* st = static_cast<const int32_t*>(states);
  const auto* ep = static_cast<const int32_t*>(esc_pos);
  const auto* ev = static_cast<const int32_t*>(esc_val);
  auto* o = static_cast<int32_t*>(out);
  switch (lanes) {
#define HYK_DECODE(L)                                                                     \
  case 32 * L:                                                                            \
    return launch_decode_lanes<L>(kind, i, bd, ax, aux_stride, rows, cols, sm, S, st, ep, \
                                  ev, o, B, T, cs);
    HYK_DECODE(1) HYK_DECODE(2) HYK_DECODE(3) HYK_DECODE(4)
    HYK_DECODE(5) HYK_DECODE(6) HYK_DECODE(7) HYK_DECODE(8)
#undef HYK_DECODE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6: rows for B images of P pixels x M channels, each pixel's 3 K M
// float32 parameters (K blocks of M logits, of means, of scales), into
// heads (B, padded) int32 and rows (B, padded, 32) u16; elements from
// P * M on get the pad row (symbol 0 alone). phi (kGmmPhiLen,) and exp
// (kGmmExpLen,) int32 are kernels/rans.py's tables; widest (one int32, or
// null) takes the max of its value and the widest coded support.
int hyk_gmm_rows(const void* params, int K, int M, int P, int padded, int B, const void* phi,
                 const void* exp_tab, void* heads, void* rows, void* widest, void* stream) {
  if (K <= 0 || K > kGmmMaxK || M <= 0 || P < 0 || padded < P * M || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(B) * padded;
  if (total == 0) return 0;
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 1056 ? want : 1056);
  gmm_rows_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), K, M, P, padded, B, static_cast<const int32_t*>(phi),
      static_cast<const int32_t*>(exp_tab), static_cast<int32_t*>(heads),
      static_cast<uint4*>(rows), static_cast<int32_t*>(widest));
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a mixture decode at this many lanes.
int hyk_gmm_decode_smem(int lanes) { return decode_smem(kGmmRow, 0, 0, lanes); }

// The mixture decode: heads (B, T, lanes) int32 and rows (B, T, lanes, 32)
// u16 from K6; stream, states and escape lists as hyk_rans_decode -> out
// (B, T, lanes) int32 symbols. heads, rows and out 16-byte aligned.
int hyk_gmm_decode(const void* heads, const void* rows, const void* stream, int64_t S,
                   const void* states, const void* esc_pos, const void* esc_val, void* out,
                   int B, int T, int lanes, void* cuda_stream) {
  if (B <= 0 || T <= 0) return 0;
  const auto cs = static_cast<cudaStream_t>(cuda_stream);
  const auto* h = static_cast<const int32_t*>(heads);
  const auto* rw = static_cast<const uint16_t*>(rows);
  const auto* sm = static_cast<const uint16_t*>(stream);
  const auto* st = static_cast<const int32_t*>(states);
  const auto* ep = static_cast<const int32_t*>(esc_pos);
  const auto* ev = static_cast<const int32_t*>(esc_val);
  auto* o = static_cast<int32_t*>(out);
  switch (lanes) {
#define HYK_GMM(L)                                                                           \
  case 32 * L:                                                                               \
    return launch_decode_warp<L, kGmmRow>(h, nullptr, nullptr, 0, 0, 0, rw, sm, S, st, ep, ev, \
                                          o, B, T, cs);
    HYK_GMM(1) HYK_GMM(2) HYK_GMM(3) HYK_GMM(4)
    HYK_GMM(5) HYK_GMM(6) HYK_GMM(7) HYK_GMM(8)
#undef HYK_GMM
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
