// Fused decode + top-k over the catalog, never storing the (B, I) scores.
//
// Replaces cdae_tpu/ops/pallas_kernels.py:fused_topk_scores (rated exclusion
// from dense int8 rows, MODE kDense) and :fused_topk_scores_csr (rated
// exclusion from sorted, padded CSR rows, MODE kCsr).
//
// What bounds it on an H100: the decode, 2*B*I*D flops, runs on the tensor
// cores in 3xTF32 (mma_tf32.cuh): three TF32 products per f32 one at the
// published 495 TFLOP/s, 0.62 ms at B = 1024, I = 1e6, D = 50 (0.69 ms with
// D padded to the products' k = 8, 56). The bytes are W (I*D*4, 200 MB at
// that shape: 0.06 ms if read from HBM once a request, 0.48 ms if each of
// the 8 user tiles read it again from HBM) and, in kDense, the int8 rows
// (B*I). The scores never leave registers, so the running top-k, not a
// (B, I) store, is what must stay cheap: about one compare a score.
//
// The TPU kernel walks the catalog as a sequential grid carrying a (B, k)
// top-k in VMEM; here blocks run in parallel: grid = (user tiles of 128) x
// (catalog splits), each block walks its split in tiles of 128 items and
// writes a partial (B, S, k); a second kernel (one warp per user) merges
// the S*k candidates into the final k.
//
// D <= 64, the Hopper path (topk_wgmma): one block of four warpgroups an
// SM, every block resident at once.
//   * The ring. One thread of warpgroup 0 keeps 1-D bulk copies
//     (cp.async.bulk) of W in flight: 64 catalog rows and their 64 b'
//     values a copy, into a ring of 3 to 8 stages (as many as shared memory
//     holds: 4 at D = 50, k = 10), each completing on an mbarrier and freed
//     by another once split. A tile of W is 128*D*4 contiguous bytes, and a
//     2-D tensor map cannot describe W (its row stride, 200 bytes at
//     D = 50, is no multiple of 16), so the copies are 1-D. A copy starts
//     and ends on the 16-byte boundaries around its bytes, which never
//     leave the pages that hold them: a W or b' whose base is not 16-byte
//     aligned, and a last tile of any length, are copied exactly, the split
//     skipping the bytes before the first.
//   * The split, once an operand. Warpgroup 1 splits each arriving tile
//     into TF32 hi and lo (split_w) in wgmma's K-major layout without
//     swizzle, K zero-padded to kKs k-steps of 8 (4, 7 or 8: a compile-time
//     count, so that the products issue back to back), into one of two
//     hi/lo stages, a thread a row; where K has a padded column (D < 8 kKs)
//     b' goes into the products there, W's column D holding b' and z's
//     holding 1. It copies the tile's b' (NaN past the split's end, so that
//     those scores fail every compare) and builds the tile's rated mask (a
//     thread a user walking its sorted rated list as the catalog advances
//     in kCsr, a rated item loaded ahead; a ballot a byte of the int8 rows
//     in kDense) into one of four small stages. z's hi and lo are made once
//     a block, in the product warpgroups' registers, as wgmma A fragments
//     (kKs x 4 x 2: 56 registers at D = 50).
//   * The products. Warpgroups 2 and 3 own 64 users each and multiply the
//     whole tile: per k-step three wgmma.m64n128k8 in TF32, lo*hi, hi*lo,
//     hi*hi (the small terms first, as mma_tf32.cuh orders them), A from
//     registers, B from the hi/lo stage. The two take turns at the tensor
//     cores (named barriers 2 and 3): one issues its tile's products right
//     after the other has issued its own, so that one warpgroup's compare
//     overlaps the other's products. A warpgroup frees the hi/lo stage as
//     soon as its products are done, and the small stage after its compare.
//   * The top-k. Every row's threshold is the k-th best score of its list
//     so far, or, if higher, the k-th best that another split of the same
//     launch has published for the user (shared_word: an atomicMax a merge;
//     read with each tile): none of the scores below it can be in the final
//     top k. In wgmma's accumulator layout a lane holds rows g and g + 8 of
//     its warp's 16 rows, columns 2t, 2t + 1 of each 8-wide block, as m16n8
//     does: the max of a lane's 32 scores of a row is compared with the
//     row's threshold, and the 32 only when it reaches it; the unrated ones
//     that do go to the row's 32-slot candidate buffer in shared memory, a
//     row's four lanes taking consecutive slots (an exclusive sum, no
//     atomics). A warp owns its 16 rows, so when a buffer is full (and at
//     the split's end) the warp alone merges it into the row's sorted list
//     (merge_into: a bitonic sort of the candidates and a bitonic merge)
//     and pushes again what found it full. The lists live in shared memory
//     where the ring keeps 3 stages beside them, else in the block's slot
//     of the partial output.
//   * W from HBM about once: the user tile is the fast grid index and every
//     block is resident at once, so the 8 blocks that share a split walk it
//     together and read each tile through L2.
// D > 64 (topk_mma_sync): blocks of 8 warps, two an SM, z and W staged
// together in 32-wide chunks of D by cp.async through one buffer,
// mma.sync.m16n8k8 in 3xTF32, the same compare, and the candidates merged
// into a top-k in shared memory with block barriers.
// Order: the larger score wins; on equal scores the lower item id wins, in
// the merges and in the final one (a score equal to the threshold is
// pushed, and the merge decides). Empty slots come out as (-inf, I), the
// streaming scan's convention; the Python wrapper turns them into cdae_tpu's
// NEG tail.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_tf32.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kTileU = 128;  // users per block
constexpr int kTileI = 128;  // catalog items per tile
constexpr int kCand = 32;    // candidate slots per row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyId = INT_MAX;

enum Mode { kDense = 0, kCsr = 1 };
enum Path { kWgmma = 0, kMmaSync = 1 };

// the Hopper path
constexpr int kWgmmaMaxD = 64;  // z's fragments in registers: 8 k-steps
constexpr int kWgmmaThreads = 512;  // copies, split, two product warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kChunkI = 64;  // catalog rows a bulk copy brings
constexpr int kStagesHL = 2, kStagesAux = 4, kMaxRaw = 8;
constexpr int kAuxStage = kTileI + kTileU * 4;  // b', then the mask words
constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory
// registers a thread of each warpgroup, of 128 (65,536 in all)
constexpr int kCopyRegs = 24, kSplitRegs = 120, kConsumerRegs = 184;

// the D > 64 path
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpU = 64, kWarpI = 32;  // 2 x 4 warps over the tile
constexpr int kMt = kWarpU / 16, kNt = kWarpI / 8;
constexpr int kChunk = 32;  // the D chunk
constexpr int kChunkRow = kChunk + 4;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Compare-exchange of a warp's bitonic network: this lane and lane ^ stride
// hold a pair; with `up` the lower lane keeps the better one.
__device__ __forceinline__ void exchange(float& v, int& id, int lane,
                                         int stride, bool up) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, id, stride);
  const bool take = ((lane & stride) == 0) == up ? better(ov, oi, v, id)
                                                 : better(v, id, ov, oi);
  if (take) {
    v = ov;
    id = oi;
  }
}

// Merge one (v, id) a lane into the warp's list (ev, eid), sorted best
// first: the list becomes the best 32 of both, sorted (so its first k are
// the top k, and lane k - 1 holds the k-th). A bitonic sort of the
// candidates, then the list against them reversed and a bitonic merge:
// 21 exchange steps, whatever the candidates.
__device__ __forceinline__ void merge_into(float& ev, int& eid, float v, int id,
                                           int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange(v, id, lane, stride, (lane & size) == 0);
    }
  }
  const float rv = __shfl_sync(kFull, v, 31 - lane);
  const int ri = __shfl_sync(kFull, id, 31 - lane);
  if (better(rv, ri, ev, eid)) {  // a bitonic sequence holding the best 32
    ev = rv;
    eid = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    exchange(ev, eid, lane, stride, true);
  }
}

// A row's threshold as the splits of a launch share it: 64 bits, the
// launch's epoch above the threshold's bits in an order where unsigned
// comparison is float comparison, so that atomicMax keeps the highest
// threshold of the launch and any word of an earlier launch loses to it.
__device__ __forceinline__ unsigned long long shared_word(int epoch, float v) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t o = b & 0x80000000u ? ~b : b | 0x80000000u;
  return static_cast<unsigned long long>(epoch) << 32 | o;
}

__device__ __forceinline__ float shared_threshold(unsigned long long w,
                                                  int epoch) {
  if (static_cast<int>(w >> 32) != epoch) return neg_inf();  // not yet
  const uint32_t o = static_cast<uint32_t>(w);
  return __uint_as_float(o & 0x80000000u ? o & 0x7fffffffu : ~o);
}

// Mark column off of a tile in its rated mask: bit (off >> 2) of word
// (off & 3), selected without indexing the array at run time.
__device__ __forceinline__ void set_rated(unsigned (&w)[4], int off) {
  const unsigned bit = 1u << (off >> 2);
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] |= (off & 3) == q ? bit : 0u;
}

// ------------------------------------------------ D <= 64: wgmma ---------

// split_tf32 in three instructions: hi = x rounded to TF32, to nearest with
// ties away from zero (cvt.rna's rounding: the same bits for every finite
// x), lo = x - hi
__device__ __forceinline__ void split_w(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// The score of accumulator row half h at bit b of a cand mask (column
// 8 (b / 2) + 2t + b % 2): a tree of selects, so that acc stays in
// registers.
__device__ __forceinline__ float pick(const float (&acc)[64], int h, int b) {
  float v16[16], v8[8], v4[4], v2[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v16[i] = b & 1 ? acc[4 * i + 2 * h + 1] : acc[4 * i + 2 * h];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v8[i] = b & 2 ? v16[2 * i + 1] : v16[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) v4[i] = b & 4 ? v8[2 * i + 1] : v8[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) v2[i] = b & 8 ? v4[2 * i + 1] : v4[2 * i];
  return b & 16 ? v2[1] : v2[0];
}

// Shared memory of a Hopper block, in floats (ints, words and barriers take
// a float's room; every region starts on 16 bytes).
struct WgmmaLayout {
  int dk, hl_stage, raw_stage, raw_b, hl, aux, cand_v, cand_i, thr, cnt,
      bars, top_v, top_i, raw, stages, total;
  // kKs k-steps of 8 columns (W's columns past D are zero); the rows'
  // top-k (k of 32 slots) here when the ring keeps 3 stages beside them,
  // else in the partial output (top_v < 0)
  __host__ __device__ WgmmaLayout(int D, int kKs, int k) {
    dk = kKs * 8;
    hl_stage = 2 * kTileI * dk;  // hi, then lo
    // a copy's W rows and b' values, each with 32 bytes for the 16-byte
    // boundaries around them
    raw_b = kChunkI * D + 8;
    raw_stage = raw_b + kChunkI + 8;
    hl = 0;
    aux = hl + kStagesHL * hl_stage;
    cand_v = aux + kStagesAux * kAuxStage;
    cand_i = cand_v + kTileU * kCand;
    thr = cand_i + kTileU * kCand;
    cnt = thr + kTileU;
    // full, hl_free, aux_free, raw_full, raw_free (8 bytes each)
    bars = cnt + kTileU;
    const int lists = bars + 2 * (2 * kStagesHL + kStagesAux + 2 * kMaxRaw);
    const int list_floats = 2 * kTileU * ((k + 3) / 4 * 4);
    const bool in_smem = (kSmemMax / 4 - lists - list_floats) / raw_stage >= 3;
    top_v = in_smem ? lists : -1;
    top_i = in_smem ? lists + list_floats / 2 : -1;
    raw = lists + (in_smem ? list_floats : 0);
    stages = (kSmemMax / 4 - raw) / raw_stage;
    if (stages > kMaxRaw) stages = kMaxRaw;
    total = raw + stages * raw_stage;
  }
};

// The bytes of copy c: W's rows [c0, c0 + n) and their b' values, widened to
// the 16-byte boundaries around each.
struct Copy {
  uintptr_t w0, w1, b0, b1;
  __device__ Copy(const float* W, const float* bp, int D, int c0, int n) {
    const uintptr_t ws =
        reinterpret_cast<uintptr_t>(W + static_cast<size_t>(c0) * D);
    const uintptr_t bs = reinterpret_cast<uintptr_t>(bp + c0);
    w0 = ws & ~uintptr_t{15};
    b0 = bs & ~uintptr_t{15};
    w1 = (ws + static_cast<size_t>(n) * D * 4 + 15) & ~uintptr_t{15};
    b1 = (bs + static_cast<size_t>(n) * 4 + 15) & ~uintptr_t{15};
  }
};

template <int MODE, int kKs>
__device__ __forceinline__ void topk_wgmma(
    float* smem, const float* __restrict__ z, const float* __restrict__ W,
    const float* __restrict__ bp, const int8_t* __restrict__ rated_rows,
    const int* __restrict__ rated_items, int L, float* __restrict__ part_v,
    int* __restrict__ part_i, int B, int I, int D, int k, int S,
    int items_per_split, unsigned long long* __restrict__ thr_g, int epoch) {
  const WgmmaLayout lay(D, kKs, k);
  // where K has a padded column, b' goes into the products there (z's
  // column D holds 1, W's b'); else the compare adds it
  const bool fold = D < kKs * 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * kTileU;
  const int split = blockIdx.y;
  const int i_begin = split * items_per_split;
  const int i_end = min(I, i_begin + items_per_split);
  const int tiles = max(0, (i_end - i_begin + kTileI - 1) / kTileI);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* const hl_free = full + kStagesHL;
  uint64_t* const aux_free = hl_free + kStagesHL;
  uint64_t* const raw_full = aux_free + kStagesAux;
  uint64_t* const raw_free = raw_full + kMaxRaw;
  float* const cand_v = smem + lay.cand_v;
  int* const cand_i = reinterpret_cast<int*>(smem + lay.cand_i);
  float* const thr_s = smem + lay.thr;
  int* const cnt = reinterpret_cast<int*>(smem + lay.cnt);

  if (tid == 0) {
    for (int s = 0; s < kStagesHL; ++s) {
      cdae::mbar_init(full + s, 4);  // the split's four warps
      cdae::mbar_init(hl_free + s, kConsumerWarps);
    }
    for (int a = 0; a < kStagesAux; ++a) {
      cdae::mbar_init(aux_free + a, kConsumerWarps);
    }
    for (int q = 0; q < lay.stages; ++q) {
      cdae::mbar_init(raw_full + q, 1);
      cdae::mbar_init(raw_free + q, 2);  // the two warps that read a copy
    }
    cdae::mbar_init_fence();
  }
  __syncthreads();

  const int copies = 2 * tiles;  // copy c: the c-th 64 rows of the split
  if (warp < 4) {
    // ---------------- copies: one thread keeps the ring full
    cdae::regs_dec<kCopyRegs>();
    if (tid == 0) {
      for (int c = 0; c < copies; ++c) {
        const int q = c % lay.stages;
        if (c >= lay.stages) {  // the copy before it in its stage is read
          cdae::mbar_wait(raw_free + q, (c / lay.stages - 1) & 1);
        }
        const int c0 = i_begin + c * kChunkI;
        const int n = max(0, min(kChunkI, i_end - c0));
        float* const slot = smem + lay.raw + q * lay.raw_stage;
        if (n == 0) {
          cdae::mbar_arrive_expect_tx(raw_full + q, 0);
          continue;
        }
        const Copy cp(W, bp, D, c0, n);
        cdae::mbar_arrive_expect_tx(
            raw_full + q,
            static_cast<uint32_t>((cp.w1 - cp.w0) + (cp.b1 - cp.b0)));
        cdae::bulk_copy(slot, reinterpret_cast<const void*>(cp.w0),
                        static_cast<uint32_t>(cp.w1 - cp.w0), raw_full + q);
        cdae::bulk_copy(slot + lay.raw_b, reinterpret_cast<const void*>(cp.b0),
                        static_cast<uint32_t>(cp.b1 - cp.b0), raw_full + q);
      }
    }
    return;
  }

  if (warp < 8) {
    // ---------------- the split, b' and the mask: thread p takes W row p
    // of each tile and user u0 + p
    cdae::regs_dec<kSplitRegs>();
    const int p = tid - 128, pw = warp - 4;
    // kCsr: thread p walks row u0 + p; nxt is its next rated id and after
    // the one past it, loaded a rated item ahead so that the walk seldom
    // waits for a load
    int cursor = 0, nxt = INT_MAX, after = INT_MAX;
    const int* my_row = rated_items + static_cast<size_t>(u0 + p) * L;
    if (MODE == kCsr && u0 + p < B) {
      int lo = 0, hi = L;  // first rated entry >= i_begin (rows are sorted)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (my_row[mid] < i_begin) lo = mid + 1; else hi = mid;
      }
      cursor = lo;
      nxt = lo < L ? my_row[lo] : INT_MAX;
      after = lo + 1 < L ? my_row[lo + 1] : INT_MAX;
    }
    // where copy c's first W value and first b' value lie in its stage (a
    // copy starts on the 16-byte boundary at or below them)
    const uintptr_t w_at = reinterpret_cast<uintptr_t>(W) & 15;
    const int b_skip = static_cast<int>(reinterpret_cast<uintptr_t>(bp) & 15) / 4;
    auto stage_of = [&](int c) {
      return smem + lay.raw + (c % lay.stages) * lay.raw_stage;
    };
    auto w_skip = [&](int c) {
      return static_cast<int>(
                 (w_at + static_cast<uintptr_t>(i_begin + c * kChunkI) * D * 4) &
                 15) / 4;
    };

    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStagesHL, a = j % kStagesAux;
      const int i0 = i_begin + j * kTileI;
      cdae::mbar_wait(hl_free + s, ((j / kStagesHL) & 1) ^ 1);
      cdae::mbar_wait(aux_free + a, ((j / kStagesAux) & 1) ^ 1);
      const int c = 2 * j + p / kChunkI;  // the copy that holds row p
      cdae::mbar_wait(raw_full + c % lay.stages, (c / lay.stages) & 1);
      // row p's b', NaN past the split's end (so that its scores fail
      // every compare)
      const float b_row = i0 + p < i_end
                              ? stage_of(c)[lay.raw_b + b_skip + p % kChunkI]
                              : quiet_nan();
      // thread p splits W row p: for each 4-wide column group kc, its four
      // values (one 16-byte, two 8-byte or four 4-byte loads, as D and the
      // copy's alignment allow) and a 16-byte store of hi and of lo at
      // ((kc*16 + p/8)*8 + p%8)*4, eight threads filling a 128-byte core
      // matrix (rows past the split are split too: their b' is NaN). Where
      // D % 4 == 0 the rows of a warp start on few banks, so thread p
      // starts at another group
      {
        const int skip = w_skip(c);
        const float* src = stage_of(c) + skip + (p % kChunkI) * D;
        const int vec = D % 4 == 0 && skip % 4 == 0   ? 4
                        : D % 2 == 0 && skip % 2 == 0 ? 2
                                                      : 1;
        const int kc0 = D % 4 ? 0 : (vec == 4 ? p : p >> 2) % (2 * kKs);
        uint32_t* const hi = reinterpret_cast<uint32_t*>(
            smem + lay.hl + s * lay.hl_stage) + p * 4;
        uint32_t* const lo = hi + kTileI * lay.dk;
#pragma unroll
        for (int e0 = 0; e0 < 2 * kKs; e0 += kKs) {  // two halves of the row
          float x[kKs][4];  // the half's loads before its first store
#pragma unroll
          for (int e = 0; e < kKs; ++e) {
            int kc = kc0 + e0 + e;
            if (kc >= 2 * kKs) kc -= 2 * kKs;
            const int d = kc * 4;
            if (d + 4 <= D && vec == 4) {
              const float4 v = *reinterpret_cast<const float4*>(src + d);
              x[e][0] = v.x;
              x[e][1] = v.y;
              x[e][2] = v.z;
              x[e][3] = v.w;
            } else if (d + 4 <= D && vec == 2) {
              const float2 u = *reinterpret_cast<const float2*>(src + d);
              const float2 v = *reinterpret_cast<const float2*>(src + d + 2);
              x[e][0] = u.x;
              x[e][1] = u.y;
              x[e][2] = v.x;
              x[e][3] = v.y;
            } else {  // (past D: b' when folded, then zeros)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                x[e][q] = d + q < D ? src[d + q]
                          : d + q == D && fold ? b_row : 0.f;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < kKs; ++e) {
            int kc = kc0 + e0 + e;
            if (kc >= 2 * kKs) kc -= 2 * kKs;
            uint4 h4, l4;
            split_w(x[e][0], h4.x, l4.x);
            split_w(x[e][1], h4.y, l4.y);
            split_w(x[e][2], h4.z, l4.z);
            split_w(x[e][3], h4.w, l4.w);
            *reinterpret_cast<uint4*>(hi + kc * kTileI * 4) = h4;
            *reinterpret_cast<uint4*>(lo + kc * kTileI * 4) = l4;
          }
        }
      }
      float* const aux = smem + lay.aux + a * kAuxStage;
      aux[p] = b_row;
      // the tile's rated mask: bit (c >> 2) of word (c & 3) for column c
      unsigned* const bits = reinterpret_cast<unsigned*>(aux + kTileI);
      if (MODE == kCsr) {
        unsigned w4[4] = {0u, 0u, 0u, 0u};
        // (rows end in padding >= I, and INT_MAX past the batch)
        while (nxt < min(i0 + kTileI, i_end)) {
          set_rated(w4, nxt - i0);
          ++cursor;
          nxt = after;
          after = cursor + 1 < L ? my_row[cursor + 1] : INT_MAX;
        }
        *reinterpret_cast<uint4*>(bits + p * 4) =
            make_uint4(w4[0], w4[1], w4[2], w4[3]);
      } else {
        // a warp's 32 rows, four at a time: 16 loads in flight a lane
        for (int r0 = pw; r0 < kTileU; r0 += 16) {
          bool rated[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int user = u0 + r0 + 4 * u;
            const int8_t* row =
                rated_rows + static_cast<size_t>(min(user, B - 1)) * I;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = i0 + 4 * lane + q;
              rated[u][q] = user < B && col < I && row[col] > 0;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const unsigned w = __ballot_sync(kFull, rated[u][q]);
              if (lane == 0) bits[(r0 + 4 * u) * 4 + q] = w;
            }
          }
        }
      }
      cdae::fence_async_shared();  // the hi/lo writes, before wgmma reads
      __syncwarp();
      if (lane == 0) {  // this warp's rows are in; it read copy c
        cdae::mbar_arrive(full + s);
        cdae::mbar_arrive(raw_free + c % lay.stages);
      }
    }
    return;
  }

  // ---------------- products, compare, candidates: 64 users a warpgroup
  cdae::regs_inc<kConsumerRegs>();
  const int wg = warp / 4 - 2;  // 0 or 1: users [64 wg, 64 wg + 64)
  const int rbase = wg * 64 + (warp & 3) * 16;  // the warp's 16 rows
  const int g = lane >> 2, t = lane & 3;

  // z's hi and lo as A fragments (zero past D and past the batch)
  uint32_t zh[kKs][4], zl[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int user = u0 + rbase + g + 8 * (q & 1);
      const int col = ks * 8 + t + 4 * (q >> 1);
      const float x = user >= B ? 0.f
                      : col < D ? z[static_cast<size_t>(user) * D + col]
                      : col == D && fold ? 1.f : 0.f;  // b''s column
      cdae::split_tf32(x, zh[ks][q], zl[ks][q]);
    }
  }
  // row r's top-k, sorted: in shared memory, or in the block's slot of the
  // partial output
  const int kp = (k + 3) / 4 * 4;
  auto list_v = [&](int r) {
    return lay.top_v >= 0
               ? smem + lay.top_v + r * kp
               : part_v + (static_cast<size_t>(u0 + r) * S + split) * k;
  };
  auto list_i = [&](int r) {
    return lay.top_v >= 0
               ? reinterpret_cast<int*>(smem + lay.top_i) + r * kp
               : part_i + (static_cast<size_t>(u0 + r) * S + split) * k;
  };
  // the warp's rows: thresholds (rows past the batch never take a
  // candidate), counts, and empty lists
  if (lane < 16) {
    const int r = rbase + lane;
    thr_s[r] = u0 + r < B ? neg_inf() : pos_inf();
    cnt[r] = 0;
  }
  for (int rr = 0; rr < 16; ++rr) {
    if (u0 + rbase + rr < B && lane < k) {
      list_v(rbase + rr)[lane] = neg_inf();
      list_i(rbase + rr)[lane] = kEmptyId;
    }
  }
  __syncwarp();

  // the warp merges row r's candidates into its top-k
  auto merge_row = [&](int r) {
    float* const lv = list_v(r);
    int* const li = list_i(r);
    const int n = min(cnt[r], kCand);
    float ev = lane < k ? lv[lane] : neg_inf();
    int eid = lane < k ? li[lane] : kEmptyId;
    const bool in = lane < n;
    merge_into(ev, eid, in ? cand_v[r * kCand + lane] : neg_inf(),
               in ? cand_i[r * kCand + lane] : kEmptyId, lane);
    if (lane < k) {
      lv[lane] = ev;
      li[lane] = eid;
    }
    if (lane == k - 1) {
      thr_s[r] = ev;
      if (u0 + r < B) atomicMax(thr_g + u0 + r, shared_word(epoch, ev));
    }
    __syncwarp();
    if (lane == 0) cnt[r] = 0;
  };

  if (wg == 1 && tiles > 0) cdae::bar_arrive(2, 256);  // warpgroup 1 second
  float acc[64] = {};  // the tile's scores, in wgmma's accumulator layout
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStagesHL, a = j % kStagesAux;
    const int i0 = i_begin + j * kTileI;
    cdae::mbar_wait(full + s, (j / kStagesHL) & 1);
    // the other splits' thresholds of the lane's rows, read while the
    // products run
    unsigned long long shared[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int user = u0 + rbase + g + 8 * h;
      shared[h] = user < B ? __ldcg(thr_g + user) : 0ull;
    }
    const float* hi = smem + lay.hl + s * lay.hl_stage;
    const uint64_t dh = cdae::wgmma_desc(hi, kTileI * 16, 128);
    const uint64_t dl = cdae::wgmma_desc(hi + kTileI * lay.dk, kTileI * 16, 128);
    cdae::bar_sync(2 + wg, 256);  // this warpgroup's turn
#pragma unroll
    for (int q = 0; q < 64; ++q) cdae::fence_operand(acc[q]);
    cdae::wgmma_fence();
    // per k-step lo*hi, hi*lo, hi*hi (the small terms first); a k-step is
    // two column groups, 2 * kTileI * 16 bytes (descriptors count 16)
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const uint64_t e = static_cast<uint64_t>(ks) * (kTileI * 32 >> 4);
      cdae::wgmma_m64n128k8(acc, zl[ks], dh + e, ks > 0);
      cdae::wgmma_m64n128k8(acc, zh[ks], dl + e, 1);
      cdae::wgmma_m64n128k8(acc, zh[ks], dh + e, 1);
    }
    cdae::wgmma_commit();
    if (wg == 0 || j + 1 < tiles) cdae::bar_arrive(3 - wg, 256);
    cdae::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 64; ++q) cdae::fence_operand(acc[q]);
    __syncwarp();
    if (lane == 0) cdae::mbar_arrive(hl_free + s);

    // ---- compare every score with its row's threshold; push winners
    const float* aux = smem + lay.aux + a * kAuxStage;
    const unsigned* bits = reinterpret_cast<const unsigned*>(aux + kTileI);
    if (!fold) {  // (else b' came in with the products)
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        const float2 b = *reinterpret_cast<const float2*>(aux + nb * 8 + 2 * t);
        acc[4 * nb] += b.x;
        acc[4 * nb + 1] += b.y;
        acc[4 * nb + 2] += b.x;
        acc[4 * nb + 3] += b.y;
      }
    }
    // cand[h], bit 2nb + e: the score of row g + 8h, column 8nb + 2t + e,
    // reaches the row's threshold -- an add and a max a score, one compare
    // for a row's 32, and the 32 only when it passes (NaN never does)
    uint32_t cand[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float thr = fmaxf(thr_s[rbase + g + 8 * h],
                              shared_threshold(shared[h], epoch));
      float vmax = neg_inf();
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        vmax = fmaxf(vmax, fmaxf(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]));
      }
      if (vmax >= thr) {
#pragma unroll
        for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (acc[4 * nb + 2 * h + e] >= thr) cand[h] |= 1u << (2 * nb + e);
          }
        }
      }
    }
    // the rated ones drop out: column 8nb + 2t + e is bit 2nb + t/2 of
    // the row's mask word 2 (t & 1) + e
    if (__any_sync(kFull, cand[0] | cand[1])) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cand[h]) {
          const unsigned* w = bits + (rbase + g + 8 * h) * 4 + 2 * (t & 1);
          const int sh = t >> 1;
          cand[h] &= ~(((w[0] >> sh) & 0x55555555u) |
                       (((w[1] >> sh) & 0x55555555u) << 1));
        }
      }
    }
    // push: a row's four lanes take consecutive slots of its buffer (an
    // exclusive sum of their counts, no atomics), each lane walking its set
    // bits; the scores that find it full stay in cand, the warp merges its
    // full rows and they go again
    while (__any_sync(kFull, cand[0] | cand[1])) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!__any_sync(kFull, cand[h])) continue;
        const int r = rbase + g + 8 * h;
        const int n = __popc(cand[h]);
        int incl = n;  // the sum over lanes t' <= t of the row
        int x = __shfl_up_sync(kFull, incl, 1, 4);
        if (t >= 1) incl += x;
        x = __shfl_up_sync(kFull, incl, 2, 4);
        if (t >= 2) incl += x;
        const int total = __shfl_sync(kFull, incl, 3, 4);
        const int base = cnt[r];
        int slot = base + incl - n;
        for (uint32_t c = cand[h]; c != 0u && slot < kCand; c &= c - 1u) {
          const int b = __ffs(c) - 1;  // column 8 (b / 2) + 2t + b % 2
          cand_v[r * kCand + slot] = pick(acc, h, b);
          cand_i[r * kCand + slot] = i0 + (b >> 1) * 8 + 2 * t + (b & 1);
          cand[h] &= ~(1u << b);
          ++slot;
        }
        __syncwarp();
        if (t == 0) cnt[r] = min(base + total, kCand);
      }
      if (!__any_sync(kFull, cand[0] | cand[1])) break;
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        if (cnt[rbase + rr] >= kCand) merge_row(rbase + rr);  // warp-uniform
      }
      __syncwarp();
    }
    __syncwarp();
    if (lane == 0) cdae::mbar_arrive(aux_free + a);
  }

  // ---- the split's end: merge what the buffers hold, write the partials
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = rbase + rr;
    if (cnt[r] > 0) merge_row(r);
    if (lay.top_v >= 0 && u0 + r < B && lane < k) {
      const size_t o = (static_cast<size_t>(u0 + r) * S + split) * k + lane;
      part_v[o] = list_v(r)[lane];
      part_i[o] = list_i(r)[lane];
    }
  }
}

// ------------------------------------------- D > 64: mma.sync ------------

// Shared memory of a block, in floats (ints and words take a float's
// room): the stage (a z chunk, then a W chunk), b' by tile parity, the
// mask, and the rows' thresholds, counts, top-k and candidates.
struct ChunkLayout {
  int stage, w_in_stage, bp, bits, thr, cnt, top_v, top_i, cand_v, cand_i,
      total;
  __host__ __device__ ChunkLayout(int k) {
    stage = 0;
    w_in_stage = kTileU * kChunkRow;
    bp = stage + w_in_stage + kTileI * kChunkRow;
    bits = bp + 2 * kTileI;
    thr = bits + kTileU * 4;
    cnt = thr + kTileU;
    top_v = cnt + kTileU;
    top_i = top_v + kTileU * k;
    cand_v = top_i + kTileU * k;
    cand_i = cand_v + kTileU * kCand;
    total = cand_i + kTileU * kCand;
  }
};

template <int MODE, int kVec>
__device__ __forceinline__ void topk_mma_sync(
    float* smem, const float* __restrict__ z, const float* __restrict__ W,
    const float* __restrict__ bp, const int8_t* __restrict__ rated_rows,
    const int* __restrict__ rated_items, int L, float* __restrict__ part_v,
    int* __restrict__ part_i, int B, int I, int D, int k, int S,
    int items_per_split) {
  const ChunkLayout lay(k);
  float* const bps = smem + lay.bp;  // [2][kTileI], by tile parity
  unsigned* const bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  float* const thr_s = smem + lay.thr;
  int* const cnt = reinterpret_cast<int*>(smem + lay.cnt);
  float* const top_v = smem + lay.top_v;
  int* const top_i = reinterpret_cast<int*>(smem + lay.top_i);
  float* const cand_v = smem + lay.cand_v;
  int* const cand_i = reinterpret_cast<int*>(smem + lay.cand_i);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wu = (warp & 1) * kWarpU, wi = (warp >> 1) * kWarpI;
  const int u0 = blockIdx.x * kTileU;
  const int split = blockIdx.y;
  const int i_begin = split * items_per_split;
  const int i_end = min(I, i_begin + items_per_split);
  const int chunks = (D + kChunk - 1) / kChunk;
  const int tiles = (i_end - i_begin + kTileI - 1) / kTileI;
  const int steps = tiles * chunks;

  for (int r = tid; r < kTileU; r += kThreads) {
    // rows past the batch never take a candidate
    thr_s[r] = u0 + r < B ? neg_inf() : pos_inf();
    cnt[r] = 0;
  }
  for (int e = tid; e < kTileU * k; e += kThreads) {
    top_v[e] = neg_inf();
    top_i[e] = kEmptyId;
  }

  // stage rows [r0, r0 + 128) x columns [d0, d0 + 32) of a (rows, D)
  // matrix into dst (rows of kChunkRow floats); columns >= D are zero
  auto load_rows = [&](float* dst, const float* src, int r0, int rows,
                       int d0) {
    const int per_row = kChunk / kVec;
    for (int e = tid; e < kTileI * per_row; e += kThreads) {
      const int r = e / per_row, d = (e - r * per_row) * kVec;
      const int gr = r0 + r, gd = d0 + d;
      const bool valid = gr < rows && gd < D;  // D % kVec == 0
      cdae::copy_async<kVec>(
          dst + r * kChunkRow + d,
          valid ? src + static_cast<size_t>(gr) * D + gd : src, valid);
    }
  };
  auto issue = [&](int s) {
    const int tile = s / chunks, c = s - tile * chunks;
    const int i0 = i_begin + tile * kTileI;
    float* st = smem + lay.stage;
    load_rows(st, z, u0, B, c * kChunk);
    load_rows(st + lay.w_in_stage, W, i0, i_end, c * kChunk);
    if (c == 0) {
      for (int e = tid; e < kTileI; e += kThreads) {
        const bool valid = i0 + e < i_end;
        cdae::copy_async<1>(bps + (tile & 1) * kTileI + e,
                            valid ? bp + i0 + e : bp, valid);
      }
    }
    cdae::cp_async_commit();
  };

  // kCsr: thread r < kTileU walks row u0 + r; nxt is its next rated id
  int cursor = 0, nxt = INT_MAX;
  if (MODE == kCsr && tid < kTileU && u0 + tid < B) {
    const int* row = rated_items + static_cast<size_t>(u0 + tid) * L;
    int lo = 0, hi = L;  // first rated entry >= i_begin (rows are sorted)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < i_begin) lo = mid + 1; else hi = mid;
    }
    cursor = lo;
    nxt = lo < L ? row[lo] : INT_MAX;
  }

  if (steps > 0) issue(0);

  float acc[kMt][kNt][4];
  // one warp merges row r's candidates into its top-k
  auto merge_row = [&](int r) {
    const int n = min(cnt[r], kCand);
    float ev = lane < k ? top_v[r * k + lane] : neg_inf();
    int eid = lane < k ? top_i[r * k + lane] : kEmptyId;
    const bool in = lane < n;
    merge_into(ev, eid, in ? cand_v[r * kCand + lane] : neg_inf(),
               in ? cand_i[r * kCand + lane] : kEmptyId, lane);
    if (lane < k) {
      top_v[r * k + lane] = ev;
      top_i[r * k + lane] = eid;
    }
    if (lane == k - 1) thr_s[r] = ev;
    if (lane == 0) cnt[r] = 0;
  };

  for (int s = 0; s < steps; ++s) {
    const int tile = s / chunks, c = s - tile * chunks;
    const int i0 = i_begin + tile * kTileI;
    cdae::cp_async_wait<0>();
    __syncthreads();
    if (c == chunks - 1) {
      // the tile's rated mask, before the products (the barrier after them
      // publishes it)
      if (MODE == kCsr) {
        if (tid < kTileU && u0 + tid < B) {
          unsigned w4[4] = {0u, 0u, 0u, 0u};
          const int* row = rated_items + static_cast<size_t>(u0 + tid) * L;
          while (nxt < min(i0 + kTileI, i_end)) {  // (padding >= I)
            set_rated(w4, nxt - i0);
            ++cursor;
            nxt = cursor < L ? row[cursor] : INT_MAX;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bits[tid * 4 + j] = w4[j];
        }
      } else {
        for (int r = warp; r < kTileU && u0 + r < B; r += kWarps) {
          const int8_t* row = rated_rows + static_cast<size_t>(u0 + r) * I;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = i0 + 4 * lane + j;
            const bool rated = col < I && row[col] > 0;
            const unsigned w = __ballot_sync(kFull, rated);
            if (lane == 0) bits[r * 4 + j] = w;
          }
        }
      }
    }
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
        }
      }
    }
    {
      const float* zc = smem + lay.stage;
      const float* wc = zc + lay.w_in_stage;
      const int ksteps = min(kChunk / 8, (D - c * kChunk + 7) / 8);
      for (int kk = 0; kk < ksteps; ++kk) {
        const int kc = kk * 8;
        uint32_t bh[kNt][2], bl[kNt][2];
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          cdae::load_b(bh[n], bl[n], wc + (wi + n * 8) * kChunkRow + kc, 1,
                       kChunkRow, g, t);
        }
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          uint32_t ah[4], al[4];
          cdae::load_a(ah, al, zc + (wu + m * 16) * kChunkRow + kc, kChunkRow,
                       1, g, t);
          // the small terms first; one product of each of the kNt
          // accumulators between two that update the same one
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], al, bh[n]);
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], ah, bl[n]);
#pragma unroll
          for (int n = 0; n < kNt; ++n) cdae::mma_tf32(acc[m][n], ah, bh[n]);
        }
      }
    }

    __syncthreads();  // the stage is free: the next copy overlaps the rest
    if (s + 1 < steps) issue(s + 1);

    if (c == chunks - 1) {
      // ---- compare every score with its row's threshold; push winners
      const float* bpt = bps + (tile & 1) * kTileI;
      // b' of the lane's columns, NaN past the split's end: those scores
      // fail every compare (rows past the batch hold an infinite threshold)
      float bpv[kNt][2];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wi + n * 8 + 2 * t + e;
          bpv[n][e] = i0 + col < i_end ? bpt[col] : quiet_nan();
        }
      }
      float thr[kMt][2];
      auto reload = [&]() {
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            thr[m][h] = thr_s[wu + m * 16 + g + 8 * h];
          }
        }
      };
      // the scores of `want` (bit ((m*2 + h)*kNt + n)*2 + e) that still
      // reach their threshold and are unrated take a slot of their row's
      // buffer; returns those that found it full
      auto push = [&](uint64_t want) {
        uint64_t pend = 0u;
        if (want == 0u) return pend;
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wu + m * 16 + g + 8 * h;
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint64_t bit = 1ull
                                     << ((((m * 2 + h) * kNt + n) * 2) + e);
                if (!(want & bit)) continue;
                const int col = wi + n * 8 + 2 * t + e;
                const float v = acc[m][n][2 * h + e] + bpv[n][e];
                if (!(v >= thr[m][h])) continue;
                if ((bits[r * 4 + (col & 3)] >> (col >> 2)) & 1u) continue;
                const int slot = atomicAdd(cnt + r, 1);
                if (slot < kCand) {
                  cand_v[r * kCand + slot] = v;
                  cand_i[r * kCand + slot] = i0 + col;
                } else {
                  pend |= bit;
                }
              }
            }
          }
        }
        return pend;
      };
      // the scores that reach their row's threshold (the rated ones among
      // them are dropped by push): an add and a max a score, and one
      // compare for the lane's 8 scores of a row
      reload();
      uint64_t want = 0u;
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[kNt][2];
          float vmax = neg_inf();
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[n][e] = acc[m][n][2 * h + e] + bpv[n][e];
              vmax = fmaxf(vmax, v[n][e]);  // a NaN column drops out
            }
          }
          if (vmax >= thr[m][h]) {
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (v[n][e] >= thr[m][h]) {
                  want |= 1ull << ((((m * 2 + h) * kNt + n) * 2) + e);
                }
              }
            }
          }
        }
      }
      // (one call site of push, so that acc stays in registers)
      while (true) {
        want = push(want);
        if (!__syncthreads_or(want != 0u)) break;
        for (int r = warp; r < kTileU; r += kWarps) {
          if (cnt[r] >= kCand) merge_row(r);  // warp-uniform
        }
        __syncthreads();
        reload();
      }
    }
  }

  // ---- the split's end: merge what the buffers hold, write the partials
  __syncthreads();  // (a split of no tile has run no barrier yet)
  for (int r = warp; r < kTileU; r += kWarps) {
    const int user = u0 + r;
    if (user >= B) break;
    if (cnt[r] > 0) merge_row(r);
    __syncwarp();
    if (lane < k) {
      const size_t o = (static_cast<size_t>(user) * S + split) * k + lane;
      part_v[o] = top_v[r * k + lane];
      part_i[o] = top_i[r * k + lane];
    }
  }
}

// One kernel name for both paths, as the profiler and the benchmark's
// census know it: the wgmma path at kKs k-steps, the mma.sync path with
// copies of kVec floats.
template <int MODE, int PATH, int kVec, int kKs>
__global__ void __launch_bounds__(PATH == kWgmma ? kWgmmaThreads : kThreads,
                                  PATH == kWgmma ? 1 : 2)
fused_topk_kernel(const float* __restrict__ z, const float* __restrict__ W,
                  const float* __restrict__ bp,
                  const int8_t* __restrict__ rated_rows,
                  const int* __restrict__ rated_items, int L,
                  float* __restrict__ part_v, int* __restrict__ part_i, int B,
                  int I, int D, int k, int S, int items_per_split,
                  unsigned long long* __restrict__ thr_g, int epoch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (PATH == kWgmma) {
    topk_wgmma<MODE, kKs>(smem, z, W, bp, rated_rows, rated_items, L, part_v,
                          part_i, B, I, D, k, S, items_per_split, thr_g,
                          epoch);
  } else {
    topk_mma_sync<MODE, kVec>(smem, z, W, bp, rated_rows, rated_items, L,
                              part_v, part_i, B, I, D, k, S, items_per_split);
  }
}

// One warp per user: merge the S*k partial candidates into the final k.
__global__ void merge_topk_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i, int B, int S, int k,
                                  int I) {
  const int lane = threadIdx.x & 31;
  const int user = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (user >= B) return;  // whole warp leaves together
  float ev = neg_inf();
  int eid = kEmptyId;
  const int n = S * k;
  const float* pv = part_v + (size_t)user * n;
  const int* pi = part_i + (size_t)user * n;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    const bool in = p < n;  // an empty slot is (-inf, kEmptyId) already
    merge_into(ev, eid, in ? pv[p] : neg_inf(), in ? pi[p] : kEmptyId, lane);
  }
  if (lane < k) {
    const bool empty = eid == kEmptyId;
    out_v[(size_t)user * k + lane] = empty ? neg_inf() : ev;
    out_i[(size_t)user * k + lane] = empty ? I : eid;
  }
}

template <int MODE, int PATH, int kVec, int kKs>
cudaError_t launch_tile(const float* z, const float* W, const float* bp,
                        const int8_t* rated_rows, const int* rated_items,
                        int L, float* part_v, int* part_i, int B, int I, int D,
                        int k, int S, int items_per_split,
                        unsigned long long* thr_g, int epoch, cudaStream_t s) {
  auto* kernel = fused_topk_kernel<MODE, PATH, kVec, kKs>;
  int threads = kThreads;
  size_t smem = sizeof(float) * ChunkLayout(k).total;
  if (PATH == kWgmma) {
    const WgmmaLayout lay(D, kKs, k);
    if (lay.stages < 3) return cudaErrorInvalidValue;
    threads = kWgmmaThreads;
    smem = sizeof(float) * lay.total;
  }
  static cdae::SmemLimit limit;  // above the default 48 KB
  const cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + kTileU - 1) / kTileU, S);
  kernel<<<grid, threads, smem, s>>>(z, W, bp, rated_rows, rated_items, L,
                                     part_v, part_i, B, I, D, k, S,
                                     items_per_split, thr_g, epoch);
  return cudaGetLastError();
}

template <int MODE>
int launch(const float* z, const float* W, const float* bp,
           const int8_t* rated_rows, const int* rated_items, int L,
           float* part_v, int* part_i, float* out_v, int* out_i, int B, int I,
           int D, int k, int S, int items_per_split, int vec,
           unsigned long long* thr_g, int epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_per_split % kTileI != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define CDAE_TILE(PATH, VEC, KS)                                     \
  launch_tile<MODE, PATH, VEC, KS>(z, W, bp, rated_rows, rated_items, L, \
                                   part_v, part_i, B, I, D, k, S,        \
                                   items_per_split, thr_g, epoch, s)
  cudaError_t err;
  // the wgmma path (any alignment: the copies widen) at 4, 7 or 8 k-steps,
  // a compile-time count so that the products issue back to back
  if (D <= 32) {
    err = CDAE_TILE(kWgmma, 1, 4);
  } else if (D <= 56) {
    err = CDAE_TILE(kWgmma, 1, 7);
  } else if (D <= kWgmmaMaxD) {
    err = CDAE_TILE(kWgmma, 1, 8);
  } else if (vec == 4) {
    err = CDAE_TILE(kMmaSync, 4, 0);
  } else if (vec == 2) {
    err = CDAE_TILE(kMmaSync, 2, 0);
  } else {
    err = CDAE_TILE(kMmaSync, 1, 0);
  }
#undef CDAE_TILE
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 4;
  const int blocks = (B + warps_per_block - 1) / warps_per_block;
  merge_topk_kernel<<<blocks, warps_per_block * 32, 0, s>>>(
      part_v, part_i, out_v, out_i, B, S, k, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after their launches (0 = launched).
// part_v/part_i: (B, S, k) scratch; out_v/out_i: (B, k). 1 <= k <= 32;
// items_per_split a multiple of 128. D <= 64 takes the wgmma path (one
// block an SM; any alignment of z, W and b'), D > 64 the mma.sync path
// (two blocks an SM), whose copies move ``vec`` (4, 2 or 1) floats:
// D % vec == 0 and z, W 4 * vec-byte aligned.
extern "C" int cdae_fused_topk_dense(const float* z, const float* W,
                                     const float* bp, const int8_t* rated_rows,
                                     float* part_v, int* part_i, float* out_v,
                                     int* out_i, int B, int I, int D, int k,
                                     int S, int items_per_split, int vec,
                                     unsigned long long* thr_g, int epoch,
                                     void* stream) {
  return launch<kDense>(z, W, bp, rated_rows, nullptr, 0, part_v, part_i,
                        out_v, out_i, B, I, D, k, S, items_per_split, vec,
                        thr_g, epoch, stream);
}

extern "C" int cdae_fused_topk_csr(const float* z, const float* W,
                                   const float* bp, const int* rated_items,
                                   int L, float* part_v, int* part_i,
                                   float* out_v, int* out_i, int B, int I,
                                   int D, int k, int S, int items_per_split,
                                   int vec, unsigned long long* thr_g,
                                   int epoch, void* stream) {
  return launch<kCsr>(z, W, bp, nullptr, rated_items, L, part_v, part_i,
                      out_v, out_i, B, I, D, k, S, items_per_split, vec,
                      thr_g, epoch, stream);
}
