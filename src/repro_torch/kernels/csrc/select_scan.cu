// Selection scan for Hopper (sm_90a): SELECT y WHERE lo <= x <= hi, stable.
//
// Replaces the Pallas TPU kernels src/repro/kernels/select_scan.py::
// select_scan (_select_kernel) and select_scan_packed
// (_select_packed_kernel): BlockLoad -> BlockPred -> BlockScan ->
// BlockShuffle -> BlockStore per tile, with the running output offset
// carried across an in-order grid.  Here a call is one sweep
// (lookback.cuh): resident blocks take tiles of kSelectTile rows from a
// ticket; a tile's x is read once, its matches ranked within each warp and
// their y read into the block's stash in shared memory, its count
// published, and a turn later its prefix is found by decoupled look-back
// over the tiles before it, the counterpart of the carried offset: the
// stash is copied to prefix + rank and the tile's misses write their share
// of the zeros past the count.  A call is one memset (the status words and
// the ticket) and one kernel, and the output is stable and the same bits
// on every run.
//
// The two scans differ only in how x is read.  A lane takes kRun
// neighbouring rows a step and the 32 lanes of a warp neighbouring runs,
// so a warp step is one coalesced read:
//   plain int32 / float32 x (PlainX): 4 rows, one 16-byte load;
//   packed x (PackedX, packed.cuh's layout; the bounds are in the encoded
//   domain, so no reference is added): the words of min(16, 128 / phys)
//   rows, one 16-byte load at 16 and 8 bits, 8 bytes at 4, a word at 2,
//   half a word at 1, every value decoded in registers.
// A lane holds kSelectRows rows of its warp's run of rows, in steps; a
// match's rank in the warp is the matches of the warp's earlier steps, of
// the earlier lanes in its step (one warp scan takes the counts of several
// steps at once, each in a field of the word) and of the earlier rows of
// its run.  y is read only for the runs of 4 rows that hold a match (one
// 16-byte load where y is aligned).
//
// What bounds it: device-memory bytes at 3.35 TB/s.  The function needs x
// read once (4n, or the packed words), y read where a row is selected (the
// 32-byte sectors that hold one, 4n at most) and the selected entries
// written (4 per selected row).  The contract also asks for zeros past
// the count, so `out` is written whole: 4n bytes, of which the zero tail,
// 4 (n - count), is not counted by chip_smoke.opat_need's bound.  This
// design moves x once, the selected rows' y sectors, out once and 4 bytes
// of status a tile: about 8n bytes + the y sectors, against 12n + the y
// sectors for the three launches before it (x read twice, a fill of out
// before the scatter).
//
// select_scan_sparse replaces src/repro/kernels/select_scan.py::
// select_scan_sparse (_select_sparse_kernel), the paper's selective load
// (§5.3): x read alone first, then y read only in the 32-row units
// (ref.SKIP_ROWS) that hold a match.  Here it is the same one sweep with
// select_scan's stage, its kernel named select_sparse_sweep so a profile
// tells the two apart: x read once, y read only in the runs of 4 rows
// that hold a match, a finer selective load than the reference's unit (a
// stage that read a 32-row unit's 128-byte line where a warp's ballot
// held a match tied or lost on every case timed on an H100).  What
// bounds it: x read once (4n), y where a match is, and out written whole
// (4n, the zero tail included).
//
// x is int32 or float32 (a NaN is never selected), or packed words; y any
// 4-byte type, moved as raw bits.  Rows >= n never match (a packed
// column's last word may hold padding lanes).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "compact.cuh"
#include "lookback.cuh"
#include "packed.cuh"

namespace {

// The select sweep's shape: rows a thread a tile, and the blocks an SM
// the kernel is built for (4: 64 registers a thread).
constexpr int kSelectRows = 16;
constexpr int kSelectBlocks = 4;
constexpr long long kSelectTile =
    static_cast<long long>(kSweepThreads) * kSelectRows;
static_assert(kSelectRows % 4 == 0 && kSelectRows <= 32,
              "runs of 4 rows; a thread's matches are the bits of a word");

template <typename T>
__device__ __forceinline__ T from_bits(unsigned u);
template <>
__device__ __forceinline__ int from_bits<int>(unsigned u) {
  return static_cast<int>(u);
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) {
  return __uint_as_float(u);
}

// A plain int32 or float32 x: 4 rows a run, one 16-byte load where x is
// aligned and the run lies before n.
template <typename T>
struct PlainX {
  static constexpr int kRun = 4;
  const T* x;
  unsigned n;
  T lo, hi;
  bool vec;                                     // x 16-byte aligned

  // The match bits of rows first .. first + kRun - 1 (first a multiple of
  // kRun): bit j for row first + j.
  __device__ __forceinline__ unsigned matches(unsigned first) const {
    const unsigned* bits = reinterpret_cast<const unsigned*>(x);
    unsigned u[kRun] = {0u, 0u, 0u, 0u};
    if (vec && first + kRun <= n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(bits + first));
      u[0] = q.x;
      u[1] = q.y;
      u[2] = q.z;
      u[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (first + j < n) u[j] = __ldg(bits + first + j);
    }
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const T v = from_bits<T>(u[j]);
      if (first + j < n && v >= lo && v <= hi) m |= 1u << j;
    }
    return m;
  }
};

// A packed x at P bits (1, 2, 4, 8 or 16): the words of kRun rows a run,
// one load of kWords words (16 or 8 bytes where the words are aligned),
// or the word that holds the run when it is less than a word.
template <int P>
struct PackedX {
  static constexpr int kPer = 32 / P;                      // rows a word
  static constexpr int kRun = 128 / P < kSelectRows ? 128 / P : kSelectRows;
  static constexpr int kBits = kRun * P;                   // bits a run
  static constexpr int kWords = kBits >= 32 ? kBits / 32 : 1;
  const unsigned* words;
  unsigned n, n_words;
  int lo, hi;
  bool vec;                                     // words aligned to a load

  __device__ __forceinline__ unsigned matches(unsigned first) const {
    const unsigned wi = first / kPer;
    unsigned w[kWords];
    if constexpr (kWords == 4) {
      if (vec && wi + 4 <= n_words) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(words + wi));
        w[0] = q.x;
        w[1] = q.y;
        w[2] = q.z;
        w[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = wi + k < n_words ? __ldg(words + wi + k) : 0u;
      }
    } else if constexpr (kWords == 2) {
      if (vec && wi + 2 <= n_words) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(words + wi));
        w[0] = q.x;
        w[1] = q.y;
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          w[k] = wi + k < n_words ? __ldg(words + wi + k) : 0u;
      }
    } else {
      w[0] = wi < n_words ? __ldg(words + wi) : 0u;
    }
    // a run shorter than a word starts at its place in the word
    const unsigned off = kBits >= 32 ? 0u : (first % kPer) * P;
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int v = static_cast<int>(
          (w[j * P / 32] >> ((j * P) % 32 + off)) & ((1u << P) - 1u));
      if (first + j < n && v >= lo && v <= hi) m |= 1u << j;
    }
    return m;
  }
};

// The select stage of a sweep (lookback.cuh) over an X (PlainX or
// PackedX): warp w of the block takes rows [w, w + 1) * 32 * kSelectRows
// of the tile, a lane kRun neighbouring rows a step, the warp's lanes
// neighbouring runs.
template <typename X>
struct SelectTile {
  static constexpr int kRun = X::kRun;
  static constexpr int kSteps = kSelectRows / kRun;
  static constexpr int kWarpStep = 32 * kRun;           // rows a warp step
  // a step's count over a warp needs log2(32 kRun) + 1 bits
  static constexpr int kField = kRun <= 4 ? 8 : kRun <= 16 ? 16 : 32;
  static constexpr int kPerScan = 32 / kField;          // steps a scan
  static_assert(kSelectRows % kRun == 0, "whole steps");

  X x;
  const unsigned* y;
  unsigned* out;
  unsigned n;
  bool y_vec;                                   // y 16-byte aligned

  __device__ __forceinline__ void put(unsigned p, unsigned v) const {
    out[p] = v;
  }

  // Step s's match bits, from a lane's.
  static __device__ __forceinline__ unsigned run_bits(unsigned hit, int s) {
    if constexpr (kRun == 32) {
      return hit;
    } else {
      return (hit >> (s * kRun)) & ((1u << kRun) - 1u);
    }
  }

  // Field f of a word of counts.
  static __device__ __forceinline__ unsigned field(unsigned v, int f) {
    if constexpr (kField == 32) {
      return v;
    } else {
      return (v >> (kField * f)) & ((1u << kField) - 1u);
    }
  }

  __device__ __forceinline__ int operator()(unsigned tile,
                                            unsigned* mine) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // step s, run row j: row base + s * kWarpStep + j
    const unsigned base = tile * static_cast<unsigned>(kSelectTile) +
                          warp * (32 * kSelectRows) + lane * kRun;
    unsigned hit = 0u;                          // bit s * kRun + j
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      hit |= x.matches(base + s * kWarpStep) << (s * kRun);

    // the y of each run of 4 rows that holds a match, all loaded before
    // the first rank
    unsigned v[kSelectRows];
#pragma unroll
    for (int g = 0; g < kSelectRows / 4; ++g) {
      const unsigned gm = (hit >> (4 * g)) & 15u;
      if (gm == 0u) continue;
      const unsigned r = base + (4 * g / kRun) * kWarpStep + (4 * g) % kRun;
      if (y_vec && r + 4 <= n) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(y + r));
        v[4 * g] = q.x;
        v[4 * g + 1] = q.y;
        v[4 * g + 2] = q.z;
        v[4 * g + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if ((gm >> j) & 1u) v[4 * g + j] = __ldg(y + r + j);
      }
    }

    // each match to the warp's region at its rank: the warp's matches of
    // the earlier steps, of the earlier lanes in its step (a warp scan of
    // kPerScan steps' counts at once) and of its run's earlier rows
    int at = 0;
#pragma unroll
    for (int s0 = 0; s0 < kSteps; s0 += kPerScan) {
      unsigned packed = 0u;
#pragma unroll
      for (int f = 0; f < kPerScan && s0 + f < kSteps; ++f)
        packed += static_cast<unsigned>(__popc(run_bits(hit, s0 + f)))
                  << (kField * f);
      const unsigned incl = warp_scan(packed);
      const unsigned all = __shfl_sync(kLanes, incl, 31);
      const unsigned excl = incl - packed;
#pragma unroll
      for (int f = 0; f < kPerScan && s0 + f < kSteps; ++f) {
        const int s = s0 + f;
        const unsigned run = run_bits(hit, s);
        int k = at + static_cast<int>(field(excl, f));
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if ((run >> j) & 1u) mine[k++] = v[s * kRun + j];
        at += static_cast<int>(field(all, f));
      }
    }
    return at;
  }
};

template <typename X>
__global__ void __launch_bounds__(kSweepThreads, kSelectBlocks)
select_sweep(const SelectTile<X> stage, unsigned* status,
             long long* count) {
  sweep<kSelectTile, unsigned>(
      stage, stage.n, status,
      status + (stage.n + kSelectTile - 1) / kSelectTile, count);
}

// The same over packed words (its own name, so a profile tells the two
// apart).
template <typename X>
__global__ void __launch_bounds__(kSweepThreads, kSelectBlocks)
select_packed_sweep(const SelectTile<X> stage, unsigned* status,
                    long long* count) {
  sweep<kSelectTile, unsigned>(
      stage, stage.n, status,
      status + (stage.n + kSelectTile - 1) / kSelectTile, count);
}

// select_scan_sparse's sweep: select_scan's stage, its own name so a
// profile tells the two apart.
template <typename X>
__global__ void __launch_bounds__(kSweepThreads, kSelectBlocks)
select_sparse_sweep(const SelectTile<X> stage, unsigned* status,
                    long long* count) {
  sweep<kSelectTile, unsigned>(
      stage, stage.n, status,
      status + (stage.n + kSelectTile - 1) / kSelectTile, count);
}

// select_scan_launch's arguments, passed by one pointer (a ctypes call
// pays for each argument it converts).
struct SelectArgs {
  const void* x;                                // x, or the packed words
  const void* y;
  long long n;
  int lo, hi;           // the bounds' bits in x's type (encoded if packed)
  int phys;             // the packed width (1, 2, 4, 8, 16), or 32: plain
  int is_float;         // a plain x: 1 float32, 0 int32
  int sparse;           // a plain x: 1 select_scan_sparse's sweep
  void* out;
  long long* count;
  unsigned* status;
  long long blocks;                             // resident blocks
};

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// One memset of the status words and the ticket, then the sweep.
template <typename X>
int launch_sweep(void (*kernel)(const SelectTile<X>, unsigned*, long long*),
                 const X& x, const SelectArgs& a, cudaStream_t s) {
  const long long tiles = (a.n + kSelectTile - 1) / kSelectTile;
  cudaError_t err = cudaMemsetAsync(
      a.status, 0, sizeof(unsigned) * static_cast<size_t>(tiles + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SelectTile<X> stage{x, static_cast<const unsigned*>(a.y),
                            static_cast<unsigned*>(a.out),
                            static_cast<unsigned>(a.n), aligned(a.y, 16)};
  const unsigned grid = static_cast<unsigned>(
      tiles < a.blocks ? tiles : a.blocks);
  kernel<<<grid, kSweepThreads, 0, s>>>(stage, a.status, a.count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_plain(const SelectArgs& a, cudaStream_t s) {
  PlainX<T> x{static_cast<const T*>(a.x), static_cast<unsigned>(a.n), T{},
              T{}, aligned(a.x, 16)};
  memcpy(&x.lo, &a.lo, 4);
  memcpy(&x.hi, &a.hi, 4);
  if (a.sparse)
    return launch_sweep(select_sparse_sweep<PlainX<T>>, x, a, s);
  return launch_sweep(select_sweep<PlainX<T>>, x, a, s);
}

template <int P>
int launch_packed(const SelectArgs& a, cudaStream_t s) {
  using X = PackedX<P>;
  const unsigned n = static_cast<unsigned>(a.n);
  const X x{static_cast<const unsigned*>(a.x), n, (n + X::kPer - 1) / X::kPer,
            a.lo, a.hi, aligned(a.x, 4 * X::kWords)};
  return launch_sweep(select_packed_sweep<X>, x, a, s);
}

}  // namespace

// Blocks of the sweep resident on the current device for an x of kind
// `which`: the packed width (1, 2, 4, 8, 16), 32 for a plain int32 x, 96
// (32 | 64) for a plain float32 x; | 128 for select_scan_sparse's sweep.
extern "C" int select_scan_shape(int which, long long* resident) {
  switch (which) {
    case 32: return sweep_blocks(select_sweep<PlainX<int>>, resident);
    case 96: return sweep_blocks(select_sweep<PlainX<float>>, resident);
    case 160:
      return sweep_blocks(select_sparse_sweep<PlainX<int>>, resident);
    case 224:
      return sweep_blocks(select_sparse_sweep<PlainX<float>>, resident);
    case 1: return sweep_blocks(select_packed_sweep<PackedX<1>>, resident);
    case 2: return sweep_blocks(select_packed_sweep<PackedX<2>>, resident);
    case 4: return sweep_blocks(select_packed_sweep<PackedX<4>>, resident);
    case 8: return sweep_blocks(select_packed_sweep<PackedX<8>>, resident);
    case 16: return sweep_blocks(select_packed_sweep<PackedX<16>>, resident);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// args: a SelectArgs (void here, so the entry keeps external linkage).
// x: (n,) int32 or float32, or the packed predicate column, ceil(n / (32
// / phys)) int32 words at `phys` bits; y: (n,) 4-byte; out: (n,), written
// whole (zeros past the count); count: one int64; status:
// select_scan_status_words(n) words of scratch, cleared here; blocks:
// select_scan_shape's for this x.  0 < n < 2^31.  Asks the runtime
// nothing but the memset and the launch.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int select_scan_launch(const void* args, void* stream) {
  const SelectArgs& a = *static_cast<const SelectArgs*>(args);
  if (a.n <= 0 || a.n > 2147483647LL || a.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.phys) {
    case 32: return a.is_float ? launch_plain<float>(a, s)
                               : launch_plain<int>(a, s);
    case 1: return launch_packed<1>(a, s);
    case 2: return launch_packed<2>(a, s);
    case 4: return launch_packed<4>(a, s);
    case 8: return launch_packed<8>(a, s);
    case 16: return launch_packed<16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Scratch words select_scan_launch takes for n rows: a status word per
// tile and the ticket.
extern "C" long long select_scan_status_words(long long n) {
  return (n + kSelectTile - 1) / kSelectTile + 1;
}

// Rows of the sweep's tile.
extern "C" long long select_scan_tile_rows() { return kSelectTile; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
