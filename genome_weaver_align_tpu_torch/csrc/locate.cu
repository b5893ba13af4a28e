// Sparse-SA locate on Hopper (sm_90a): the LF walk of each BWT row to its
// nearest sampled row, over one index or over its interval shards, on a
// persistent grid whose threads walk one row after another.
//
// Replaces the JAX package's device loops
//   genome_weaver_align_tpu/ops/rank.py:234                 (locate)
//   genome_weaver_align_tpu/parallel/sharded_index.py:267   (locate)
// (each a lax.fori_loop of sample_rate steps under jit) and computes exactly
// the port's plain versions, ops/rank.py locate_plain and
// parallel/sharded_index.py locate_plain (default merge):
//   while the row is not marked (at most sample_rate times): row = LF(row), d++
//   position = ssa_values[rank1(marks, row)] + d
// The plain loops take LF sample_rate times and keep a marked row where it
// is; a marked row stays marked, so stopping at the first mark gives the
// same row and d.  Rows are in [0, n] (callers clamp); every table index is
// also clamped into its table, so no row reads outside the tables.
//
// One loop (walk) over a table accessor.  OneIndex: a step reads the row's
// 16-byte mark block (rank.MARK_BLOCK_BITS = 128 rows) and its 48-byte fused
// row together, before the mark is known: one dependent round trip a step,
// for one row read in vain at the marked end.  LF's code and count come from
// that row (rank.lf_fused; fm_occ.cuh lf_below).  rank1 is the mark
// block's checkpoint plus the popcount of the block's bits below the row
// (the words masked as rank._mark_rank1 does), then one sampled value.
// Shards: the same walk over the ShardedFMIndex tables
// (parallel/sharded_index.py:56), one base pointer a shard and table
// (fm_occ.cuh ShardTable: the stacked tables' rows, one kernel
// instantiation, or shards in their own allocations, a peer process's
// mapped through CUDA IPC, through a device table of their pointers, the
// other).  Each step finds the row's owner in the row coordinates (marks,
// sampled values) and in the packed coordinates (BWT words and
// checkpoints) with fm_occ.cuh owner_of (x / width, confirmed against the
// bounds) and reads only the owners' tables.
// That equals the plain loop's sums over the shards, where non-owners add
// 0, including its quirks: the BWT code has an owner only below n
// (local_bwt_char), a coordinate with no owner adds 0, and the sampled slot
// is clamped to the shard's table (local_ssa_value).
//
// What bounds it: the walk's dependent chain and the issue of its steps.
// A walk takes 0 to sample_rate - 1 LF steps (4.74 on average on the FM
// path at sample_rate 8); each step is one dependent round trip to L2 (the
// tables stay there at the paths' index sizes, except the sampled values)
// and the instructions that turn the row into the next row.  Below about
// 65,536 rows a launch waits on the chain; at the FM path's 393,216 rows
// on issue and on waves (PERF.md section 6).  So a step's chain is short
// (lf_below: one masked word, selects by bits, no branch), the sharded
// owners come by division (owner_of, not two scans of the bounds), and the
// grid is persistent: the blocks that fit on the SMs at once, no more than
// the rows need, each thread walking one row at a time until the rows run
// out, its next row strided (the grid's threads further on) and that row's
// id read while the current one walks.  Measured at the paths' shapes
// (PERF.md section 6), one walk a thread beats two and four walked in
// lockstep (more registers, fewer threads, the longest of the thread's
// walks), strided rows beat rows claimed from a counter (the atomic's
// round trip before each row), and both beat a machine of per-slot stages
// that let a slot start a new row while its warp still walked (its
// per-trip overhead lengthens every step's chain).
//
// Entries: gwa_locate (one index) and gwa_locate_sharded (any S >= 1
// interval shards: up to fm_occ.cuh kMaxStaged with the pointers and
// bounds staged in shared memory once a block, past it the wide kernel,
// everything read through L1), plain C functions bound with ctypes; they
// launch on the
// caller's stream, do not synchronise, allocate nothing, and return the
// launch's CUDA error code.  gwa_locate_resident gives the blocks of a
// kernel that fit on one SM (the binding's persistent grid).

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_occ.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMarkBits = 128;  // rows a mark block (4 words)

// The row's bit in its 16-byte mark block (bit at offset rem, 0..127; a
// larger offset reads the last word).
__device__ __forceinline__ bool mark_bit(const uint4& m, int rem) {
  return (gwa::sel4(m.x, m.y, m.z, m.w, min(rem >> 5, 3)) >> (rem & 31)) & 1u;
}

// Marked rows of the block before offset rem (0..128).
__device__ __forceinline__ int marks_below(const uint4& m, int rem) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int allowed = min(max(rem - 32 * j, 0), 32);
    const unsigned mask = allowed >= 32 ? 0xFFFFFFFFu : (1u << allowed) - 1u;
    n += __popc(w[j] & mask);
  }
  return n;
}

__device__ __forceinline__ uint4 load4(const int* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct LocateArgs {
  const int* rows;  // (Q,)
  int* out;         // (Q,)
  int Q, sample_rate;
};

// Where a walk stopped: its mark block's rank1 checkpoint (null: no owner,
// the value is 0) and a key for the sampled value's index: the block's
// marked rows below the row, and the owner above bit 8 (shards).
struct Stop {
  const int* cp;
  int key;
};

// One index: DeviceFMIndex's fused rows and marks.
struct OneIndex {
  gwa::FMTable fm;
  const int* blocks;  // (mb, 4) mark words
  const int* cp;      // (mb + 1,) rank1 checkpoints
  const int* ssa;     // (n_ssa,) sampled values in row order
  int mb, n_ssa, n;

  struct Step {
    gwa::FusedRow row;
    uint4 marks;
    int mblk, rem;
  };
  __device__ __forceinline__ Step load(int i) const {
    Step s;
    s.mblk = min(max(i >> 7, 0), mb - 1);
    s.rem = i - s.mblk * kMarkBits;
    s.marks = load4(blocks + static_cast<int64_t>(s.mblk) * 4);
    s.row = gwa::load_row(fm, min(max(i, 0), n));
    return s;
  }
  __device__ __forceinline__ bool marked(const Step& s) const {
    return mark_bit(s.marks, s.rem & (kMarkBits - 1));
  }
  __device__ __forceinline__ int lf(const Step& s) const { return gwa::lf_below(s.row, fm.C); }
  __device__ __forceinline__ Stop stop(const Step& s) const {
    return {cp + s.mblk, marks_below(s.marks, s.rem)};
  }
  __device__ __forceinline__ const int* value_at(int key, int rank0) const {
    return ssa + min(max(rank0 + key, 0), n_ssa - 1);
  }
};

// Interval shards: ShardedFMIndex's tables (fm_occ.cuh ShardTable: stacked,
// or one base pointer a shard, from a device table or, Staged, in shared
// memory), both splits' bounds and the sampled values' bases in device
// memory (Staged: in shared memory).
template <bool Stacked, bool Staged>
struct Shards {
  gwa::ShardedFM<Stacked, Staged> fm;    // the packed split in fm.pk
  gwa::Split rows;                     // the row coordinates' split
  gwa::ShardTable<Stacked> blocks;     // each shard's (mbs, 4) mark words
  gwa::ShardTable<Stacked> cp;         // each shard's (mbs + 1) global rank1 at its block starts
  gwa::ShardTable<Stacked> ssa;        // each shard's (vmax) sampled values
  const int* ssa_base;                 // (S,) marked rows before each shard
  int mbs, vmax, n;

  struct Step {
    gwa::ShardRow row;
    uint4 marks;
    int owner, b, rem;  // the row's owner, its local mark block, the offset in it
    bool coded;         // the coordinate lies below n: its BWT code has an owner
  };
  __device__ __forceinline__ Step load(int i) const {
    Step s;
    s.owner = gwa::owner_of<Staged>(rows, i);
    s.b = s.rem = 0;
    s.marks = make_uint4(0, 0, 0, 0);
    if (s.owner >= 0) {
      const int local = i - gwa::bound_at<Staged>(rows.start, s.owner);  // >= 0: the owner's range holds i
      s.b = min(local >> 7, mbs - 1);
      s.rem = local - s.b * kMarkBits;
      s.marks = load4(blocks[s.owner] + static_cast<int64_t>(s.b) * 4);
    }
    s.row = gwa::load_row(fm, i);
    s.coded = i - (i > fm.primary ? 1 : 0) < n;
    return s;
  }
  __device__ __forceinline__ bool marked(const Step& s) const {
    return s.owner >= 0 && mark_bit(s.marks, s.rem);
  }
  __device__ __forceinline__ int lf(const Step& s) const {
    return s.row.own ? gwa::lf_below(s.row.row, fm.C, s.coded) : fm.C[0];
  }
  __device__ __forceinline__ Stop stop(const Step& s) const {
    if (s.owner < 0) return {nullptr, 0};
    return {cp[s.owner] + s.b, marks_below(s.marks, s.rem) | s.owner << 8};
  }
  __device__ __forceinline__ const int* value_at(int key, int rank0) const {
    const int owner = key >> 8;
    return ssa[owner] + min(max(rank0 + (key & 255) - gwa::bound_at<Staged>(ssa_base, owner), 0), vmax - 1);
  }
};

// The persistent walk: each thread walks rows start, start + threads, ...
// (threads = the grid's), each to its first mark, then reads its checkpoint
// and sampled value; the next row's id is read while the current one walks.
template <class Table>
__device__ __forceinline__ void walk(const LocateArgs& a, const Table& tab) {
  const int threads = gridDim.x * kThreads;
  int q = blockIdx.x * kThreads + threadIdx.x;
  int row = q < a.Q ? __ldg(a.rows + q) : 0;
  while (q < a.Q) {
    const int next = q + threads;
    const int next_row = next < a.Q ? __ldg(a.rows + next) : 0;
    int i = row, d = 0;
    typename Table::Step st = tab.load(i);
    while (d != a.sample_rate && !tab.marked(st)) {
      i = tab.lf(st);
      ++d;
      st = tab.load(i);
    }
    const Stop e = tab.stop(st);
    const int rank0 = e.cp != nullptr ? __ldg(e.cp) : 0;
    const int value = e.cp != nullptr ? __ldg(tab.value_at(e.key, rank0)) : 0;
    a.out[q] = value + d;
    q = next;
    row = next_row;
  }
}

__global__ void __launch_bounds__(kThreads)
    locate_kernel(const LocateArgs a, OneIndex tab, const int* C) {
#pragma unroll
  for (int c = 0; c < 4; ++c) tab.fm.C[c] = __ldg(C + c);
  walk(a, tab);
}

// The bounds of both splits and the sampled values' bases, in device
// memory.
struct ShardBounds {
  const int* pk_start;
  const int* pk_end;
  const int* row_start;
  const int* row_end;
  const int* ssa_base;
};

struct ShardTables {
  gwa::ShardPtrs bwt, occ_cp, mark_blocks, mark_cp, ssa_values;
};

// Up to gwa::kMaxStaged shards: the S bounds of both splits, the sampled
// values' bases and the tables' base pointers go to shared memory once a
// block (fm_occ.cuh load_shards, load_split).
template <bool Stacked>
__global__ void __launch_bounds__(kThreads)
    locate_sharded_kernel(const LocateArgs a, Shards<Stacked, true> tab, const int* C,
                          const ShardBounds sb, const ShardTables t) {
  __shared__ int s_ps[gwa::kMaxStaged], s_pe[gwa::kMaxStaged];
  __shared__ int s_rs[gwa::kMaxStaged], s_re[gwa::kMaxStaged], s_base[gwa::kMaxStaged];
  __shared__ const int* s_ptr[5][gwa::kMaxStaged];
  const int S = tab.fm.pk.S;
  const int64_t R = tab.fm.R, mbs = tab.mbs;
  if (threadIdx.x < S) s_base[threadIdx.x] = sb.ssa_base[threadIdx.x];
  tab.fm.bwt = gwa::load_shards<Stacked>(t.bwt, S, R * 8, s_ptr[0]);
  tab.fm.cp = gwa::load_shards<Stacked>(t.occ_cp, S, R * 4, s_ptr[1]);
  tab.blocks = gwa::load_shards<Stacked>(t.mark_blocks, S, mbs * 4, s_ptr[2]);
  tab.cp = gwa::load_shards<Stacked>(t.mark_cp, S, mbs + 1, s_ptr[3]);
  tab.ssa = gwa::load_shards<Stacked>(t.ssa_values, S, tab.vmax, s_ptr[4]);
  tab.fm.pk = gwa::load_split(sb.pk_start, sb.pk_end, S, tab.fm.pk.magic, tab.fm.pk.shift,
                              s_ps, s_pe);
  tab.rows = gwa::load_split(sb.row_start, sb.row_end, S, tab.rows.magic, tab.rows.shift, s_rs,
                             s_re);
  tab.ssa_base = s_base;
#pragma unroll
  for (int c = 0; c < 4; ++c) tab.fm.C[c] = __ldg(C + c);
  walk(a, tab);
}

// Any S: `tab` comes whole from the host (the tables stacked or in a
// device table, the splits with the binding's findings).
template <bool Stacked>
__global__ void __launch_bounds__(kThreads)
    locate_wide_kernel(const LocateArgs a, Shards<Stacked, false> tab, const int* C) {
  gwa::split_base(tab.fm.pk);
  gwa::split_base(tab.rows);
#pragma unroll
  for (int c = 0; c < 4; ++c) tab.fm.C[c] = __ldg(C + c);
  walk(a, tab);
}

// The kernel of one index, or of the shards (stacked, or apart; staged up
// to gwa::kMaxStaged shards).
const void* kernel_of(bool sharded, bool stacked = true, bool staged = true) {
  if (!sharded) return reinterpret_cast<const void*>(&locate_kernel);
  if (!staged)
    return stacked ? reinterpret_cast<const void*>(&locate_wide_kernel<true>)
                   : reinterpret_cast<const void*>(&locate_wide_kernel<false>);
  return stacked ? reinterpret_cast<const void*>(&locate_sharded_kernel<true>)
                 : reinterpret_cast<const void*>(&locate_sharded_kernel<false>);
}

// Checks a launch's shape and launches the kernel with its arguments.
int launch(const void* kernel, int64_t Q, int grid, void** args, cudaStream_t stream) {
  // every row index a thread reaches, Q + threads, stays inside int32
  if (Q < 0 || Q > (1 << 30) || grid < 1 || grid > (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  return static_cast<int>(
      cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 0, stream));
}

// A sharded launch's sizes and owner divisors.
struct ShardSizes {
  int S, R, mbs, vmax, primary, n;
  unsigned pk_magic;
  int pk_shift;
  unsigned row_magic;
  int row_shift;
};

// The staged launch (S <= gwa::kMaxStaged): the S pointers of each table
// (`ptrs`, host memory, in the order bwt, occ_cp, mark blocks, mark
// checkpoints, sampled values) go in as parameters.
template <bool Stacked>
int launch_staged(LocateArgs a, int64_t Q, const ShardSizes& z, const int* c, ShardBounds sb,
                  const uint64_t* const* ptrs, int grid, cudaStream_t stream) {
  ShardTables t{};
  gwa::ShardPtrs* tables[] = {&t.bwt, &t.occ_cp, &t.mark_blocks, &t.mark_cp, &t.ssa_values};
  for (int u = 0; u < 5; ++u) {
    for (int s = 0; s < z.S; ++s) tables[u]->p[s] = reinterpret_cast<const int*>(ptrs[u][s]);
  }
  Shards<Stacked, true> tab{};
  tab.fm.pk = {nullptr, nullptr, z.S, z.pk_magic, z.pk_shift, false, false, 0};
  tab.fm.R = z.R;
  tab.fm.primary = z.primary;
  tab.rows = {nullptr, nullptr, z.S, z.row_magic, z.row_shift, false, false, 0};
  tab.mbs = z.mbs;
  tab.vmax = z.vmax;
  tab.n = z.n;
  void* args[] = {&a, &tab, &c, &sb, &t};
  return launch(kernel_of(true, Stacked), Q, grid, args, stream);
}

// The launch for any S: `table` (null for stacked tables) holds the five
// tables' S pointers each, in `ptrs`' order.
template <bool Stacked>
int launch_wide(LocateArgs a, int64_t Q, const ShardSizes& z, const int* c, ShardBounds sb,
                const uint64_t* const* ptrs, const uint64_t* table, int pk_facts, int row_facts,
                int grid, cudaStream_t stream) {
  const auto at = [&](int u) { return table ? table + static_cast<int64_t>(u) * z.S : nullptr; };
  Shards<Stacked, false> tab{};
  const void* first[5];
  for (int u = 0; u < 5; ++u) first[u] = reinterpret_cast<const void*>(ptrs[u][0]);
  tab.fm.bwt = gwa::shard_table<Stacked>(first[0], at(0), static_cast<int64_t>(z.R) * 8);
  tab.fm.cp = gwa::shard_table<Stacked>(first[1], at(1), static_cast<int64_t>(z.R) * 4);
  tab.blocks = gwa::shard_table<Stacked>(first[2], at(2), static_cast<int64_t>(z.mbs) * 4);
  tab.cp = gwa::shard_table<Stacked>(first[3], at(3), z.mbs + 1);
  tab.ssa = gwa::shard_table<Stacked>(first[4], at(4), z.vmax);
  tab.fm.pk = gwa::make_split(sb.pk_start, sb.pk_end, z.S, z.pk_magic, z.pk_shift, pk_facts);
  tab.fm.R = z.R;
  tab.fm.primary = z.primary;
  tab.rows = gwa::make_split(sb.row_start, sb.row_end, z.S, z.row_magic, z.row_shift, row_facts);
  tab.ssa_base = sb.ssa_base;
  tab.mbs = z.mbs;
  tab.vmax = z.vmax;
  tab.n = z.n;
  void* args[] = {&a, &tab, &c};
  return launch(kernel_of(true, Stacked, false), Q, grid, args, stream);
}

}  // namespace

// Blocks of the kernel (one index or stacked shards) that fit on one SM at
// once, in *blocks.
extern "C" int gwa_locate_resident(int sharded, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(sharded != 0), kThreads, 0));
}

// rows and out (Q,), blocks (nb_rows, 12) 16-byte aligned, C (5,),
// mark_blocks (mb, 4) 16-byte aligned, mark_cp (mb + 1,), ssa_values
// (n_ssa,): all int32.  grid blocks of 256 threads.
extern "C" int gwa_locate(const void* rows, int64_t Q, const void* blocks, int nb_rows,
                          const void* C, int primary, int n, const void* mark_blocks, int mb,
                          const void* mark_cp, const void* ssa_values, int n_ssa,
                          int sample_rate, void* out, int grid, void* stream) {
  // a row of [0, n] must find its fused row: n / 128 < nb_rows
  if ((n >> 7) >= nb_rows || mb < 1 || n_ssa < 1 || sample_rate < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LocateArgs a{static_cast<const int*>(rows), static_cast<int*>(out), static_cast<int>(Q),
               sample_rate};
  OneIndex tab{};
  tab.fm.blocks = static_cast<const int*>(blocks);
  tab.fm.primary = primary;
  tab.blocks = static_cast<const int*>(mark_blocks);
  tab.cp = static_cast<const int*>(mark_cp);
  tab.ssa = static_cast<const int*>(ssa_values);
  tab.mb = mb;
  tab.n_ssa = n_ssa;
  tab.n = n;
  const int* c = static_cast<const int*>(C);
  void* args[] = {&a, &tab, &c};
  return launch(kernel_of(false), Q, grid, args, static_cast<cudaStream_t>(stream));
}

// rows and out (Q,); each of the S shards' bwt (R, 8) and occ_cp (R, 4)
// 16-byte aligned, mark_blocks (mbs, 4) 16-byte aligned, mark_cp (mbs + 1)
// and ssa_values (vmax) (the *_ptrs: S device pointers each, in host
// memory); pk_start / pk_end, row_start / row_end and ssa_base (S,), C
// (5,): all int32.  The shards are the rows of five stacked tables where
// `table` is null, else each in its own allocation, `table` the 5 S
// pointers in device memory, in the *_ptrs' order.  Each split's owner
// guess is (x - start[0]) / width = __umulhi(x - start[0], magic) >> shift
// (fm_search_cuda.owner_divisor); pk_facts / row_facts are the binding's
// findings on each split's bounds (bit 0: disjoint, bit 1: in order), read
// past gwa::kMaxStaged shards (below it a block finds disjointness itself).
extern "C" int gwa_locate_sharded(const void* rows, int64_t Q, int S, int R,
                                  const uint64_t* bwt_ptrs, const uint64_t* cp_ptrs,
                                  const void* pk_start, const void* pk_end, unsigned pk_magic,
                                  int pk_shift, int pk_facts, int mbs,
                                  const uint64_t* mark_block_ptrs, const uint64_t* mark_cp_ptrs,
                                  const void* row_start, const void* row_end,
                                  unsigned row_magic, int row_shift, int row_facts, int vmax,
                                  const uint64_t* ssa_ptrs, const void* ssa_base, const void* C,
                                  int primary, int n, int sample_rate, void* out, int grid,
                                  const void* table, void* stream) {
  if (S < 1 || R < 1 || mbs < 1 || vmax < 1 || sample_rate < 0 || n < 0 || pk_shift < 0 ||
      pk_shift > 31 || row_shift < 0 || row_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  LocateArgs a{static_cast<const int*>(rows), static_cast<int*>(out), static_cast<int>(Q),
               sample_rate};
  ShardSizes z{S, R, mbs, vmax, primary, n, pk_magic, pk_shift, row_magic, row_shift};
  const int* c = static_cast<const int*>(C);
  ShardBounds sb{static_cast<const int*>(pk_start), static_cast<const int*>(pk_end),
                 static_cast<const int*>(row_start), static_cast<const int*>(row_end),
                 static_cast<const int*>(ssa_base)};
  const uint64_t* ptrs[] = {bwt_ptrs, cp_ptrs, mark_block_ptrs, mark_cp_ptrs, ssa_ptrs};
  const auto tab = static_cast<const uint64_t*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (S <= gwa::kMaxStaged) {
    if (tab == nullptr) return launch_staged<true>(a, Q, z, c, sb, ptrs, grid, st);
    return launch_staged<false>(a, Q, z, c, sb, ptrs, grid, st);
  }
  if (tab == nullptr)
    return launch_wide<true>(a, Q, z, c, sb, ptrs, tab, pk_facts, row_facts, grid, st);
  return launch_wide<false>(a, Q, z, c, sb, ptrs, tab, pk_facts, row_facts, grid, st);
}
