// Standalone halo exchange of one stacked-layout block, leading (level)
// dims carried, in two launch forms over the one map of halo_remap.cuh,
//
//   out[Y, X] = in[halo_remap_row(Y), halo_remap_col(X)]:
//
// * functional (halo_exchange_launch): a new block, every cell written,
//   as the TPU kernel's output is;
// * ring (halo_exchange_ring_launch): the same exchange in place, writing
//   only the ring, the cells whose source is not themselves.
//
// Replaces the TPU kernel dl_esm_inf_tpu/parallel/halo_pallas.py::
// make_block_exchange: a whole-block copy followed by remote DMAs of the x
// column strips and then the full-width y rows between devices, with
// border restores where a device has no neighbour.  Here every tile is
// in one array on one card, so the two phases collapse into the separable
// map and an exchange is one launch.  The TPU kernel copies the whole
// block because its DMAs land in a new output; on one card only the ring
// changes, so the field's exchange (parallel/halo_kernel.py::
// remote_dma_exchange) takes the ring form wherever it is safe.
//
// Functional form.  What bounds it: one read and one write of the block
// (40.69 us for a 4128^2 float32 block at 3.35 TB/s; sweep_probe.py
// --exchange times a torch.clone of it beside the kernel).  A warp takes 32
// consecutive words of a row, a thread one word; the row's source row is
// looked up once per word, not per element.  A word whose columns all
// map to themselves (every word of a tile's row but those touching the
// d-column strips at each seam) is one load from the source row at the
// same columns and one store; a word touching a strip is copied element
// by element through the column map.  One word a thread, and a grid of
// as many blocks as the words need, beat the other shapes tried on the
// H100 (a persistent grid of whole waves with 4 words in flight a
// thread; 2-8 rows a thread): the map's few integer divisions a thread
// then overlap other threads' loads instead of delaying a thread's own.
// Words are 16 bytes (uint4) where a row is a whole number of them
// (nx * elem_bytes % 16 == 0) and both pointers are 16-byte aligned, else
// single elements (the same kernel, W = E):
//   - 16 bytes: float32 / int32 blocks with nx % 4 == 0 and float64 with
//     nx % 2 == 0 (1056^2 and 4128^2 float32 blocks; a walled 2x2 grid at
//     halo 1 with 18-column rows at float64);
//   - elements: the rest (the same 18-column rows at float32: 72 bytes).
//
// Ring form.  Threads take the strip cells: for every y seam with a
// neighbour its d full-width rows (in words, as above), for every x seam
// with a neighbour its d columns over the rows outside the y strips, so
// each corner is written once, by its row.  What bounds it: the ring's
// bytes are ~1% of the block's (1.05 MB at 4128^2, halo 8, depth 8, 2x2
// tiles: 0.31 us), so its time is a launch and a few dependent loads.
//
// Why the ring form is race-free, and when.  Along one axis with tile
// extent t, a strip cell at local r in [h-d, h) reads local r + t of the
// tile before it, in [h-d+t, h+t); one at r in [h+t, h+t+d) reads r - t of
// the tile after it, in [h, h+d).  When d <= t both ranges lie inside
// [h, h+t), a tile's interior, which maps to itself: the source index is
// a fixed point of the axis map.  A written cell (Y, X) is one where
// R(Y) != Y or C(X) != X; it reads (R(Y), C(X)), whose indices are fixed
// points, so no thread reads a cell any thread writes (a corner reads the
// diagonal tile's interior).  The reads see the input, the writes are
// disjoint, so the launch equals the functional form.  When d > t on an
// axis that moves strips, a strip's first index reads local h-d+t < h of
// the tile before it, which is that tile's own strip of the same launch
// wherever it has a neighbour there (three or more tiles, or a periodic
// axis; not two walled ones).  The rule is kept simple, d <= t: the
// launcher refuses the rest, and the field takes the functional form
// there (halo_kernel.py::ring_in_place).
//
// Both forms copy raw 4- or 8-byte words, so float32, int32 and float64
// move bit for bit.  Item counts are 32-bit: a block holds fewer than
// 2^31 elements (the wrapper checks it).
#include <cuda_runtime.h>

#include <cstdint>

#include "halo_remap.cuh"

namespace {

// The functional form's block: kRowsY rows of threads, kWordsX (a warp)
// consecutive words of a row each, one word a thread.
constexpr int kWordsX = 32;
constexpr int kRowsY = 8;
// The ring form's block: one strip item a thread.
constexpr int kRingThreads = 256;

// Offset of the row that row `row` (of level row / ny) reads.
__device__ __forceinline__ size_t source_row(const HaloRemap& m, int row,
                                             int ny, int nx) {
  const int lvl = row / ny, y = row - lvl * ny;
  return (static_cast<size_t>(lvl) * ny + halo_remap_row(m, y)) * nx;
}

// Word w of the row at element offset `dst` from the row at `src`: one
// word from the same columns where none of them moves, else element by
// element through the column map.
template <typename E, typename W>
__device__ __forceinline__ void copy_word(const E* in, E* out, size_t src,
                                          size_t dst, int w,
                                          const HaloRemap& m) {
  constexpr int V = sizeof(W) / sizeof(E);
  if (!halo_remap_cols_move(m, w * V, V)) {
    reinterpret_cast<W*>(out)[dst / V + w] =
        reinterpret_cast<const W*>(in)[src / V + w];
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int x = w * V + j;
    out[dst + x] = in[src + halo_remap_col(m, x)];
  }
}

// Functional form: thread (tx, ty) copies word blockIdx.x * kWordsX + tx
// of row y0 + blockIdx.y * kRowsY + ty of level blockIdx.z.
template <typename E, typename W>
__global__ void __launch_bounds__(kWordsX* kRowsY)
halo_exchange_kernel(const E* __restrict__ in, E* __restrict__ out, int ny,
                     int nx, int y0, HaloRemap m) {
  const int w = blockIdx.x * kWordsX + threadIdx.x;
  const int y = y0 + blockIdx.y * kRowsY + threadIdx.y;
  if (w >= nx / static_cast<int>(sizeof(W) / sizeof(E)) || y >= ny) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * ny;
  copy_word<E, W>(in, out, (plane + halo_remap_row(m, y)) * nx,
                  (plane + y) * nx, w, m);
}

// One thread per ring item: first the y strips' rows in words
// (((lvl * 2 nprocy + strip) * d + i) * nw + w), then the x strips'
// columns (((lvl * 2 nprocx + strip) * ny + y) * d + i); a strip slot is
// (tile, side), idle where the tile has no neighbour on that side.
template <typename E, typename W>
__global__ void __launch_bounds__(kRingThreads)
halo_ring_kernel(E* blk, int ny, int nx, HaloRemap m, unsigned row_items,
                 unsigned total) {
  constexpr int V = sizeof(W) / sizeof(E);
  const unsigned item = blockIdx.x * kRingThreads + threadIdx.x;
  if (item >= total) return;
  const int d = m.depth;
  if (item < row_items) {
    const unsigned nw = nx / V;
    unsigned r = item / nw;
    const int w = item - r * nw;
    const int i = r % d;
    r /= d;
    const int slot = r % (2 * m.nprocy), lvl = r / (2 * m.nprocy);
    const int y0 = halo_strip_start(slot >> 1, slot & 1, m.halo, d,
                                    m.tile_ny, m.local_ny, m.nprocy,
                                    m.wrap_y);
    if (y0 < 0) return;
    const int row = lvl * ny + y0 + i;
    copy_word<E, W>(blk, blk, source_row(m, row, ny, nx),
                    static_cast<size_t>(row) * nx, w, m);
    return;
  }
  unsigned r = item - row_items;
  const int i = r % d;
  r /= d;
  const int y = r % ny;
  r /= ny;
  const int slot = r % (2 * m.nprocx), lvl = r / (2 * m.nprocx);
  const int x0 = halo_strip_start(slot >> 1, slot & 1, m.halo, d, m.tile_nx,
                                  m.local_nx, m.nprocx, m.wrap_x);
  if (x0 < 0 || halo_remap_row(m, y) != y) return;  // corners: by the rows
  const size_t at = (static_cast<size_t>(lvl) * ny + y) * nx;
  blk[at + x0 + i] = blk[at + halo_remap_col(m, x0 + i)];
}

// Grids of at most 65535 levels by 65535 row blocks, as many as the block
// needs, on `stream`.
template <typename E, typename W>
cudaError_t launch_copy(const void* in, void* out, int lead, int ny, int nx,
                        const HaloRemap& m, cudaStream_t stream) {
  constexpr int kMax = 65535;
  const int nw = nx / (sizeof(W) / sizeof(E));
  const int row_blocks = (ny + kRowsY - 1) / kRowsY;
  for (int l0 = 0; l0 < lead; l0 += kMax) {
    const size_t at = static_cast<size_t>(l0) * ny * nx;
    for (int b0 = 0; b0 < row_blocks; b0 += kMax) {
      const dim3 grid((nw + kWordsX - 1) / kWordsX,
                      row_blocks - b0 < kMax ? row_blocks - b0 : kMax,
                      lead - l0 < kMax ? lead - l0 : kMax);
      halo_exchange_kernel<E, W><<<grid, dim3(kWordsX, kRowsY), 0, stream>>>(
          static_cast<const E*>(in) + at, static_cast<E*>(out) + at, ny, nx,
          b0 * kRowsY, m);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename E, typename W>
cudaError_t launch_ring(void* blk, int lead, int ny, int nx,
                        const HaloRemap& m, cudaStream_t stream) {
  const unsigned nw = nx / (sizeof(W) / sizeof(E));
  const unsigned row_items = static_cast<unsigned>(lead) * 2 * m.nprocy *
                             m.depth * nw;
  const unsigned total = row_items + static_cast<unsigned>(lead) * 2 *
                                         m.nprocx * ny * m.depth;
  halo_ring_kernel<E, W><<<(total + kRingThreads - 1) / kRingThreads,
                           kRingThreads, 0, stream>>>(
      static_cast<E*>(blk), ny, nx, m, row_items, total);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// launch(E{}, W{}) for the block's elements E (elem_bytes 4 or 8) and
// words W (16 bytes where `vec`, else one element).
template <typename Launch>
cudaError_t by_word(int elem_bytes, bool vec, Launch launch) {
  using U64 = unsigned long long;
  if (elem_bytes == 4) {
    return vec ? launch(uint32_t{}, uint4{}) : launch(uint32_t{}, uint32_t{});
  }
  if (elem_bytes == 8) {
    return vec ? launch(U64{}, uint4{}) : launch(U64{}, U64{});
  }
  return cudaErrorInvalidValue;
}

// The remap's fields in order, checked against the block: false where
// they do not describe it or the block is too large for 32-bit items.
bool read_remap(const int* remap, int n_remap, int lead, int ny, int nx,
                HaloRemap* m) {
  if (n_remap != kHaloRemapInts || lead < 1 || ny < 1 || nx < 1) return false;
  int* dst = reinterpret_cast<int*>(m);
  for (int i = 0; i < kHaloRemapInts; ++i) dst[i] = remap[i];
  return m->nprocy * m->local_ny == ny && m->nprocx * m->local_nx == nx &&
         m->depth >= 1 && m->depth <= m->halo &&
         static_cast<long long>(lead) * ny * nx < (1ll << 31);
}

}  // namespace

extern "C" {

// Number of ints the launches expect in `remap`.
int halo_exchange_num_remap_ints() { return kHaloRemapInts; }

// The functional form.  elem_bytes: 4 or 8.  `in` and `out` are device
// pointers of distinct contiguous (lead, ny, nx) blocks, ny =
// nprocy*local_ny, nx = nprocx*local_nx, fewer than 2^31 elements;
// `remap` (host memory, read before the launch returns) holds the fields
// of HaloRemap in order.  Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch.
int halo_exchange_launch(int elem_bytes, const void* in, void* out, int lead,
                         int ny, int nx, const int* remap, int n_remap,
                         void* stream) {
  HaloRemap m;
  if (!read_remap(remap, n_remap, lead, ny, nx, &m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (nx * elem_bytes) % 16 == 0 && aligned16(in) &&
                   aligned16(out);
  return static_cast<int>(by_word(elem_bytes, vec, [&](auto e, auto w) {
    return launch_copy<decltype(e), decltype(w)>(
        in, out, lead, ny, nx, m, static_cast<cudaStream_t>(stream));
  }));
}

// The ring form: the same exchange of the block `blk` in place.  Refuses
// (cudaErrorInvalidValue) a depth above the tile extent on an axis that
// moves strips (see the header comment).
int halo_exchange_ring_launch(int elem_bytes, void* blk, int lead, int ny,
                              int nx, const int* remap, int n_remap,
                              void* stream) {
  HaloRemap m;
  if (!read_remap(remap, n_remap, lead, ny, nx, &m) ||
      ((m.nprocx > 1 || m.wrap_x) && m.depth > m.tile_nx) ||
      ((m.nprocy > 1 || m.wrap_y) && m.depth > m.tile_ny)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (nx * elem_bytes) % 16 == 0 && aligned16(blk);
  return static_cast<int>(by_word(elem_bytes, vec, [&](auto e, auto w) {
    return launch_ring<decltype(e), decltype(w)>(
        blk, lead, ny, nx, m, static_cast<cudaStream_t>(stream));
  }));
}

}  // extern "C"
