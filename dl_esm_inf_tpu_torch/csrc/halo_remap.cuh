// Geometry of the two-phase halo exchange on the stacked layout: the one
// place that says which cell each point of an exchanged block is copied
// from.  Both exchange kernels include it: the standalone block exchange
// (halo_exchange.cu) and the exchange inside the flagship sweep
// (nemolite2d_sweep.cu, EXCH).  It plays the part of the JAX package's
// dl_esm_inf_tpu/parallel/rdma.py, which keeps the pieces the two TPU
// transports must not let drift in one place; its Python mirror is
// dl_esm_inf_tpu_torch/parallel/halo.py::exchange_index.
//
// The stacked array is (nprocy*local_ny, nprocx*local_nx): every tile of
// the decomposition with its halo ring.  One exchange of depth d is an x
// phase (d edge columns of every row of a tile move to the east and west
// neighbours) and then a y phase (d full-width edge rows, the x halos
// just received included, move north and south), so corners come from the
// diagonal tile.  Both phases are separable, so the exchange is a gather:
//
//   out[Y, X] = in[halo_remap_row(Y), halo_remap_col(X)]
//
// Along one axis, with halo h, depth d, tile extent t, local extent l and
// n tiles, a point at local r of tile k reads
//   row/column r + t of tile k-1 (mod n)  if h-d <= r < h   and k has a
//                                          west/south neighbour,
//   row/column r - t of tile k+1 (mod n)  if h+t <= r < h+t+d and k has an
//                                          east/north neighbour,
//   itself                                 otherwise.
// A tile has a neighbour on a side unless it is the last tile on that
// side of a walled (non-periodic) axis; one tile on a periodic axis is
// its own neighbour on both sides.
//
// On one card every tile is in one array and the exchange reads only its
// input and writes a separate output, so no block depends on another:
// the readiness fence and the entry barrier the TPU transports need
// between devices (rdma.py: make_fence, entry_barrier) have nothing to
// order here.  They come back with exchanges between cards.
#pragma once

struct HaloRemap {
  int halo, depth;
  int tile_nx, tile_ny;
  int local_nx, local_ny;
  int nprocx, nprocy;
  int wrap_x, wrap_y;
};
constexpr int kHaloRemapInts = 10;
static_assert(sizeof(HaloRemap) == kHaloRemapInts * sizeof(int), "layout");

// Source index along one axis (see above).
__host__ __device__ inline int halo_remap_axis(int i, int h, int d, int t,
                                               int l, int n, int wrap) {
  const int k = i / l, r = i - k * l;
  if (r >= h - d && r < h && (k > 0 || wrap)) {
    return (k > 0 ? k - 1 : n - 1) * l + r + t;
  }
  if (r >= h + t && r < h + t + d && (k < n - 1 || wrap)) {
    return (k < n - 1 ? k + 1 : 0) * l + r - t;
  }
  return i;
}

__host__ __device__ inline int halo_remap_row(const HaloRemap& m, int y) {
  return halo_remap_axis(y, m.halo, m.depth, m.tile_ny, m.local_ny, m.nprocy,
                         m.wrap_y);
}

__host__ __device__ inline int halo_remap_col(const HaloRemap& m, int x) {
  return halo_remap_axis(x, m.halo, m.depth, m.tile_nx, m.local_nx, m.nprocx,
                         m.wrap_x);
}
