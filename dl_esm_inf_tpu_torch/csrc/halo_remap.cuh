// Geometry of the two-phase halo exchange on the stacked layout: the one
// place that says which cell each point of an exchanged block is copied
// from.  Both exchange kernels include it: the standalone block exchange
// (halo_exchange.cu, both its forms) and the exchange inside the flagship
// sweep (nemolite2d_sweep.cu, EXCH).  It plays the part of the JAX package's
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
// On one card every tile is in one array, read and written by one launch:
// the readiness fence and the entry barrier the TPU transports need
// between devices (rdma.py: make_fence, entry_barrier) have nothing to
// order here.  They come back with exchanges between cards.  Where the
// launch writes the array it reads (halo_exchange.cu's ring form), no
// source may lie in a strip: d <= t on every axis that moves strips, as
// proved there.
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

// Whether any column of [x0, x0 + n) reads another column: the same map
// as halo_remap_col, with one division for the span (which may run on
// into the tiles after x0's; x0 + n <= nprocx * local_nx).
__host__ __device__ inline bool halo_remap_cols_move(const HaloRemap& m,
                                                     int x0, int n) {
  const int h = m.halo, d = m.depth, t = m.tile_nx, l = m.local_nx;
  int k = x0 / l, r = x0 - k * l;
  while (n > 0) {
    const int e = r + n < l ? r + n : l;  // [r, e) lies in tile k
    if ((k > 0 || m.wrap_x) && r < h && e > h - d) return true;
    if ((k < m.nprocx - 1 || m.wrap_x) && r < h + t + d && e > h + t) {
      return true;
    }
    n -= e - r;
    ++k;
    r = 0;
  }
  return false;
}

// The first index of the strip that tile k receives along one axis on
// side 0 (from the tile before it: west or south) or side 1 (from the
// tile after it: east or north), or -1 where it has no neighbour there.
// The strips are the indices halo_remap_axis moves, d each.
__host__ __device__ inline int halo_strip_start(int k, int side, int h,
                                                int d, int t, int l, int nt,
                                                int wrap) {
  if (side == 0) return k > 0 || wrap ? k * l + h - d : -1;
  return k < nt - 1 || wrap ? k * l + h + t : -1;
}
