// Standalone halo exchange of one stacked-layout block, leading (level)
// dims carried: out = the block with every tile's halo ring refreshed to
// depth d from its neighbours, as one gather (halo_remap.cuh).
//
// Replaces the TPU kernel dl_esm_inf_tpu/parallel/halo_pallas.py::
// make_block_exchange: a whole-block copy followed by remote DMAs of the x
// column strips and then the full-width y rows between devices, with
// border restores where a device has no neighbour.  Here every tile is
// in one array on one card, so the two phases collapse into the separable
// map of halo_remap.cuh and the whole exchange is one launch that writes
// the whole new block (functional, like the TPU kernel's whole-block
// copy).  It reads only its input and writes only its output, so blocks
// need no ordering between them: the TPU kernel's readiness fence and
// entry barrier have nothing to order on one card.
//
// What bounds it.  It moves each element once in and once out: the bound
// is one read and one write of the block over HBM bandwidth (about 2.6 us
// for a 1040^2 float32 block at 3.35 TB/s).  Each thread copies one
// element of a row; consecutive threads take consecutive columns, whose
// sources are consecutive except at the few halo columns, so loads and
// stores coalesce.  The row and column maps cost a few integer operations
// per element, well under the memory time.  Elements are copied as raw
// 4- or 8-byte words, so float32, int32 and float64 move bit for bit.
// Writing only the halo strips in place would move far fewer bytes; that
// is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "halo_remap.cuh"

namespace {

constexpr int BX = 128;
constexpr int BY = 4;

template <typename E>
__global__ void __launch_bounds__(BX* BY)
halo_exchange_kernel(const E* __restrict__ in, E* __restrict__ out,
                     int rows, int ny, int nx, HaloRemap m) {
  const int x = blockIdx.x * BX + threadIdx.x;
  if (x >= nx) return;
  const int sx = halo_remap_col(m, x);
  for (int row = blockIdx.y * BY + threadIdx.y; row < rows;
       row += gridDim.y * BY) {
    const int lvl = row / ny, y = row - lvl * ny;
    const int sy = halo_remap_row(m, y);
    out[static_cast<size_t>(row) * nx + x] =
        in[(static_cast<size_t>(lvl) * ny + sy) * nx + sx];
  }
}

template <typename E>
cudaError_t launch(const void* in, void* out, int rows, int ny, int nx,
                   const HaloRemap& m, cudaStream_t stream) {
  const int gy = min((rows + BY - 1) / BY, 65535);
  const dim3 grid((nx + BX - 1) / BX, gy);
  halo_exchange_kernel<E><<<grid, dim3(BX, BY), 0, stream>>>(
      static_cast<const E*>(in), static_cast<E*>(out), rows, ny, nx, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of ints halo_exchange_launch expects in `remap`.
int halo_exchange_num_remap_ints() { return kHaloRemapInts; }

// elem_bytes: 4 or 8.  `in` and `out` are device pointers of contiguous
// (lead, ny, nx) blocks, ny = nprocy*local_ny, nx = nprocx*local_nx;
// `remap` (host memory, read before the launch returns) holds the fields
// of HaloRemap in order.  Launches on `stream` without synchronising and
// returns cudaGetLastError() of the launch.
int halo_exchange_launch(int elem_bytes, const void* in, void* out, int lead,
                         int ny, int nx, const int* remap, int n_remap,
                         void* stream) {
  if (n_remap != kHaloRemapInts || lead < 1 || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HaloRemap m;
  int* dst = reinterpret_cast<int*>(&m);
  for (int i = 0; i < kHaloRemapInts; ++i) dst[i] = remap[i];
  if (m.nprocy * m.local_ny != ny || m.nprocx * m.local_nx != nx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = lead * ny;
  cudaError_t err;
  if (elem_bytes == 4) {
    err = launch<uint32_t>(in, out, rows, ny, nx, m, s);
  } else if (elem_bytes == 8) {
    err = launch<unsigned long long>(in, out, rows, ny, nx, m, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
