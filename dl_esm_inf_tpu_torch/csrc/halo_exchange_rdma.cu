// The halo exchange between ranks: each rank writes its edge strips into
// its neighbours' landing buffers through CUDA IPC, fenced.
//
// Replaces the TPU kernel dl_esm_inf_tpu/parallel/halo_pallas.py::
// make_block_exchange on its multi-device path: one tile per rank, a
// whole-block copy (out = in: the exchange is functional, like the
// ppermute path), then the protocol of rdma_protocol.cuh on collective
// id 1 (rdma.py: COLLECTIVE_ID_EXCHANGE): the entry barrier, and per
// phase the readiness fence, the remote writes of the edge strips, a
// delivery signal, and the merge of the received strips where the rank
// has a neighbour.  This file also holds the windows' host side
// (allocate, export, open, close, read the status), which the fused
// transport's sweep (nemolite2d_sweep_rdma.cu) shares through rdma.py.
//
// Ordering.  The copy is its own launch (many CTAs) before the protocol
// launch on the same stream, so the protocol reads a complete `out`; the
// protocol is one CTA, so no CTA waits on another CTA of its grid.
//
// What bounds it.  Bytes: the copy reads and writes the block once (2.6 us
// for a 1040^2 float32 block at 3.35 TB/s); the strips are ~1% of that.
// Latency: two fence round trips and two deliveries between processes,
// which on one card without MPS wait for the context scheduler.
#include <cuda_runtime.h>

#include <cstdint>

#include "rdma_protocol.cuh"

namespace {

using rdma::RdmaGeo;

template <typename E>
cudaError_t launch(const void* in, void* out, char* const* wins,
                   const RdmaGeo& g, unsigned long long budget_ns,
                   cudaStream_t s) {
  cudaError_t err = rdma::launch_copy<E>(in, out, g.lead * g.ly * g.lx, s);
  if (err != cudaSuccess) return err;
  return rdma::launch_protocol<E>(out, wins, g, budget_ns, s);
}

}  // namespace

extern "C" {

int rdma_num_geo_ints() { return rdma::kGeoInts; }
int rdma_num_slots() { return kNumSlots; }

// Allocate a zeroed window of `bytes` on `device` and export it:
// *ptr gets the device pointer, `handle` (64 bytes, host memory) the
// cudaIpcMemHandle_t.
int rdma_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

int rdma_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Open a peer's exported window on `device`.
int rdma_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int rdma_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

int rdma_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// Copy the window's status pair to `out` (host) after `stream`'s work:
// {0, 0} when every wait of every launch so far was satisfied.
int rdma_read_status(void* win, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(
      out, static_cast<char*>(win) + kNumSlots * sizeof(unsigned),
      2 * sizeof(int), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// elem_bytes: 4 or 8.  `in`, `out`: contiguous (lead, ly, lx) blocks on
// the card.  `wins`: my window, then the east, west, north and south
// peers' (opened) windows.  `geo`: RdmaGeo's fields in order.  Launches
// the copy and the protocol on `stream` without synchronising; returns
// cudaGetLastError() of the launches.
int rdma_exchange_launch(int elem_bytes, const void* in, void* out,
                         void* const* wins, const long long* geo, int n_geo,
                         unsigned long long budget_ns, void* stream) {
  RdmaGeo g;
  if (!rdma::read_geo(geo, n_geo, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* w[5];
  for (int i = 0; i < 5; ++i) w[i] = static_cast<char*>(wins[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return static_cast<int>(launch<uint32_t>(in, out, w, g, budget_ns, s));
  if (elem_bytes == 8) return static_cast<int>(launch<unsigned long long>(in, out, w, g, budget_ns, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
