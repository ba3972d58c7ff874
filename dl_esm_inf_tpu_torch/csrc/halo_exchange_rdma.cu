// The halo exchange between ranks: each rank writes its edge strips into
// its neighbours' landing buffers through CUDA IPC, with one hand-off per
// call.
//
// Replaces the TPU kernel dl_esm_inf_tpu/parallel/halo_pallas.py::
// make_block_exchange on its multi-device path: one tile per rank, a
// whole-block copy (out = in: the exchange is functional, like the
// ppermute path) fused with the sends, then the signals, the wait and the
// merge of rdma_protocol.cuh, on the window of collective id 1 (rdma.py:
// COLLECTIVE_ID_EXCHANGE).  This file also holds the windows' host side
// (allocate, export, open, close, read and release the slots, the
// window's event), which the fused transport's sweep
// (nemolite2d_sweep_rdma.cu) shares through rdma.py.
//
// What bounds it.  Bytes: the copy reads and writes the block once (2.6 us
// for a 1040^2 float32 block at 3.35 TB/s); the strips are ~1% of that.
// Latency: one hand-off between processes per call.  The wait blocks the
// stream in the card's front end (a stream memory operation), so a
// time-sliced card switches to the peer's context at once instead of at
// the end of a slice spent spinning.
#include <cuda_runtime.h>

#include <cstdint>

#include "rdma_protocol.cuh"

namespace {

using rdma::RdmaGeo;

template <typename E>
int launch(const void* in, void* out, const rdma::Wins& wins,
           const RdmaGeo& g, cudaEvent_t waited, cudaStream_t s) {
  const rdma::Contiguous<E> src{static_cast<const E*>(in), g.ly * g.lx};
  return rdma::run_exchange<E>(src, static_cast<E*>(out), wins, g, waited,
                               s);
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

// A window's event (one per call parity): recorded by a call after its
// waits.
int rdma_event_create(void** event) {
  return static_cast<int>(cudaEventCreateWithFlags(
      reinterpret_cast<cudaEvent_t*>(event), cudaEventDisableTiming));
}

// 0 once the event's work is done, cudaErrorNotReady (600) before.
int rdma_event_query(void* event) {
  return static_cast<int>(cudaEventQuery(static_cast<cudaEvent_t>(event)));
}

int rdma_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

// Copy the window's kNumSlots slots to `out` (host), on a stream of its
// own on `device` that waits for no other: a stream held by a pending
// stream wait must not hold this read.
int rdma_read_slots(int device, void* win, unsigned* out) {
  cudaStream_t s;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(out, win, kNumSlots * sizeof(unsigned),
                        cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  return static_cast<int>(err);
}

// Write `value` into slot `slot` of `win` (mine) on a stream of its own:
// releases a stream wait on that slot that no peer will satisfy, so the
// waiting stream drains.  Returns 0, a cudaError_t, or minus a CUresult.
int rdma_release(int device, void* win, int slot, unsigned value) {
  cudaStream_t s;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUresult e =
      stream_signal(s, static_cast<unsigned*>(win) + slot, value);
  int rc = e == CUDA_SUCCESS ? static_cast<int>(cudaStreamSynchronize(s))
                             : -static_cast<int>(e);
  cudaStreamDestroy(s);
  return rc;
}

// elem_bytes: 4 or 8.  `in`, `out`: contiguous (lead, ly, lx) blocks on
// the card.  `wins`: my window, then the neighbours' (opened) windows by
// direction (W, E, S, N, SW, SE, NW, NE; any pointer for a direction
// that does not exchange).  `geo`: RdmaGeo's fields in order.  `event`:
// recorded after the waits.  Enqueues the call on `stream` without
// synchronising; returns 0, a cudaError_t, or minus a CUresult.
int rdma_exchange_launch(int elem_bytes, const void* in, void* out,
                         void* const* wins, const long long* geo, int n_geo,
                         void* event, void* stream) {
  RdmaGeo g;
  if (!rdma::read_geo(geo, n_geo, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rdma::Wins w;
  w.mine = static_cast<char*>(wins[0]);
  for (int d = 0; d < rdma::kDirs; ++d) w.peer[d] = static_cast<char*>(wins[1 + d]);
  cudaEvent_t ev = static_cast<cudaEvent_t>(event);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch<uint32_t>(in, out, w, g, ev, s);
  if (elem_bytes == 8) return launch<unsigned long long>(in, out, w, g, ev, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
