// The strips that cross a rank seam, moved card to card: the transport
// of the plain exchange's ppermute (parallel/halo.py::_send_recv) through
// peer-memory windows, instead of host memory.
//
// The JAX package moves these strips with lax.ppermute
// (dl_esm_inf_tpu/parallel/halo.py:176, :193), device to device; there is
// no Pallas kernel behind it, and there is none here: one batch of strips
// is a list of copies and stream memory operations, enqueued in order on
// the caller's stream by seam_batch below (parallel/seam.py keeps the
// windows and the counts):
//
//   1. per send: a copy of the strip (a 2-D copy: rows of one contiguous
//      run each, read straight from the strided block) into the peer's
//      landing buffer of parity n & 1, then stream_signal(n) on the
//      peer's delivered slot of that strip (the signal's default flag
//      fences the copy first);
//   2. per receive: stream_wait(n) on this rank's slot (the stream blocks
//      in the card's front end, off the SMs; rdma_fence.cuh);
//   3. the window's event, recorded after the waits (the host's budget);
//   4. per receive: a copy from the landing buffer of parity n & 1 into
//      the receiving tensor.
//
// n counts the messages of one strip's edge (sender, receiver, tag,
// shape, dtype) on both of its ranks.  The landings are double-buffered
// by n's parity, for the reason rdma_protocol.cuh gives: every batch that
// sends to a peer also receives from it, so a rank writes a peer's
// parity p again (message n + 2) only after its stream waited for a
// strip the peer sent after its message-n copy-out.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rdma_fence.cuh"

namespace {

// The fields of one send or receive in seam_batch's arrays, in order.
enum SendField { kSrc, kSrcPitch, kWidth, kHeight, kDst, kPeerSlot,
                 kSendValue, kSendFields };
enum RecvField { kSlot, kRecvValue, kLand, kOut, kOutPitch, kRWidth,
                 kRHeight, kRecvFields };

inline void* ptr(long long v) {
  return reinterpret_cast<void*>(static_cast<uintptr_t>(v));
}

}  // namespace

extern "C" {

int seam_send_fields() { return kSendFields; }
int seam_recv_fields() { return kRecvFields; }

// Enqueue one batch on `stream` of `device` without synchronising.
// `send`: n_send rows of kSendFields (source pointer, its row pitch in
// bytes, row width in bytes, rows, the landing buffer's pointer, the
// peer's slot pointer, the value to signal).  `recv`: n_recv rows of
// kRecvFields (my slot pointer, the value to wait for, the landing
// buffer's pointer, the output pointer, its row pitch, row width, rows).
// `event`: recorded after the waits.  Returns 0, a cudaError_t, or minus
// a CUresult.
int seam_batch(int device, int n_send, const long long* send, int n_recv,
               const long long* recv, void* event, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_send; ++i) {
    const long long* f = send + i * kSendFields;
    err = cudaMemcpy2DAsync(ptr(f[kDst]), static_cast<size_t>(f[kWidth]),
                            ptr(f[kSrc]), static_cast<size_t>(f[kSrcPitch]),
                            static_cast<size_t>(f[kWidth]),
                            static_cast<size_t>(f[kHeight]),
                            cudaMemcpyDefault, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const CUresult e =
        stream_signal(s, static_cast<unsigned*>(ptr(f[kPeerSlot])),
                      static_cast<unsigned>(f[kSendValue]));
    if (e != CUDA_SUCCESS) return -static_cast<int>(e);
  }
  for (int i = 0; i < n_recv; ++i) {
    const long long* f = recv + i * kRecvFields;
    const CUresult e = stream_wait(s, static_cast<unsigned*>(ptr(f[kSlot])),
                                   static_cast<unsigned>(f[kRecvValue]));
    if (e != CUDA_SUCCESS) return -static_cast<int>(e);
  }
  err = cudaEventRecord(static_cast<cudaEvent_t>(event), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_recv; ++i) {
    const long long* f = recv + i * kRecvFields;
    err = cudaMemcpy2DAsync(ptr(f[kOut]), static_cast<size_t>(f[kOutPitch]),
                            ptr(f[kLand]), static_cast<size_t>(f[kRWidth]),
                            static_cast<size_t>(f[kRWidth]),
                            static_cast<size_t>(f[kRHeight]),
                            cudaMemcpyDefault, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
