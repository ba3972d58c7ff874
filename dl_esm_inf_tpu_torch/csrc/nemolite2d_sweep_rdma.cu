// The NEMOLite2D sweep with the halo exchange between ranks before it:
// the flagship's fused transport across processes, one tile per rank.
//
// Replaces the multi-device branch of the TPU kernel
// dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep with exchange_spec
// (run_exchange, ops/sweep.py:383-513, instantiated by
// ops/pallas_step.py::make_fused_step): the remote-DMA exchange of the
// three state planes at the full halo depth between devices, then K
// steps.  One call, in stream order on the caller's stream:
//
//   1. the exchange of rdma_protocol.cuh on a window of collective id 2
//      (rdma.py: COLLECTIVE_ID_SWEEP): the send kernel copies the three
//      state planes into a (3, ny, nx) staging block and writes the x
//      strips, the full-width y rows and the corner blocks straight from
//      the planes into the 8 neighbours' landing buffers of this call's
//      parity; one stream_signal per neighbour, one stream_wait per
//      neighbour (the call's one hand-off, off the SMs); the merge into
//      the staging block's halo (the caller's arrays are left as the
//      ppermute transport leaves them; the JAX kernel merged into its
//      inputs through input_output_aliases);
//   2. sweep: the K sub-steps of nemolite2d_step.cuh on tiles staged from
//      the merged block (flat or variable depth; 16-byte copies where a
//      chunk lies inside the block), the last one written to new planes.
//
// The output equals the ppermute exchange at the full halo depth followed
// by the sweep, bitwise at internal points.
//
// Why it cannot deadlock.  No kernel waits at all: the wait is a stream
// memory operation between the send and the merge, for signals that
// every neighbour's call of the same number sends right after its own
// send, before its own wait.  The window of collective id 2 is not the
// standalone exchange's, so a sweep and an exchange between two sweeps
// never satisfy each other's waits.  The host bounds each call's wait
// (rdma.py: BUDGET_S) and raises, naming the slot, on one still pending.
//
// What bounds it.  Bytes: the copy reads and writes the three planes
// once and the sweep moves them once more with the code (and ht), about
// 25 B per point per sweep at float32 plus the copy's 24; the strips are
// ~1% of that.  Latency: one hand-off between processes, which the
// stream wait makes a context switch on one card.  Streaming the
// interior tiles under the in-flight strips, as the TPU kernel does, is
// later work.
#include "nemolite2d_step.cuh"
#include "rdma_protocol.cuh"

namespace {

using nemo::Consts;

template <typename T, int K, bool HT>
__global__ void __launch_bounds__(nemo::Geo<T, K, HT>::NT,
                                  nemo::Geo<T, K, HT>::CTAS)
nemo_sweep_merged_kernel(const T* __restrict__ xs_g,
                         const int8_t* __restrict__ code_g,
                         const T* __restrict__ ht_g, T* __restrict__ ssha_g,
                         T* __restrict__ ua_g, T* __restrict__ va_g, int ny,
                         int nx,
                         const __grid_constant__ nemo::StepConsts<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t plane = static_cast<size_t>(ny) * nx;
  nemo::Planes<T> s = nemo::carve<T, K, HT>(smem_raw);
  nemo::stage<T, K, HT, false, (K > 1)>(s, xs_g, xs_g + plane,
                                        xs_g + 2 * plane, code_g, ht_g, ny,
                                        nx, HaloRemap{});
  __syncthreads();
  const nemo::Out<T> out{ssha_g, ua_g, va_g, ny, nx};
  nemo::substeps<T, K, HT, false, true>(s, c, out);
}

// The launch's pointers and extents.
struct Args {
  const void *sshn, *un, *vn, *code, *ht;
  void *xs, *ssha, *ua, *va;
  int ny, nx;
};

template <typename T, int K, bool HT>
cudaError_t launch_sweep(const Args& a, const Consts& c, cudaStream_t s) {
  using G = nemo::Geo<T, K, HT>;
  return nemo::launch<nemo_sweep_merged_kernel<T, K, HT>>(
      G::smem_bytes, nemo::tile_grid<G>(a.ny, a.nx), G::NT, s,
      static_cast<const T*>(a.xs), static_cast<const int8_t*>(a.code),
      static_cast<const T*>(a.ht), static_cast<T*>(a.ssha),
      static_cast<T*>(a.ua), static_cast<T*>(a.va), a.ny, a.nx,
      nemo::working<T>(c));
}

template <typename T, int K>
cudaError_t dispatch_ht(bool ht, const Args& a, const Consts& c,
                        cudaStream_t s) {
  return ht ? launch_sweep<T, K, true>(a, c, s)
            : launch_sweep<T, K, false>(a, c, s);
}

template <typename T>
cudaError_t sweep_k(int K, bool ht, const Args& a, const Consts& c,
                    cudaStream_t s) {
  switch (K) {
    case 1: return dispatch_ht<T, 1>(ht, a, c, s);
    case 2: return dispatch_ht<T, 2>(ht, a, c, s);
    case 3: return dispatch_ht<T, 3>(ht, a, c, s);
    case 4: return dispatch_ht<T, 4>(ht, a, c, s);
    default: return cudaErrorInvalidValue;
  }
}

// Exchange, then sweep; E is T's raw word.  Returns 0, a cudaError_t,
// or minus a CUresult.
template <typename T, typename E>
int run(int K, const Args& a, const Consts& c, const rdma::Wins& wins,
        const rdma::RdmaGeo& g, cudaEvent_t waited, cudaStream_t s) {
  const rdma::ThreePlanes<E> src{{static_cast<const E*>(a.sshn),
                                  static_cast<const E*>(a.un),
                                  static_cast<const E*>(a.vn)}};
  const int rc = rdma::run_exchange<E>(src, static_cast<E*>(a.xs), wins, g,
                                       waited, s);
  if (rc != 0) return rc;
  return static_cast<int>(sweep_k<T>(K, a.ht != nullptr, a, c, s));
}

}  // namespace

extern "C" {

// Number of doubles nemo_sweep_rdma_launch expects in `consts`, and of
// integers in `geo`.
int nemo_sweep_rdma_num_consts() { return nemo::kNumConsts; }
int nemo_sweep_rdma_num_geo_ints() { return rdma::kGeoInts; }

// dtype_code: 0 = float32, 1 = float64.  sshn, un, vn, code (int8), ht
// (null for flat bathymetry), ssha, ua, va: contiguous (ny, nx) planes of
// this rank's one-tile block on the card; xs: a (3, ny, nx) staging block.
// `consts`: the sweep's constants (nemolite2d_sweep.cu's); `wins`: my
// window of collective id 2, then the neighbours' (opened) windows by
// direction (W, E, S, N, SW, SE, NW, NE); `geo`: RdmaGeo's fields (lead
// 3, depth = halo); `event`: recorded after the waits.  Enqueues the
// exchange and the sweep on `stream` without synchronising; returns 0, a
// cudaError_t, or minus a CUresult.  Everything is checked before the
// first launch: a refused call signals no peer.
int nemo_sweep_rdma_launch(int dtype_code, int K, const void* sshn,
                           const void* un, const void* vn, const void* code,
                           const void* ht, void* xs, void* ssha, void* ua,
                           void* va, int ny, int nx, const double* consts,
                           int n_consts, void* const* wins,
                           const long long* geo, int n_geo, void* event,
                           void* stream) {
  Consts c;
  rdma::RdmaGeo g;
  if (!nemo::read_consts(consts, n_consts, &c) ||
      !rdma::read_geo(geo, n_geo, &g) || g.lead != 3 || g.ly != ny ||
      g.lx != nx || g.d != g.h || K < 1 || K > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rdma::Wins w;
  w.mine = static_cast<char*>(wins[0]);
  for (int d = 0; d < rdma::kDirs; ++d) w.peer[d] = static_cast<char*>(wins[1 + d]);
  const Args a{sshn, un, vn, code, ht, xs, ssha, ua, va, ny, nx};
  cudaEvent_t ev = static_cast<cudaEvent_t>(event);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return run<float, uint32_t>(K, a, c, w, g, ev, s);
  if (dtype_code == 1) {
    return run<double, unsigned long long>(K, a, c, w, g, ev, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
