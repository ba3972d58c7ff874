// The NEMOLite2D sweep with the halo exchange between ranks inside it:
// the flagship's fused transport across processes, one tile per rank.
//
// Replaces the multi-device branch of the TPU kernel
// dl_esm_inf_tpu/ops/sweep.py::make_stencil_sweep with exchange_spec
// (run_exchange, ops/sweep.py:383-513, instantiated by
// ops/pallas_step.py::make_fused_step): the remote-DMA exchange of the
// three state planes at the full halo depth between devices, then K
// steps.  One call, in stream order on the caller's stream:
//
//   1. copy: the three state planes into a (3, ny, nx) staging block
//      (the caller's arrays are left as the ppermute transport leaves
//      them; the JAX kernel merged into its inputs through
//      input_output_aliases);
//   2. protocol (rdma_protocol.cuh, one CTA): the entry barrier on
//      collective id 2 (rdma.py: COLLECTIVE_ID_SWEEP), then the x phase
//      (fence, the east and west column strips into the peers' landing
//      buffers, deliver, wait, merge where has_w / has_e) and the y phase
//      (fence, the full-width rows after the x merge, so corners arrive
//      by sequencing; merge where has_s / has_n), on the staging block in
//      place, in a window of the sweep's own;
//   3. sweep: the K sub-steps of nemolite2d_step.cuh on tiles staged from
//      the merged block (flat or variable depth), written to new planes.
//
// The output equals the ppermute exchange at the full halo depth followed
// by the sweep, bitwise at internal points.
//
// Why it cannot deadlock.  No CTA ever waits on another CTA of its own
// grid: the copy and the sweep never wait (about 1000 CTAs each at
// 1024^2, more than can be resident at once, so a grid-wide wait there
// could hang), and the protocol that waits is a grid of one CTA, whose
// phases __syncthreads orders.  Stream order puts the copy before the
// protocol and the protocol before the sweep, so no cooperative launch
// or grid sync is needed.  Between ranks, every wait is for a signal
// that a peer's protocol of the same call sends before any wait of its
// own phase that could depend on this rank; the entry barrier pairs the
// calls, the counting slots (rdma_fence.cuh) buffer a peer one or two
// calls ahead, and the window of collective id 2 is not the standalone
// exchange's, so a sweep and an exchange between two sweeps never consume
// each other's signals.  A wait that outlasts its %globaltimer budget
// gives up and writes the status word, which the wrapper reads after the
// call and raises on.
//
// What bounds it.  Bytes: the copy reads and writes the three planes
// once and the sweep moves them once more with the code (and ht), about
// 25 B per point per sweep at float32 plus the copy's 24; the strips are
// ~1% of that.  Latency: the entry barrier and two fence round trips
// between processes, which on one card without MPS wait for the context
// scheduler (milliseconds); between cards, microseconds.  Streaming the
// interior tiles under the in-flight y rows, as the TPU kernel does, is
// later work.
#include "nemolite2d_step.cuh"
#include "rdma_protocol.cuh"

namespace {

using nemo::Consts;

template <typename T, int K, bool HT>
__global__ void __launch_bounds__(nemo::NT)
nemo_sweep_merged_kernel(const T* __restrict__ xs_g,
                         const int8_t* __restrict__ code_g,
                         const T* __restrict__ ht_g, T* __restrict__ ssha_g,
                         T* __restrict__ ua_g, T* __restrict__ va_g, int ny,
                         int nx, Consts c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t plane = static_cast<size_t>(ny) * nx;
  nemo::Planes<T> s = nemo::carve<T, K, HT>(smem_raw);
  nemo::stage<T, K, HT, false>(s, xs_g, xs_g + plane, xs_g + 2 * plane,
                               code_g, ht_g, ny, nx, HaloRemap{});
  __syncthreads();
  nemo::substeps<T, K, HT, false>(s, c);
  nemo::write_back<T, K, HT>(s, ssha_g, ua_g, va_g, ny, nx);
}

// The launch's pointers and extents.
struct Args {
  const void *sshn, *un, *vn, *code, *ht;
  void *xs, *ssha, *ua, *va;
  int ny, nx;
};

template <typename T, int K, bool HT>
cudaError_t launch_sweep(const Args& a, const Consts& c, cudaStream_t s) {
  return nemo::launch<nemo_sweep_merged_kernel<T, K, HT>>(
      nemo::Window<T, K, HT>::smem_bytes, nemo::tile_grid(a.ny, a.nx), s,
      static_cast<const T*>(a.xs), static_cast<const int8_t*>(a.code),
      static_cast<const T*>(a.ht), static_cast<T*>(a.ssha),
      static_cast<T*>(a.ua), static_cast<T*>(a.va), a.ny, a.nx, c);
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

// Copy, protocol, sweep; E is T's raw word.
template <typename T, typename E>
cudaError_t run(int K, const Args& a, const Consts& c, char* const* wins,
                const rdma::RdmaGeo& g, unsigned long long budget_ns,
                cudaStream_t s) {
  const size_t plane = static_cast<size_t>(a.ny) * a.nx;
  const void* in[3] = {a.sshn, a.un, a.vn};
  for (int f = 0; f < 3; ++f) {
    cudaError_t err = rdma::launch_copy<E>(
        in[f], static_cast<T*>(a.xs) + f * plane,
        static_cast<long long>(plane), s);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = rdma::launch_protocol<E>(a.xs, wins, g, budget_ns, s);
  if (err != cudaSuccess) return err;
  return sweep_k<T>(K, a.ht != nullptr, a, c, s);
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
// window of collective id 2, then the east, west, north and south peers'
// (opened) windows; `geo`: RdmaGeo's fields (lead 3, depth = halo).
// Launches the copies, the protocol and the sweep on `stream` without
// synchronising; returns the first launch error.  Everything is checked
// before the first launch: a refused call signals no peer.
int nemo_sweep_rdma_launch(int dtype_code, int K, const void* sshn,
                           const void* un, const void* vn, const void* code,
                           const void* ht, void* xs, void* ssha, void* ua,
                           void* va, int ny, int nx, const double* consts,
                           int n_consts, void* const* wins,
                           const long long* geo, int n_geo,
                           unsigned long long budget_ns, void* stream) {
  Consts c;
  rdma::RdmaGeo g;
  if (!nemo::read_consts(consts, n_consts, &c) ||
      !rdma::read_geo(geo, n_geo, &g) || g.lead != 3 || g.ly != ny ||
      g.lx != nx || g.d != g.h || K < 1 || K > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* w[5];
  for (int i = 0; i < 5; ++i) w[i] = static_cast<char*>(wins[i]);
  const Args a{sshn, un, vn, code, ht, xs, ssha, ua, va, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = run<float, uint32_t>(K, a, c, w, g, budget_ns, s);
  } else if (dtype_code == 1) {
    err = run<double, unsigned long long>(K, a, c, w, g, budget_ns, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
