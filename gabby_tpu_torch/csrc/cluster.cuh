// Thread-block cluster helpers shared by the kernels that merge partial
// results across a cluster through distributed shared memory
// (quant_matmul_stacked.cu, decode_attention.cu).

#pragma once

#include <stdint.h>

namespace {

// The cluster's barrier, arrive (relaxed: it orders nothing but the
// mbarrier inits, which their fence releases) and wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The address in the cluster's block `rank` of a shared address of ours
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// Waits for the mbarrier's phase `parity` with acquire at cluster scope:
// what completes it comes from the cluster's other blocks. Traps after
// about ten seconds.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

}  // namespace
