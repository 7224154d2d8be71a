// The cluster BCD kernel of bcd_cluster.cuh at ranks 17..32: the codec's
// 8x8-patch stacks at quality 27-50 (R = round(0.64 q)), among them the
// q40 Y stack (1, 6144, 64, 26) of a per-image encode. Built by its own
// nvcc process beside bcd_cluster.cu (ranks 1..16).

#define LRF_BCDC_MIN_RANK 17
#define LRF_BCDC_MAX_RANK 32
#define LRF_FOR_EACH_RANK(X)                                                                        \
  X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26) X(27) X(28) X(29) X(30) X(31) X(32)

#include "bcd_cluster.cuh"
