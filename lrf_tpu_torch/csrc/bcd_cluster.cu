// The cluster BCD kernel of bcd_cluster.cuh at ranks 1..16: the codec's
// 8x8-patch stacks up to quality 26 (R = round(0.64 q)), the bench shapes
// among them. bcd_cluster_wide.cu builds ranks 17..32 beside it, in a
// second nvcc process.

#define LRF_BCDC_MIN_RANK 1
#define LRF_BCDC_MAX_RANK 16
#define LRF_FOR_EACH_RANK(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

#include "bcd_cluster.cuh"
