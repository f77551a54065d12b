// The MTTKRP entries of rows 1-4 in float64 (mttkrp_entries.cuh): the shared
// body (mttkrp_cluster.cuh) reading float64 and summing in fp32, float output.
#include "mttkrp_entries.cuh"

MTTKRP_ENTRIES(double, f64)
